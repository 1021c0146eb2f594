"""End-to-end entry point on the PyTorch/CUDA port (paper-kind =
inference service), the counterpart of ``examples/serve_gnn.py`` with its
flags, drills and asserts: concurrent GNN serving against a near-storage
graph through the serving runtime — multi-queue RoP, continuous request
batching, and the device-DRAM embedding cache — with mixed-priority
traffic and live mutations.

Traffic mix per client round:
  * interactive clients submit high-priority requests with a deadline;
  * bulk clients submit best-effort requests that the scheduler coalesces
    into fused super-batches;
  * a mutator thread streams unit graph updates (add_edge / update_embed)
    through the same queues — mutations dispatch immediately, never stuck
    behind a model execution, and invalidate exactly the cached pages they
    touch.

With ``--replication R --kill-shard S`` the run doubles as a fault drill
(the CI fault-injection gate): once a third of the traffic has completed,
a chaos thread fails shard S mid-serve — requests keep completing from
the surviving replicas — then after the clients drain, a seeded reference
request is answered degraded, the shard is rebuilt from the survivors,
and the post-rebuild answer is asserted bit-identical to the degraded one
(the live mutator means there is no meaningful pre-failure reference;
healthy-vs-degraded bit-identity on a quiesced store is asserted by
``tests/test_torch_array.py``).

With ``--chaos`` the drill goes autonomic: a shard's DEVICE is killed
directly mid-serve — no ``fail_shard``, no operator RPC of any kind —
and the attached ``ShardSupervisor`` must detect the fault on its own
(zero-traffic probe + serving-path error mapping), auto-drain, and
auto-rebuild back to full redundancy.  After the traffic drains the
mutator is quiesced and a second device kill asserts bit-identity end to
end: reference answer == degraded answer (auto-steering, still no
operator) == post-auto-rebuild answer.

With ``--remote-shards N`` the array is multi-host: every shard sits
behind its own RoP endpoint (``make_rop_endpoints`` — per-shard SQ/CQ
pairs + PCIeChannel mmap buffers + a shard-host poll thread), the
coordinator speaks only the ShardEndpoint protocol, and rebuild streams
survivor pages shard-to-shard over the peer links.  Results stay
bit-identical to the in-process array.

With ``--reshard-grow K`` (or ``--reshard-shrink K``) the run doubles as
an elastic drill: once a third of the traffic has completed, the array is
resharded LIVE — K shards attach (or the K highest-id shards drain out)
and only the vertex classes that change owner migrate over the peer
links, while the clients and the mutator keep running.  Combined with
``--kill-shard S`` the kill fires *mid-migration* (the chaos thread waits
for the copy windows to open) and the migration must complete from the
surviving replicas.  After the traffic drains, the mutated graph is
asserted bit-identical to a reference store that replays the acknowledged
op log serially — the array answered through attach, copy, flip and
detach without dropping or corrupting anything, with zero failed
requests.

With ``--firehose`` the bulk load goes through the distributed
device-side ingest (raw chunk streaming + shard-local sort/pack) and the
mutator's writes flow through an open ``MutationFirehose``: each time
window becomes ONE device-side ``apply_mutations`` command per shard
instead of one RPC per op.  After the traffic drains, the firehose is
flushed + closed and the mutated graph is asserted bit-identical to a
reference store that replays the exact op log one unit mutation at a
time — the serving answers mid-stream came from real window boundaries.

  PYTHONPATH=src python examples/torch_serve_gnn.py [--requests 20] \
      [--clients 8]
  PYTHONPATH=src python examples/torch_serve_gnn.py --shards 3 \
      --replication 2 --kill-shard 1
  PYTHONPATH=src python examples/torch_serve_gnn.py --remote-shards 3 \
      --replication 2 --chaos
  PYTHONPATH=src python examples/torch_serve_gnn.py --shards 2 --firehose
  PYTHONPATH=src python examples/torch_serve_gnn.py --device cpu

The engine runs on the card (``--device``, default ``cuda``): GCN's fused
layers on the AggCombine kernel, GIN's and NGCF's on spmm and gemm, NGCF's
similarity on sddmm.  ``main(argv)`` returns what it printed as a dict.
"""
import argparse
import threading
import time

import numpy as np

from repro_torch.core import gnn
from repro_torch.core.service import HolisticGNNService, make_service_dfg
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import program_config
from repro_torch.serve import HealthPolicy, ServingRuntime, ShardSupervisor
from repro_torch.store import BlockDevice, GraphStore, make_rop_endpoints


def _kill_device(store, s):
    """Chaos: kill the shard's device directly — the array is never told."""
    ep = store.endpoints[s]
    if hasattr(ep, "local_store"):
        ep.local_store.dev.fail()
    else:
        ep.host.service.store.dev.fail()


def _wait_healed(sup, store, deadline_s=120.0):
    t_end = time.perf_counter() + deadline_s
    while time.perf_counter() < t_end:
        snap = sup.snapshot()
        if (snap["incidents"] and not any(store.failed_shards)
                and all(s == "healthy" for s in snap["states"])):
            return snap
        time.sleep(0.02)
    raise AssertionError(f"array did not heal itself: {sup.snapshot()}")


def _serial_replay(edges, emb, op_log) -> GraphStore:
    """The pre-mutation store rebuilt locally with the acknowledged op log
    replayed one unit mutation at a time."""
    ref = GraphStore(BlockDevice(), h_threshold=64)
    ref.update_graph(edges, emb)
    for op in op_log:
        getattr(ref, op[0])(*op[1:])
    return ref


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=20,
                    help="requests per client")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--model", default="gcn", choices=["gcn", "gin", "ngcf"])
    ap.add_argument("--shards", type=int, default=1,
                    help="CSSD array size: the graph is hash-partitioned "
                         "across N simulated devices (1 = single CSSD)")
    ap.add_argument("--remote-shards", type=int, default=None,
                    help="multi-host array: N shards each behind its own "
                         "RoP endpoint (per-shard SQ/CQ pair + host poll "
                         "thread) instead of in-process")
    ap.add_argument("--replication", type=int, default=1,
                    help="R-way replica placement across the array "
                         "(R >= 2 enables fail/rebuild)")
    ap.add_argument("--kill-shard", type=int, default=None,
                    help="fault injection: fail this shard once a third of "
                         "the traffic has completed, rebuild after drain")
    ap.add_argument("--chaos", action="store_true",
                    help="autonomic fault drill: kill a shard DEVICE "
                         "mid-serve with no operator RPC; the supervisor "
                         "must auto-detect, auto-drain and auto-rebuild")
    ap.add_argument("--firehose", action="store_true",
                    help="ingest drill: chunked distributed bulk load + "
                         "mutations batched through a MutationFirehose, "
                         "verified bit-identical to serial replay at exit")
    ap.add_argument("--reshard-grow", type=int, default=None, metavar="K",
                    help="elastic drill: grow the array by K shards LIVE "
                         "once a third of the traffic has completed; the "
                         "final graph is verified bit-identical to serial "
                         "replay")
    ap.add_argument("--reshard-shrink", type=int, default=None, metavar="K",
                    help="elastic drill: drain the K highest-id shards out "
                         "of the array live (same verification)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cpu: plain versions)")
    args = ap.parse_args(argv)
    if args.kill_shard is not None and args.replication < 2:
        ap.error("--kill-shard needs --replication >= 2")
    if args.chaos and args.replication < 2:
        ap.error("--chaos needs --replication >= 2")
    if args.chaos and args.kill_shard is not None:
        ap.error("--chaos and --kill-shard are mutually exclusive")
    if args.remote_shards is not None and args.shards != 1:
        ap.error("--remote-shards and --shards are mutually exclusive")
    if args.firehose and (args.chaos or args.kill_shard is not None):
        ap.error("--firehose and the fault drills are mutually exclusive")
    args.reshard_drill = (args.reshard_grow is not None
                          or args.reshard_shrink is not None)
    args.n_arr = args.remote_shards if args.remote_shards is not None \
        else args.shards
    if args.reshard_drill:
        if args.reshard_grow is not None and args.reshard_shrink is not None:
            ap.error("--reshard-grow and --reshard-shrink are mutually "
                     "exclusive")
        if args.chaos or args.firehose:
            ap.error("the reshard drill composes with --kill-shard only")
        if args.n_arr < 2:
            ap.error("the reshard drill needs an array "
                     "(--shards/--remote-shards >= 2)")
        if args.reshard_shrink is not None and args.kill_shard is not None:
            ap.error("--reshard-shrink renumbers shards; combine "
                     "--kill-shard with --reshard-grow")
        if args.reshard_shrink is not None \
                and args.n_arr - args.reshard_shrink < max(1,
                                                           args.replication):
            ap.error("--reshard-shrink would leave too few shards")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    reshard_drill, n_arr = args.reshard_drill, args.n_arr
    report: dict = {"model": args.model, "device": str(device)}

    rng = np.random.default_rng(0)
    n, e, feat = 5000, 40000, 128
    edges = np.stack([rng.integers(0, n, e), rng.zipf(1.4, e) % n],
                     1).astype(np.int64)
    emb = rng.standard_normal((n, feat)).astype(np.float32)

    endpoints = None
    if args.remote_shards is not None:
        endpoints = make_rop_endpoints(args.remote_shards, h_threshold=64)
    svc = HolisticGNNService(h_threshold=64, pad_to=64, cache_pages=4096,
                             n_shards=args.shards, endpoints=endpoints,
                             replication=args.replication,
                             stats_staleness_s=(0.01 if endpoints else 0.0),
                             device=device)
    runtime = ServingRuntime(svc, n_queues=min(args.clients, 8),
                             max_group=16, max_pending=512)
    boot = runtime.client()
    runtime.start()
    boot.call("update_graph", edge_array=edges, embeddings=emb,
              chunked=args.firehose, timeout=600)
    program_config(svc.xbuilder, "hetero")
    if args.firehose:
        boot.call("open_firehose", window_s=0.01, timeout=600)

    supervisor = None
    if args.chaos:
        supervisor = ShardSupervisor(svc.store, HealthPolicy(
            probe_interval_s=0.01, rebuild_retry_s=0.1)).start()

    params = gnn.init_params(args.model, [feat, 64, 32], seed=1,
                             device="cpu")
    dfg = make_service_dfg(args.model, 2, [10, 10]).save()
    weights = {k: v.numpy() for k, v in
               gnn.dfg_feeds(args.model, params, None, []).items()
               if k != "H"}
    # deploy the model device-side once; requests then carry only targets
    boot.call("put_weights", name="deployed", weights=weights, timeout=600)

    lat = {"interactive": [], "bulk": []}
    errors = []
    lock = threading.Lock()
    stop_mutator = threading.Event()
    total_reqs = args.requests * args.clients

    def completed():
        with lock:
            return len(lat["interactive"]) + len(lat["bulk"]) + len(errors)

    killed = threading.Event()
    chaos_victim = 1
    reshard_started = threading.Event()
    reshard_report: dict = {}

    def reshard_loop():
        """Reshard the array live once a third of the traffic completed.

        Small chunks + pacing stretch the migration so the traffic (and,
        with --kill-shard, the kill) really lands mid-copy-window."""
        cl = runtime.client()
        deadline = time.perf_counter() + 120.0
        while completed() < total_reqs // 3 \
                and time.perf_counter() < deadline:
            time.sleep(0.01)
        reshard_started.set()
        kw = dict(chunk_pages=8, pace_s=0.002, timeout=600)
        if args.reshard_grow is not None:
            r = cl.call("reshard", add=args.reshard_grow, **kw)
        else:
            n0 = svc.store.n_shards
            r = cl.call("reshard",
                        remove=list(range(n0 - args.reshard_shrink, n0)),
                        **kw)
        reshard_report.update(r)
        print(f"reshard: {r['classes_moved']} classes moved "
              f"({r['copies']} copies, {r['bytes_shipped']} bytes over the "
              f"peer links) -> {r['n_shards']} shards in "
              f"{r['seconds'] * 1e3:.0f} ms, {r['epochs']} routing epochs")

    def chaos_loop():
        """Fail the victim shard once a third of the traffic completed —
        or, when composed with the reshard drill, mid-migration."""
        cl = runtime.client()
        mid_copy = False
        if reshard_drill:
            reshard_started.wait(timeout=120.0)
            deadline = time.perf_counter() + 60.0
            while time.perf_counter() < deadline and not reshard_report:
                ps = svc.store.placement_stats()
                if ps["migrating_classes"]:
                    mid_copy = True           # a copy window is open NOW
                    break
                time.sleep(0.001)
        else:
            deadline = time.perf_counter() + 120.0
            while completed() < total_reqs // 3 \
                    and time.perf_counter() < deadline:
                time.sleep(0.01)
        info = cl.call("fail_shard", shard=args.kill_shard, timeout=600)
        killed.set()
        report["kill"] = {"after_requests": completed(),
                          "mid_migration": mid_copy,
                          "degraded_classes": info["degraded_classes"]}
        print(f"chaos: failed shard {args.kill_shard} after {completed()} "
              f"requests (degraded classes {info['degraded_classes']})"
              + (", mid-migration" if mid_copy else ""))

    def autonomic_chaos_loop():
        """Kill the victim DEVICE once a third of the traffic completed —
        no RPC: the supervisor has to notice."""
        deadline = time.perf_counter() + 120.0
        while completed() < total_reqs // 3 \
                and time.perf_counter() < deadline:
            time.sleep(0.01)
        _kill_device(svc.store, chaos_victim)
        killed.set()
        print(f"chaos: killed shard {chaos_victim}'s device after "
              f"{completed()} requests — no operator call issued")

    def client_loop(cid):
        cl = runtime.client()
        crng = np.random.default_rng(100 + cid)
        interactive = cid % 4 == 0            # every 4th client is latency-
        kind = "interactive" if interactive else "bulk"     # sensitive
        for r in range(args.requests):
            targets = crng.integers(0, n, args.batch_size).tolist()
            t0 = time.perf_counter()
            try:
                cl.call("run", dfg=dfg, batch=targets,
                        weights_ref="deployed", seed=cid * 1000 + r,
                        priority=10 if interactive else 0,
                        deadline_s=30.0 if interactive else None,
                        timeout=600)
            except Exception as e:  # noqa: BLE001 — surfaced at exit
                with lock:
                    errors.append(f"client {cid} req {r}: {e}")
                continue
            with lock:
                lat[kind].append(time.perf_counter() - t0)

    op_log = []                 # (kind, args) for the serial replay checks

    def mutator_loop():
        cl = runtime.client()
        mrng = np.random.default_rng(999)
        while not stop_mutator.is_set():
            dst, src = int(mrng.integers(0, n)), int(mrng.integers(0, n))
            vid = int(mrng.integers(0, n))
            vec = mrng.standard_normal(feat).astype(np.float32)
            try:
                cl.call("add_edge", dst=dst, src=src, timeout=600)
                op_log.append(("add_edge", dst, src))
                cl.call("update_embed", vid=vid, embed=vec, timeout=600)
                op_log.append(("update_embed", vid, vec))
            except Exception as e:  # noqa: BLE001 — surfaced at exit
                with lock:
                    errors.append(f"mutator: {e}")
            stop_mutator.wait(0.02)

    threads = [threading.Thread(target=client_loop, args=(c,))
               for c in range(args.clients)]
    mut = threading.Thread(target=mutator_loop)
    if reshard_drill:
        threads.append(threading.Thread(target=reshard_loop))
    if args.kill_shard is not None:
        threads.append(threading.Thread(target=chaos_loop))
    if args.chaos:
        threads.append(threading.Thread(target=autonomic_chaos_loop))
    t_serve = time.perf_counter()
    for t in threads:
        t.start()
    mut.start()
    for t in threads:
        t.join()
    serve_s = time.perf_counter() - t_serve
    stop_mutator.set()
    mut.join()
    served = len(lat["interactive"]) + len(lat["bulk"])
    report.update(requests=served, failed=len(errors), serve_s=serve_s,
                  requests_per_s=served / serve_s, mutations=len(op_log))
    print(f"served {served} of {total_reqs} requests in {serve_s:.3f} s "
          f"({served / serve_s:.1f} requests/s) beside {len(op_log)} "
          f"acknowledged mutations on {device}")

    if args.firehose:
        # drain the window log, then prove the windowed application left
        # the EXACT graph a serial unit-mutation replay leaves
        final = boot.call("flush_firehose", timeout=600)
        snap = boot.call("close_firehose", timeout=600)
        assert snap["applied"] == snap["submitted"] == len(op_log), \
            (snap, len(op_log))
        ref = _serial_replay(edges, emb, op_log)
        assert ref.to_adjacency() == svc.store.to_adjacency(), \
            "firehose graph diverged from serial replay"
        vids = np.arange(0, n, 17)
        assert (ref.get_embeds(vids) ==
                np.asarray(svc.store.get_embeds(vids))).all(), \
            "firehose embeddings diverged from serial replay"
        report["firehose"] = {"applied": snap["applied"],
                              "windows": snap["windows"],
                              "barriers": snap["barriers"],
                              "shed": snap["shed"],
                              "applied_at_drain": final["applied_now"],
                              "bit_identical": True}
        print(f"firehose drill: {snap['applied']} ops in "
              f"{snap['windows']} windows ({snap['barriers']} barriers, "
              f"{snap['shed']} shed, {final['applied_now']} at drain) — "
              f"bit-identical to serial replay")

    if args.kill_shard is not None:
        assert killed.is_set(), "chaos thread never fired"
        # the traffic has drained; the degraded answer and the post-rebuild
        # answer to the same seeded request must be bit-identical — the
        # rebuilt shard re-materialised exactly the survivors' state
        ref_req = dict(dfg=dfg, batch=list(range(8)),
                       weights_ref="deployed", seed=424242)
        degraded = boot.call("run", **ref_req, timeout=600)["Result"]
        st = boot.call("stats", timeout=600)
        assert st["replication"]["failed_shards"] == [args.kill_shard], st
        info = boot.call("rebuild_shard", shard=args.kill_shard, timeout=600)
        print(f"rebuild: shard {info['shard']} re-materialised "
              f"{info['vertices']} vertices / {info['pages_written']} pages "
              f"in {info['seconds'] * 1e3:.0f} ms")
        rebuilt = boot.call("run", **ref_req, timeout=600)["Result"]
        assert (np.asarray(degraded) == np.asarray(rebuilt)).all(), \
            "post-rebuild result diverged from degraded result"
        st = boot.call("stats", timeout=600)
        assert st["replication"]["failed_shards"] == [], st
        sh = st["shards"][args.kill_shard]
        assert sh["pages_l"] + sh["pages_h"] > 0 \
            and sh["device"]["written_pages"] > 0, sh
        report["kill"].update(rebuilt_vertices=info["vertices"],
                              rebuilt_pages=info["pages_written"],
                              rebuild_s=info["seconds"], bit_identical=True)
        print("fault drill: degraded serve + rebuild verified bit-identical")

    if reshard_drill:
        assert reshard_report, "reshard thread never completed"
        st = boot.call("stats", timeout=600)
        pl = st["placement"]
        assert not pl["resharding"] and not pl["migrating_classes"], pl
        n_expect = (n_arr + args.reshard_grow) \
            if args.reshard_grow is not None \
            else n_arr - args.reshard_shrink
        assert reshard_report["n_shards"] == n_expect \
            and svc.store.n_shards == n_expect, (reshard_report, n_expect)
        # the migrated, mutated-throughout graph must be EXACTLY the graph
        # a serial replay of the acknowledged op log leaves — the copy
        # windows, flips and detaches dropped / duplicated nothing
        ref = _serial_replay(edges, emb, op_log)
        vids = np.arange(0, n, 7)
        assert (np.asarray(svc.store.get_embeds(vids)) ==
                ref.get_embeds(vids)).all(), \
            "post-reshard embeddings diverged from serial replay"
        assert ref.to_adjacency() == svc.store.to_adjacency(), \
            "post-reshard graph diverged from serial replay"
        report["reshard"] = {k: reshard_report[k] for k in
                             ("classes_moved", "copies", "bytes_shipped",
                              "n_shards", "seconds", "epochs")}
        report["reshard"]["bit_identical"] = True
        print(f"reshard drill: array now {n_expect} shards "
              f"({reshard_report['bytes_shipped']} bytes migrated, "
              f"{reshard_report['epochs']} epochs) — graph bit-identical "
              f"to serial replay after live migration")

    if args.chaos:
        assert killed.is_set(), "chaos thread never fired"
        # the supervisor must bring the array back to full redundancy with
        # ZERO operator involvement
        snap = _wait_healed(supervisor, svc.store)
        inc = snap["last_incident"]
        assert inc["shard"] == chaos_victim and inc["drained"] is True, snap
        assert inc["cause"] in ("probe", "error_burst", "observed_drained")
        print(f"chaos drill: auto-detected ({inc['cause']}), auto-drained, "
              f"auto-rebuilt in {inc.get('restore_s', 0):.2f}s — "
              f"no operator call")
        # graph now quiesced (mutator stopped): a second device kill must
        # leave a seeded answer bit-identical through degraded serving AND
        # through the auto-rebuild
        ref_req = dict(dfg=dfg, batch=list(range(8)),
                       weights_ref="deployed", seed=424242)
        ref = boot.call("run", **ref_req, timeout=600)["Result"]
        _kill_device(svc.store, chaos_victim)
        degraded = boot.call("run", **ref_req, timeout=600)["Result"]
        assert (np.asarray(ref) == np.asarray(degraded)).all(), \
            "degraded result diverged from healthy reference"
        _wait_healed(supervisor, svc.store)
        healed = boot.call("run", **ref_req, timeout=600)["Result"]
        assert (np.asarray(ref) == np.asarray(healed)).all(), \
            "post-auto-rebuild result diverged from healthy reference"
        st = boot.call("stats", timeout=600)
        assert st["health"]["incidents"] >= 2, st["health"]
        assert all(s == "healthy" for s in st["health"]["states"])
        assert st["replication"]["failed_shards"] == [], st
        report["chaos"] = {"cause": inc["cause"],
                           "restore_s": inc.get("restore_s"),
                           "incidents": st["health"]["incidents"],
                           "bit_identical": True}
        print(f"chaos drill: {st['health']['incidents']} incidents healed, "
              f"reference answer bit-identical healthy/degraded/rebuilt")

    stats = boot.call("stats", timeout=600)
    if supervisor is not None:
        supervisor.stop()
    runtime.stop()

    qos = stats["qos"]
    report["latency_ms"] = {}
    for kind, xs in lat.items():
        if not xs:
            continue
        xs = np.array(xs) * 1e3
        pct = {f"p{q}": float(np.percentile(xs, q)) for q in (50, 95, 99)}
        report["latency_ms"][kind] = {"n": len(xs), **pct}
        print(f"{kind:12s} {len(xs):4d} reqs: p50={pct['p50']:.1f} "
              f"ms p95={pct['p95']:.1f} ms p99={pct['p99']:.1f} ms")
    report["scheduler"] = {k: qos[k] for k in
                           ("groups", "avg_group_size", "throughput_rps",
                            "expired", "rejected")}
    print(f"scheduler: {qos['groups']} groups, "
          f"avg group size {qos['avg_group_size']:.1f}, "
          f"throughput {qos['throughput_rps']:.1f} req/s, "
          f"{qos['expired']} expired, {qos['rejected']} rejected")
    cache = stats.get("embcache", {})
    if cache:
        report["embcache"] = {k: cache[k] for k in
                              ("hit_rate", "hits", "misses", "invalidations")}
        print(f"embcache: hit rate {cache['hit_rate']:.2f} "
              f"({cache['hits']} hits / {cache['misses']} misses, "
              f"{cache['invalidations']} invalidations)")
    report["store"] = {"pages_h": stats["store"]["pages_h"],
                       "pages_l": stats["store"]["pages_l"],
                       "unit_updates": stats["store"]["unit_updates"],
                       "read_pages": stats["device"]["read_pages"]}
    print(f"store: {stats['store']['pages_h']} H-pages, "
          f"{stats['store']['pages_l']} L-pages, "
          f"{stats['store']['unit_updates']} unit updates, "
          f"{stats['device']['read_pages']} device page reads")
    report["shards"] = []
    for i, sh in enumerate(stats.get("shards", [])):
        hr = sh["embcache"]["hit_rate"] if sh["embcache"] else 0.0
        report["shards"].append({"reads": sh["device"]["read_pages"],
                                 "writes": sh["device"]["written_pages"],
                                 "hit_rate": hr})
        print(f"  shard {i}: {sh['device']['read_pages']} reads, "
              f"{sh['device']['written_pages']} writes, "
              f"cache hit rate {hr:.2f}")
    report["links"] = []
    for link in qos.get("shard_links") or []:
        report["links"].append(dict(link))
        extra = (f", {link['channel_bytes'] / 1e6:.1f} MB over RoP"
                 if "channel_bytes" in link else " (in-process)")
        print(f"  link {link['shard']}: {link['calls']} commands{extra}")
    svc.close()
    # CI drills run with REPRO_LOCK_WITNESS=1: every lock the drill
    # touched was order-checked live; a recorded inversion fails here
    from repro_torch.concurrency import assert_clean, witness_enabled, \
        witness_report
    if witness_enabled():
        rep = witness_report()
        report["witness"] = {"edges": len(rep["edges"]),
                             "violations": len(rep["violations"])}
        print(f"lock witness: {len(rep['edges'])} nesting edges observed, "
              f"{len(rep['violations'])} violations")
        assert_clean()
    if errors:
        print(f"{len(errors)} failed requests; first: {errors[0]}")
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
