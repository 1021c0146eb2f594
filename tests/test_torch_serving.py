"""The port's serving stack on the CPU (the kernels' plain versions): the
scheduler and runtime over the port's service, bit for bit with serial
runs (stepped and threaded), QoS mechanics (priorities, deadlines,
admission, error fan-out, weights coalescing), mutations under load, the
shard supervisor's chaos drills through the port's replicated service,
typed flow-control completions, and one runtime pumped beside the JAX
reference's over the same submissions."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.service import HolisticGNNService as JService
from repro.serve import ServingRuntime as JServingRuntime
from repro.serve.batcher import fingerprint_weights as j_fingerprint_weights
from repro_torch.core import gnn
from repro_torch.core.service import HolisticGNNService, make_service_dfg
from repro_torch.rpc.queues import BackpressureError
from repro_torch.serve import (AdmissionError, BatchScheduler, HealthPolicy,
                               ServingRuntime, ShardSupervisor)
from repro_torch.serve.batcher import fingerprint_weights
from repro_torch.store import make_rop_endpoints
from repro_torch.store.sharded import FlowControl

TOL = 2e-5


def _graph(n=600, e=5000, feat=32, seed=0):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.zipf(1.4, e) % n],
                     axis=1).astype(np.int64)
    return edges, rng.standard_normal((n, feat)).astype(np.float32)


def _service(cache_pages=2048, n=600, e=5000, feat=32, **array):
    edges, emb = _graph(n, e, feat)
    svc = HolisticGNNService(h_threshold=16, pad_to=32,
                             cache_pages=cache_pages, device="cpu", **array)
    svc.store.update_graph(edges, emb)
    return svc, n


def _model_setup(model, feat=32, seed=1):
    """A service DFG and its weights as NumPy (what RPC carries)."""
    params = gnn.init_params(model, [feat, 16, 8], seed=seed, device="cpu")
    weights = {k: v.numpy() for k, v in
               gnn.dfg_feeds(model, params, None, []).items() if k != "H"}
    return make_service_dfg(model, 2, [5, 5]).save(), weights


def test_scheduled_runtime_bit_identical_to_serial():
    """As ``tests/test_serving.py::test_scheduled_runtime_bit_identical_to_
    serial``."""
    svc, n = _service()
    dfg, weights = _model_setup("gcn")
    rt = ServingRuntime(svc, n_queues=3, max_group=8)
    rng = np.random.default_rng(6)
    cmds = []
    for i in range(6):
        c = rt.client()
        targets = rng.integers(0, n, 8).tolist()
        cmds.append((c, c.submit("run", dfg=dfg, batch=targets,
                                 weights=weights, seed=i), targets, i))
    assert rt.pump() == 6
    assert rt.scheduler.qos.groups >= 1
    assert rt.scheduler.qos.grouped_requests == 6
    for c, cid, targets, i in cmds:
        got = c.result(cid)["Result"]
        want = svc.run(dfg, targets, weights=weights, seed=i)["Result"]
        np.testing.assert_array_equal(want[:8], got[:8], err_msg=f"req {i}")


def test_threaded_runtime_bit_identical_to_serial():
    """Threaded mode over a replicated array: client threads submit every
    model's requests while another thread sends ``stats`` and a model-only
    (immediate) ``run``, so the scheduler thread and the immediate pool
    enter the engine at once; every reply equals a serial run bit for
    bit."""
    svc, n = _service(n_shards=3, replication=2)
    setups = {m: _model_setup(m) for m in ("gcn", "gin", "ngcf")}
    rng = np.random.default_rng(3)
    jobs = [(m, rng.integers(0, n, 6).tolist(), i)
            for i in range(8) for m in setups]
    want = {(m, i): svc.run(setups[m][0], t, weights=setups[m][1],
                            seed=i)["Result"][:6] for m, t, i in jobs}
    model_only = gnn.build_gin_dfg(2).save()
    want_mo = svc.run(model_only, [1, 2], weights=setups["gin"][1],
                      fanouts=[5, 5])["Result"]
    errors = []
    with ServingRuntime(svc, n_queues=4, max_group=8) as rt:
        def client(k):
            try:
                cl = rt.client()
                ids = [(m, i, cl.submit("run", dfg=setups[m][0], batch=t,
                                        weights=setups[m][1], seed=i))
                       for m, t, i in jobs[k::3]]
                for m, i, cid in ids:
                    got = cl.result(cid, timeout=120)["Result"]
                    np.testing.assert_array_equal(got[:6], want[(m, i)])
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        def immediate():
            try:
                cl = rt.client()
                for _ in range(6):
                    got = cl.call("run", dfg=model_only, batch=[1, 2],
                                  weights=setups["gin"][1], fanouts=[5, 5],
                                  timeout=120)["Result"]
                    np.testing.assert_array_equal(got, want_mo)
                    assert "qos" in cl.call("stats", timeout=120)
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(3)]
        threads.append(threading.Thread(target=immediate))
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    assert not errors, errors
    assert rt.scheduler.qos.completed == len(jobs)
    svc.close()


def test_scheduler_priorities_schedule_first():
    svc, n = _service()
    dfg_a, weights = _model_setup("gcn")
    dfg_b = make_service_dfg("gcn", 2, [4, 4]).save()   # different program
    sched = BatchScheduler(svc, max_group=8, batch_window_s=0)
    order = []

    def done(tag):
        return lambda resp: order.append((tag, resp["ok"]))
    for i in range(3):
        sched.submit(dfg=dfg_a, batch=[i], weights=weights, seed=i,
                     priority=0, on_done=done(f"bulk{i}"))
    sched.submit(dfg=dfg_b, batch=[0], weights=weights, seed=9,
                 priority=5, on_done=done("urgent"))
    assert sched.step() == 1                  # high-priority singleton first
    assert order == [("urgent", True)]
    assert sched.step() == 3                  # bulk group coalesces after
    assert len(order) == 4 and all(ok for _, ok in order)


def test_scheduler_deadline_expiry():
    svc, n = _service()
    dfg, weights = _model_setup("gcn")
    sched = BatchScheduler(svc, batch_window_s=0)
    got = []
    sched.submit(dfg=dfg, batch=[1, 2], weights=weights, deadline_s=-0.001,
                 on_done=got.append)
    assert sched.step() == 0                  # expired, nothing executed
    assert len(got) == 1 and not got[0]["ok"]
    assert "DeadlineExceeded" in got[0]["error"]
    assert sched.qos.expired == 1


def test_admission_backpressure():
    svc, n = _service()
    dfg, weights = _model_setup("gcn")
    sched = BatchScheduler(svc, max_pending=2)
    for i in range(2):
        sched.submit(dfg=dfg, batch=[i], weights=weights,
                     on_done=lambda r: None)
    with pytest.raises(AdmissionError):
        sched.submit(dfg=dfg, batch=[9], weights=weights,
                     on_done=lambda r: None)
    assert sched.qos.rejected == 1
    rt = ServingRuntime(svc, max_pending=1)
    c = rt.client()
    ids = [c.submit("run", dfg=dfg, batch=[i], weights=weights, seed=i)
           for i in range(3)]
    rt.pump()
    outcomes = []
    for cid in ids:
        try:
            c.result(cid)
            outcomes.append("ok")
        except RuntimeError as e:
            assert "AdmissionError" in str(e)
            outcomes.append("rejected")
    assert outcomes.count("rejected") == 2 and outcomes.count("ok") == 1


def test_scheduler_error_fans_out_with_traceback():
    svc, n = _service()
    dfg, _ = _model_setup("gcn")
    rt = ServingRuntime(svc)
    c = rt.client()
    cid = c.submit("run", dfg=dfg, batch=[1], weights={}, seed=0)  # no weights
    rt.pump()
    with pytest.raises(RuntimeError, match="device traceback"):
        c.result(cid)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_weights_fingerprint_prevents_wrong_coalescing(kind):
    """As ``tests/test_serving.py::test_weights_fingerprint_prevents_wrong_
    coalescing``: NumPy weights through the runtime, tensor weights
    through the scheduler (the transport carries NumPy)."""
    svc, n = _service()
    dfg, weights = _model_setup("gcn")
    _, weights2 = _model_setup("gcn", seed=99)
    t = [1, 2, 3]
    if kind == "numpy":
        rt = ServingRuntime(svc, max_group=8)
        sched = rt.scheduler
        c = rt.client()
        c1 = c.submit("run", dfg=dfg, batch=t, weights=weights, seed=0)
        c2 = c.submit("run", dfg=dfg, batch=t, weights=weights2, seed=0)
        rt.pump()
        out1, out2 = c.result(c1)["Result"], c.result(c2)["Result"]
    else:
        sched = BatchScheduler(svc, max_group=8)
        got = {}
        for tag, w in (("a", weights), ("b", weights2)):
            sched.submit(dfg=dfg, batch=t, seed=0,
                         weights={k: torch.from_numpy(v)
                                  for k, v in w.items()},
                         on_done=lambda r, tag=tag: got.update({tag: r}))
        sched.drain()
        out1, out2 = (got[k]["result"]["Result"] for k in "ab")
    assert sched.qos.groups == 2              # two groups, not one
    np.testing.assert_array_equal(
        out1[:3], svc.run(dfg, t, weights=weights, seed=0)["Result"][:3])
    np.testing.assert_array_equal(
        out2[:3], svc.run(dfg, t, weights=weights2, seed=0)["Result"][:3])


def test_fingerprint_of_tensor_weights_matches_numpy_twin():
    """A deployed tensor set and its NumPy twin coalesce together, under
    the reference's key for the NumPy set."""
    _, weights = _model_setup("ngcf")
    tensors = {k: torch.from_numpy(v.copy()) for k, v in weights.items()}
    key = fingerprint_weights(weights)
    assert fingerprint_weights(tensors) == key == \
        j_fingerprint_weights(weights)
    name = sorted(tensors)[0]
    tensors[name] = tensors[name] + 1.0
    assert fingerprint_weights(tensors) != key


def test_weights_registry_equivalence_and_coalescing():
    """As ``tests/test_serving.py::test_weights_registry_equivalence_and_
    coalescing``."""
    svc, n = _service()
    dfg, weights = _model_setup("gcn")
    info = svc.put_weights("m1", weights)
    assert info["tensors"] == len(weights) and info["bytes"] > 0
    t = [1, 2, 3]
    a = svc.run(dfg, t, weights=weights, seed=3)["Result"]
    b = svc.run(dfg, t, weights_ref="m1", seed=3)["Result"]
    np.testing.assert_array_equal(a, b)
    fused = svc.run_batch(dfg, [{"targets": t, "seed": 3}],
                          weights_ref="m1")[0]["Result"]
    np.testing.assert_array_equal(a[:3], fused[:3])
    with pytest.raises(KeyError):
        svc.run(dfg, t, weights_ref="unregistered")
    rt = ServingRuntime(svc, max_group=8)
    c = rt.client()
    ids = [c.submit("run", dfg=dfg, batch=t, weights_ref="m1", seed=s)
           for s in range(3)]
    rt.pump()
    assert rt.scheduler.qos.groups == 1       # one fused group via the ref
    for s, cid in enumerate(ids):
        np.testing.assert_array_equal(
            c.result(cid)["Result"][:3],
            svc.run(dfg, t, weights_ref="m1", seed=s)["Result"][:3])


def test_qos_telemetry_via_stats_rpc():
    svc, n = _service()
    dfg, weights = _model_setup("gcn")
    rt = ServingRuntime(svc)
    c = rt.client()
    for i in range(5):
        c.submit("run", dfg=dfg, batch=[i, i + 1], weights=weights, seed=i)
    rt.pump()
    cid = c.submit("stats")
    rt.pump()
    st = c.result(cid)
    qos = st["qos"]
    assert qos["completed"] == 5 and qos["queue_depth"] == 0
    assert qos["p99_latency_s"] >= qos["p50_latency_s"] > 0
    assert qos["throughput_rps"] > 0 and qos["groups"] >= 1
    assert st["embcache"]["hits"] + st["embcache"]["misses"] > 0
    assert "run" in st["rpc"] or "stats" in st["rpc"]
    assert st["qos"]["transport"]["in_flight"] <= 1


def test_mutable_ops_under_load_match_serial_reference():
    """As ``tests/test_serving.py::test_mutable_ops_under_load_match_serial_
    reference``: every scheduled output bit for bit with a serial
    cacheless twin receiving the same operation sequence."""
    svc, n = _service(cache_pages=512)
    ref, _ = _service(cache_pages=None)
    dfg, weights = _model_setup("gcn")
    rt = ServingRuntime(svc, n_queues=2, max_group=8)
    mut_client = rt.client()
    rng = np.random.default_rng(7)
    seed_ctr = 0
    for round_ in range(6):
        cmds = []
        cl = rt.client()
        for _ in range(4):
            t = rng.integers(0, n, 6).tolist()
            cmds.append((t, seed_ctr,
                         cl.submit("run", dfg=dfg, batch=t, weights=weights,
                                   seed=seed_ctr)))
            seed_ctr += 1
        rt.pump()
        for t, s, cid in cmds:
            got = cl.result(cid)["Result"]
            want = ref.run(dfg, t, weights=weights, seed=s)["Result"]
            np.testing.assert_array_equal(want[:6], got[:6],
                                          err_msg=f"round {round_}")
        a, b = int(rng.integers(0, n)), int(rng.integers(0, n))
        row = rng.standard_normal(32).astype(np.float32)
        mids = [mut_client.submit("add_edge", dst=a, src=b),
                mut_client.submit("update_embed", vid=a, embed=row),
                mut_client.submit("delete_vertex", vid=(a + 1) % n)]
        rt.pump()
        for mid in mids:
            mut_client.result(mid)
        ref.store.add_edge(a, b)
        ref.store.update_embed(a, row)
        ref.store.delete_vertex((a + 1) % n)
    assert svc.store.cache.stats.invalidations > 0
    assert svc.store.cache.stats.hits > 0


# ------------------------------------------------------- supervisor drills
def _chaos_pair(remote):
    """(single-device, 3-shard 2-way replicated) port services, the model
    and a few requests with the single device's results."""
    array = ({"endpoints": make_rop_endpoints(3, h_threshold=16)} if remote
             else {"n_shards": 3})
    one, n = _service(n=240, e=1600, feat=12)
    svc, _ = _service(n=240, e=1600, feat=12, replication=2, **array)
    dfg, weights = _model_setup("ngcf", feat=12)
    rng = np.random.default_rng(100)
    reqs = [{"targets": rng.integers(0, n, 8).tolist(), "seed": i}
            for i in range(4)]
    want = one.run_batch(dfg, reqs, weights=weights)
    return svc, dfg, weights, reqs, want


def _assert_serves(svc, dfg, weights, reqs, want):
    for a, b in zip(svc.run_batch(dfg, reqs, weights=weights), want):
        np.testing.assert_array_equal(a["Result"], b["Result"])


def _kill_device(store, s):
    """Kill the shard's device directly: no operator RPC."""
    ep = store.endpoints[s]
    if hasattr(ep, "local_store"):
        ep.local_store.dev.fail()
    else:
        ep.host.service.store.dev.fail()


def _wait_healthy(sup, store, deadline_s=20.0):
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        snap = sup.snapshot()
        if (snap["incidents"] and not any(store.failed_shards)
                and all(st == "healthy" for st in snap["states"])):
            return snap
        time.sleep(0.01)
    raise AssertionError(f"array did not heal: {sup.snapshot()}")


@pytest.mark.parametrize("remote", [False, True])
def test_chaos_kill_auto_detect_drain_rebuild_bit_identical(remote):
    """As ``tests/test_supervisor.py::test_chaos_kill_auto_detect_drain_
    rebuild_bit_identical``, through the port's service: results stay the
    single device's bit for bit degraded and after the rebuild."""
    svc, dfg, weights, reqs, want = _chaos_pair(remote)
    sup = ShardSupervisor(svc.store, HealthPolicy(
        probe_interval_s=0.005, rebuild_retry_s=0.05)).start()
    try:
        _kill_device(svc.store, 2)
        _assert_serves(svc, dfg, weights, reqs, want)
        snap = _wait_healthy(sup, svc.store)
        inc = snap["last_incident"]
        assert inc["shard"] == 2
        assert inc["cause"] in ("probe", "error_burst", "observed_drained")
        assert inc["drained"] is True and inc["refused"] is None
        assert inc["detect_s"] <= 5.0 and "restore_s" in inc
        _assert_serves(svc, dfg, weights, reqs, want)
    finally:
        sup.stop()
        svc.close()


@pytest.mark.parametrize("remote", [False, True])
def test_kill_while_fetches_in_flight(remote):
    """As ``tests/test_supervisor.py::test_kill_while_fetches_in_flight``:
    two threads keep running groups through the port's service (and its
    engine) while a device dies underneath them."""
    svc, dfg, weights, reqs, want = _chaos_pair(remote)
    sup = ShardSupervisor(svc.store, HealthPolicy(
        probe_interval_s=0.005, rebuild_retry_s=0.05)).start()
    stop, errs, rounds = threading.Event(), [], [0, 0]

    def reader(tid):
        while not stop.is_set():
            try:
                _assert_serves(svc, dfg, weights, reqs, want)
                rounds[tid] += 1
            except Exception as e:  # noqa: BLE001 — collected
                errs.append(f"reader{tid}: {type(e).__name__}: {e}")
                return

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    try:
        t_end = time.monotonic() + 20.0
        while min(rounds) < 1 and time.monotonic() < t_end and not errs:
            time.sleep(0.005)                  # groups in flight
        _kill_device(svc.store, 1)
        _wait_healthy(sup, svc.store)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30.0)
        sup.stop()
    assert not errs, errs
    assert min(rounds) >= 1
    _assert_serves(svc, dfg, weights, reqs, want)
    svc.close()


def test_fault_rpcs_idempotent_status_dicts():
    """As ``tests/test_supervisor.py::test_fault_rpcs_idempotent_status_
    dicts``, through the service RPCs."""
    svc, _ = _service(n=240, e=1600, feat=12, n_shards=3, replication=2)
    assert svc.rebuild_shard(1) == {"shard": 1, "already_live": True}
    info = svc.fail_shard(1)
    assert info["shard"] == 1 and info["degraded_classes"]
    assert svc.fail_shard(1) == {"shard": 1, "already_failed": True}
    out = {}

    def run_rebuild():
        out["info"] = svc.rebuild_shard(1, pacing_s=0.05)

    th = threading.Thread(target=run_rebuild)
    th.start()
    t_end = time.monotonic() + 20.0
    while time.monotonic() < t_end and "info" not in out:
        got = svc.rebuild_shard(1)             # stream in progress
        if got != {"shard": 1, "already_live": True}:
            assert got == {"shard": 1, "rebuild_in_progress": True}
            break
        time.sleep(0.001)
    th.join(timeout=60.0)
    assert out["info"]["pages_written"] > 0
    assert not any(svc.store.failed_shards)
    svc.close()


def test_admission_error_carries_reason_and_health():
    svc, _ = _service(n=240, e=1600, feat=12)
    sched = BatchScheduler(svc, max_pending=1)
    sched.health_provider = lambda: {"failed_shards": [2],
                                     "states": ["healthy"] * 3}
    dfg, weights = _model_setup("gcn", feat=12)
    sched.submit(dfg=dfg, batch=[1], weights=weights, on_done=lambda r: None)
    with pytest.raises(AdmissionError) as ei:
        sched.submit(dfg=dfg, batch=[2], weights=weights,
                     on_done=lambda r: None)
    r = ei.value.reason
    assert r["source"] == "admission"
    assert r["queue_depth"] == 1 and r["max_pending"] == 1
    assert r["shard_health"]["failed_shards"] == [2]
    assert sched.qos.rejected == 1
    assert sched.qos.snapshot()["last_reject_reason"]["source"] == "admission"


def test_scheduler_turns_backpressure_into_typed_completion():
    svc, _ = _service(n=240, e=1600, feat=12)
    reason = {"source": "inflight_window", "shard": 1, "limit": 2}

    def run_batch(*a, **kw):
        raise BackpressureError("window full", reason=reason)

    svc.run_batch = run_batch
    sched = BatchScheduler(svc)
    dfg, weights = _model_setup("gcn", feat=12)
    got = []
    sched.submit(dfg=dfg, batch=[1], weights=weights, on_done=got.append)
    sched.drain()
    assert len(got) == 1
    assert got[0]["ok"] is False and got[0]["backpressure"] is True
    assert got[0]["reason"] == reason
    assert sched.qos.backpressured == 1
    assert sched.qos.snapshot()["last_reject_reason"] == reason


def test_stats_rpc_carries_health_and_flow_blocks():
    svc, _ = _service(n=240, e=1600, feat=12, n_shards=3, replication=2,
                      flow=FlowControl(max_inflight_per_shard=4))
    sup = ShardSupervisor(svc.store, HealthPolicy(auto_rebuild=False))
    svc.store.health = sup
    with ServingRuntime(svc) as rt:
        st = rt.client().call("stats", timeout=30)
    assert st["health"]["states"] == ["healthy"] * 3
    assert st["flow"]["max_inflight_per_shard"] == 4
    assert st["flow"]["backpressure_events"] == 0
    assert "backpressure" in st["qos"] and "health" in st["qos"]
    assert st["replication"] == {"r": 2, "failed_shards": []}
    svc.close()


# ------------------------------------------------------ across the packages
def test_runtime_groups_and_results_match_reference_runtime():
    """The port's runtime and the reference's, pumped over the same
    submissions (two programs, two weight sets, priorities): the same
    groups, the same completion order, results within 2e-5."""
    edges, emb = _graph()
    port = HolisticGNNService(h_threshold=16, pad_to=32, device="cpu")
    ref = JService(h_threshold=16, pad_to=32)
    dfg_a, weights = _model_setup("gcn")
    dfg_b = make_service_dfg("ngcf", 2, [4, 4]).save()
    _, weights_b = _model_setup("ngcf")
    rng = np.random.default_rng(11)
    subs = []
    for i in range(10):
        dfg, w = (dfg_a, weights) if i % 3 else (dfg_b, weights_b)
        subs.append({"dfg": dfg, "batch": rng.integers(0, 600, 5).tolist(),
                     "weights": w, "seed": i, "priority": int(i % 4 == 0)})
    runs = []
    for svc, runtime in ((port, ServingRuntime), (ref, JServingRuntime)):
        svc.store.update_graph(edges, emb)
        rt = runtime(svc, n_queues=2, max_group=3)
        order = []
        post = rt.rop.post_completion

        def record(qid, cmd_id, packet, post=post, order=order):
            order.append((qid, cmd_id))
            post(qid, cmd_id, packet)
        rt.rop.post_completion = record
        clients = [rt.client(), rt.client()]
        ids = [(clients[i % 2], clients[i % 2].submit("run", **s))
               for i, s in enumerate(subs)]
        assert rt.pump() == len(subs)
        q = rt.scheduler.qos
        runs.append(([c.result(cid)["Result"] for c, cid in ids],
                     (q.groups, q.grouped_requests), order))
    (got, groups, order), (want, ref_groups, ref_order) = runs
    assert groups == ref_groups and groups[0] > 3
    assert order == ref_order
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
