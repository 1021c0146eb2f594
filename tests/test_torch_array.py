"""The port's service over a CSSD array against its single-device service
and against the JAX reference's array service, on the CPU (the kernels'
plain versions): sharded and replicated arrays with local and RoP shard
endpoints, the shard fault RPCs, per-shard stats, the chunked ingest, the
mutation firehose and the elastic reshard RPC.  Results equal the port's
single device bit for bit and the reference at 2e-5; sampled feeds equal
the reference's bit for bit."""
import numpy as np
import pytest

from repro.core import gnn as jgnn
from repro.core.service import HolisticGNNService as JService
from repro.core.service import make_service_dfg as j_make_service_dfg
from repro.store import make_rop_endpoints as j_make_rop_endpoints
from repro.store.sampler import sample_batch as j_sample_batch
from repro_torch.core.service import HolisticGNNService, make_service_dfg
from repro_torch.serve import ServingRuntime
from repro_torch.serve.batcher import sample_group
from repro_torch.store import (ReplicatedGraphStore, ShardedGraphStore,
                               make_rop_endpoints, sample_batch)

MODELS = ("gcn", "gin", "ngcf")
TOL = 2e-5
REQS = [{"targets": [3, 7], "seed": 1},
        {"targets": [9, 20, 31], "seed": 2},
        {"targets": [100], "seed": 3}]


def _graph(n=420, e=3200, feat=24, seed=0):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.zipf(1.4, e) % n],
                     axis=1).astype(np.int64)
    return edges, rng.standard_normal((n, feat)).astype(np.float32)


def _weights(model, dims=(24, 12, 8), seed=1):
    """The reference's weights as a NumPy feed dict (what RPC carries)."""
    params = jgnn.init_params(model, list(dims), seed=seed)
    return {k: np.asarray(v) for k, v in
            jgnn.dfg_feeds(model, params, None, []).items() if k != "H"}


def _array_kw(n_shards, replication, transport, make_rop):
    kw = {"replication": replication}
    if transport == "rop":
        kw["endpoints"] = make_rop(n_shards, h_threshold=16)
    else:
        kw["n_shards"] = n_shards
    return kw


def _assert_batches_equal(a, b):
    np.testing.assert_array_equal(a.node_vids, b.node_vids)
    for la, lb in zip(a.layers, b.layers):
        np.testing.assert_array_equal(la.nbr, lb.nbr)
        np.testing.assert_array_equal(la.mask, lb.mask)
    np.testing.assert_array_equal(a.embeddings, b.embeddings)


@pytest.fixture(scope="module")
def single():
    edges, emb = _graph()
    svc = HolisticGNNService(h_threshold=16, pad_to=32, device="cpu")
    svc.update_graph(edges, emb)
    return svc


@pytest.mark.parametrize("transport", ["local", "rop"])
@pytest.mark.parametrize("replication", [1, 2])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_array_service_matches_single_device_and_reference(
        single, n_shards, replication, transport):
    """As ``tests/test_sharded_store.py::test_run_and_run_batch_bit_
    identical`` and ``tests/test_endpoint.py::test_remote_run_bit_
    identical_service``, across the packages, for the three models."""
    edges, emb = _graph()
    port = HolisticGNNService(
        h_threshold=16, pad_to=32, cache_pages=256, device="cpu",
        **_array_kw(n_shards, replication, transport, make_rop_endpoints))
    ref = JService(
        h_threshold=16, pad_to=32, cache_pages=256,
        **_array_kw(n_shards, replication, transport, j_make_rop_endpoints))
    try:
        port.update_graph(edges, emb)
        ref.update_graph(edges, emb)
        want_cls = ReplicatedGraphStore if replication > 1 \
            else ShardedGraphStore
        assert type(port.store) is want_cls
        for model in MODELS:
            weights = _weights(model)
            dfg = make_service_dfg(model, 2, [5, 5]).save()
            assert dfg == j_make_service_dfg(model, 2, [5, 5]).save()
            got = port.run(dfg, [3, 7, 11, 200], weights=weights,
                           seed=42)["Result"]
            np.testing.assert_array_equal(
                got, single.run(dfg, [3, 7, 11, 200], weights=weights,
                                seed=42)["Result"])
            np.testing.assert_allclose(
                got, ref.run(dfg, [3, 7, 11, 200], weights=weights,
                             seed=42)["Result"], rtol=TOL, atol=TOL)
            fused = port.run_batch(dfg, REQS, weights=weights)
            for a, b, c in zip(fused, single.run_batch(dfg, REQS,
                                                       weights=weights),
                               ref.run_batch(dfg, REQS, weights=weights)):
                np.testing.assert_array_equal(a["Result"], b["Result"])
                np.testing.assert_allclose(a["Result"], c["Result"],
                                           rtol=TOL, atol=TOL)
        targets = np.array([3, 7, 11, 200, 401])
        got = sample_batch(port.store, targets, [5, 5],
                           rng=np.random.default_rng(9), pad_to=32)
        _assert_batches_equal(got, j_sample_batch(
            ref.store, targets, [5, 5], rng=np.random.default_rng(9),
            pad_to=32))
        _assert_batches_equal(got, sample_batch(
            single.store, targets, [5, 5], rng=np.random.default_rng(9),
            pad_to=32))
        a, _ = sample_group(port.store, [r["targets"] for r in REQS],
                            [r["seed"] for r in REQS], [5, 5])
        b, _ = sample_group(single.store, [r["targets"] for r in REQS],
                            [r["seed"] for r in REQS], [5, 5])
        _assert_batches_equal(a, b)
    finally:
        port.close()
        ref.close()


def _port_pair(**array_kw):
    """(single-device, array) port services over the same graph."""
    edges, emb = _graph(n=600, e=5000, feat=32)
    one = HolisticGNNService(h_threshold=16, pad_to=32, device="cpu")
    one.store.update_graph(edges, emb)
    arr = HolisticGNNService(h_threshold=16, pad_to=32, device="cpu",
                             **array_kw)
    arr.store.update_graph(edges, emb)
    return one, arr


def test_service_replicated_run_and_fault_rpcs():
    """As ``tests/test_replicated_store.py::test_service_replicated_run_
    and_fault_rpcs``; the healthy result also against the reference."""
    one, svc = _port_pair(n_shards=3, replication=2, cache_pages=600)
    dfg = make_service_dfg("gcn", 2, [5, 5]).save()
    weights = _weights("gcn", dims=(32, 16, 8))
    want = one.run(dfg, [3, 7, 11, 200], weights=weights, seed=42)["Result"]
    got = svc.run(dfg, [3, 7, 11, 200], weights=weights, seed=42)["Result"]
    np.testing.assert_array_equal(want, got)
    edges, emb = _graph(n=600, e=5000, feat=32)
    ref = JService(h_threshold=16, pad_to=32, n_shards=3, replication=2)
    ref.store.update_graph(edges, emb)
    np.testing.assert_allclose(
        got, ref.run(dfg, [3, 7, 11, 200], weights=weights,
                     seed=42)["Result"], rtol=TOL, atol=TOL)

    st = svc.stats()
    assert st["replication"] == {"r": 2, "failed_shards": []}
    assert all(not s["failed"] for s in st["shards"])

    svc.fail_shard(1)
    got = svc.run(dfg, [3, 7, 11, 200], weights=weights, seed=42)["Result"]
    np.testing.assert_array_equal(want, got)
    st = svc.stats()
    assert st["replication"]["failed_shards"] == [1]
    assert st["shards"][1]["failed"]
    probe = svc.probe_shards()
    assert len(probe) == 3

    info = svc.rebuild_shard(1)
    assert info["pages_written"] > 0
    st = svc.stats()
    assert st["replication"]["failed_shards"] == []
    assert st["shards"][1]["pages_l"] + st["shards"][1]["pages_h"] > 0
    got = svc.run(dfg, [3, 7, 11, 200], weights=weights, seed=42)["Result"]
    np.testing.assert_array_equal(want, got)


def test_service_fault_rpcs_need_replication():
    """As ``tests/test_replicated_store.py::test_service_fault_rpcs_need_
    replication``; a single device has no probe or reshard either."""
    svc = HolisticGNNService(n_shards=2, device="cpu")
    for call in (lambda: svc.fail_shard(0), lambda: svc.rebuild_shard(0)):
        with pytest.raises(RuntimeError, match="replicated array"):
            call()
    solo = HolisticGNNService(device="cpu")
    for call in (solo.probe_shards, lambda: solo.reshard(add=1)):
        with pytest.raises(RuntimeError, match="sharded array"):
            call()
    for call in (solo.flush_firehose, solo.close_firehose):
        with pytest.raises(RuntimeError, match="no firehose open"):
            call()


def test_stats_rpc_reports_per_shard_telemetry():
    """As ``tests/test_sharded_store.py::test_stats_rpc_reports_per_shard_
    telemetry``."""
    _, sharded = _port_pair(n_shards=3, cache_pages=600)
    vids = np.arange(12)
    sharded.store.get_embeds(vids)
    sharded.store.get_embeds(vids)              # second gather hits the cache
    st = sharded.stats()
    assert st["store"]["n_shards"] == 3
    assert len(st["shards"]) == 3
    agg_reads = sum(s["device"]["read_pages"] for s in st["shards"])
    assert st["device"]["read_pages"] == agg_reads > 0
    hit_rates = [s["embcache"]["hit_rate"] for s in st["shards"]]
    assert all(0.0 <= h <= 1.0 for h in hit_rates)
    assert st["embcache"]["hits"] == sum(s["embcache"]["hits"]
                                         for s in st["shards"]) > 0


def test_mutable_ops_under_load_cross_shard():
    """As ``tests/test_sharded_store.py::test_mutable_ops_under_load_cross_
    shard``: a stepped runtime over the port's 3-shard service, scheduled
    groups interleaved with cross-shard mutations, bit for bit with the
    port's serial single-device twin."""
    ref, svc = _port_pair(n_shards=3, cache_pages=600)
    dfg = make_service_dfg("gcn", 2, [5, 5]).save()
    weights = _weights("gcn", dims=(32, 16, 8))
    rt = ServingRuntime(svc, n_queues=2, max_group=8)
    cl, mut = rt.client(), rt.client()
    rng = np.random.default_rng(7)
    seed_ctr, n = 0, 600
    for round_ in range(5):
        cmds = []
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
        a = int(rng.integers(0, n - 3))
        row = rng.standard_normal(32).astype(np.float32)
        mids = [mut.submit("add_edge", dst=a, src=a + 1),
                mut.submit("update_embed", vid=a + 2, embed=row),
                mut.submit("delete_vertex", vid=a + 3)]
        rt.pump()
        for mid in mids:
            mut.result(mid)
        ref.store.add_edge(a, a + 1)
        ref.store.update_embed(a + 2, row)
        ref.store.delete_vertex(a + 3)
    cache = svc.store.cache.stats
    assert cache.invalidations > 0 and cache.hits > 0


def test_stats_report_identical_shape_local_vs_remote():
    """As ``tests/test_endpoint.py::test_stats_report_identical_shape_
    local_vs_remote``."""
    edges, emb = _graph(n=300, e=2000, feat=24)
    local = HolisticGNNService(h_threshold=16, pad_to=32, n_shards=2,
                               cache_pages=256, device="cpu")
    local.store.update_graph(edges, emb)
    remote = HolisticGNNService(h_threshold=16, pad_to=32,
                                endpoints=make_rop_endpoints(
                                    2, h_threshold=16),
                                cache_pages=256, device="cpu")
    try:
        remote.store.update_graph(edges, emb)
        vids = np.arange(24)
        local.store.get_embeds(vids)
        remote.store.get_embeds(vids)
        a, b = local.stats(), remote.stats()
        assert set(a) == set(b)
        assert set(a["store"]) == set(b["store"])
        assert a["store"]["pages_l"] == b["store"]["pages_l"]
        assert a["store"]["pages_h"] == b["store"]["pages_h"]
        assert a["device"]["read_pages"] == b["device"]["read_pages"]
        for sa, sb in zip(a["shards"], b["shards"]):
            assert set(sa) == set(sb)
            assert sa["device"] == sb["device"]
            assert set(sa["rpc"]) == set(sb["rpc"])
            assert sa["embcache"]["hits"] == sb["embcache"]["hits"]
        assert a["embcache"] == b["embcache"]
    finally:
        remote.close()


def _keys(d):
    """The nested key structure of a stats report (lists by their first
    entry)."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list) and d and isinstance(d[0], dict):
        return [_keys(d[0])]
    return None


@pytest.mark.parametrize("array", [{}, {"n_shards": 3},
                                   {"n_shards": 3, "replication": 2}],
                         ids=["single", "sharded", "replicated"])
def test_stats_keys_match_reference(array):
    edges, emb = _graph(n=300, e=2000, feat=24)
    port = HolisticGNNService(h_threshold=16, pad_to=32, cache_pages=256,
                              device="cpu", **array)
    ref = JService(h_threshold=16, pad_to=32, cache_pages=256, **array)
    for svc in (port, ref):
        svc.update_graph(edges, emb)
        svc.store.get_embeds(np.arange(24))
        svc.qos_provider = lambda: {"groups": 0}
    assert _keys(port.stats()) == _keys(ref.stats())


def test_service_update_graph_chunked_and_already_undirected():
    """As ``tests/test_ingest.py::test_service_update_graph_chunked_and_
    already_undirected``; the chunked array then serves the monolithic
    array's results bit for bit."""
    edges, emb = _graph(n=300, e=2000, feat=16)
    ref = HolisticGNNService(h_threshold=16, n_shards=2, device="cpu")
    ref.update_graph(edges, emb)
    svc = HolisticGNNService(h_threshold=16, n_shards=2, device="cpu")
    out = svc.update_graph(edges, emb, chunked=True, chunk_edges=400)
    assert out["total_s"] > 0
    assert ref.store.to_adjacency() == svc.store.to_adjacency()
    mirrored = np.concatenate([edges, edges[:, ::-1]])
    svc2 = HolisticGNNService(h_threshold=16, n_shards=2, device="cpu")
    svc2.update_graph(mirrored, emb, already_undirected=True,
                      chunked=True, chunk_edges=400)
    assert ref.store.to_adjacency() == svc2.store.to_adjacency()
    solo = HolisticGNNService(h_threshold=16, device="cpu")
    solo.update_graph(edges, emb, chunked=True)
    assert ref.store.to_adjacency() == solo.store.to_adjacency()
    dfg = make_service_dfg("gin", 2, [5, 5]).save()
    weights = _weights("gin", dims=(16, 8, 4))
    np.testing.assert_array_equal(
        ref.run(dfg, [1, 5, 9], weights=weights, seed=3)["Result"],
        svc.run(dfg, [1, 5, 9], weights=weights, seed=3)["Result"])


def _mixed_ops(n, feat, count, seed=1):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(count):
        k = int(rng.integers(0, 5))
        if k == 0:
            ops.append(("add_edge", int(rng.integers(0, n)),
                        int(rng.integers(0, n))))
        elif k == 1:
            ops.append(("delete_edge", int(rng.integers(0, n)),
                        int(rng.integers(0, n))))
        elif k == 2:
            ops.append(("update_embed", int(rng.integers(0, n)),
                        rng.standard_normal(feat).astype(np.float32)))
        elif k == 3:
            ops.append(("add_vertex", int(rng.integers(0, n)),
                        rng.standard_normal(feat).astype(np.float32)))
        else:
            ops.append(("delete_vertex", int(rng.integers(0, n))))
    return ops


def test_service_firehose_rpcs_route_unit_mutations():
    """As ``tests/test_ingest.py::test_service_firehose_rpcs_route_unit_
    mutations``."""
    edges, emb = _graph(n=200, e=1200, feat=8)
    svc = HolisticGNNService(h_threshold=16, n_shards=2, device="cpu")
    svc.update_graph(edges, emb)
    ref = HolisticGNNService(h_threshold=16, n_shards=2, device="cpu")
    ref.update_graph(edges, emb)
    svc.open_firehose(window_s=60.0)       # timer effectively off
    with pytest.raises(RuntimeError):
        svc.open_firehose()
    for op in _mixed_ops(200, 8, 60, seed=9):
        getattr(ref, op[0])(*op[1:])
        getattr(svc, op[0])(*op[1:])
    st = svc.stats()
    assert st["firehose"]["submitted"] == 60
    out = svc.flush_firehose()
    assert out["applied_now"] + out["barriers"] >= 0
    snap = svc.close_firehose()
    assert snap["applied"] == 60
    assert svc.firehose is None
    assert ref.store.to_adjacency() == svc.store.to_adjacency()
    svc.add_edge(1, 2)
    ref.add_edge(1, 2)
    assert ref.store.to_adjacency() == svc.store.to_adjacency()


@pytest.mark.parametrize("replication", [1, 2])
def test_firehose_reads_bit_identical_to_serial_replay(replication):
    """As ``tests/test_ingest.py::test_firehose_reads_bit_identical_to_
    serial_replay``, through the service: at each flush the firehose
    service's reads and model results equal a twin service applying the
    same unit mutations one at a time."""
    edges, emb = _graph(n=300, e=2000, feat=16)
    n = 300
    a = HolisticGNNService(h_threshold=16, pad_to=32, n_shards=3,
                           replication=replication, device="cpu")
    b = HolisticGNNService(h_threshold=16, pad_to=32, n_shards=3,
                           replication=replication, device="cpu")
    a.update_graph(edges, emb)
    b.update_graph(edges, emb)
    b.open_firehose(window_s=60.0, max_window_ops=32)
    dfg = make_service_dfg("ngcf", 2, [4, 4]).save()
    weights = _weights("ngcf", dims=(16, 8, 4))
    rng = np.random.default_rng(7)
    for i, op in enumerate(_mixed_ops(n, 16, 260)):
        getattr(a, op[0])(*op[1:])
        getattr(b, op[0])(*op[1:])
        if i % 57 == 0:
            b.flush_firehose()
            vids = rng.integers(0, n, 32)
            for va, vb in zip(a.store.get_neighbors_batch(vids),
                              b.store.get_neighbors_batch(vids)):
                np.testing.assert_array_equal(va, vb)
            np.testing.assert_array_equal(a.store.get_embeds(vids),
                                          b.store.get_embeds(vids))
            live = [int(v) for v in vids[:4] if a.store.get_neighbors(int(v))
                    is not None]
            np.testing.assert_array_equal(
                a.run(dfg, live, weights=weights, seed=i)["Result"],
                b.run(dfg, live, weights=weights, seed=i)["Result"])
    snap = b.close_firehose()
    assert a.store.to_adjacency() == b.store.to_adjacency()
    assert a.store.num_vertices == b.store.num_vertices
    assert a.store.stats.unit_updates == b.store.stats.unit_updates
    assert snap["applied"] == snap["submitted"] == 260
    assert snap["windows"] > 1 and snap["barriers"] > 0


@pytest.mark.parametrize("transport", ["local", "rop"])
def test_reshard_rpc_grow_then_shrink_bit_identical(transport):
    """The service ``reshard`` RPC grows the array by ``add=`` (new
    endpoints built to match the transport) and shrinks it by
    ``remove=``; reads and model results stay the single device's bit for
    bit after each."""
    kw = _array_kw(3, 2, transport, make_rop_endpoints)
    one, svc = _port_pair(cache_pages=256, **kw)
    dfg = make_service_dfg("gcn", 2, [5, 5]).save()
    weights = _weights("gcn", dims=(32, 16, 8))
    targets = [3, 7, 11, 200, 599]

    def check():
        np.testing.assert_array_equal(
            one.run(dfg, targets, weights=weights, seed=4)["Result"],
            svc.run(dfg, targets, weights=weights, seed=4)["Result"])
        vids = np.arange(0, 600, 7)
        np.testing.assert_array_equal(one.store.get_embeds(vids),
                                      svc.store.get_embeds(vids))

    try:
        check()
        grown = svc.reshard(add=1, chunk_pages=8)
        assert grown["n_shards"] == 4 and svc.store.n_shards == 4
        assert type(svc.store.endpoints[3]) is type(svc.store.endpoints[0])
        check()
        shrunk = svc.reshard(remove=[3], chunk_pages=8)
        assert shrunk["n_shards"] == 3 and svc.store.n_shards == 3
        check()
        assert len(svc.stats()["shards"]) == 3
    finally:
        svc.close()
