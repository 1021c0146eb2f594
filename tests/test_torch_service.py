"""The port's service, engine and models against the JAX reference, on
the CPU (the kernels' plain versions): GCN/GIN/NGCF under Octa, Lsap and
Hetero, the planned (cached) engine path, fused == serial bit for bit, the
RPC quickstart flow, DFG markup across packages, and parameters."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import gnn as jgnn
from repro.core.dfg import DFG as JDFG
from repro.core.dfg import fuse_aggregate_combine as j_fuse
from repro.core.service import HolisticGNNService as JService
from repro.core.service import make_service_dfg as j_make_service_dfg
from repro.store.sampler import sample_batch as j_sample_batch
from repro_torch.core import gnn
from repro_torch.core.dfg import DFG, fuse_aggregate_combine
from repro_torch.core.service import HolisticGNNService, make_service_dfg
from repro_torch.kernels.ops import program_config
from repro_torch.rpc import RPCClient, RPCServer

MODELS = ("gcn", "gin", "ngcf")


def _graph(seed=3, n=80, e=400, feat=24):
    rng = np.random.default_rng(seed)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)],
                     axis=1).astype(np.int64)
    return edges, rng.standard_normal((n, feat)).astype(np.float32)


def _weights(model, dims=(24, 12, 8), seed=2):
    """The reference's weights as a NumPy feed dict (what RPC carries)."""
    params = jgnn.init_params(model, list(dims), seed=seed)
    return {k: np.asarray(v) for k, v in
            jgnn.dfg_feeds(model, params, None, []).items() if k != "H"}, params


@pytest.fixture(scope="module")
def services():
    edges, emb = _graph()
    port = HolisticGNNService(h_threshold=8, pad_to=16, device="cpu")
    ref = JService(h_threshold=8, pad_to=16)
    for svc in (port, ref):
        svc.update_graph(edges, emb)
    return port, ref


@pytest.mark.parametrize("config", ["octa", "lsap", "hetero"])
@pytest.mark.parametrize("model", MODELS)
def test_gnn_service_matches_reference(services, model, config):
    """As ``tests/test_dfg.py::test_gnn_dfg_equals_direct``, across the
    packages and the three bitstreams."""
    port, ref = services
    weights, params = _weights(model)
    dfg = make_service_dfg(model, 2, [4, 4]).save()
    program_config(port.xbuilder, config)
    out = port.run(dfg, [1, 2], weights=weights)["Result"]
    b = j_sample_batch(ref.store, [1, 2], [4, 4],
                       rng=np.random.default_rng(0), pad_to=16)
    blocks = [(jnp.asarray(x.nbr), jnp.asarray(x.mask)) for x in b.layers]
    want = jgnn.FORWARD[model](params, jnp.asarray(b.embeddings), blocks)
    np.testing.assert_allclose(out[:2], np.asarray(want)[:2],
                               rtol=2e-5, atol=2e-5)
    ref_out = ref.run(j_make_service_dfg(model, 2, [4, 4]).save(), [1, 2],
                      weights=weights)["Result"]
    np.testing.assert_allclose(out[:2], ref_out[:2], rtol=2e-5, atol=2e-5)
    devices = {d for op, d in port.engine.trace if op != "BatchPre"}
    gcn_fused = model == "gcn" and config == "hetero"   # AggCombine only
    assert devices == {"octa": {"cpu"}, "lsap": {"cpu", "systolic"},
                       "hetero": {"vector"} if gcn_fused
                       else {"cpu", "vector", "systolic"}}[config]


@pytest.mark.parametrize("model", MODELS)
def test_forward_matches_reference(services, model):
    _, ref = services
    b = j_sample_batch(ref.store, [1, 2, 5], [4, 4],
                       rng=np.random.default_rng(1), pad_to=16)
    _, jparams = _weights(model)
    tparams = gnn.params_from_numpy(
        model, [{k: np.asarray(v) for k, v in p.items()} for p in jparams],
        "cpu")
    want = jgnn.FORWARD[model](
        jparams, jnp.asarray(b.embeddings),
        [(jnp.asarray(x.nbr), jnp.asarray(x.mask)) for x in b.layers])
    got = gnn.FORWARD[model](
        tparams, torch.from_numpy(b.embeddings),
        [(torch.from_numpy(x.nbr), torch.from_numpy(x.mask)) for x in b.layers])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_engine_planned_path_matches_eager_and_caches():
    """As ``tests/test_fastpath.py::test_engine_jit_path_matches_eager_and_
    caches``: one cached plan per model DFG; repeat runs hit the cache."""
    edges, emb = _graph()
    svc = HolisticGNNService(h_threshold=8, pad_to=16, device="cpu")
    svc.update_graph(edges, emb)
    for model in MODELS:
        weights, _ = _weights(model)
        dfg = make_service_dfg(model, 2, [4, 4])
        o_eager = svc.run(dfg.save(), [1, 2], weights=weights,
                          jit=False)["Result"]
        o_jit = svc.run(dfg.save(), [1, 2], weights=weights,
                        jit=True)["Result"]
        np.testing.assert_allclose(o_eager, o_jit, rtol=1e-5, atol=1e-5)
    assert len(svc.engine._jit_cache) == 3
    svc.run(dfg.save(), [1, 2], weights=weights, jit=True)
    assert len(svc.engine._jit_cache) == 3
    stats = svc.engine_stats()["jit_cache"]
    assert stats == {"size": 3, "capacity": 32, "hits": 1, "misses": 3,
                     "evictions": 0}
    assert svc.engine.timings[-1][:2] == ("__dfg_jit__", "jit")


@pytest.fixture(scope="module")
def serving():
    rng = np.random.default_rng(0)
    n, e, feat = 600, 5000, 32
    edges = np.stack([rng.integers(0, n, e), rng.zipf(1.4, e) % n],
                     axis=1).astype(np.int64)
    emb = rng.standard_normal((n, feat)).astype(np.float32)
    svc = HolisticGNNService(h_threshold=16, pad_to=32, cache_pages=2048,
                             device="cpu")
    svc.store.update_graph(edges, emb)
    return svc, n


@pytest.mark.parametrize("config", ["octa", "hetero"])
@pytest.mark.parametrize("model", MODELS)
def test_run_batch_bit_identical_to_serial(serving, model, config):
    """As ``tests/test_serving.py::test_run_batch_bit_identical_to_serial``."""
    svc, n = serving
    program_config(svc.xbuilder, config)
    weights, _ = _weights(model, dims=(32, 16, 8), seed=1)
    dfg = make_service_dfg(model, 2, [5, 5]).save()
    rng = np.random.default_rng(5)
    reqs = [{"targets": rng.integers(0, n, sz).tolist(), "seed": 50 + i}
            for i, sz in enumerate([8, 3, 8, 1, 16])]
    fused = svc.run_batch(dfg, reqs, weights=weights, jit=True)
    for r, f in zip(reqs, fused):
        nt = len(r["targets"])
        serial = svc.run(dfg, r["targets"], weights=weights,
                         seed=r["seed"], jit=True)
        for k in serial:
            np.testing.assert_array_equal(serial[k][:nt], f[k][:nt])


def test_quickstart_over_rpc_matches_reference():
    """``examples/quickstart.py`` in the port's terms, against the
    reference service's Shell result; unprogramming falls back to Shell."""
    rng = np.random.default_rng(0)
    n, e, feat = 1000, 8000, 64
    edges = np.stack([rng.integers(0, n, e), rng.zipf(1.4, e) % n],
                     1).astype(np.int64)
    emb = rng.standard_normal((n, feat)).astype(np.float32)
    svc = HolisticGNNService(h_threshold=32, pad_to=32, device="cpu")
    client = RPCClient(RPCServer(svc))
    stats = client.call("update_graph", edge_array=edges, embeddings=emb)
    assert stats["total_s"] > 0
    assert program_config(svc.xbuilder, "hetero") >= 0
    weights, _ = _weights("gcn", dims=(feat, 32, 16), seed=1)
    dfg = make_service_dfg("gcn", num_layers=2, fanouts=[10, 10]).save()
    out = client.call("run", dfg=dfg, batch=[1, 2, 3, 4],
                      weights=weights)["Result"]
    assert svc.engine.trace.count(("AggCombine", "vector")) == 2
    assert not any(op in ("SpMM_Mean", "GEMM", "BiasAdd", "ReLU")
                   for op, _ in svc.engine.trace)
    ref = JService(h_threshold=32, pad_to=32)
    ref.update_graph(edges, emb)
    want = ref.run(dfg, [1, 2, 3, 4], weights=weights)["Result"]
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)
    svc.xbuilder.unprogram("vector")
    svc.xbuilder.unprogram("systolic")
    fallback = client.call("run", dfg=dfg, batch=[1, 2, 3, 4],
                           weights=weights)["Result"]
    assert all(d == "cpu" for _, d in svc.engine.trace)
    np.testing.assert_allclose(fallback, out, rtol=1e-5, atol=1e-5)
    st = client.call("stats")
    assert st["store"]["num_vertices"] == n and "rpc" in st


@pytest.mark.parametrize("model", MODELS)
def test_dfg_markup_round_trips_between_packages(model):
    jm = j_make_service_dfg(model, 2, [4, 3]).save()
    tm = make_service_dfg(model, 2, [4, 3]).save()
    assert tm == jm
    jd, td = JDFG.load(tm), DFG.load(jm)
    assert td.save() == jm and jd.save() == tm
    assert [n.op for n in td.topo_nodes()] == [n.op for n in jd.topo_nodes()]
    outs = set(td._outs.values())
    assert [(n.seq, n.op, n.inputs) for n in
            fuse_aggregate_combine(td.topo_nodes(), outs)] == \
        [(n.seq, n.op, n.inputs) for n in j_fuse(jd.topo_nodes(), outs)]


@pytest.mark.parametrize("model", MODELS)
def test_params_from_numpy_matches_init_params(model):
    dims = [24, 12, 8]
    ref = [{k: np.asarray(v) for k, v in p.items()}
           for p in jgnn.init_params(model, dims, seed=7)]
    for got in (gnn.init_params(model, dims, seed=7, device="cpu"),
                gnn.params_from_numpy(model, ref, "cpu")):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert set(g) == set(r)
            for k in r:
                assert g[k].dtype == torch.float32
                np.testing.assert_array_equal(g[k].numpy(), r[k])
    with pytest.raises(ValueError):
        gnn.params_from_numpy("gcn" if model != "gcn" else "gin", ref, "cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        HolisticGNNService()
    with pytest.raises(RuntimeError, match="CUDA"):
        gnn.init_params("gcn", [4, 2])


def test_unported_features_raise_naming_the_roadmap():
    """Every service feature is ported: ``mesh=`` and ``model_parallel=``
    build a meshed engine on the CPU (``tests/test_torch_spmd.py``), the
    array, firehose and shard admin RPCs ``tests/test_torch_array.py``;
    ``model_parallel=3`` and ``dev=`` with an array raise the reference's
    ``ValueError``."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(shape=(1, 2), devices=["cpu"] * 2)
    for kw, want in (({"mesh": mesh}, {"data": 1, "model": 2}),
                     ({"model_parallel": 2}, {"data": 4, "model": 2}),
                     ({"mesh": mesh, "n_shards": 2}, {"data": 1, "model": 2})):
        svc = HolisticGNNService(device="cpu", **kw)
        assert svc.engine.mesh is not None
        assert svc.stats()["engine"]["mesh"] == want
        svc.close()
    with pytest.raises(ValueError, match="must divide device count 8"):
        HolisticGNNService(device="cpu", model_parallel=3)
    from repro_torch.store import BlockDevice
    with pytest.raises(ValueError, match="dev= is single-device only"):
        HolisticGNNService(device="cpu", dev=BlockDevice(), n_shards=2)
    with pytest.raises(ValueError, match="dev= is single-device only"):
        JService(dev=BlockDevice(), n_shards=2)


def test_put_weights_and_model_only_dfg():
    edges, emb = _graph()
    svc = HolisticGNNService(h_threshold=8, pad_to=16, device="cpu")
    svc.update_graph(edges, emb)
    weights, _ = _weights("gin")
    info = svc.put_weights("gin-v1", weights)
    assert info["tensors"] == len(weights)
    assert info["bytes"] == sum(v.nbytes for v in weights.values())
    dfg = make_service_dfg("gin", 2, [4, 4]).save()
    by_ref = svc.run(dfg, [1, 2], weights_ref="gin-v1")["Result"]
    np.testing.assert_array_equal(
        by_ref, svc.run(dfg, [1, 2], weights=weights)["Result"])
    with pytest.raises(KeyError):
        svc.run(dfg, [1, 2], weights_ref="missing")
    model_only = svc.run(gnn.build_gin_dfg(2).save(), [1, 2],
                         weights=weights, fanouts=[4, 4])["Result"]
    np.testing.assert_array_equal(model_only, by_ref)
    svc.add_edge(1, 2)
    assert 2 in svc.get_neighbors(1)
    np.testing.assert_array_equal(svc.get_embed(3), emb[3])
