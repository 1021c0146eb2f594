"""The port's SPMD engine against the reference's, on the CPU (the
kernels' plain versions): GCN/GIN/NGCF across mesh shapes, padding of odd
hidden and row dims, the Hetero fused path (AggCombinePartial + psum),
the serving batcher and the Run RPC on a meshed service, the bounded LRU
plan cache and the mesh in its key.

The reference runs ``shard_map`` over 8 forced host devices (under the
``spmd_devices`` fixture); the port runs its body over CPU slots of a
``launch.mesh.Mesh``.  Both get the same NumPy inputs, made from the
reference's seeds, and the same weights (``params_from_numpy``); results
agree at rtol = atol = 2e-5, the reference's own sharded-vs-single-device
tolerance.  The port's own gates follow: a (1, 1) mesh equals the
unmeshed engine bit for bit, and meshed ``run_batch`` equals meshed serial
``run`` bit for bit on a (2, 4) mesh.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import gnn as jgnn
from repro.core.dfg import Engine as JEngine
from repro.core.registry import KernelRegistry as JKernelRegistry
from repro.core.service import HolisticGNNService as JService
from repro.core.xbuilder import XBuilder as JXBuilder
from repro.kernels.ops import program_config as j_program_config
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro_torch.core import gnn, spmd
from repro_torch.core.dfg import DFG, Engine
from repro_torch.core.registry import KernelRegistry
from repro_torch.core.service import HolisticGNNService, make_service_dfg
from repro_torch.core.xbuilder import SHELL_DEVICE, XBuilder
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ops import program_config
from repro_torch.launch.mesh import CPU_POOL_SLOTS, make_host_mesh

MESH_SHAPES = [(1, 1), (1, 2), (2, 2), (1, 4)]
N, K = 60, 5
ROWS = [24, 12]                      # decreasing hop row counts
TOL = 2e-5
POOL = ["cpu"] * CPU_POOL_SLOTS


def _mesh(shape):
    return make_host_mesh(shape=shape, devices=["cpu"] * (shape[0] * shape[1]))


def _j_mesh(shape):
    return j_make_host_mesh(shape[0] * shape[1], shape=shape)


def _blocks(rng, rows=ROWS, n=N):
    out, prev = [], n
    for d in rows:
        nbr = rng.integers(0, prev, (d, K)).astype(np.int32)
        mask = (rng.random((d, K)) < 0.8).astype(np.float32)
        out.append((nbr, mask))
        prev = d
    return out


def _engine(mesh=None, config=None, **kw):
    reg = KernelRegistry()
    xb = XBuilder(reg)
    for name, fn in gnn.extra_shell_kernels().items():
        reg.register_op(name, SHELL_DEVICE, fn)
    if config:
        program_config(xb, config)
    return Engine(reg, mesh=mesh, **kw)


def _j_engine(mesh=None, config=None, **kw):
    reg = JKernelRegistry()
    xb = JXBuilder(reg)
    for name, fn in jgnn.extra_shell_kernels().items():
        reg.register_op(name, "cpu", fn)
    if config:
        j_program_config(xb, config)
    return JEngine(reg, mesh=mesh, **kw)


class _Case:
    """One model's DFG and feeds for both packages, from the same NumPy
    draws (the reference test's seeds)."""

    def __init__(self, model, dims, seed=1, rng_seed=0, rows=ROWS):
        rng = np.random.default_rng(rng_seed)
        jparams = jgnn.init_params(model, dims, seed=seed)
        emb = rng.standard_normal((N, dims[0])).astype(np.float32)
        blocks = _blocks(rng, rows=rows)
        self.model = model
        self.j_dfg = jgnn.BUILD_DFG[model](len(dims) - 1)
        self.dfg = gnn.BUILD_DFG[model](len(dims) - 1)
        self.j_feeds = jgnn.dfg_feeds(
            model, jparams, jnp.asarray(emb),
            [(jnp.asarray(n), jnp.asarray(m)) for n, m in blocks])
        params = gnn.params_from_numpy(
            model, [{k: np.asarray(v) for k, v in p.items()}
                    for p in jparams], "cpu")
        self.feeds = gnn.dfg_feeds(
            model, params, torch.tensor(emb),
            [(torch.tensor(n), torch.tensor(m)) for n, m in blocks])

    def run(self, engine):
        return engine.run(self.dfg, dict(self.feeds), jit=True)

    def j_run(self, engine):
        return engine.run(self.j_dfg, dict(self.j_feeds), jit=True)


def _close(port, reference):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    reference = np.asarray(reference)
    assert port.shape == reference.shape
    np.testing.assert_allclose(port, reference, rtol=TOL, atol=TOL)


# -------------------------------------------------- sharded == reference
@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("model,dims", [
    ("gcn", [13, 17, 7]), ("gin", [13, 17, 7]), ("ngcf", [13, 13, 13])])
def test_sharded_matches_reference(model, dims, shape, spmd_devices):
    case = _Case(model, dims)
    want = case.j_run(_j_engine(_j_mesh(shape)))
    got = case.run(_engine(_mesh(shape)))
    single = case.run(_engine())
    for k in want:
        _close(got[k], want[k])
        _close(got[k], single[k].numpy())


def test_data_by_model_mesh(spmd_devices):
    """Both axes striped at once (2 data x 4 model = all 8 slots)."""
    for model, dims in [("gcn", [13, 17, 7]), ("ngcf", [13, 13, 13])]:
        case = _Case(model, dims)
        want = case.j_run(_j_engine(j_make_host_mesh(8, shape=(2, 4))))
        got = case.run(_engine(make_host_mesh(8, shape=(2, 4),
                                              devices=POOL)))
        _close(got["Result"], want["Result"])
        _close(got["Result"], case.run(_engine())["Result"].numpy())


def test_hetero_fused_path(spmd_devices):
    """The Hetero config fuses GCN layers into AggCombine; the sharded
    engine must route through AggCombinePartial + psum and still match."""
    case = _Case("gcn", [13, 17, 7])
    want = case.j_run(_j_engine(_j_mesh((2, 4)), config="hetero"))
    eng = _engine(_mesh((2, 4)), config="hetero")
    got = case.run(eng)
    assert any(op == "AggCombine" for op, _ in eng.trace)   # fusion fired
    _close(got["Result"], want["Result"])


@pytest.mark.parametrize("dims", [[5, 9, 3], [7, 11, 11]])
def test_odd_hidden_dims_are_padded(dims, spmd_devices):
    """No dim divides the 4-way model axis: zero-padding to divisibility
    must be numerically invisible and outputs sliced back to true shape."""
    case = _Case("gcn", dims)
    want = case.j_run(_j_engine(_j_mesh((2, 4))))
    got = case.run(_engine(_mesh((2, 4))))
    _close(got["Result"], want["Result"])


def test_odd_row_counts_are_padded(spmd_devices):
    """Hop row counts that don't divide the data axis (11, 7 on d=2)."""
    case = _Case("gcn", [13, 17, 7], rng_seed=4, rows=[11, 7])
    want = case.j_run(_j_engine(_j_mesh((2, 4))))
    got = case.run(_engine(_mesh((2, 4))))
    _close(got["Result"], want["Result"])


# --------------------------------------------------------- service / serving
def _graph():
    rng = np.random.default_rng(7)
    n, e, feat = 400, 3000, 32
    edges = np.stack([rng.integers(0, n, e), rng.zipf(1.4, e) % n],
                     axis=1).astype(np.int64)
    emb = rng.standard_normal((n, feat)).astype(np.float32)
    return edges, emb, n


def _services(port_kw, ref_kw):
    edges, emb, n = _graph()
    port = HolisticGNNService(h_threshold=16, pad_to=32, device="cpu",
                              **port_kw)
    ref = JService(h_threshold=16, pad_to=32, **ref_kw)
    for svc in (port, ref):
        svc.update_graph(edges, emb)
    return port, ref, n


def _weights(model, seed):
    params = jgnn.init_params(model, [32, 16, 8], seed=seed)
    return {k: np.asarray(v) for k, v in
            jgnn.dfg_feeds(model, params, None, []).items() if k != "H"}


def test_run_batch_on_meshed_service(spmd_devices):
    """The serving batcher's fused super-batch through the SPMD engine:
    same near-storage sampling, results at 2e-5, mesh in stats."""
    port, ref, n = _services({"model_parallel": 4}, {"model_parallel": 4})
    dfg = make_service_dfg("gcn", 2, [5, 5]).save()
    weights = _weights("gcn", 1)
    rng = np.random.default_rng(5)
    reqs = [{"targets": rng.integers(0, n, sz).tolist(), "seed": 50 + i}
            for i, sz in enumerate([8, 3, 16])]
    want = ref.run_batch(dfg, reqs, weights=weights, jit=True)
    got = port.run_batch(dfg, reqs, weights=weights, jit=True)
    for a, b in zip(got, want):
        for k in b:
            _close(a[k], b[k])
    st = port.stats()["engine"]
    assert st["mesh"] == {"data": 2, "model": 4} == \
        ref.stats()["engine"]["mesh"]
    assert st["jit_cache"]["misses"] >= 1
    port.close()
    ref.close()


def test_service_run_on_mesh(spmd_devices):
    """Single-request Run RPC path (BatchPre eager prefix + sharded
    suffix) against an explicit mesh= handle."""
    port, ref, _ = _services(
        {"mesh": make_host_mesh(4, shape=(1, 4), devices=POOL)},
        {"mesh": j_make_host_mesh(4, shape=(1, 4))})
    dfg = make_service_dfg("gin", 2, [5, 5]).save()
    weights = _weights("gin", 2)
    targets = list(range(12))
    want = ref.run(dfg, targets, weights=weights, seed=3, jit=True)
    got = port.run(dfg, targets, weights=weights, seed=3, jit=True)
    for k in want:
        _close(got[k], want[k])
    assert port.stats()["engine"]["mesh"] == {"data": 1, "model": 4}
    port.close()
    ref.close()


# ------------------------------------------------------------- LRU plan cache
def test_plan_cache_lru_eviction_and_stats():
    """The reference's LRU sequence, step for step: the port's counters
    equal the reference's after every run."""
    eng, j_eng = _engine(jit_cache_size=2), _j_engine(jit_cache_size=2)
    dfg, j_dfg = gnn.BUILD_DFG["gcn"](1), jgnn.BUILD_DFG["gcn"](1)
    rng = np.random.default_rng(0)
    jparams = jgnn.init_params("gcn", [8, 4], seed=0)
    params = gnn.params_from_numpy(
        "gcn", [{k: np.asarray(v) for k, v in p.items()} for p in jparams],
        "cpu")

    def feeds(d):
        emb = rng.standard_normal((N, 8)).astype(np.float32)
        ((nbr, mask),) = _blocks(rng, rows=[d])
        return (gnn.dfg_feeds("gcn", params, torch.tensor(emb),
                              [(torch.tensor(nbr), torch.tensor(mask))]),
                jgnn.dfg_feeds("gcn", jparams, jnp.asarray(emb),
                               [(jnp.asarray(nbr), jnp.asarray(mask))]))

    f1, f2, f3 = feeds(8), feeds(12), feeds(16)   # 3 distinct signatures
    for f in (f1, f1, f2, f3, f2, f1):
        got = eng.run(dfg, dict(f[0]), jit=True)["Result"]
        want = j_eng.run(j_dfg, dict(f[1]), jit=True)["Result"]
        _close(got, want)
        assert eng.cache_stats() == j_eng.cache_stats()
    st = eng.cache_stats()
    assert (st["hits"], st["misses"], st["evictions"]) == (2, 4, 2)
    assert st["size"] == st["capacity"] == 2
    with pytest.raises(ValueError):
        _engine(jit_cache_size=0)


def test_mesh_in_cache_key(spmd_devices):
    """Same DFG + signature on different meshes must not share plans."""
    case = _Case("gcn", [13, 17, 7])
    eng = _engine(make_host_mesh(2, shape=(1, 2), devices=POOL))
    case.run(eng)
    eng.mesh = make_host_mesh(4, shape=(1, 4), devices=POOL)   # re-point
    got = case.run(eng)
    st = eng.cache_stats()
    assert st["misses"] == 2 and st["hits"] == 0  # distinct cache entries
    case.run(eng)
    assert eng.cache_stats()["hits"] == 1
    want = case.j_run(_j_engine())
    _close(got["Result"], want["Result"])


# ------------------------------------------------------- the port's own gates
@pytest.mark.parametrize("config", [None, "hetero"])
@pytest.mark.parametrize("model,dims", [
    ("gcn", [13, 17, 7]), ("gin", [13, 17, 7]), ("ngcf", [13, 13, 13])])
def test_unit_mesh_equals_unmeshed_engine_bitwise(model, dims, config):
    """A (1, 1) mesh has no collective and no padding: the same bits as
    the plan walk, and the same kernels in the trace."""
    case = _Case(model, dims)
    plain = _engine(config=config)
    meshed = _engine(_mesh((1, 1)), config=config)
    want, got = case.run(plain), case.run(meshed)
    assert meshed.trace == plain.trace
    for k in want:
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("model", ["gcn", "gin", "ngcf"])
def test_meshed_run_batch_equals_meshed_serial_run_bitwise(model):
    """Every row's arithmetic depends only on (F, O) and the psum runs in
    slot order, so a request's rows in a fused group on a (2, 4) mesh are
    the bits of its own serial run on that mesh."""
    edges, emb, n = _graph()
    svc = HolisticGNNService(h_threshold=16, pad_to=32, device="cpu",
                             mesh=_mesh((2, 4)))
    svc.update_graph(edges, emb)
    program_config(svc.xbuilder, "hetero")
    dfg = make_service_dfg(model, 2, [5, 5]).save()
    weights = _weights(model, 3)
    rng = np.random.default_rng(9)
    reqs = [{"targets": rng.integers(0, n, sz).tolist(), "seed": 70 + i}
            for i, sz in enumerate([8, 3, 16, 5])]
    fused = svc.run_batch(dfg, reqs, weights=weights)
    for got, r in zip(fused, reqs):
        serial = svc.run(dfg, r["targets"], weights=weights, seed=r["seed"])
        np.testing.assert_array_equal(
            got["Result"], serial["Result"][:len(r["targets"])])
    svc.close()


def test_mesh_slots_must_be_the_service_device_type():
    for devices in (["cuda:0"] * 2, ["meta"] * 4, ["cpu", "meta"]):
        with pytest.raises(ValueError, match="mesh slots"):
            HolisticGNNService(device="cpu",
                               mesh=make_host_mesh(devices=devices))
    with pytest.raises(ValueError):                 # 3 does not divide 8
        HolisticGNNService(device="cpu", model_parallel=3)


def test_registry_without_agg_combine_partial_takes_the_plain_fallback():
    """A registry whose AggCombine has no slice-shaped partial kernel runs
    the fused layer through ``_agg_partial_ref`` + psum."""
    case = _Case("gcn", [13, 17, 7])
    eng = _engine(_mesh((2, 2)))
    eng.registry.register_device("fused", 100)
    eng.registry.register_op(
        "AggCombine", "fused",
        lambda h, n, m, w, b: kref.agg_combine_ref(h, n, m, w, b))
    got = case.run(eng)
    assert ("AggCombine", "fused") in eng.trace
    _close(got["Result"], case.run(_engine())["Result"].numpy())


def test_op_outside_the_vocabulary_runs_replicated():
    """An op the plan does not know gathers its striped inputs and runs
    on full values in every slot."""
    g = DFG()
    h, nbr, mask, w = (g.create_in(x) for x in ("H", "nbr", "mask", "W"))
    (a,) = g.create_op("SpMM_Mean", [h, nbr, mask])
    (t,) = g.create_op("Tanh", [a])
    (z,) = g.create_op("GEMM", [t, w])
    g.create_out("Result", z)
    rng = np.random.default_rng(2)
    ((nb, mk),) = _blocks(rng, rows=[11])
    feeds = {"H": torch.tensor(rng.standard_normal((N, 10)), dtype=torch.float32),
             "nbr": torch.tensor(nb), "mask": torch.tensor(mk),
             "W": torch.tensor(rng.standard_normal((10, 6)), dtype=torch.float32)}
    results = []
    for mesh in (None, _mesh((2, 4))):
        eng = _engine(mesh)
        eng.registry.register_op("Tanh", SHELL_DEVICE, torch.tanh)
        results.append(eng.run(g, dict(feeds), jit=True)["Result"])
    _close(results[1], results[0].numpy())


def _vocabulary_cases():
    """Inputs for each op of the plan's vocabulary, with dims that all
    differ (N 13, F 5, D 7, K 3, O 4), so a shape rule that mixes two of
    them up cannot match by chance."""
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)

    h, x, y, b = t(13, 5), t(7, 5), t(7, 4), t(4)
    nbr = torch.tensor(rng.integers(0, 13, (7, 3)), dtype=torch.int32)
    mask = torch.tensor((rng.random((7, 3)) < 0.7).astype(np.float32))
    agg = (h, nbr, mask)
    return {
        "SpMM": (agg, {}), "SpMM_Mean": (agg, {}), "SpMM_Sum": (agg, {}),
        "SDDMM": (agg, {}), "Prefix": ((h, nbr), {}),
        "GEMM": ((x, t(5, 4)), {}),
        "AggCombine": ((*agg, t(5, 4), b), {}),
        "BiasAdd": ((y, b), {}), "ReLU": ((y,), {}), "LeakyReLU": ((y,), {}),
        "Scale": ((x, torch.tensor(0.5)), {}), "Add": ((x, t(7, 5)), {}),
        "Mul": ((x, t(7, 1)), {}), "DegNorm": ((mask,), {}),
        "Reduce": ((t(7, 3, 5),), {"axis": 1, "op": "sum"}),
    }


def _registered_kernels() -> dict[str, list]:
    """Every kernel registered for each op under each configuration, with
    the GNN helper ops: (configuration, device, kernel)."""
    found: dict[str, list] = {}
    for config in (None, "octa", "lsap", "hetero"):
        for op, cands in _engine(config=config).registry.ops.items():
            found.setdefault(op, []).extend(
                (config, dev, fn) for dev, fn in cands)
    return found


@pytest.mark.parametrize("op", sorted(_vocabulary_cases()))
def test_shape_rule_matches_every_registered_kernel(op):
    """The plan's shape rule for an op gives the shape each kernel
    registered for it returns (the Shell op, the bitstreams' kernels and
    the GNN helpers), since the rule alone decides ``true_out``."""
    args, attrs = _vocabulary_cases()[op]
    want = spmd._shape_rule(op, [tuple(a.shape) for a in args], attrs)
    impls = _registered_kernels().get(op)
    assert want is not None and impls, (op, want)
    for config, dev, fn in impls:
        out = fn(*args, **attrs)
        assert tuple(out.shape) == want, (op, config, dev, out.shape, want)


def test_every_op_with_a_shape_rule_is_checked():
    """No registered op has a shape rule that the test above skips."""
    cases = _vocabulary_cases()
    for op in _registered_kernels():
        if spmd._shape_rule(op, [(2, 2)] * 5, {}) is not None:
            assert op in cases, op
