"""MoE experts on the model axis (``models/layers.py::_moe_split``), on 8
CPU slots.  phi3.5-moe's and llama4-scout's smokes have 4 experts: 2 a
slot at model degree 2, 1 at 4, and unsplit at 8 (``moe_defs`` leaves
the stacks whole where the degree does not divide them, and the first
slot runs the whole MoE); those cases run in
``tests/test_torch_model_axis.py`` (training) and
``tests/test_torch_mesh_serve.py`` (serving).  Here each smoke is also
built with 8 experts (``.replace(moe=...)``, in both packages), so that
degree 8 splits them too: the split train step, and the split prefill
plus 3 decode steps, against the gathered ones at (1, 8), (2, 4) and
(4, 2); at (1, 8) against the reference (its ``jax.value_and_grad`` of
``train_loss`` and its prefill and decode jitted with the port's
shardings on its 8 forced host devices); and the slot that runs each
expert MLP, which must be the slot holding those experts' blocks.

The smokes run in fp32.  Tolerance: the loss and each gradient leaf,
each step's logits and every cache leaf, within 1e-5 of their largest
element."""
import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from repro.configs import SMOKES as J_SMOKES
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.models import build as jbuild, layers as JL
from repro_torch.configs import SMOKES
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import MeshServe
from repro_torch.models import build, layers as L
from repro_torch.train import optimizer as O
from repro_torch.train import sharded as S
from repro_torch.train import trainer as T
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
FAMILIES = ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")
MESHES = [(1, 8), (2, 4), (4, 2)]
EXPERTS = 8
TOL = 1e-5
SEQ, BATCH = 16, 8                     # training
PROMPT, CACHE, STEPS = 16, 32, 3       # serving


def _mesh_id(s):
    return f"{s[0]}x{s[1]}"


def _moe(cfg, experts):
    return cfg.replace(dtype="float32", moe=dataclasses.replace(
        cfg.moe, num_experts=experts))


def _cfg(name, experts=EXPERTS):
    return _moe(SMOKES[name], experts)


def _jcfg(name, experts=EXPERTS):
    return _moe(J_SMOKES[name], experts)


def _params(name, tp):
    """The reference's seed-0 parameters at model degree ``tp``, numpy."""
    return jax.tree.map(np.asarray, jbuild(_jcfg(name), tp=tp).init_params(0))


def _batch(cfg):
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), generator=g,
                           dtype=torch.int32)
    labels = tokens[:, 1:].clone()
    labels[0, :3] = -1
    return {"tokens": tokens[:, :-1].contiguous(), "labels": labels}


def _step(name, mesh_shape):
    """(mesh step, params laid out, batch) of the 8-expert smoke."""
    cfg = _cfg(name)
    d, m = mesh_shape
    mesh = make_host_mesh(devices=[CPU] * (d * m), shape=mesh_shape)
    api = build(cfg, tp=m)
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    with L.use_mesh(mesh):
        pspecs = api.param_pspecs()
        parts = T.MeshStep(api, O.AdamWConfig(), mesh, param_specs=pspecs,
                           opt_specs=O.opt_pspecs(api.param_defs(),
                                                  zero1=False,
                                                  dp_axes=("data",),
                                                  dp_size=d),
                           batch_specs=api.input_pspecs(shape))
    params = S.lay_out_tree(api.params_from_numpy(_params(name, m), CPU),
                            S.layouts(mesh, pspecs))
    return parts, params, _batch(cfg)


def _whole(laid):
    coords = laid.layout.coords()
    out = torch.full(laid.shape, float("nan"))
    for j, b in enumerate(laid.blocks):
        if b is not None:
            out[laid.layout.block_slices(laid.shape, coords[j])] = b
    assert not torch.isnan(out).any()
    return out


def _hold(got, want, what):
    for i, (a, w) in enumerate(zip(got, want)):
        a, w = np.asarray(a), np.asarray(w)
        assert a.shape == w.shape, (what, i, a.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(a - w).max())
        assert err <= TOL * scale, (what, i, err, scale)


def _split_grads(name, mesh_shape, split=True):
    parts, params, batch = _step(name, mesh_shape)
    assert parts.split
    parts.split = split
    with L.use_mesh(parts.mesh):
        loss, met, grads = parts.grads(params, batch)
    whole = [_whole(g) if isinstance(g, S.Laid) else g
             for g in L.tree_leaves(grads)]
    return float(loss), float(met["xent"]), [g.numpy() for g in whole]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("name", FAMILIES)
def test_split_train_step_equals_the_gathered_step(name, mesh_shape):
    """The loss, cross-entropy and every gradient leaf of one micro-batch,
    with E/tp experts a slot at every degree."""
    loss, xent, grads = _split_grads(name, mesh_shape)
    want_loss, want_xent, want = _split_grads(name, mesh_shape, split=False)
    np.testing.assert_allclose(loss, want_loss, rtol=TOL)
    np.testing.assert_allclose(xent, want_xent, rtol=TOL)
    _hold(grads, want, (name, mesh_shape))


@pytest.mark.parametrize("name", FAMILIES)
def test_split_train_step_equals_the_reference(name):
    """At (1, 8), one data shard: the loss and every gradient leaf of the
    reference's ``train_loss`` under ``jax.value_and_grad``."""
    loss, _, grads = _split_grads(name, (1, 8))
    jcfg = _jcfg(name)
    api = jbuild(jcfg, tp=8)
    jp = jax.tree.map(jax.numpy.asarray, _params(name, 8))
    batch = {k: jax.numpy.asarray(v.numpy())
             for k, v in _batch(_cfg(name)).items()}
    (want_loss, _), want = jax.value_and_grad(api.train_loss, has_aux=True)(
        jp, batch)
    np.testing.assert_allclose(loss, float(want_loss), rtol=TOL)
    _hold(grads, [np.asarray(g) for g in jax.tree.leaves(want)],
          (name, "reference"))


def _steps():
    """(prefill batch, decode batches) in numpy, from a numpy seed."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SMOKES[FAMILIES[0]].vocab_size,
                          (BATCH, PROMPT + STEPS)).astype(np.int32)
    return ({"tokens": tokens[:, :PROMPT]},
            [{"tokens": tokens[:, i:i + 1],
              "lengths": np.full((BATCH,), i, np.int32)}
             for i in range(PROMPT, PROMPT + STEPS)])


def _serve(name, mesh_shape, split=True):
    """MeshServe's prefill and decode steps of the 8-expert smoke on 8 CPU
    slots: (each step's logits, the caches after the last), gathered."""
    d, m = mesh_shape
    api = build(_cfg(name), tp=m)
    mesh = make_host_mesh(devices=[CPU] * (d * m), shape=mesh_shape)
    serve = MeshServe(api, mesh)
    assert serve.split
    serve.split = split
    params = serve.lay_out_params(api.params_from_numpy(_params(name, m),
                                                        CPU))
    caches = serve.init_caches(BATCH, CACHE)
    first, steps = _steps()
    logits = []
    with torch.no_grad():
        for i, batch in enumerate([first] + steps):
            fn = serve.decode if i else serve.prefill
            lg, caches = fn(params, serve.lay_out_inputs(
                {k: torch.from_numpy(v) for k, v in batch.items()}), caches)
            logits.append(S.gather(lg).numpy().copy())
    return logits, [t.numpy() for t in L.tree_leaves(S.gather_tree(caches))]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("name", FAMILIES)
def test_split_serving_equals_the_gathered_step(name, mesh_shape):
    lg, caches = _serve(name, mesh_shape)
    want_lg, want_caches = _serve(name, mesh_shape, split=False)
    _hold(lg, want_lg, (name, mesh_shape, "logits"))
    _hold(caches, want_caches, (name, mesh_shape, "caches"))


@pytest.mark.parametrize("name", FAMILIES)
def test_split_serving_equals_the_references_sharded_jit(spmd_devices, name):
    """At (1, 8): the reference's prefill and decode jitted with the port's
    layouts as NamedShardings on its (1, 8) host mesh."""
    lg, caches = _serve(name, (1, 8))
    jcfg = _jcfg(name)
    api = jbuild(jcfg, tp=8)
    port = MeshServe(build(_cfg(name), tp=8),
                     make_host_mesh(devices=[CPU] * 8, shape=(1, 8)))
    jmesh = j_make_host_mesh(8, shape=(1, 8))

    def ns(spec):
        return NamedSharding(jmesh, JP(*spec))

    defs = api.cache_defs(BATCH, CACHE)
    c_sh = jax.tree.unflatten(
        jax.tree.structure(defs, is_leaf=lambda x: isinstance(x, JL.ParamDef)),
        [ns(p) for p in L.tree_leaves(port.cache_specs(BATCH, CACHE))])
    first, steps = _steps()

    def in_sh(batch):
        return {k: ns(lay.spec) for k, lay in port.input_layouts(
            {k: torch.from_numpy(v) for k, v in batch.items()}).items()}

    jcaches = JL.init_tree(defs)
    with JL.use_mesh(jmesh, ("data",)):
        p_sh = jax.tree.map(ns, api.param_pspecs(),
                            is_leaf=lambda x: isinstance(x, JP))
        jp = _params(name, 8)
        out, jcaches = jax.jit(
            api.prefill, in_shardings=(p_sh, in_sh(first), c_sh),
            out_shardings=(ns(port.logits_spec), c_sh))(jp, first, jcaches)
        want = [np.asarray(out)]
        decode = jax.jit(api.decode,
                         in_shardings=(p_sh, in_sh(steps[0]), c_sh),
                         out_shardings=(ns(port.logits_spec), c_sh))
        for batch in steps:
            out, jcaches = decode(jp, batch, jcaches)
            want.append(np.asarray(out))
    _hold(lg, want, (name, "logits"))
    _hold(caches, [np.asarray(a) for a in jax.tree.leaves(jcaches)],
          (name, "caches"))


def _expert_calls(monkeypatch):
    """Each run of the expert MLPs as (slot, its buffer's experts, storage
    of the ``w_in`` block it is given), through ``ModelRow.run_at``."""
    calls = []
    run_at = S.ModelRow.run_at

    def noted(self, slot, fn, *args, **kwargs):
        if fn is L._moe_experts:
            calls.append((slot, args[0].shape[0],
                          args[2].untyped_storage().data_ptr()))
        return run_at(self, slot, fn, *args, **kwargs)

    monkeypatch.setattr(S.ModelRow, "run_at", noted)
    return calls


@pytest.mark.parametrize("experts,mesh_shape", [(8, (2, 4)), (8, (1, 8)),
                                                (4, (4, 2)), (4, (1, 8))],
                         ids=["8e-2x4", "8e-1x8", "4e-4x2", "4e-1x8"])
@pytest.mark.parametrize("name", FAMILIES)
def test_each_slot_runs_only_its_own_experts(monkeypatch, name, experts,
                                             mesh_shape):
    """A train step and a prefill: every expert MLP runs on the slot that
    holds the ``w_in`` block it computes with, E/tp experts, each of the
    rows' model slots alike, once a layer or more (remat's recompute);
    with 4 experts at degree 8 the
    stacks are whole, and no slot runs a share of them."""
    d, m = mesh_shape
    cfg = _moe(SMOKES[name], experts)
    api = build(cfg, tp=m)
    mesh = make_host_mesh(devices=[CPU] * (d * m), shape=mesh_shape)
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    with L.use_mesh(mesh):
        pspecs = api.param_pspecs()
        parts = T.MeshStep(api, O.AdamWConfig(), mesh, param_specs=pspecs,
                           opt_specs=O.opt_pspecs(api.param_defs(),
                                                  zero1=False,
                                                  dp_axes=("data",),
                                                  dp_size=d),
                           batch_specs=api.input_pspecs(shape))
    own = lambda laid: S.Laid(laid.layout, laid.shape,  # noqa: E731
                              [b.clone() for b in laid.blocks])
    params = L.tree_map(own, S.lay_out_tree(api.init_params(0, CPU),
                                            S.layouts(mesh, pspecs)))
    w_in = [blk["ffn"]["w_in"] for blk in params["stack"]]
    owner = {b.untyped_storage().data_ptr(): j
             for laid in w_in for j, b in enumerate(laid.blocks)}
    split = experts % m == 0
    firsts = S.data_slots(mesh, ("data",))
    for run in ("train", "prefill"):
        calls = _expert_calls(monkeypatch)
        with L.use_mesh(mesh):
            if run == "train":
                parts.grads(params, _batch(cfg))
            else:
                serve = MeshServe(api, mesh)
                with torch.no_grad():
                    serve.prefill(params, serve.lay_out_inputs(
                        {"tokens": _batch(cfg)["tokens"]}),
                        serve.init_caches(BATCH, SEQ))
        monkeypatch.undo()
        if not split:
            assert not calls
            continue
        assert calls
        for slot, n, ptr in calls:
            assert owner[ptr] == slot, (run, slot, owner[ptr])
            assert n == experts // m
        runs = collections.Counter(s for s, _, _ in calls)
        assert set(runs) == {s for i in firsts for s in parts.rows[i]}
        assert len(set(runs.values())) == 1          # remat: a layer twice
        assert min(runs.values()) >= cfg.num_layers
    if not split:
        assert all(laid.layout.spec[1] is None for laid in w_in)
        assert all(tuple(laid.blocks[0].shape)[1] == experts
                   for laid in w_in)
