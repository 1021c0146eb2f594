"""The port's single-device training against the JAX reference, on the
CPU: ``ModelAPI.train_loss`` and the gradient of every parameter leaf
against ``jax.value_and_grad`` for eight families, AdamW
(``apply_updates``, ``schedule``) and ``make_train_step`` with gradient
accumulation, the rmsnorm and flash_attention kernels' autograd
Functions against autograd through their plain versions, checkpoints
restored across the two packages, ``synth_batch``, the int8
error-feedback compressed mean over a mesh's slots, the trainer's
fault-resume determinism, and the launcher.  Inputs come from numpy
seeds; weights are the reference's, carried across with
``params_from_numpy``.

Tolerances: the loss within 1e-5 relative and every gradient leaf within
1e-4 of its largest element in fp32 (the reference's own 1e-4 for model
outputs); 2e-2 of each leaf's own largest element in bf16.  In bf16 a
gradient behind a discrete decision (an MoE's top-k routing, relu) or an
exp-scaled path (Mamba's dt) is not a smooth function of the rounding:
one ulp flips a token's expert or a unit's sign.  The rule that picks
such leaves is read off the reference: for the three families with one
(phi3.5-moe, jamba, seamless), a leaf whose bf16 gradient in the
reference differs from the reference's own fp32 gradient by more than
1e-2 of its largest element (``e_ref``).  Such a leaf is held, against
the reference's bf16 gradient and against its fp32 gradient alike, to
2e-2 + e_ref of its largest element: the bar widened by what the
reference's own rounding moves it.  Readings on the CPU (error / own
max; port vs reference bf16, e_ref, port vs reference fp32):
phi3.5-moe's five MoE FFN leaves (ln, router, w_gate, w_in, w_out)
0.25-0.40, 0.24-0.40, 0.005-0.009 (the reference's bf16 routes a token
otherwise; the port's bf16 stays near fp32); jamba's Mamba leaves past
2e-2 (A_log, dt_bias, dt_proj, x_proj; gradients 1e-10 to 1e-15 of the
tree's largest) 0.020-0.037, 0.015-0.036, 0.015-0.024; seamless's two
relu-gated w_gate 0.062 / 0.065, 0.052 / 0.064, 0.062 / 0.062.  Every
other leaf of those families is held to 2e-2 of its own max, as every
leaf of the other five.  AdamW against the reference at 1e-6."""
import functools
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import SMOKES as J_SMOKES
from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as jpipe
from repro.models import build as jbuild
from repro.train import optimizer as JO
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro.train.collectives import compressed_psum_mean as j_compressed
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch import kernels as tk
from repro_torch.configs import SMOKES
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops, ref as tref
from repro_torch.launch import train as ltrain
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build, layers as L
from repro_torch.train import optimizer as O
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.collectives import compressed_psum_mean
from repro_torch.train.trainer import StragglerMonitor, Trainer, \
    loss_and_grads, make_train_step
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
FAMILIES = ["llama3.2-3b", "gemma3-12b", "minicpm3-4b",
            "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b", "xlstm-125m",
            "internvl2-76b", "seamless-m4t-large-v2"]
DISCRETE = {"phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b", "seamless-m4t-large-v2"}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    """Seed-0 parameters as a numpy tree of the reference's structure
    (drawn by the port's ``init_params``: the reference's own takes
    seconds a tree, and the values only need to be the same for both)."""
    return L.tree_map(lambda t: t.numpy(),
                      build(SMOKES[name]).init_params(0, CPU))


def _shape(cfg, seq=16, batch=2):
    if cfg.family == "vlm":
        seq += cfg.num_patches
    return ShapeConfig("t", "train", seq_len=seq, global_batch=batch)


def _jshape(shape):
    return JShape(shape.name, shape.kind, shape.seq_len, shape.global_batch)


def _batch(cfg, shape, step=0):
    """The reference's synthetic batch: numpy arrays."""
    return jpipe.synth_batch(cfg, _jshape(shape), step)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -------------------------------------------- train_loss and every gradient
@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(name, dtype):
    """The reference's (loss, metric keys, gradient leaves as numpy) on
    the seed-0 parameters and the synthetic batch."""
    jcfg = J_SMOKES[name].replace(dtype=dtype)
    batch = _batch(jcfg, _shape(SMOKES[name]))
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        jbuild(jcfg).train_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, _ref_params(name)),
        jax.tree.map(jnp.asarray, batch))
    return float(jloss), sorted(jm), [_f32(g) for g in jax.tree.leaves(jg)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_train_loss_and_gradients_match_reference(name, dtype):
    """The loss, and the gradient of every leaf (the reference's remat and
    the port's checkpointed periods both on, as in the configs)."""
    cfg = SMOKES[name].replace(dtype=dtype)
    jloss, jkeys, jleaves = _ref_loss_and_grads(name, dtype)
    api = build(cfg)
    loss, metrics, grads = loss_and_grads(
        api, api.params_from_numpy(_ref_params(name), CPU),
        _torch(_batch(J_SMOKES[name].replace(dtype=dtype), _shape(cfg))))
    assert sorted(metrics) == jkeys
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(loss), jloss, rtol=tol)
    items = L.tree_items(grads)
    assert len(items) == len(jleaves)
    j32 = _ref_loss_and_grads(name, "float32")[2] \
        if dtype == "bfloat16" and name in DISCRETE else None
    for k, ((path, g), want) in enumerate(zip(items, jleaves)):
        got = _f32(g)
        assert got.shape == want.shape, path
        own = np.abs(want).max()
        err = float(np.abs(got - want).max())
        if dtype == "float32":
            assert err <= 1e-4 * own, (path, err, own)
            continue
        bar = 2e-2
        if j32 is not None:
            own32 = np.abs(j32[k]).max()
            e_ref = float(np.abs(want - j32[k]).max() / own32)
            if e_ref > 1e-2:            # the reference's rounding moves it
                bar += e_ref
                err32 = float(np.abs(got - j32[k]).max())
                assert err32 <= bar * own32, (path, err32 / own32, bar)
        assert err <= bar * own, (path, err / own, bar)


def test_a_cut_gradient_raises_naming_the_leaves(monkeypatch):
    """A norm whose output carries no gradient (as a kernel written into
    a fresh tensor would) leaves the leaves upstream of it without one:
    the step raises instead of training them silently."""
    cfg = SMOKES["llama3.2-3b"]
    api = build(cfg)
    params = api.params_from_numpy(_ref_params(cfg.name), CPU)
    monkeypatch.setattr(ops, "rmsnorm", lambda x, w, eps=1e-6:
                        tref.rmsnorm_ref(x.detach(), w.detach(), eps=eps))
    with pytest.raises(RuntimeError, match=r"no gradient reaches .*"
                                           r"stack/0/mixer/wq"):
        loss_and_grads(api, params, _torch(_batch(cfg, _shape(cfg))))


# ------------------------------------------------------------------ AdamW
def _tree(rng, scale=1.0):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32) * scale,
            "b": {"c": rng.standard_normal(5).astype(np.float32) * scale},
            "d": (rng.standard_normal((2, 2)).astype(np.float32) * scale,)}


@pytest.mark.parametrize("gscale", [0.01, 30.0])
def test_apply_updates_matches_reference(gscale):
    """Three AdamW steps on the same gradients, unclipped and clipped:
    parameters, moments, step, grad_norm and lr at 1e-6."""
    c = O.AdamWConfig(lr=0.1, warmup_steps=2, decay_steps=10)
    jc = JO.AdamWConfig(**c.__dict__)
    rng = np.random.default_rng(20)
    p0 = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p0), L.tree_map(torch.from_numpy, p0)
    js, ts = JO.init_state(jp), O.init_state(tp)
    for _ in range(3):
        g = _tree(rng, gscale)
        jp, js, jm = JO.apply_updates(jc, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = O.apply_updates(c, tp, L.tree_map(torch.from_numpy, g),
                                     ts)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32
    for a, b in zip(L.tree_leaves({"p": tp, "m": ts["m"], "v": ts["v"]}),
                    jax.tree.leaves({"p": jp, "m": js["m"], "v": js["v"]})):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-6, atol=1e-6)


def test_schedule_matches_reference():
    c = O.AdamWConfig(lr=1.0, warmup_steps=10, decay_steps=100)
    steps = np.arange(0, 130, dtype=np.int32)
    got = O.schedule(c, torch.from_numpy(steps)).numpy()
    want = np.asarray(JO.schedule(JO.AdamWConfig(**c.__dict__),
                                  jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert float(O.schedule(c, 1)) < 0.2
    assert float(O.schedule(c, 10)) == pytest.approx(1.0)
    assert float(O.schedule(c, 100)) == pytest.approx(0.1)


def test_adamw_converges_quadratic():
    c = O.AdamWConfig(lr=0.1, warmup_steps=1, decay_steps=1000,
                      weight_decay=0.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = O.init_state(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        g = {"x": 2 * (params["x"] - target)}
        params, state, _ = O.apply_updates(c, params, g, state)
    np.testing.assert_allclose(params["x"].numpy(), target.numpy(), atol=1e-2)


def test_int8_ef_compression_matches_reference_and_reduces_error():
    rng = np.random.default_rng(0)
    g = rng.standard_normal(1000).astype(np.float32)
    err, jerr = torch.zeros(1000), jnp.zeros(1000)
    acc = torch.zeros(1000)
    for _ in range(20):                       # repeated steps: EF compensates
        q, scale, err = O.compress_int8(torch.from_numpy(g), err)
        jq, jscale, jerr = JO.compress_int8(jnp.asarray(g), jerr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-7)
        np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-6)
        acc = acc + O.decompress_int8(q, scale)
    rel = float(torch.linalg.norm(acc - 20 * torch.from_numpy(g))
                / torch.linalg.norm(20 * torch.from_numpy(g)))
    assert rel < 1e-2, rel


def test_train_step_with_grad_accum_matches_reference():
    """Two micro-batches summed, then one AdamW step (the trainer's default
    configuration), from the same fp32 parameters: loss, grad_norm and lr
    at 1e-6 relative, every new parameter within 1e-6; the moments carry
    the accumulated gradient, held at the gradients' bar (1e-4 of each
    leaf's largest element: two frameworks' backward passes sum in other
    orders, 1.2e-6 apart here)."""
    cfg = SMOKES["llama3.2-3b"].replace(dtype="float32")
    jcfg = J_SMOKES["llama3.2-3b"].replace(dtype="float32")
    c = O.AdamWConfig()
    jp = _ref_params(cfg.name)
    batch = _batch(jcfg, _shape(cfg, seq=8, batch=4))
    jstep = jax.jit(j_make_train_step(jbuild(jcfg), JO.AdamWConfig(),
                                      grad_accum=2))
    jparams = jax.tree.map(jnp.asarray, jp)
    jnew, jstate, jm = jstep(jparams, JO.init_state(jparams),
                             jax.tree.map(jnp.asarray, batch))
    api = build(cfg)
    params = api.params_from_numpy(jp, CPU)
    new, state, m = make_train_step(api, c, grad_accum=2)(
        params, O.init_state(params), _torch(batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    for key in ("m", "v"):
        for a, b in zip(L.tree_leaves(state[key]),
                        jax.tree.leaves(jstate[key])):
            b = _f32(b)
            assert np.abs(_f32(a) - b).max() <= 1e-4 * np.abs(b).max()
    for a, b in zip(L.tree_leaves(new), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=0, atol=1e-6)
    for a, b in zip(L.tree_leaves(params), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(_f32(a), b)        # left as it was


# ------------------------------------------------ the kernels' Functions
@pytest.mark.parametrize("shape", [(3, 5, 8), (4, 33)])
def test_rmsnorm_function_gradcheck(shape):
    """The closed-form backward in float64 against finite differences of
    the plain version, through the wrapper ``kernels.ops`` exposes."""
    g = torch.Generator().manual_seed(21)
    x = torch.randn(shape, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(shape[-1], generator=g, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: ops.rmsnorm(a, b, eps=1e-6), (x, w))


ATTN_CASES = [(2, 2, 9, 9, True, 0), (4, 2, 9, 9, True, 3),
              (6, 2, 7, 7, False, 0), (3, 1, 12, 12, True, 5),
              (2, 2, 5, 8, False, 2)]


@pytest.mark.parametrize("hq,hkv,t,s,causal,window", ATTN_CASES)
def test_flash_attention_function_gradcheck(hq, hkv, t, s, causal, window):
    """The backward (P rebuilt under the causal and window mask, dk and dv
    summed over each KV head's G query heads) in float64 against finite
    differences of the plain version; GQA at G = 1, 2, 3."""
    g = torch.Generator().manual_seed(22)
    q = torch.randn(2, hq, t, 8, generator=g, dtype=torch.float64,
                    requires_grad=True)
    k, v = (torch.randn(2, hkv, s, 8, generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.flash_attention(a, b, c, causal=causal,
                                            window=window), (q, k, v))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_functions_match_autograd_through_the_plain_versions(dtype, tol):
    """fp32 and bf16: the Functions' gradients against autograd through
    ``rmsnorm_ref`` and ``attention_ref`` on the same inputs and output
    gradients, relative to each gradient's largest element."""
    gen = torch.Generator().manual_seed(23)

    def r(*shape):
        return torch.randn(*shape, generator=gen).to(dtype)

    def grads(fn, args, dy):
        args = [a.detach().requires_grad_(True) for a in args]
        return torch.autograd.grad(fn(*args), args, dy)

    cases = [(lambda x, w: ops.rmsnorm(x, w, eps=1e-6),
              lambda x, w: tref.rmsnorm_ref(x, w, eps=1e-6),
              [r(4, 7, 32), torch.randn(32, generator=gen)], r(4, 7, 32))]
    for causal, window in ((True, 0), (True, 4), (False, 0)):
        cases.append((
            lambda q, k, v, c=causal, w=window: ops.flash_attention(
                q, k, v, causal=c, window=w),
            lambda q, k, v, c=causal, w=window: tref.attention_ref(
                q, k, v, causal=c, window=w),
            [r(2, 4, 11, 16), r(2, 2, 11, 16), r(2, 2, 11, 16)],
            r(2, 4, 11, 16)))
    for fn, plain, args, dy in cases:
        for got, want in zip(grads(fn, args, dy), grads(plain, args, dy)):
            assert got.dtype == want.dtype
            bar = tol * float(want.float().abs().max())
            assert float((got.float() - want.float()).abs().max()) <= bar


def test_decode_attention_refuses_a_gradient():
    """No training path decodes: asked for a gradient, the wrapper raises
    rather than return a result cut from the graph."""
    q = torch.randn(1, 2, 8, requires_grad=True)
    pages = torch.randn(2, 4, 1, 8)
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    lengths = torch.tensor([6], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        tk.decode_attention(q, pages, pages, table, lengths)
    with torch.no_grad():
        tk.decode_attention(q, pages, pages, table, lengths)


# ------------------------------------------------------------ checkpoints
def _ckpt_tree(rng):
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "stack": (rng.standard_normal(5).astype(np.float32),
                                 {"b": np.arange(6, dtype=np.int32)})},
            "opt": {"step": np.asarray(7, np.int32),
                    "m": rng.standard_normal(2).astype(np.float32)}}


def test_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path):
    tree = _ckpt_tree(np.random.default_rng(24))
    Checkpointer(str(tmp_path)).save(5, L.tree_map(torch.from_numpy, tree),
                                     blocking=True)
    got, step = JCheckpointer(str(tmp_path)).restore(
        jax.tree.map(jnp.asarray, tree))
    assert step == 5
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path):
    tree = _ckpt_tree(np.random.default_rng(25))
    ck = JCheckpointer(str(tmp_path))
    ck.save(9, jax.tree.map(jnp.asarray, tree))           # async writer
    ck.wait()
    got, step = Checkpointer(str(tmp_path)).restore(tree, device=CPU)
    assert step == 9
    for a, b in zip(L.tree_leaves(got), jax.tree.leaves(tree)):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)
        assert a.numpy().dtype == b.dtype


def test_checkpoint_roundtrip_atomicity_and_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(10), "b": {"c": torch.ones((3, 3))},
            "stack": (torch.zeros(4), torch.full((2,), 7.0))}
    for s in (3, 7, 11):
        ck.save(s, tree)
    ck.wait()
    assert ck.committed_steps() == [7, 11]     # keep=2 collected step 3
    got, step = ck.restore(tree, device=CPU)
    assert step == 11
    for a, b in zip(L.tree_leaves(tree), L.tree_leaves(got)):
        assert torch.equal(a, b)
    os.remove(tmp_path / "step_11" / "COMMIT")  # uncommitted: invisible
    assert ck.committed_steps() == [7]
    leaf = tmp_path / "step_7" / "b__c.npy"
    np.save(leaf, np.load(leaf) + 1)
    with pytest.raises(IOError, match="b/c"):
        ck.restore(tree, step=7, device=CPU)


def test_checkpoint_bf16_leaf_raises_naming_its_key(tmp_path):
    tree = {"p": {"w": torch.ones(3, dtype=torch.bfloat16)}}
    with pytest.raises(TypeError, match="p/w"):
        Checkpointer(str(tmp_path / "port")).save(1, tree, blocking=True)
    JCheckpointer(str(tmp_path / "ref")).save(
        1, {"p": {"w": jnp.ones(3, jnp.bfloat16)}}, blocking=True)
    with pytest.raises(TypeError, match="p/w"):
        Checkpointer(str(tmp_path / "ref")).restore(tree, device=CPU)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("name", sorted(SMOKES))
def test_synth_batch_is_the_reference_bit_for_bit(name):
    cfg = SMOKES[name]
    shape = _shape(cfg, seq=24, batch=4)
    for step in (0, 3):
        got = tpipe.synth_batch(cfg, shape, step, seed=5)
        want = jpipe.synth_batch(J_SMOKES[name], _jshape(shape), step,
                                 seed=5)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_replays_the_stream_from_its_start_step():
    cfg = SMOKES["llama3.2-3b"]
    shape = _shape(cfg)
    pipe = tpipe.Pipeline(cfg, shape, seed=2, start_step=4)
    try:
        for step in (4, 5, 6):
            got_step, batch = pipe.next()
            assert got_step == step
            want = tpipe.synth_batch(cfg, shape, step, seed=2)
            np.testing.assert_array_equal(batch["tokens"], want["tokens"])
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()


# ------------------------------------------------------ compressed mean
def test_compressed_psum_mean_matches_reference_on_8_slots(spmd_devices):
    """The port's 8 CPU slots against the reference's 8 forced host
    devices: shared max scale, int32 sum in slot order, mean and new
    error on every slot, within 1e-6."""
    rng = np.random.default_rng(26)
    g = {"w": rng.standard_normal((8, 64)).astype(np.float32),
         "b": rng.standard_normal((8, 3, 5)).astype(np.float32)}
    e = {k: 0.01 * rng.standard_normal(v.shape).astype(np.float32)
         for k, v in g.items()}
    jmesh = jax.make_mesh((8,), ("data",))
    jmean, jerr = j_compressed(jmesh, "data")(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    f = compressed_psum_mean(Mesh(["cpu"] * 8, ("data",)), "data")
    slot = lambda t, s: {k: torch.from_numpy(v[s:s + 1])  # noqa: E731
                         for k, v in t.items()}
    means, errs = f([slot(g, s) for s in range(8)],
                    [slot(e, s) for s in range(8)])
    for k in g:
        np.testing.assert_allclose(
            np.concatenate([m[k].numpy() for m in means]),
            np.asarray(jmean[k]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            np.concatenate([r[k].numpy() for r in errs]),
            np.asarray(jerr[k]), rtol=1e-6, atol=1e-6)


def test_compressed_psum_mean_single_shard_and_groups():
    """The reference's own single-shard case (mean ~= g, mean + err == g
    within 1e-6), and a (2, 4) mesh, whose four groups along "data" each
    hold the mean of their own two slots."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((1, 64)).astype(np.float32))
    f = compressed_psum_mean(Mesh(["cpu"], ("data",)), "data")
    (mean,), (err,) = f([{"w": g}], [{"w": torch.zeros(1, 64)}])
    np.testing.assert_allclose(mean["w"].numpy(), g.numpy(), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose((mean["w"] + err["w"]).numpy(), g.numpy(),
                               rtol=1e-6, atol=1e-6)
    mesh = Mesh(np.array(["cpu"] * 8).reshape(2, 4), ("data", "model"))
    gs = [{"w": torch.full((3,), float(s))} for s in range(8)]
    means, _ = compressed_psum_mean(mesh, "data")(
        gs, [{"w": torch.zeros(3)} for _ in range(8)])
    for s in range(8):
        j = s % 4                                  # slots j and 4 + j
        np.testing.assert_allclose(means[s]["w"].numpy(), (2 * j + 4) / 2,
                                   rtol=1e-2)


# ---------------------------------------------------------------- trainer
def test_trainer_fault_resume_is_deterministic(tmp_path):
    cfg = SMOKES["llama3.2-3b"]
    shape = ShapeConfig("t", "train", seq_len=16, global_batch=2)
    api = build(cfg, tp=1)

    def mk():
        return Trainer(api, shape, opt_cfg=None, ckpt_dir=str(tmp_path),
                       ckpt_every=5, seed=3, device=CPU)

    t1 = mk()                                   # uninterrupted, 10 steps
    t1.run(10)
    losses_ref = [m["loss"] for m in t1.metrics_log]
    shutil.rmtree(tmp_path)
    os.makedirs(tmp_path)

    t2 = mk()                                   # fails at step 7
    with pytest.raises(RuntimeError, match="injected fault"):
        t2.run(10, fault_hook=lambda s: s == 7)
    t2.ckpt.wait()
    assert [m["step"] for m in t2.metrics_log] == list(range(7))
    np.testing.assert_allclose([m["loss"] for m in t2.metrics_log][:5],
                               losses_ref[:5], rtol=1e-5)
    t3 = mk()                                   # resumes from step 5
    assert t3.ckpt.latest_step() == 5
    _, opt, step = t3.run(5)
    assert step == 10 and int(opt["step"]) == 10
    assert [m["step"] for m in t3.metrics_log] == list(range(5, 10))
    np.testing.assert_allclose([m["loss"] for m in t3.metrics_log],
                               losses_ref[5:10], rtol=1e-5)


def test_straggler_monitor():
    m = StragglerMonitor(factor=2.0)
    for _ in range(5):
        m.observe(0, 1.0)
    assert not m.flagged
    assert m.observe(6, 5.0) is True
    assert len(m.flagged) == 1


def test_tiny_overfit():
    """The loss falls by more than 0.5 over 15 steps on a repeated batch
    (``tests/test_models.py::test_tiny_overfit``)."""
    cfg = SMOKES["llama3.2-3b"]
    api = build(cfg, tp=1)
    params = api.init_params(0, CPU)
    opt = O.init_state(params)
    step = make_train_step(api, O.AdamWConfig(lr=3e-3, warmup_steps=2,
                                              decay_steps=100))
    batch = _torch(tpipe.synth_batch(cfg, _shape(cfg), 0))
    losses = []
    for _ in range(15):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    tr = ltrain.main(["--smoke", "--device", "cpu", "--steps", "3",
                      "--seq", "32", "--batch", "4", "--ckpt",
                      str(tmp_path), "--ckpt-every", "2"])
    assert tr.api.cfg.name == "xlstm-125m"
    assert [m["step"] for m in tr.metrics_log] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)
    assert tr.ckpt.committed_steps() == [2, 3]
    assert "finished at step 3" in capsys.readouterr().out
