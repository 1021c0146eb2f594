"""The port's recurrent mixers against the JAX reference, on the CPU:
``mamba_apply`` (jamba's selective SSM), ``mlstm_apply`` and
``slstm_apply`` (xlstm's blocks) in train, prefill and decode mode on the
SMOKE configs' layers, their caches leaf for leaf, the in-place cache
contract the port's decoder relies on, and the cached path against the
port's own full forward.  Inputs come from numpy seeds;
weights are the reference's, carried across with ``params_from_numpy``.

Tolerances: 1e-5 in fp32 for a single layer, as for the attention layers
(``tests/test_torch_dense.py``), and 2e-2 in bf16."""
import functools
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import SMOKES as J_SMOKES
from repro.models import build as jbuild, mamba as JM, xlstm as JX
from repro_torch.configs import SMOKES
from repro_torch.models import build, layers as L, mamba as M, \
    transformer as T, xlstm as X
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B = 2
# mixer kind -> (arch, position in the period, reference apply, port apply)
MIXERS = {"mamba": ("jamba-v0.1-52b", 0, JM.mamba_apply, M.mamba_apply),
          "mlstm": ("xlstm-125m", 0, JX.mlstm_apply, X.mlstm_apply),
          "slstm": ("xlstm-125m", 5, JX.slstm_apply, X.slstm_apply)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    return jax.tree.map(np.asarray, jbuild(J_SMOKES[name]).init_params(0))


def _layer(kind, dtype):
    """(reference cfg, port cfg, the layer's mixer params in numpy)."""
    name, pos, _, _ = MIXERS[kind]
    jp = jax.tree.map(lambda a: a[0], _ref_params(name)["stack"][pos]
                      ["mixer"])
    return (J_SMOKES[name].replace(dtype=dtype),
            SMOKES[name].replace(dtype=dtype), jp)


def _random_cache(cfg, kind, rng):
    """A cache of the kind's shapes filled from ``rng`` (a sane state:
    positive normalisers, finite stabilisers)."""
    defs = T.block_cache_defs(cfg, kind, B, 0, tp=1)

    def leaf(d):
        a = rng.standard_normal(d.shape).astype(np.float32)
        return np.abs(a) + 0.5 if kind == "slstm" else a
    return L.tree_map(leaf, defs)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_matches_reference(kind, mode, dtype):
    """One layer's output, and the cache it leaves (prefill, decode),
    against the reference; the port writes the cache it is given."""
    jcfg, cfg, jp = _layer(kind, dtype)
    _, _, japply, apply = MIXERS[kind]
    tp = L.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.default_rng(11)
    t = 1 if mode == "decode" else 9
    x = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)
    dt = getattr(torch, dtype)
    jc = tc = None
    if mode != "train":
        c = _random_cache(cfg, kind, rng)
        cdt = {k: d.dtype for k, d in T.block_cache_defs(
            cfg, kind, B, 0, tp=1).items()}
        jc = {k: jnp.asarray(v, jnp.dtype(cdt[k])) for k, v in c.items()}
        tc = {k: torch.from_numpy(v).to(getattr(torch, cdt[k]))
              for k, v in c.items()}
    want, jnew = japply(jp, jnp.asarray(x, jnp.dtype(dtype)), jcfg,
                        cache=jc)
    got, tnew = apply(tp, torch.from_numpy(x).to(dt), cfg, cache=tc)
    assert got.dtype == dt
    _close(got, want, TOL[dtype], f"{kind} {mode}")
    if mode == "train":
        assert tnew is None and jnew is None
        return
    assert tnew is tc                              # written in place
    for key in jnew:
        _close(tc[key], jnew[key], TOL[dtype], f"{kind} {mode} cache {key}")


@pytest.mark.parametrize("kind", list(MIXERS))
def test_recurrent_prefill_then_decode_continues_the_scan(kind):
    """Prefill of 7 tokens, then 3 decode steps from the cache it wrote,
    equal the train-mode scan over all 10 tokens (fp32, 1e-5)."""
    _, cfg, jp = _layer(kind, "float32")
    apply = MIXERS[kind][3]
    tp = L.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (B, 10, cfg.d_model)).astype(np.float32))
    full, _ = apply(tp, x, cfg)
    cache = L.init_tree(T.block_cache_defs(cfg, kind, B, 0, tp=1), 0, CPU)
    outs = [apply(tp, x[:, :7], cfg, cache=cache)[0]]
    for i in range(7, 10):
        outs.append(apply(tp, x[:, i:i + 1], cfg, cache=cache)[0])
    _close(torch.cat(outs, dim=1), full, 1e-5, kind)


@pytest.mark.parametrize("kind", list(MIXERS))
def test_decoder_raises_if_a_mixer_returns_a_fresh_cache(kind, monkeypatch):
    """The reference's mixers return a new cache; the port's decoder
    keeps the tree it was given, so a mixer that returned a fresh one
    would leave the caches at zeros.  ``decoder_forward`` raises."""
    name = MIXERS[kind][0]
    cfg = SMOKES[name]
    api = build(cfg)
    params = api.params_from_numpy(_ref_params(name), CPU)
    module, fn = (M, "mamba_apply") if kind == "mamba" else (X, f"{kind}_apply")
    original = getattr(module, fn)

    def returns_a_copy(*args, **kwargs):
        y, cache = original(*args, **kwargs)
        return y, None if cache is None else L.tree_map(torch.clone, cache)

    monkeypatch.setattr(module, fn, returns_a_copy)
    caches = L.init_tree(api.cache_defs(B, 16), 0, CPU)
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (B, 5)).astype(np.int32))
    with pytest.raises(RuntimeError, match=f"the {kind} mixer returned a new "
                                           "cache"):
        api.prefill(params, {"tokens": toks}, caches)
    x = L.embed_apply(params["embed"], toks, cfg)
    T.decoder_forward(params, cfg, x)             # no cache: nothing to hold


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "xlstm-125m"])
def test_recurrent_cache_defs_match_reference(name):
    """Every cache leaf's shape and dtype, jamba's attention layer too."""
    jdefs = jbuild(J_SMOKES[name]).cache_defs(B, 24)
    defs = build(SMOKES[name]).cache_defs(B, 24)
    jl = jax.tree.leaves(jdefs, is_leaf=lambda d: hasattr(d, "shape"))
    tl = L.tree_leaves(defs)
    assert [(tuple(d.shape), str(d.dtype)) for d in jl] == \
        [(tuple(d.shape), d.dtype) for d in tl]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "xlstm-125m"])
def test_cached_path_matches_full_forward_on_the_cpu(name, dtype):
    """Prefill of 12 tokens and 5 decode steps against the port's own full
    forward over all 17 (jamba's MoE at a capacity that drops nothing):
    fp32 within 1e-4; bf16 within 1e-2 of the logits' scale, since the
    CPU's products do not change their order with the rows (on the card
    they do, and the bf16 runs are compared there, not gated)."""
    cfg = SMOKES[name].replace(dtype=dtype)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    api = build(cfg)
    params = api.params_from_numpy(_ref_params(name), CPU)
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (B, 17)).astype(np.int32))
    x, _, _ = T.decoder_forward(params, cfg,
                                L.embed_apply(params["embed"], toks, cfg))
    full = L.logits_apply(params["embed"], x, cfg).float()[:, 11:]
    caches = L.init_tree(api.cache_defs(B, 32), 0, CPU)
    lg, caches = api.prefill(params, {"tokens": toks[:, :12]}, caches)
    got = [lg[:, 0].float()]
    lengths = torch.full((B,), 12, dtype=torch.int32)
    for i in range(12, 17):
        lg, caches = api.decode(params, {"tokens": toks[:, i:i + 1],
                                         "lengths": lengths}, caches)
        got.append(lg[:, 0].float())
        lengths = lengths + 1
    got = torch.stack(got, dim=1)
    if dtype == "float32":
        _close(got, full, 1e-4, name)
    else:
        assert float((got - full).abs().max()) <= \
            1e-2 * float(full.abs().max())
