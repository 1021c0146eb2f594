"""The port's dense-cache LM path against the JAX reference, on the CPU:
``ModelAPI.prefill`` / ``decode`` of every family (GQA with the local
ring cache, MLA, MoE, VLM, encoder-decoder, and the recurrent ones:
jamba's Mamba with attention and MoE, xlstm's mLSTM and sLSTM) at SMOKE
sizes, the caches they fill, the cached path against the port's own full
forward,
and the layers under it (``attn_apply`` in each mode, ``mla_apply``,
``moe_apply``, ``encode`` / ``decode_stack``), the routes ``_sdpa`` takes
on the card run through the kernels' plain versions, and the dense
cache's page view.  Inputs come from numpy seeds; weights are the
reference's, carried across with ``params_from_numpy``.

Tolerances: 1e-4 in fp32 (the reference's own, ``tests/test_models.py``)
and 2e-2 in bf16, the dtype every config computes in (bf16 products
round where the two frameworks' matmuls order their sums differently),
1e-5 for single layers in fp32."""
import functools
from math import gcd

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import SMOKES as J_SMOKES
from repro.models import build as jbuild, encdec as JE, layers as JL
from repro_torch import kernels as tk
from repro_torch.configs import SMOKES
from repro_torch.models import build, encdec as E, layers as L, \
    transformer as T
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
FAMILIES = ["llama3.2-3b", "gemma3-12b", "gemma3-27b", "minicpm3-4b",
            "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e", "internvl2-76b",
            "seamless-m4t-large-v2", "jamba-v0.1-52b", "xlstm-125m"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, PROMPT, STEPS, SEQ = 2, 12, 5, 32


def _f32(x):
    if isinstance(x, torch.Tensor):                # a copy, not a view
        return x.detach().float().numpy().copy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol,
                               err_msg=what)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))              # writable, contiguous
    return t if dtype is None else t.to(dtype)


def _cfgs(name, dtype):
    return (J_SMOKES[name].replace(dtype=dtype),
            SMOKES[name].replace(dtype=dtype))


@functools.lru_cache(maxsize=None)
def _params(name, dtype):
    """The reference's seed-0 parameters: its tree, and the port's."""
    jcfg, cfg = _cfgs(name, dtype)
    jp = jax.tree.map(np.asarray, jbuild(jcfg, tp=1).init_params(0))
    return jp, build(cfg).params_from_numpy(jp, CPU)


def _inputs(cfg, seed=0):
    """Tokens (B, PROMPT + STEPS), and frames or patches where the family
    takes them, from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (B, PROMPT + STEPS)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, 10, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _prefix(cfg):
    return cfg.num_patches if cfg.family == "vlm" else 0


@functools.lru_cache(maxsize=None)
def _reference_run(name, dtype):
    """The reference's prefill then STEPS decode steps (jitted): logits
    of each and the caches right after prefill, in numpy."""
    jcfg, _ = _cfgs(name, dtype)
    api = jbuild(jcfg, tp=1)
    params = jax.tree.map(jnp.asarray, _params(name, dtype)[0])
    inp = _inputs(jcfg)
    toks = jnp.asarray(inp["tokens"])
    caches = JL.init_tree(api.cache_defs(B, SEQ + _prefix(jcfg)))
    batch = {"tokens": toks[:, :PROMPT]}
    for key in ("frames", "patches"):
        if key in inp:
            batch[key] = jnp.asarray(inp[key])
    out = jax.jit(api.prefill)(params, batch, caches)
    logits, caches = [np.asarray(out[0][:, 0].astype(jnp.float32))], out[1]
    enc_out = out[2] if jcfg.family == "encdec" else None
    after_prefill = jax.tree.map(lambda a: _f32(a), caches)
    decode = jax.jit(api.decode)
    lengths = jnp.full((B,), PROMPT + _prefix(jcfg), jnp.int32)
    for i in range(PROMPT, PROMPT + STEPS):
        batch = {"tokens": toks[:, i:i + 1], "lengths": lengths}
        if enc_out is not None:
            batch["enc_out"] = enc_out
        lg, caches = decode(params, batch, caches)
        logits.append(np.asarray(lg[:, 0].astype(jnp.float32)))
        lengths = lengths + 1
    return logits, after_prefill


@functools.lru_cache(maxsize=None)
def _port_run(name, dtype):
    """The port's prefill then STEPS decode steps on the CPU: logits of
    each and a copy of the caches right after prefill (they are written
    in place)."""
    _, cfg = _cfgs(name, dtype)
    api = build(cfg)
    params = _params(name, dtype)[1]
    inp = _inputs(cfg)
    toks = _t(inp["tokens"])
    caches = L.init_tree(api.cache_defs(B, SEQ + _prefix(cfg)), 0, CPU)
    batch = {"tokens": toks[:, :PROMPT]}
    for key in ("frames", "patches"):
        if key in inp:
            batch[key] = _t(inp[key])
    out = api.prefill(params, batch, caches)
    assert out[1] is caches                       # written in place
    logits = [_f32(out[0][:, 0])]
    enc_out = out[2] if cfg.family == "encdec" else None
    after_prefill = L.tree_map(lambda a: _f32(a), caches)
    lengths = torch.full((B,), PROMPT + _prefix(cfg), dtype=torch.int32)
    for i in range(PROMPT, PROMPT + STEPS):
        batch = {"tokens": toks[:, i:i + 1], "lengths": lengths}
        if enc_out is not None:
            batch["enc_out"] = enc_out
        lg, caches = api.decode(params, batch, caches)
        logits.append(_f32(lg[:, 0]))
        lengths = lengths + 1
    return logits, after_prefill


# ------------------------------------------------- ModelAPI against reference
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_decode_matches_reference(name, dtype):
    """Prefill and 5 decode steps: every step's logits."""
    want, _ = _reference_run(name, dtype)
    got, _ = _port_run(name, dtype)
    for step, (a, b) in enumerate(zip(got, want)):
        _close(a, b, TOL[dtype], f"{name} {dtype} step {step}")


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_caches_match_reference(name, dtype):
    """The caches after prefill, leaf for leaf (the local ring's rolled
    layout, MLA's compressed KV, the encoder-decoder's self caches)."""
    _, want = _reference_run(name, dtype)
    _, got = _port_run(name, dtype)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        _close(a, b, TOL[dtype], f"{name} {dtype}")


# ------------------------------------------- cached path against full forward
def _full_forward(cfg, params, inp, total):
    """Teacher-forced logits over the first ``total`` tokens, no cache."""
    toks = _t(inp["tokens"][:, :total])
    if cfg.family == "encdec":
        enc = E.encode(params, cfg, _t(inp["frames"]))
        x = L.embed_apply(params["embed"], toks, cfg)
        x, _ = E.decode_stack(params, cfg, x, enc)
        return L.logits_apply(params["embed"], x, cfg)
    x = L.embed_apply(params["embed"], toks, cfg)
    if cfg.family == "vlm":
        x = torch.cat([_t(inp["patches"]).to(x.dtype), x], dim=1)
    x, caches, _ = T.decoder_forward(params, cfg, x)
    assert caches is None
    return L.logits_apply(params["embed"], x[:, _prefix(cfg):], cfg)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_decode_matches_full_forward(name):
    """The port's prefill + decode against its own full forward in fp32,
    as ``tests/test_models.py::test_prefill_decode_matches_full`` and
    ``test_encdec_prefill_decode`` hold the reference: 1e-4, 5e-2 for the
    capacity MoEs (a token's drop depends on the batch it is routed in)."""
    _, cfg = _cfgs(name, "float32")
    got, _ = _port_run(name, "float32")
    ref = _full_forward(cfg, _params(name, "float32")[1], _inputs(cfg),
                        PROMPT + STEPS)
    tol = 5e-2 if cfg.moe is not None else 1e-4
    for step, lg in enumerate(got):
        _close(lg, ref[:, PROMPT - 1 + step], tol, f"{name} step {step}")


@pytest.mark.parametrize("dtype", list(TOL))
def test_local_ring_cache_past_window(dtype):
    """gemma3 (window 8): a 4-token prompt, then 26 decode steps far past
    the window, against the full forward
    (``test_models.py::test_local_ring_cache_past_window``); bf16 at
    2e-2, where the one-token and the full products round apart."""
    _, cfg = _cfgs("gemma3-12b", dtype)
    api = build(cfg)
    params = _params("gemma3-12b", dtype)[1]
    rng = np.random.default_rng(1)
    toks = _t(rng.integers(0, cfg.vocab_size, (1, 30)).astype(np.int32))
    x = L.embed_apply(params["embed"], toks, cfg)
    x, _, _ = T.decoder_forward(params, cfg, x)
    ref = L.logits_apply(params["embed"], x, cfg)
    caches = L.init_tree(api.cache_defs(1, 64), 0, CPU)
    _, caches = api.prefill(params, {"tokens": toks[:, :4]}, caches)
    lengths = torch.full((1,), 4, dtype=torch.int32)
    for i in range(4, 30):
        lg, caches = api.decode(params, {"tokens": toks[:, i:i + 1],
                                         "lengths": lengths}, caches)
        _close(lg[:, 0], ref[:, i], TOL[dtype], f"position {i}")
        lengths = lengths + 1


# ----------------------------------------------------------------- layers
ATTN_MODES = ["plain", "full", "nope", "local_plain", "prefill",
              "prefill_local_short", "prefill_local_roll", "decode",
              "decode_local", "cross"]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("mode", ATTN_MODES)
def test_attn_apply_matches_reference(mode, dtype):
    """Every mode of ``attn_apply`` on gemma3's smoke layer (window 8):
    no cache (causal, full, ``nope``, local), prefill into a global cache
    and a local ring shorter and longer than the prompt (the roll), a
    decode step with ragged offsets into each, cross-attention; outputs
    and caches, fp32 at 1e-5, bf16 at 2e-2."""
    jcfg, cfg = _cfgs("gemma3-12b", dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    jp = jax.tree.map(lambda a: a[0], _params("gemma3-12b", dtype)[0]
                      ["stack"][0]["mixer"])
    tp = L.tree_map(lambda a: _t(a), jp)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(2)
    t = {"decode": 1, "decode_local": 1, "prefill_local_short": 5}.get(mode,
                                                                      13)
    x = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.dtype(dtype)), _t(x, dt)
    kw = {}
    kind = {"nope": "nope", "local_plain": "local",
            "prefill_local_short": "local", "prefill_local_roll": "local",
            "decode_local": "local"}.get(mode, "attn")
    kw["kind"] = kind
    if mode == "full":
        kw["causal"] = False
    jc = tc = None
    if mode.startswith(("prefill", "decode")):
        s = cfg.window_size if kind == "local" else 24
        c = rng.standard_normal((B, s, cfg.num_kv_heads,
                                 cfg.resolved_head_dim)).astype(np.float32)
        jc = {"k": jnp.asarray(c, jnp.dtype(dtype)),
              "v": jnp.asarray(c[::-1], jnp.dtype(dtype))}
        tc = {"k": _t(c, dt), "v": _t(c[::-1], dt)}
    if mode.startswith("decode"):
        off = np.asarray([3, 17], np.int32)
        kw["cache_len"] = off
        kw["positions"] = off[:, None]
    jkw = dict(kw)
    tkw = dict(kw)
    if "cache_len" in kw:
        jkw["cache_len"] = jnp.asarray(kw["cache_len"])
        jkw["positions"] = jnp.asarray(kw["positions"])
        tkw["cache_len"] = _t(kw["cache_len"])
        tkw["positions"] = _t(kw["positions"])
    if mode == "cross":
        e = rng.standard_normal((B, 9, cfg.d_model)).astype(np.float32)
        je, te = jnp.asarray(e, jnp.dtype(dtype)), _t(e, dt)
        jkw["kv_override"] = JE._cross_kv(jp, je, jcfg)
        tkw["kv_override"] = E._cross_kv(tp, te, cfg)
    want, jnew = JL.attn_apply(jp, jx, jcfg, cache=jc, **jkw)
    got, tnew = L.attn_apply(tp, tx, cfg, cache=tc, **tkw)
    assert got.dtype == dt
    _close(got, want, tol, mode)
    if jc is not None:
        assert tnew is tc                          # written in place
        _close(tnew["k"], jnew["k"], tol, mode)
        _close(tnew["v"], jnew["v"], tol, mode)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("mode", ["plain", "prefill", "decode"])
def test_mla_apply_matches_reference(mode, dtype):
    """MLA (minicpm3 smoke): no cache, prefill from offset 0, a decode
    step with ragged offsets; the output and the compressed caches."""
    jcfg, cfg = _cfgs("minicpm3-4b", dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    jp = jax.tree.map(lambda a: a[0], _params("minicpm3-4b", dtype)[0]
                      ["stack"][0]["mixer"])
    tp = L.tree_map(lambda a: _t(a), jp)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    t = 1 if mode == "decode" else 11
    x = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)
    m = cfg.mla
    jc = tc = None
    jkw, tkw = {}, {}
    if mode != "plain":
        ckv = rng.standard_normal((B, 20, m.kv_lora_rank)).astype(np.float32)
        kr = rng.standard_normal((B, 20, m.qk_rope_head_dim)).astype(
            np.float32)
        jc = {"ckv": jnp.asarray(ckv, jnp.dtype(dtype)),
              "krope": jnp.asarray(kr, jnp.dtype(dtype))}
        tc = {"ckv": _t(ckv, dt), "krope": _t(kr, dt)}
    if mode == "prefill":
        jkw["cache_len"], tkw["cache_len"] = jnp.zeros((), jnp.int32), 0
    if mode == "decode":
        off = np.asarray([4, 13], np.int32)
        jkw = {"cache_len": jnp.asarray(off),
               "positions": jnp.asarray(off[:, None])}
        tkw = {"cache_len": _t(off), "positions": _t(off[:, None])}
    want, jnew = JL.mla_apply(jp, jnp.asarray(x, jnp.dtype(dtype)), jcfg,
                              cache=jc, **jkw)
    got, tnew = L.mla_apply(tp, _t(x, dt), cfg, cache=tc, **tkw)
    _close(got, want, tol, mode)
    if jc is not None:
        for key in ("ckv", "krope"):
            _close(tnew[key], jnew[key], tol, f"{mode} {key}")


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("name,t", [("phi3.5-moe-42b-a6.6b", 13),
                                    ("llama4-scout-17b-a16e", 13),
                                    ("phi3.5-moe-42b-a6.6b", 40)])
def test_moe_apply_matches_reference(name, t, dtype):
    """Top-2 (phi3.5) and top-1 with a shared expert (llama4); 80 tokens
    on 4 experts pass the capacity (max(8, 1.25 * 80 * 2 / 4) = 50), so
    tokens are dropped; the output and the aux loss."""
    jcfg, cfg = _cfgs(name, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    jp = jax.tree.map(lambda a: a[0], _params(name, dtype)[0]
                      ["stack"][0]["ffn"])
    tp = L.tree_map(lambda a: _t(a), jp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)
    want, jaux = JL.moe_apply(jp, jnp.asarray(x, jnp.dtype(dtype)), jcfg)
    got, aux = L.moe_apply(tp, _t(x, getattr(torch, dtype)), cfg)
    _close(got, want, tol)
    _close(aux, jaux, 1e-5)


def test_moe_ties_route_as_the_reference():
    """Tied router probabilities: experts 1 and 2 have the same router
    column, and every token's scores tie across all four experts for a
    zero token; both packages route ties to the lower index
    (``jax.lax.top_k``), so the outputs agree with distinct experts."""
    jcfg, cfg = _cfgs("phi3.5-moe-42b-a6.6b", "float32")
    jp = jax.tree.map(lambda a: np.array(a[0]),
                      _params("phi3.5-moe-42b-a6.6b", "float32")[0]
                      ["stack"][0]["ffn"])
    jp["router"][:, 2] = jp["router"][:, 1]
    tp = L.tree_map(lambda a: _t(a), jp)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 9, cfg.d_model)).astype(np.float32)
    x[0, :3] = 0.0                                # all four experts tie
    want, jaux = JL.moe_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                              jcfg)
    got, aux = L.moe_apply(tp, _t(x), cfg)
    _close(got, want, 1e-5)
    _close(aux, jaux, 1e-6)
    probs = np.full((3, 5), 0.2, np.float32)
    probs[1, 3] = 0.5
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = L._top_k(_t(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("dtype", list(TOL))
def test_encode_and_decode_stack_match_reference(dtype):
    """The seamless smoke encoder over frames, then the decoder stack over
    tokens with cross-attention, no cache."""
    jcfg, cfg = _cfgs("seamless-m4t-large-v2", dtype)
    jp, tp = _params("seamless-m4t-large-v2", dtype)
    inp = _inputs(cfg)
    jenc = JE.encode(jax.tree.map(jnp.asarray, jp), jcfg,
                     jnp.asarray(inp["frames"]))
    enc = E.encode(tp, cfg, _t(inp["frames"]))
    _close(enc, jenc, TOL[dtype])
    toks = inp["tokens"][:, :PROMPT]
    jx = JL.embed_apply(jp["embed"], jnp.asarray(toks), jcfg)
    jx, _ = JE.decode_stack(jax.tree.map(jnp.asarray, jp), jcfg, jx, jenc)
    x = L.embed_apply(tp["embed"], _t(toks), cfg)
    x, caches = E.decode_stack(tp, cfg, x, enc)
    assert caches is None
    _close(x, jx, TOL[dtype])


# ----------------------------------------- the card's routes, plain versions
@pytest.mark.parametrize("t,window", [(37, 0), (37, 8), (40, 1), (21, 64)])
def test_card_route_prefill_with_window_matches_reference(t, window):
    """``_sdpa``'s card route for prefill (the flash_attention wrapper over
    permuted views, here its plain version ``attention_ref``) with and
    without a window, against the reference's ``_sdpa``."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, t, 2, 3, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, t, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = L._sdpa_on_card(_t(q), _t(k), _t(v), causal=True, window=window,
                          q_pos0=0, kv_len=None, dtype=None)
    _close(got, JL._sdpa(q, k, v, causal=True, window=window), 1e-5)


@pytest.mark.parametrize("causal,window", [(True, 1), (True, 8),
                                           (True, 1024), (False, 5)])
def test_attention_ref_window_matches_reference(causal, window):
    """The flash kernel's plain version with a window against the
    reference's ``_sdpa`` (T = 1100 takes its chunked path only past a
    multiple of 512, so this is its direct form) and the reference
    Pallas kernel's oracle where there is no window to apply."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 1100, 2, 2, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 1100, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = tk.flash_attention(_t(q).reshape(1, 1100, 4, 16).permute(0, 2, 1, 3),
                             _t(k).permute(0, 2, 1, 3),
                             _t(v).permute(0, 2, 1, 3), causal=causal,
                             window=window)
    want = JL._sdpa(q, k, v, causal=causal, window=window)
    _close(got.permute(0, 2, 1, 3).reshape(1, 1100, 2, 2, 16), want, 1e-5)


def _cache(rng, b, s, dtype=np.float32):
    return [rng.standard_normal((b, s, 2, 16)).astype(dtype)
            for _ in range(2)]


@pytest.mark.parametrize("s_len", [2048, 48, 20])
def test_dense_decode_route_matches_reference(s_len):
    """The decode route: the cache viewed as pages of gcd(S, 16) slots
    (16 at S = 2048 and 48, 4 at S = 20), ``decode_attention_ref`` with
    lengths = kv_len, against the reference's ``_sdpa`` with its q_pos0
    and kv_len; and through ``_sdpa_on_card``."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((3, 1, 2, 3, 16)).astype(np.float32)
    kc, vc = _cache(rng, 3, s_len)
    off = np.asarray([0, s_len // 2, s_len - 1], np.int32)
    want = JL._sdpa(q, kc, vc, causal=True, window=0,
                    q_pos0=jnp.asarray(off), kv_len=jnp.asarray(off + 1))
    got = L._cache_as_pages(_t(q), _t(kc), _t(vc), _t(off + 1), None)
    _close(got, want, 1e-5)
    got = L._sdpa_on_card(_t(q), _t(kc), _t(vc), causal=True, window=0,
                          q_pos0=_t(off), kv_len=_t(off + 1), dtype=None)
    _close(got, want, 1e-5)
    assert gcd(s_len, 16) * (s_len // gcd(s_len, 16)) == s_len


@pytest.mark.parametrize("off", [[0, 3], [6, 7], [8, 11], [23, 40]])
def test_ring_page_view_matches_the_reference_mask(off):
    """A local layer's decode over its ring of 8 slots, before it fills,
    as it fills, and after it wraps: the page view with lengths =
    min(off + 1, w) equals the reference's ``_sdpa_mask`` over each
    slot's absolute position."""
    rng = np.random.default_rng(9)
    w = 8
    q = rng.standard_normal((2, 1, 2, 3, 16)).astype(np.float32)
    kc, vc = _cache(rng, 2, w)
    off = np.asarray(off, np.int32)
    n = off + 1
    j = np.arange(w)[None, :]
    abs_pos = j + ((n[:, None] - 1 - j) // w) * w
    visible = (abs_pos >= 0) & (abs_pos < n[:, None]) \
        & (abs_pos <= off[:, None]) & (off[:, None] - abs_pos < w)
    want = JL._sdpa_mask(q, kc, vc, jnp.asarray(visible[:, None, :]))
    lengths = _t(np.minimum(off + 1, w))
    _close(L._cache_as_pages(_t(q), _t(kc), _t(vc), lengths, None), want,
           1e-5)
    _close(L._ring_attention(_t(q), _t(kc), _t(vc), _t(off)), want, 1e-5)


def test_dense_path_on_cpu_launches_nothing():
    """On CPU tensors every wrapper on the path is its plain version."""
    tk.reset_launch_counts()
    _port_run.__wrapped__("gemma3-12b", "float32")
    counts = tk.launch_counts()
    assert set(tk.KERNELS) < set(counts)
    assert counts == dict.fromkeys(counts, 0)
