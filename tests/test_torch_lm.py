"""The port's paged-KV LM serving path against the JAX reference, on the
CPU: the model layers, the three LM kernels' plain versions (against the
Pallas kernels in interpret mode, at the shapes and tolerances of
``tests/test_kernels.py``, plus a G = 3 case for each attention), the
parameter tree, ``PagedLM`` token for token and ``serve``'s continuous
batching.  Inputs and weights come from numpy and go to both packages."""
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import SMOKES as J_SMOKES
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.rmsnorm import rmsnorm as j_rmsnorm
from repro.launch import serve as jserve
from repro.models import build as jbuild, layers as JL
from repro.store import pagedkv as jpagedkv
from repro_torch import kernels as tk
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import build, layers as L
from repro_torch.store import pagedkv as tpagedkv
from _torch_threads import one_torch_thread  # noqa: F401

CFG = SMOKES["llama3.2-3b"]
CPU = "cpu"


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _ref_params(cfg, seed):
    return jax.tree.map(np.asarray, jbuild(cfg, tp=1).init_params(seed))


@pytest.fixture(scope="module")
def params():
    """The reference's smoke parameters, in numpy and in the port."""
    ref = _ref_params(CFG, 0)
    return ref, build(CFG).params_from_numpy(ref, CPU)


# ------------------------------------------------------------ model layers
def test_configs_are_the_references():
    assert ARCHS.keys() == J_SMOKES.keys()
    for name, cfg in SMOKES.items():
        assert repr(cfg) == repr(J_SMOKES[name])
    full = ARCHS["llama3.2-3b"]
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size,
            full.tie_embeddings) == (28, 3072, 24, 8, 128, 8192, 128256, True)


@pytest.mark.parametrize("shape", [(2, 5, 64), (7, 3072)])
def test_rms_norm_matches_reference(shape):
    rng = np.random.default_rng(0)
    x, w = _np(rng, *shape), _np(rng, shape[-1])
    _close(L.rms_norm(_t(x), _t(w), 1e-6), JL.rms_norm(x, w, 1e-6), 1e-5)


@pytest.mark.parametrize("pos_shape", [(9,), (3, 1)])
@pytest.mark.parametrize("dim", [16, 128])
def test_rope_matches_reference(pos_shape, dim):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 64, pos_shape).astype(np.int32)
    cos, sin = L.rope_tables(_t(pos, torch.int32), dim, 5e5)
    jcos, jsin = JL.rope_tables(jnp.asarray(pos), dim, 5e5)
    _close(cos, jcos, 1e-5)
    _close(sin, jsin, 1e-5)
    x = _np(rng, 3, 9 if len(pos_shape) == 1 else 1, 4, dim)
    _close(L.apply_rope(_t(x), cos, sin), JL.apply_rope(x, jcos, jsin), 1e-5)


@pytest.mark.parametrize("t,s,causal,window", [
    (9, 9, True, 0), (33, 33, False, 0), (20, 20, True, 8),
    (1536, 1536, True, 0), (1536, 1536, True, 700)])
def test_sdpa_matches_reference(t, s, causal, window):
    """Causal, full and windowed; T = 1536 takes both packages' chunked
    path (q chunks of 512)."""
    rng = np.random.default_rng(2)
    q, k, v = _np(rng, 1, t, 2, 2, 16), _np(rng, 1, s, 2, 16), \
        _np(rng, 1, s, 2, 16)
    got = L._sdpa(_t(q), _t(k), _t(v), causal=causal, window=window)
    _close(got, JL._sdpa(q, k, v, causal=causal, window=window), 1e-5)


def test_sdpa_with_cache_lengths_matches_reference():
    """Per-sequence q offsets and kv lengths (the dense-cache decode form)."""
    rng = np.random.default_rng(3)
    q, k, v = _np(rng, 3, 1, 2, 3, 16), _np(rng, 3, 12, 2, 16), \
        _np(rng, 3, 12, 2, 16)
    off = np.asarray([2, 7, 11], np.int32)
    got = L._sdpa(_t(q), _t(k), _t(v), causal=True, window=0,
                  q_pos0=_t(off, torch.int32), kv_len=_t(off + 1, torch.int32))
    want = JL._sdpa(q, k, v, causal=True, window=0, q_pos0=jnp.asarray(off),
                    kv_len=jnp.asarray(off + 1))
    _close(got, want, 1e-5)


def test_mlp_embed_logits_match_reference(params):
    jp, tp = params
    rng = np.random.default_rng(4)
    x = _np(rng, 2, 5, CFG.d_model)
    ffn_j = jax.tree.map(lambda a: a[0], jp["stack"][0]["ffn"])
    ffn_t = L.tree_map(lambda a: a[0], tp["stack"][0]["ffn"])
    _close(L.mlp_apply(ffn_t, _t(x), CFG), JL.mlp_apply(ffn_j, x, CFG), 1e-5)
    _close(L.logits_apply(tp["embed"], _t(x), CFG),
           JL.logits_apply(jp["embed"], x, CFG), 1e-5)
    toks = rng.integers(0, CFG.vocab_size, (2, 7)).astype(np.int32)
    got = L.embed_apply(tp["embed"], _t(toks, torch.int32), CFG)
    want = JL.embed_apply(jp["embed"], jnp.asarray(toks), CFG)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # bit for bit: the same round-to-nearest-even of the same fp32 rows
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_bf16_layer0_promotes_as_jax_does(params):
    """Layer 0 sees the bf16 embedding: its norm stays bf16 and each
    product with an fp32 weight is fp32, as under JAX's promotion."""
    jp, tp = params
    x = L.embed_apply(tp["embed"], torch.tensor([[1, 2, 3]]), CFG)
    pm = L.tree_map(lambda a: a[0], tp["stack"][0]["mixer"])
    xn = L.rms_norm(x, pm["ln"], CFG.norm_eps)
    q = L.einsum("btd,dhk->bthk", xn, pm["wq"])
    jx = JL.embed_apply(jp["embed"], jnp.asarray([[1, 2, 3]]), CFG)
    jpm = jax.tree.map(lambda a: a[0], jp["stack"][0]["mixer"])
    jxn = JL.rms_norm(jx, jpm["ln"], CFG.norm_eps)
    jq = jnp.einsum("btd,dhk->bthk", jxn, jpm["wq"])
    assert (xn.dtype, q.dtype) == (torch.bfloat16, torch.float32)
    assert (jxn.dtype, jq.dtype) == (jnp.bfloat16, jnp.float32)
    _close(q, jq, 1e-5)


# ------------------------------------------- kernels' plain versions vs Pallas
@pytest.mark.parametrize("b,f", [(3, 64), (17, 256), (64, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(b, f, dtype):
    rng = np.random.default_rng(5)
    x, w = _np(rng, b, f), _np(rng, f)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    got = tk.rmsnorm(_t(x, tdt), _t(w, tdt))
    assert got.dtype == tdt
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    _close(got, j_rmsnorm(jx, jw), tol)
    _close(tref.rmsnorm_ref(_t(x, tdt), _t(w, tdt)), jref.rmsnorm_ref(jx, jw),
           tol)


@pytest.mark.parametrize("b,hq,hkv,t,d", [(1, 2, 2, 64, 32), (2, 4, 2, 100, 64),
                                          (1, 8, 1, 33, 16), (1, 6, 2, 40, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas(b, hq, hkv, t, d, causal):
    """The reference sweep plus G = 3 (6 query heads over 2 KV heads)."""
    rng = np.random.default_rng(6)
    q, k, v = _np(rng, b, hq, t, d), _np(rng, b, hkv, t, d), \
        _np(rng, b, hkv, t, d)
    got = tk.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    _close(got, j_flash(q, k, v, causal=causal, bq=32, bk=32), 3e-5)
    _close(got, jref.attention_ref(q, k, v, causal=causal), 3e-5)


def test_flash_bf16_numerics_fit_the_reference():
    """The bf16 kernel's numerics, as its plain version computes them on
    the CPU (fp32 scores, P rounded to bf16 before P.V: the one rounding
    the fp32 arithmetic does not make; fp32 sums), against the
    reference's Pallas kernel in interpret mode, in bf16, at gemma3's
    head dim, causal: within the bf16 gate of 2e-2."""
    rng = np.random.default_rng(0)
    q, k, v = _np(rng, 1, 4, 300, 256), _np(rng, 1, 2, 300, 256), \
        _np(rng, 1, 2, 300, 256)
    tq, tk_, tv = (_t(x, torch.bfloat16) for x in (q, k, v))
    got = tk.flash_attention(tq, tk_, tv, causal=True)
    assert got.dtype == torch.bfloat16
    # P is rounded: the plain version is not the fp32 softmax rounded once
    assert not torch.equal(got, tref.attention_ref(
        tq.float(), tk_.float(), tv.float(), causal=True).bfloat16())
    want = j_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                   causal=True)
    _close(got, want, 2e-2)


@pytest.mark.parametrize("b,hq,hkv,d,ps,pp", [(2, 4, 2, 32, 8, 4),
                                              (3, 8, 2, 64, 16, 6),
                                              (1, 4, 4, 128, 32, 3),
                                              (2, 6, 2, 32, 8, 5)])
def test_decode_attention_plain_matches_pallas(b, hq, hkv, d, ps, pp):
    """The reference sweep plus G = 3; lengths end mid-page."""
    rng = np.random.default_rng(7)
    p_total = b * pp + 2
    q = _np(rng, b, hq, d)
    kp, vp = _np(rng, p_total, ps, hkv, d), _np(rng, p_total, ps, hkv, d)
    pt = rng.permutation(p_total)[: b * pp].reshape(b, pp).astype(np.int32)
    lengths = rng.integers(1, ps * pp, b).astype(np.int32)
    got = tk.decode_attention(_t(q), _t(kp), _t(vp), _t(pt, torch.int32),
                              _t(lengths, torch.int32))
    _close(got, j_decode(q, kp, vp, pt, lengths), 3e-5)
    _close(got, jref.decode_attention_ref(q, kp, vp, pt, lengths), 3e-5)


def test_plain_lm_kernels_on_cpu_launch_nothing():
    rng = np.random.default_rng(8)
    tk.reset_launch_counts()
    tk.rmsnorm(_t(_np(rng, 4, 8)), _t(_np(rng, 8)))
    tk.flash_attention(*(_t(_np(rng, 1, 2, 5, 16)) for _ in range(3)))
    tk.decode_attention(_t(_np(rng, 1, 2, 16)), _t(_np(rng, 3, 4, 2, 16)),
                        _t(_np(rng, 3, 4, 2, 16)),
                        torch.tensor([[2, 0]], dtype=torch.int32),
                        torch.tensor([5], dtype=torch.int32))
    tk.decode_attention_partial(
        _t(_np(rng, 1, 2, 16)), _t(_np(rng, 3, 4, 2, 16)),
        _t(_np(rng, 3, 4, 2, 16)), torch.tensor([[2, 0]], dtype=torch.int32),
        torch.tensor([5], dtype=torch.int32))
    counts = tk.launch_counts()
    assert set(tk.KERNELS) < set(counts)
    assert counts == dict.fromkeys(counts, 0)


def test_decode_splits_depend_on_the_pools_only():
    """decode_attention's split boundaries come from the pools' page size,
    head dim and element size alone: 4 pages (64 positions) at
    llama3.2-3b's pools, halved only where a split's K and V rows would
    pass the shared-memory budget, so they never move with the batch or
    the table's width."""
    from repro_torch.kernels.decode_attention import (PAGES_PER_SPLIT,
                                                      SPLIT_SMEM,
                                                      pages_per_split)
    assert pages_per_split(16, 128) * 16 == 64 and PAGES_PER_SPLIT == 4
    for ps, d in [(8, 32), (16, 64), (16, 256), (32, 256), (64, 512),
                  (16, 20)]:
        n = pages_per_split(ps, d)
        assert 1 <= n <= PAGES_PER_SPLIT
        assert n == 1 or 2 * n * ps * (-(-d // 4) * 4) * 4 <= SPLIT_SMEM
        if n < PAGES_PER_SPLIT:
            assert 2 * (2 * n) * ps * (-(-d // 4) * 4) * 4 > SPLIT_SMEM
    # bf16 pools: rows of D rounded up to 8 elements, 2 bytes each
    for ps, d in [(16, 256), (32, 512), (64, 512), (16, 20)]:
        n = pages_per_split(ps, d, 2)
        assert n >= pages_per_split(ps, d)
        assert n == 1 or 2 * n * ps * (-(-d // 8) * 8) * 2 <= SPLIT_SMEM
        if n < PAGES_PER_SPLIT:
            assert 2 * (2 * n) * ps * (-(-d // 8) * 8) * 2 > SPLIT_SMEM


def test_partial_split_plan_depends_on_the_pools_only():
    """decode_attention_partial's split: PARTIAL_SPLIT positions (one page
    where a page holds more), halved only where a split's K and V rows
    would pass the shared-memory budget, from the pools' page size, head
    dim and element size alone; the table's width picks only the path,
    one cluster where 1 to CLUSTER_SPLITS splits cover it and a block's
    shared memory holds them (at 8 heads a block).  At the split
    serving step's blocks: gemma3-12b's 128 global and 64 ring positions
    (ps 16, D 256, bf16) one cluster of 8 and of 4; the MoE's 3 positions
    (ps 1, D 128) and jamba's 8 (ps 8) one split; long mode's 1,024 (64
    pages of 16) the split and combine kernels."""
    from repro_torch.kernels.decode_attention import (
        BLOCK_SMEM, CLUSTER_SPLITS, PARTIAL_SPLIT, SPLIT_SMEM, cluster_smem,
        partial_pages_per_split, partial_plan)
    assert PARTIAL_SPLIT == 16 and CLUSTER_SPLITS == 8
    assert partial_plan(16, 256, 2, 8) == (1, 8, True)
    assert partial_plan(16, 256, 2, 4) == (1, 4, True)
    assert partial_plan(1, 128, 2, 3) == (16, 1, True)
    assert partial_plan(8, 128, 2, 1) == (2, 1, True)
    assert partial_plan(16, 256, 2, 64) == (1, 64, False)
    for ps, d, size in [(1, 128, 2), (3, 64, 4), (8, 128, 2), (16, 256, 2),
                        (16, 20, 4), (32, 512, 4), (64, 512, 4),
                        (64, 512, 2)]:
        per = 16 // size
        row = -(-d // per) * per * size
        n = partial_pages_per_split(ps, d, size)
        assert 1 <= n <= max(1, PARTIAL_SPLIT // ps)
        assert n == 1 or 2 * n * ps * row <= SPLIT_SMEM
        if n < max(1, PARTIAL_SPLIT // ps):
            assert 2 * (2 * n) * ps * row > SPLIT_SMEM
        for pp in range(0, 3 * CLUSTER_SPLITS * n):
            pps, n_split, cluster = partial_plan(ps, d, size, pp)
            assert pps == n and n_split == -(-pp // n)
            assert cluster == (1 <= n_split <= CLUSTER_SPLITS and
                               cluster_smem(n, ps, d, size, n_split)
                               <= BLOCK_SMEM)
    # the split serving step's blocks fit a cluster's shared memory
    assert cluster_smem(1, 16, 256, 2, 8) <= cluster_smem(
        1, 16, 512, 4, 8) <= BLOCK_SMEM
    assert not partial_plan(32, 512, 4, 8)[2]     # 128 KB of rows a block


@pytest.mark.parametrize("pp,cluster", [(1, True), (8, True), (9, False),
                                        (40, False)])
def test_partial_allocates_on_meta_what_its_launch_does(pp, cluster):
    """On ``meta`` tensors decode_attention_partial allocates what a CUDA
    launch on its path allocates: out and lse, and the split kernels'
    workspace (B*Hq*n_split*(D+2) fp32) only on the two-kernel path."""
    from repro_torch.kernels.decode_attention import partial_plan
    from repro_torch.launch.memtrace import StepTrace
    meta = torch.device("meta")
    q = torch.empty(3, 8, 64, device=meta)
    pages = torch.empty(50, 16, 2, 64, device=meta)
    table = torch.empty(3, pp, dtype=torch.int32, device=meta)
    lengths = torch.empty(3, dtype=torch.int32, device=meta)
    pps, n_split, path = partial_plan(16, 64, 4, pp)
    assert path == cluster
    with StepTrace() as tr:
        tr.hold((q, pages, table, lengths))
        with torch.no_grad():
            out, lse = tops.decode_attention_partial(q, pages, pages, table,
                                                     lengths)
    ws = 0 if cluster else 3 * 8 * n_split * 66 * 4
    assert tr.peak_bytes - tr.held_bytes == out.nbytes + lse.nbytes + ws
    assert tr.kernel_calls == {"decode_attention_partial": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partial_cost_is_unchanged(dtype):
    """kernels/cost.py counts the partial's work as before its redesign:
    the visible positions' K and V rows and q read once, out and lse
    written in fp32, the table and lengths; 4*Hq*D flops a position."""
    from repro_torch.kernels import cost
    g = torch.Generator().manual_seed(0)
    q = torch.empty(4, 16, 256, dtype=dtype)
    pages = torch.empty(32, 16, 8, 256, dtype=dtype)
    table = torch.zeros(4, 8, dtype=torch.int32)
    lengths = torch.randint(-3, 200, (4,), generator=g, dtype=torch.int32)
    n = int(lengths.clamp(0, 128).sum())
    args = (q, pages, pages, table, lengths)
    size = q.element_size()
    assert cost.lm_call_cost("decode_attention_partial", args, {}) == (
        (2 * n * 8 * 256 + q.numel()) * size + (q.numel() + 64) * 4
        + (32 + 4) * 4, 4.0 * n * 16 * 256)
    assert cost.lm_dot_flops("decode_attention_partial", args, {}) == \
        4.0 * 4 * 16 * 8 * 16 * 256


@pytest.mark.parametrize("f", [1, 17, 64, 3072, 3075, 4096, 8192, 16384])
@pytest.mark.parametrize("rows", [1, 4, 500])
def test_rmsnorm_threads_per_row_hold_the_row(f, rows):
    """The rmsnorm kernel's row split: whole warps or a power-of-two share
    of one, at most 8 vectors of 4 a thread; 128 threads at the prefill
    rows of llama3.2-3b (one wave of blocks), 256 at its decode rows."""
    from repro_torch.kernels.rmsnorm import (MAX_CHUNKS, MAX_THREADS,
                                             threads_per_row)
    t = threads_per_row(f, rows)
    assert 1 <= t <= MAX_THREADS and t * MAX_CHUNKS * 4 >= f
    assert (t <= 32 and 32 % t == 0) or t % 32 == 0
    if f == 3072:
        assert t == (128 if rows == 500 else 256)


# ---------------------------------------------------------- parameter tree
def test_params_from_numpy_round_trips_the_reference_tree(params):
    jp, tp = params
    assert jax.tree.structure(jp) == jax.tree.structure(
        L.tree_map(lambda a: a.numpy(), tp))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(
            L.tree_map(lambda a: a.numpy(), tp))):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    bad = jax.tree.map(lambda a: a, jp)
    bad["embed"]["tokens"] = bad["embed"]["tokens"][:, :3]
    with pytest.raises(ValueError):
        build(CFG).params_from_numpy(bad, CPU)


def test_init_params_has_the_reference_shapes_and_inits(params):
    jp, _ = params
    got = build(CFG).init_params(3, CPU)
    again = build(CFG).init_params(3, CPU)
    for a, b, c in zip(jax.tree.leaves(jp), jax.tree.leaves(
            L.tree_map(lambda t: t.numpy(), got)),
            jax.tree.leaves(L.tree_map(lambda t: t.numpy(), again))):
        assert a.shape == b.shape and b.dtype == np.float32
        np.testing.assert_array_equal(b, c)           # seeded
        if np.all(a == 1.0):                           # norm weights
            assert np.all(b == 1.0)
        else:                                          # same scale
            assert 0.5 < b.std() / a.std() < 2.0


# ------------------------------------------------------------ paged serving
def _generate(engine, prompt, steps=5):
    seq = engine.mgr.add_sequence(0, prompt)
    out = [engine.prefill(seq)]
    seq.generated.append(out[0])
    for _ in range(steps):
        out.append(engine.decode_step([seq])[0])
        seq.generated.append(out[-1])
    return out


@pytest.mark.parametrize("seed,pallas", [(0, False), (1, False), (2, False),
                                         (0, True)])
def test_paged_lm_matches_reference_token_for_token(seed, pallas,
                                                    monkeypatch):
    """Prefill + 5 decode steps (``tests/test_sharding.py``'s paged case)
    on the reference's weights; the reference decodes through its oracle
    or its Pallas kernel.  The KV pools end equal too."""
    if pallas:
        # the reference binds ``dk`` to the package attribute, which is the
        # kernel function rather than its module; hand it the module
        monkeypatch.setattr(jserve, "dk", importlib.import_module(
            "repro.kernels.decode_attention"))
    jp = _ref_params(CFG, seed)
    prompt = list(np.random.default_rng(seed).integers(0, CFG.vocab_size, 9))
    kw = dict(num_pages=32, page_size=4, num_layers=CFG.num_layers,
              num_kv_heads=CFG.num_kv_heads, head_dim=CFG.resolved_head_dim)
    jeng = jserve.PagedLM(J_SMOKES[CFG.name], jax.tree.map(jnp.asarray, jp),
                          jpagedkv.PagePool(**kw), use_pallas=pallas)
    teng = tserve.PagedLM(CFG, build(CFG).params_from_numpy(jp, CPU),
                          tpagedkv.PagePool(**kw, device=CPU))
    assert _generate(teng, prompt) == _generate(jeng, prompt)
    np.testing.assert_allclose(teng.pool.k.numpy(), jeng.pool.k, atol=1e-5)
    np.testing.assert_allclose(teng.pool.v.numpy(), jeng.pool.v, atol=1e-5)


def test_decode_logits_match_the_reference_forward(params):
    """The port's last-position logits after prefill and one decode step
    against the reference's own layer functions, at 1e-4."""
    jp, tp = params
    prompt = list(np.random.default_rng(9).integers(0, CFG.vocab_size, 7))
    pool = tpagedkv.PagePool(num_pages=8, page_size=4,
                             num_layers=CFG.num_layers,
                             num_kv_heads=CFG.num_kv_heads,
                             head_dim=CFG.resolved_head_dim, device=CPU)
    eng = tserve.PagedLM(CFG, tp, pool)
    seq = eng.mgr.add_sequence(0, prompt)
    pre = eng.prefill_logits(seq)
    seq.generated.append(int(torch.argmax(pre)))
    dec = eng.decode_logits([seq])[0]
    # dense forward of the reference over prompt + first token
    toks = jnp.asarray([prompt + seq.generated[:1]])
    x = JL.embed_apply(jp["embed"], toks, CFG)
    cos, sin = JL.rope_tables(jnp.arange(toks.shape[1]), 16, CFG.rope_theta)
    for li in range(CFG.num_layers):
        p = jax.tree.map(lambda a: a[li], jp["stack"][0])
        pm = p["mixer"]
        xn = JL.rms_norm(x, pm["ln"], CFG.norm_eps)
        q, k, v = (jnp.einsum("btd,dhk->bthk", xn, pm[w])
                   for w in ("wq", "wk", "wv"))
        q, k = JL.apply_rope(q, cos, sin), JL.apply_rope(k, cos, sin)
        out = JL._sdpa(q.reshape(1, -1, 2, 2, 16), k, v, causal=True,
                       window=0)
        x = x + jnp.einsum("bthk,hkd->btd", out.reshape(1, -1, 4, 16),
                           pm["wo"])
        x = JL.mlp_apply(p["ffn"], x, CFG)
    want = JL.logits_apply(jp["embed"], x, CFG)[0]
    _close(pre, want[-2], 1e-4)
    _close(dec, want[-1], 1e-4)


def test_serve_matches_reference_batching(params, monkeypatch):
    """``serve``'s continuous batching (6 requests, 4 at a time, page
    size 4): the same tokens per request, the same page tables at every
    decode step and the same allocation count in both packages."""
    jp, tp = params
    tables = {"j": [], "t": []}
    for tag, mod in (("j", jpagedkv), ("t", tpagedkv)):
        orig = mod.PagedKVManager.page_table

        def record(self, seqs, max_pages, _orig=orig, _tag=tag):
            pt = _orig(self, seqs, max_pages)
            tables[_tag].append(pt.copy())
            return pt
        monkeypatch.setattr(mod.PagedKVManager, "page_table", record)
    kw = dict(num_requests=6, prompt_len=7, max_new=6, seed=0, page_size=4,
              num_pages=40, log=lambda *_: None)
    jdone, jstats = jserve.serve(J_SMOKES[CFG.name], **kw)
    tdone, tstats = tserve.serve(CFG, params=tp, device=CPU, **kw)
    assert [(s.sid, s.generated) for s in tdone] == \
        [(s.sid, s.generated) for s in jdone]
    assert len(tables["t"]) == len(tables["j"]) == tstats["decode_steps"]
    for a, b in zip(tables["t"], tables["j"]):
        np.testing.assert_array_equal(a, b)
    assert tstats["pages_alloc"] == jstats["pages_alloc"]
    assert len(tstats["prefill_s"]) == 6


def test_engine_defaults_to_cuda_and_needs_attention_archs():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build(CFG).init_params(0)
        with pytest.raises(RuntimeError, match="CUDA"):
            tpagedkv.PagePool(num_pages=2, page_size=2, num_layers=1,
                              num_kv_heads=1, head_dim=4)
    pool = tpagedkv.PagePool(num_pages=2, page_size=2, num_layers=1,
                             num_kv_heads=1, head_dim=4, device=CPU)
    with pytest.raises(ValueError, match="attention"):
        tserve.PagedLM(SMOKES["xlstm-125m"], {}, pool)


def test_ops_exposes_the_lm_kernels_for_the_path():
    """The LM path calls its kernels as attributes of ``kernels.ops`` (so a
    run can record or swap them), and Hetero binds ``RMSNorm``."""
    assert tops.rmsnorm is tk.rmsnorm
    assert tops.flash_attention is tk.flash_attention
    assert tops.decode_attention is tk.decode_attention
    rng = np.random.default_rng(10)
    x, w = _t(_np(rng, 3, 8)), _t(_np(rng, 8))
    got = tops.hetero_bitstream().kernels["RMSNorm"](x, w)
    assert torch.equal(got, tref.rmsnorm_ref(x, w))


@pytest.mark.parametrize("t,s,causal", [(37, 37, True), (20, 20, False),
                                        (1536, 1536, True)])
def test_sdpa_card_route_reads_the_model_layout(t, s, causal):
    """The route ``_sdpa`` takes on a CUDA tensor (the flash_attention
    wrapper over permuted (B,T,H,D) views), run here through the
    wrapper's plain version, equals the reference's ``_sdpa``, with and
    without a window; what neither kernel takes raises, naming it."""
    rng = np.random.default_rng(11)
    q, k, v = _np(rng, 2, t, 2, 3, 16), _np(rng, 2, s, 2, 16), \
        _np(rng, 2, s, 2, 16)
    got = L._sdpa_on_card(_t(q), _t(k), _t(v), causal=causal, window=0,
                          q_pos0=0, kv_len=None, dtype=None)
    _close(got, JL._sdpa(q, k, v, causal=causal, window=0), 1e-5)
    got = L._sdpa_on_card(_t(q), _t(k), _t(v), causal=True, window=8,
                          q_pos0=0, kv_len=None, dtype=None)
    _close(got, JL._sdpa(q, k, v, causal=True, window=8), 1e-5)
    with pytest.raises(NotImplementedError, match="q_pos0"):
        L._sdpa_on_card(_t(q), _t(k), _t(v), causal=True, window=0,
                        q_pos0=3, kv_len=None, dtype=None)
    with pytest.raises(NotImplementedError, match="kv_len"):
        L._sdpa_on_card(_t(q), _t(k), _t(v), causal=True, window=0,
                        q_pos0=0, kv_len=_t(np.full(2, s, np.int32)),
                        dtype=None)
