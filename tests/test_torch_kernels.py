"""The port's kernels (plain versions on the CPU) against the JAX
reference: ``repro.kernels.ref`` and the Pallas kernels in interpret
mode, on the shapes and at the tolerances of ``tests/test_kernels.py``
and ``tests/test_fastpath.py``.  Inputs come from numpy seeds and go to
both packages."""
import importlib
import inspect

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from _hyp import given, settings, st

from repro import kernels as jk
from repro.kernels import ref as jref
from repro.kernels.agg_combine import agg_combine_partial as j_agg_partial
from repro.kernels import ops as j_ops
from repro.kernels.ops import (_sddmm_via_gemm as j_sddmm_via_gemm,
                               _spmm_via_gemm as j_spmm_via_gemm)
from repro_torch import kernels as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ell(rng, n, d, k):
    return (rng.integers(0, n, (d, k)).astype(np.int32),
            rng.integers(0, 2, (d, k)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (100, 130, 70), (128, 128, 128),
                                   (257, 64, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_plain_matches_reference(m, k, n, dtype):
    rng = np.random.default_rng(0)
    a, b = _np(rng, m, k), _np(rng, k, n)
    tol = 1e-5 if dtype == "float32" else 2e-2
    ta, tb = _t(a).to(getattr(torch, dtype)), _t(b).to(getattr(torch, dtype))
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    got = tk.gemm(ta, tb)
    assert got.dtype == ta.dtype                # output in a's dtype
    np.testing.assert_allclose(_f32(got), _f32(jk.gemm(ja, jb)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(tref.gemm_ref(ta, tb)),
                               _f32(jref.gemm_ref(ja, jb)), rtol=tol, atol=tol)


@pytest.mark.parametrize("n,f,d,kk", [(50, 32, 10, 4), (300, 96, 64, 7),
                                      (128, 256, 128, 16)])
@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_spmm_plain_matches_reference(n, f, d, kk, mode):
    rng = np.random.default_rng(1)
    h = _np(rng, n, f)
    nbr, mask = _ell(rng, n, d, kk)
    got = tk.spmm(_t(h), _t(nbr), _t(mask), mode=mode).numpy()
    np.testing.assert_allclose(got, jref.spmm_ref(h, nbr, mask, mode=mode),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jk.spmm(h, nbr, mask, mode=mode),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,f,d,kk", [(60, 32, 20, 3), (130, 64, 40, 8)])
def test_sddmm_plain_matches_reference(n, f, d, kk):
    rng = np.random.default_rng(2)
    h = _np(rng, n, f)
    nbr, mask = _ell(rng, n, d, kk)
    got = tk.sddmm(_t(h), _t(nbr), _t(mask)).numpy()
    np.testing.assert_allclose(got, jref.sddmm_ref(h, nbr, mask),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jk.sddmm(h, nbr, mask),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,f,d,k,o", [(50, 32, 10, 4, 16),
                                       (128, 220, 88, 10, 64)])
def test_agg_combine_plain_matches_reference(n, f, d, k, o):
    """The chain of ``test_fastpath.py::test_agg_combine_fused_kernel_
    matches_chain`` and the Pallas kernel, epilogue on and off."""
    rng = np.random.default_rng(0)
    h = _np(rng, n, f)
    nbr, mask = _ell(rng, n, d, k)
    w = (rng.standard_normal((f, o)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(o) * 0.1).astype(np.float32)
    got = tk.agg_combine(_t(h), _t(nbr), _t(mask), _t(w), _t(b)).numpy()
    g = jnp.take(h, nbr, axis=0) * mask[..., None]
    agg = g.sum(1) / jnp.maximum(mask.sum(1), 1.0)[:, None]
    chain = jnp.maximum(agg @ w + b[None, :], 0.0)
    np.testing.assert_allclose(got, np.asarray(chain), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, jk.agg_combine(h, nbr, mask, w, b),
                               rtol=2e-5, atol=2e-5)
    part = tk.agg_combine_partial(_t(h), _t(nbr), _t(mask), _t(w)).numpy()
    np.testing.assert_allclose(part, j_agg_partial(h, nbr, mask, w),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_lsap_dense_paths_match_reference(mode):
    rng = np.random.default_rng(3)
    h = _np(rng, 40, 16)
    nbr, mask = _ell(rng, 40, 12, 5)
    np.testing.assert_allclose(
        tops._spmm_via_gemm(_t(h), _t(nbr), _t(mask), mode=mode).numpy(),
        j_spmm_via_gemm(h, nbr, mask, mode=mode), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tops._sddmm_via_gemm(_t(h), _t(nbr), _t(mask)).numpy(),
        j_sddmm_via_gemm(h, nbr, mask), rtol=1e-5, atol=1e-5)


def test_named_configs_match_shell():
    """Octa/Lsap/Hetero all compute the same SpMM_Mean (as the reference's
    ``test_dfg.py::test_named_configs_match_shell``)."""
    from repro_torch.core.registry import KernelRegistry
    from repro_torch.core.xbuilder import XBuilder
    rng = np.random.default_rng(0)
    h = _t(_np(rng, 64, 32))
    nbr, mask = map(_t, _ell(rng, 64, 16, 5))
    results = {}
    for name in ("octa", "lsap", "hetero"):
        reg = KernelRegistry()
        tk.program_config(XBuilder(reg), name)
        results[name] = reg.dispatch("SpMM_Mean", h, nbr, mask).numpy()
    np.testing.assert_allclose(results["octa"], results["lsap"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(results["octa"], results["hetero"],
                               rtol=1e-5, atol=1e-5)


def test_hetero_registers_the_ported_kernels_only():
    """Hetero binds every C-kernel the reference's Hetero binds, RMSNorm
    included now that its kernel is ported."""
    vector = tops.hetero_bitstream().kernels
    assert set(vector) == {"SpMM", "SpMM_Mean", "SpMM_Sum", "SDDMM",
                           "RMSNorm", "AggCombine", "AggCombinePartial"}
    assert set(vector) == set(j_ops.hetero_bitstream().kernels)
    assert set(tops.hetero_gemm_bitstream().kernels) == {"GEMM"}


def test_plain_path_on_cpu_launches_nothing():
    rng = np.random.default_rng(4)
    h = _t(_np(rng, 20, 8))
    nbr, mask = map(_t, _ell(rng, 20, 6, 3))
    tk.reset_launch_counts()
    tk.spmm(h, nbr, mask)
    tk.sddmm(h, nbr, mask)
    tk.gemm(h, h.t().contiguous())
    tk.agg_combine(h, nbr, mask, h[:8].t().contiguous(), torch.zeros(8))
    counts = tk.launch_counts()
    assert set(tk.KERNELS) < set(counts)
    assert counts == dict.fromkeys(counts, 0)
    with pytest.raises(ValueError):
        tk.spmm(h, nbr, mask, mode="max")
    with pytest.raises(ValueError):
        tk.sddmm(h[:3], nbr, mask)                 # D > N


@pytest.mark.parametrize("f", [1, 33, 128, 420, 3000, 8192])
@pytest.mark.parametrize("o", [1, 64, 65, 128, 200])
def test_agg_combine_tile_fits_shared_memory(f, o):
    """agg_combine's tile comes from (F, O) alone (never D, so a row's
    bits do not move with the batch), is whole warps, and its aggregate
    and stages of w fit the 227 KB an H100 block may use, at every F up
    to 8192."""
    from repro_torch.kernels.agg_combine import (MAX_SMEM, TILES, agg_tile,
                                                 smem_bytes, threads)
    assert list(inspect.signature(agg_tile).parameters) == ["f", "o"]
    shape = TILES[agg_tile(f, o)]
    rows, cols, tm, bk, stages, warps = shape
    assert smem_bytes(shape, f) <= MAX_SMEM
    assert threads(shape) % 32 == 0 and threads(shape) <= 1024
    assert rows % tm == 0 and 128 % bk == 0 and stages >= 2 and warps >= 1


@pytest.mark.parametrize("f,o,d,blocks,warps", [(420, 128, 3072, 128, 20),
                                                (128, 64, 512, 64, 12)])
def test_agg_combine_tile_fills_the_card_at_the_service_layers(f, o, d,
                                                               blocks, warps):
    """At the GNN main path's two layers the tile gives the blocks and
    warps its docstring claims: 128 blocks of 20 warps at the 3,072-row
    layer (one block an SM, 128 of the H100's 132), 64 of 12 at the
    512-row layer."""
    from repro_torch.kernels.agg_combine import TILES, agg_tile, threads
    shape = TILES[agg_tile(f, o)]
    assert -(-d // shape[0]) == blocks and threads(shape) == 32 * warps


@pytest.mark.parametrize("f,d", [(0, 10), (3, 7), (421, 100), (130, 5),
                                 (420, 1), (1, 1), (8192, 3),
                                 (420, 3072), (128, 512)])
def test_spmm_width_is_a_valid_mapping(f, d):
    """spmm's mapping comes from (F, D) alone (never N) and is one the C
    entry takes: a vector of 4, 2 or 1 floats that divides F; float4s at
    the 3,072-row layer, two floats at the 512-row layer (16,384 float4s
    would leave the card mostly idle)."""
    from repro_torch.kernels.spmm import spmm_width
    assert list(inspect.signature(spmm_width).parameters) == ["f", "d"]
    width = spmm_width(f, d)
    assert width in (4, 2, 1) and f % width == 0
    assert width == {(420, 3072): 4, (128, 512): 2}.get((f, d), width)


def test_agg_combine_tiles_are_generated_into_the_build(monkeypatch):
    """The C entry's switch is generated from the wrapper's TILES, one
    line an index, and the build is keyed by it: another table builds
    another library."""
    from repro_torch.kernels import _build
    agg_combine = importlib.import_module("repro_torch.kernels.agg_combine")
    lines = _build.generated()["agg_tiles.inc"].splitlines()
    assert lines == [f"REPRO_AGG_TILE({i}, {', '.join(map(str, t))})"
                     for i, t in enumerate(agg_combine.TILES)]
    before = _build.build_dir()
    monkeypatch.setattr(agg_combine, "TILES", agg_combine.TILES[:2])
    assert _build.build_dir() != before


def test_plain_versions_are_row_invariant():
    """A row's result does not depend on the rows batched with it — what
    keeps run_batch bit-identical to serial run (torch's own CPU matmul
    does not have this property)."""
    rng = np.random.default_rng(5)
    a, w = _t(_np(rng, 300, 420)), _t(_np(rng, 420, 128))
    full = tref.gemm_ref(a, w)
    for lo, hi in ((0, 1), (7, 40), (100, 300)):
        assert torch.equal(full[lo:hi], tref.gemm_ref(a[lo:hi], w))
    nbr, mask = map(_t, _ell(rng, 300, 64, 10))
    s = tref.spmm_ref(a, nbr, mask)
    assert torch.equal(s[3:9], tref.spmm_ref(a, nbr[3:9], mask[3:9]))


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 48), st.integers(1, 24), st.integers(1, 8))
def test_spmm_property(n, d, kk):
    """Property: SpMM(sum) == dense one-hot matmul for any shape."""
    rng = np.random.default_rng(n * 1000 + d * 10 + kk)
    h = _np(rng, n, 8)
    nbr, mask = _ell(rng, n, d, kk)
    got = tk.spmm(_t(h), _t(nbr), _t(mask), mode="sum").numpy()
    onehot = (np.eye(n, dtype=np.float32)[nbr] * mask[..., None]).sum(1)
    np.testing.assert_allclose(got, onehot @ h, rtol=1e-4, atol=1e-4)
