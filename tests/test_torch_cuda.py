"""The port's CUDA kernels against their plain versions, on the card.

Imports torch, numpy and ``repro_torch`` only (no JAX), so it runs on the
machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test skips on a host without CUDA.  Shapes are those of
``tests/test_kernels.py`` and ``tests/test_fastpath.py``, tolerances the
reference's own (1e-5 fp32, 2e-2 bf16, 2e-5 agg_combine).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _r(rng, *shape, device, dtype=torch.float32):
    return torch.tensor(rng.standard_normal(shape), dtype=dtype, device=device)


def _ell(rng, n, d, k, device):
    nbr = torch.tensor(rng.integers(0, n, (d, k)), dtype=torch.int32,
                       device=device)
    mask = torch.tensor(rng.integers(0, 2, (d, k)), dtype=torch.float32,
                        device=device)
    return nbr, mask


def _close(got, want, tol):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n,scale", [(8, 16, 8, 1.0), (100, 130, 70, 1.0),
                                         (128, 128, 128, 1.0),
                                         (257, 64, 33, 1.0),
                                         (6144, 420, 128, 0.1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_kernel_matches_plain(cuda, m, k, n, scale, dtype):
    """The reference's shapes with its N(0,1) inputs, and the service's
    layer-0 transform with glorot-scale weights (|w| ~ 0.1)."""
    rng = np.random.default_rng(0)
    a = _r(rng, m, k, device=cuda, dtype=dtype)
    b = (_r(rng, k, n, device=cuda) * scale).to(dtype)
    before = kernels.launch_counts()["gemm"]
    got = kernels.gemm(a, b)
    assert got.dtype == dtype and kernels.launch_counts()["gemm"] == before + 1
    _close(got, ref.gemm_ref(a, b).to(dtype), 1e-5 if dtype == torch.float32
           else 2e-2)


@pytest.mark.parametrize("n,f,d,kk", [(50, 32, 10, 4), (300, 96, 64, 7),
                                      (128, 256, 128, 16), (65536, 420, 6144, 10)])
@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_spmm_kernel_matches_plain_bitwise(cuda, n, f, d, kk, mode):
    rng = np.random.default_rng(1)
    h = _r(rng, n, f, device=cuda)
    nbr, mask = _ell(rng, n, d, kk, cuda)
    got = kernels.spmm(h, nbr, mask, mode=mode)
    # same rounding order as the plain version, no fused multiply-add
    assert torch.equal(got, ref.spmm_ref(h, nbr, mask, mode=mode))


@pytest.mark.parametrize("n,f,d,kk", [(60, 32, 20, 3), (130, 64, 40, 8),
                                      (65536, 420, 6144, 10)])
def test_sddmm_kernel_matches_plain_bitwise(cuda, n, f, d, kk):
    rng = np.random.default_rng(2)
    h = _r(rng, n, f, device=cuda)
    nbr, mask = _ell(rng, n, d, kk, cuda)
    assert torch.equal(kernels.sddmm(h, nbr, mask), ref.sddmm_ref(h, nbr, mask))


@pytest.mark.parametrize("n,f,d,k,o", [(50, 32, 10, 4, 16),
                                       (128, 220, 88, 10, 64),
                                       (65536, 420, 6144, 10, 128),
                                       (300, 3000, 40, 5, 200)])
def test_agg_combine_kernel_matches_plain(cuda, n, f, d, k, o):
    rng = np.random.default_rng(3)
    h = _r(rng, n, f, device=cuda)
    nbr, mask = _ell(rng, n, d, k, cuda)
    w = _r(rng, f, o, device=cuda) * 0.1
    b = _r(rng, o, device=cuda) * 0.1
    _close(kernels.agg_combine(h, nbr, mask, w, b),
           ref.agg_combine_ref(h, nbr, mask, w, b), 2e-5)
    _close(kernels.agg_combine_partial(h, nbr, mask, w),
           ref.agg_combine_ref(h, nbr, mask, w, None), 2e-5)


def test_kernels_rows_do_not_depend_on_batch(cuda):
    """A row's result is the same bits whatever rows ride with it — the
    property that keeps run_batch bit-identical to serial run."""
    rng = np.random.default_rng(4)
    h = _r(rng, 4000, 420, device=cuda)
    nbr, mask = _ell(rng, 4000, 640, 10, cuda)
    w, b = _r(rng, 420, 128, device=cuda) * 0.1, _r(rng, 128, device=cuda)
    full = kernels.agg_combine(h, nbr, mask, w, b)
    part = kernels.agg_combine(h, nbr[100:117].contiguous(),
                               mask[100:117].contiguous(), w, b)
    assert torch.equal(full[100:117], part)
    g_full = kernels.gemm(h[:640].contiguous(), w)
    g_part = kernels.gemm(h[33:97].contiguous(), w)
    assert torch.equal(g_full[33:97], g_part)
    s_full = kernels.spmm(h, nbr, mask, mode="mean")
    assert torch.equal(s_full[5:6], kernels.spmm(h, nbr[5:6].contiguous(),
                                                 mask[5:6].contiguous()))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(5)
    h = _r(rng, 50, 32, device=cuda)
    nbr, mask = _ell(rng, 50, 10, 4, cuda)
    with pytest.raises(TypeError):
        kernels.spmm(h.double(), nbr, mask)
    with pytest.raises(TypeError):
        kernels.spmm(h, nbr.long(), mask)
    with pytest.raises(ValueError):
        kernels.spmm(h, nbr, mask.cpu())
    with pytest.raises(ValueError):
        kernels.gemm(h.t(), h)
    with pytest.raises(ValueError):
        kernels.sddmm(h[:5].contiguous(), nbr, mask)
