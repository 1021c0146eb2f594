"""The port's CUDA kernels against their plain versions, on the card.

Imports torch, numpy and ``repro_torch`` only (no JAX), so it runs on the
machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test skips on a host without CUDA.  Shapes are those of
``tests/test_kernels.py`` and ``tests/test_fastpath.py`` plus the
full-width llama3.2-3b shapes of the LM path, tolerances the reference's
own (1e-5 fp32, 2e-2 bf16, 2e-5 agg_combine, 3e-5 attention).
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import pages_per_split
from repro_torch.kernels.flash_attention import HEAD_DIMS

pytestmark = pytest.mark.cuda

# positions a decode_attention block owns at llama3.2-3b's pools (ps 16, D 128)
SPLIT = pages_per_split(16, 128) * 16


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
                                         (6144, 420, 128, 0.1),
                                         (3072, 420, 128, 0.1),
                                         (3072, 128, 128, 0.1),
                                         (512, 128, 64, 0.1),
                                         (512, 64, 64, 0.1),
                                         (1, 420, 128, 1.0),
                                         (100, 421, 70, 1.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_kernel_matches_plain(cuda, m, k, n, scale, dtype):
    """The reference's shapes with its N(0,1) inputs; the service's
    transforms with glorot-scale weights (|w| ~ 0.1) at the four shapes of
    the GNN main path (3072 x 420 and 3072 x 128 by 128, 512 x 128 by 64,
    512 x 64 by 64); one row; and K = 421, whose rows are not 16-byte
    aligned (bf16 rows at K = 420 are not either)."""
    rng = np.random.default_rng(0)
    a = _r(rng, m, k, device=cuda, dtype=dtype)
    b = (_r(rng, k, n, device=cuda) * scale).to(dtype)
    before = kernels.launch_counts()["gemm"]
    got = kernels.gemm(a, b)
    assert got.dtype == dtype and kernels.launch_counts()["gemm"] == before + 1
    _close(got, ref.gemm_ref(a, b).to(dtype), 1e-5 if dtype == torch.float32
           else 2e-2)


def test_gemm_kernel_at_lsap_depth(cuda):
    """Lsap's one-hot lowering: a (1024 x 16384) aggregation matrix with at
    most 10 nonzero mean weights a row, through the kernel at K = 16384."""
    rng = np.random.default_rng(11)
    n, rows, fanout, f = 16384, 1024, 10, 420
    a = np.zeros((rows, n), np.float32)
    for r in range(rows):
        cols = rng.integers(0, n, fanout)
        keep = rng.integers(0, 2, fanout).astype(bool)
        a[r, cols[keep]] += 1.0 / max(int(keep.sum()), 1)
    a = torch.tensor(a, device=cuda)
    h = _r(rng, n, f, device=cuda)
    _close(kernels.gemm(a, h), ref.gemm_ref(a, h), 1e-5)


def test_gemm_copy_width_does_not_change_bits(cuda):
    """Rows that are not 16-byte aligned take narrower copies: a row slice
    of a K = 421 matrix (1,684 bytes in) and bf16 rows at K = 420 give the
    same bits as an aligned copy of the same numbers."""
    rng = np.random.default_rng(12)
    a = _r(rng, 300, 421, device=cuda)[1:]
    b = _r(rng, 421, 128, device=cuda) * 0.1
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    assert torch.equal(kernels.gemm(a, b), kernels.gemm(a.clone(), b))
    a16 = _r(rng, 301, 420, device=cuda, dtype=torch.bfloat16)[1:]
    b16 = (_r(rng, 420, 64, device=cuda) * 0.1).bfloat16()
    assert a16.data_ptr() % 16 != 0
    assert torch.equal(kernels.gemm(a16, b16), kernels.gemm(a16.clone(), b16))


# (N, F, D, K): the reference's shapes; the two main-path layers; F = 3
# and 421 (a float a thread), F = 6 and 130 (two floats); D = 1, 17 and
# 3073; K = 0, 1, 13 (two rounds of the five gathers a thread holds, then
# a partial one) and 40 (eight rounds, more slots than a warp has lanes)
SPMM_SHAPES = [(50, 32, 10, 4), (300, 96, 64, 7), (128, 256, 128, 16),
               (65536, 420, 6144, 10), (16384, 420, 3072, 10),
               (3072, 128, 512, 10), (200, 3, 70, 5), (500, 421, 100, 10),
               (300, 6, 50, 10), (300, 130, 60, 10), (4000, 420, 1, 10),
               (4000, 420, 17, 10), (4000, 128, 3073, 10),
               (300, 420, 60, 0), (300, 128, 77, 1), (300, 420, 50, 13),
               (300, 420, 50, 40)]


@pytest.mark.parametrize("n,f,d,kk", SPMM_SHAPES)
@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_spmm_kernel_matches_plain_bitwise(cuda, n, f, d, kk, mode):
    """Bit for bit against the plain version (same rounding order, no
    fused multiply-add), with random slots and with slots laid out as the
    sampler pads them (all-masked rows included); one launch a call."""
    rng = np.random.default_rng(1)
    h = _r(rng, n, f, device=cuda)
    for nbr, mask in (_ell(rng, n, d, kk, cuda),
                      _sampled(rng, n, d, kk, cuda, empty=range(0, d, 7))):
        before = kernels.launch_counts()["spmm"]
        got = kernels.spmm(h, nbr, mask, mode=mode)
        assert kernels.launch_counts()["spmm"] == before + 1
        assert torch.equal(got, ref.spmm_ref(h, nbr, mask, mode=mode))


@pytest.mark.parametrize("n,f,d,kk", [(16384, 420, 3072, 10),
                                      (3072, 128, 512, 10), (300, 130, 60, 13)])
def test_spmm_every_width_gives_the_same_bits(cuda, monkeypatch, n, f, d,
                                              kk):
    """Whatever width spmm_width picks (4, 2 or 1 floats a thread), the
    output is spmm_ref's bits: each is forced in turn at the main path's
    layers and at an F that takes two floats a thread."""
    spmm_mod = importlib.import_module("repro_torch.kernels.spmm")
    rng = np.random.default_rng(6)
    h = _r(rng, n, f, device=cuda)
    nbr, mask = _sampled(rng, n, d, kk, cuda, empty=range(0, d, 7))
    want = {m: ref.spmm_ref(h, nbr, mask, mode=m) for m in ("mean", "sum")}
    for width in (4, 2, 1):
        if f % width:
            continue
        monkeypatch.setattr(spmm_mod, "spmm_width", lambda f, d: width)
        for m in ("mean", "sum"):
            assert torch.equal(kernels.spmm(h, nbr, mask, mode=m),
                               want[m]), (width, m)


@pytest.mark.parametrize("f", [420, 128])
@pytest.mark.parametrize("offset", [1, 2])
def test_spmm_copy_width_does_not_change_bits(cuda, f, offset):
    """h 4 or 8 bytes past a 16-byte boundary (a row view of a wider
    buffer) takes one- or two-float gathers; the output has the plain
    version's bits, as from an aligned copy of the same rows."""
    rng = np.random.default_rng(7)
    buf = _r(rng, 3000 * f + offset, device=cuda)
    h = buf[offset:].view(3000, f)
    assert h.data_ptr() % 16 == 4 * offset
    nbr, mask = _sampled(rng, 3000, 300, 10, cuda)
    for mode in ("mean", "sum"):
        got = kernels.spmm(h, nbr, mask, mode=mode)
        assert torch.equal(got, kernels.spmm(h.clone(), nbr, mask, mode=mode))
        assert torch.equal(got, ref.spmm_ref(h, nbr, mask, mode=mode))


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_spmm_index_outside_h_reads_a_zero_row(cuda, mode):
    """Negative indices and indices at or past N read as a zero row: the
    plain version on h with a zero row appended, those slots pointed at
    it, gives the same bits."""
    rng = np.random.default_rng(8)
    n, f, d, k = 500, 420, 90, 10
    h = _r(rng, n, f, device=cuda)
    nbr, mask = _sampled(rng, n, d, k, cuda)
    bad = torch.tensor(rng.random((d, k)) < 0.2, device=cuda)
    wild = torch.tensor(rng.choice([-1, -7, n, n + 3, 2**31 - 1], (d, k)),
                        dtype=torch.int32, device=cuda)
    nbr = torch.where(bad, wild, nbr)
    padded = torch.cat([h, torch.zeros(1, f, device=cuda)])
    inside = torch.where(bad, torch.full_like(nbr, n), nbr)
    assert torch.equal(kernels.spmm(h, nbr, mask, mode=mode),
                       ref.spmm_ref(padded, inside, mask, mode=mode))


@pytest.mark.parametrize("f", [420, 421])
def test_spmm_masked_slot_on_a_nan_row_gives_nan(cuda, f):
    """Masked slots are multiplied by their mask, never skipped: a masked
    slot pointing at a row that holds NaN gives NaN, as in the plain
    version, and the other rows keep their bits."""
    rng = np.random.default_rng(9)
    h = _r(rng, 300, f, device=cuda)
    h[0, 5] = float("nan")
    nbr, mask = _sampled(rng, 300, 40, 10, cuda)     # masked slots -> row 0
    for mode in ("mean", "sum"):
        got = kernels.spmm(h, nbr, mask, mode=mode)
        want = ref.spmm_ref(h, nbr, mask, mode=mode)
        assert got[:, 5].isnan().any()
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


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
    # the gemm tile is 32 rows: a slice from mid-tile and a single row, at
    # N = 128 (32x64 tiles) and N = 64 (32x32 tiles)
    for wn in (w, w[:, :64].contiguous()):
        g_full = kernels.gemm(h[:640].contiguous(), wn)
        assert torch.equal(g_full[45:123], kernels.gemm(h[45:123].contiguous(), wn))
        assert torch.equal(g_full[77:78], kernels.gemm(h[77:78].contiguous(), wn))
    s_full = kernels.spmm(h, nbr, mask, mode="mean")
    assert torch.equal(s_full[5:6], kernels.spmm(h, nbr[5:6].contiguous(),
                                                 mask[5:6].contiguous()))
    # spmm at both layers' widths, a mid-slice of rows against the launch
    for hs in (h, h[:3072, :128].contiguous()):
        nb = (nbr % hs.shape[0]).contiguous()
        s_full = kernels.spmm(hs, nb, mask, mode="sum")
        assert torch.equal(s_full[100:117], kernels.spmm(
            hs, nb[100:117].contiguous(), mask[100:117].contiguous(),
            mode="sum"))
    # agg_combine at the 512-row layer's widths (F 128, O 64), a slice
    # from mid-block; sddmm, whose destination rows are a prefix of h, the
    # first 70 rows alone against the full launch
    h2 = h[:3072, :128].contiguous()
    w2, b2 = w[:128, :64].contiguous(), b[:64].contiguous()
    a_full = kernels.agg_combine(h2, nbr % 3072, mask, w2, b2)
    assert torch.equal(a_full[6:23], kernels.agg_combine(
        h2, (nbr[6:23] % 3072).contiguous(), mask[6:23].contiguous(), w2, b2))
    d_full = kernels.sddmm(h, nbr, mask)
    assert torch.equal(d_full[:70], kernels.sddmm(
        h, nbr[:70].contiguous(), mask[:70].contiguous()))


def _sampled(rng, n, d, k, device, *, empty=()):
    """nbr and mask laid out as the sampler pads them: about a third of
    the slots masked, a masked slot pointing at row 0, and the rows in
    ``empty`` all masked (degree 0)."""
    nbr = rng.integers(0, n, (d, k))
    mask = (rng.random((d, k)) < 0.7).astype(np.float32)
    mask[list(empty)] = 0.0
    nbr[mask == 0] = 0
    return (torch.tensor(nbr, dtype=torch.int32, device=device),
            torch.tensor(mask, device=device))


# (N, F, D, K, O): the two main-path layers, F not a multiple of 4, D not
# a multiple of the block's rows, K = 1 and K = 40 (> 32 lanes), O = 1,
# 65 and 200 (two column tiles, the second ragged), F = 3000 (one row a
# block), F = 0 and K = 0 (a zero aggregate)
AGG_SHAPES = [(16384, 420, 3072, 10, 128), (3072, 128, 512, 10, 64),
              (200, 33, 70, 5, 16), (500, 421, 100, 10, 128),
              (4000, 420, 1, 10, 128), (4000, 420, 17, 10, 128),
              (4000, 420, 3073, 10, 128), (300, 128, 77, 1, 64),
              (300, 420, 50, 40, 128), (300, 128, 60, 10, 1),
              (300, 420, 60, 10, 65), (300, 420, 60, 10, 200),
              (300, 3000, 33, 10, 128), (300, 0, 60, 10, 128),
              (300, 0, 60, 10, 64), (300, 420, 60, 0, 128)]


@pytest.mark.parametrize("n,f,d,k,o", AGG_SHAPES)
@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_agg_combine_kernel_edges(cuda, n, f, d, k, o, mode):
    """Against the plain version at 2e-5, and bit for bit against the
    port's unfused pair (the spmm kernel, then the gemm kernel): the fused
    aggregate is spmm's bits and each output one in-order FMA chain over
    F, as in gemm."""
    rng = np.random.default_rng(21)
    h = _r(rng, n, f, device=cuda)
    nbr, mask = _sampled(rng, n, d, k, cuda, empty=range(0, d, 7))
    w = _r(rng, f, o, device=cuda) * 0.1
    b = _r(rng, o, device=cuda) * 0.1
    before = kernels.launch_counts()["agg_combine"]
    got = kernels.agg_combine(h, nbr, mask, w, b, mode=mode)
    assert kernels.launch_counts()["agg_combine"] == before + 1
    _close(got, ref.agg_combine_ref(h, nbr, mask, w, b, mode=mode), 2e-5)
    part = kernels.agg_combine_partial(h, nbr, mask, w, mode=mode)
    unfused = kernels.gemm(kernels.spmm(h, nbr, mask, mode=mode), w)
    assert torch.equal(part, unfused)
    assert torch.equal(got, torch.relu(unfused + b))
    # all-masked rows: a zero aggregate (mean over degree 0), relu(b) out
    assert torch.equal(got[::7], torch.relu(b).expand(len(got[::7]), o))


@pytest.mark.parametrize("f", [420, 128])
def test_agg_combine_copy_width_does_not_change_bits(cuda, f):
    """h 4 bytes past a 16-byte boundary (a row slice) takes the gather's
    single-float path; the output has the same bits as from an aligned
    copy of the same rows."""
    rng = np.random.default_rng(22)
    buf = _r(rng, 3000 * f + 1, device=cuda)
    h = buf[1:].view(3000, f)
    assert h.data_ptr() % 16 == 4
    nbr, mask = _sampled(rng, 3000, 300, 10, cuda)
    w, b = _r(rng, f, 128, device=cuda) * 0.1, _r(rng, 128, device=cuda)
    got = kernels.agg_combine(h, nbr, mask, w, b)
    assert torch.equal(got, kernels.agg_combine(h.clone(), nbr, mask, w, b))
    _close(got, ref.agg_combine_ref(h, nbr, mask, w, b), 2e-5)


# (N, F, D, K): the two main-path layers, F not a multiple of 4, D = 1,
# 17 and 3073, K = 1 and 40, F = 3000 (column passes of 128 vectors)
SDDMM_SHAPES = [(16384, 420, 3072, 10), (3072, 128, 512, 10),
                (200, 33, 70, 5), (500, 421, 100, 10), (4000, 420, 1, 10),
                (4000, 420, 17, 10), (4000, 420, 3073, 10),
                (300, 128, 77, 1), (300, 420, 50, 40), (300, 3000, 33, 10)]


@pytest.mark.parametrize("n,f,d,k", SDDMM_SHAPES)
def test_sddmm_kernel_edges(cuda, n, f, d, k):
    """Bit for bit against the plain version, all-masked rows included."""
    rng = np.random.default_rng(23)
    h = _r(rng, n, f, device=cuda)
    nbr, mask = _sampled(rng, n, d, k, cuda, empty=range(0, d, 7))
    before = kernels.launch_counts()["sddmm"]
    got = kernels.sddmm(h, nbr, mask)
    assert kernels.launch_counts()["sddmm"] == before + 1
    assert torch.equal(got, ref.sddmm_ref(h, nbr, mask))


@pytest.mark.parametrize("f", [420, 128])
def test_sddmm_copy_width_does_not_change_bits(cuda, f):
    """h 4 bytes past a 16-byte boundary takes single-float loads and
    stores; the output has the same bits as from an aligned copy."""
    rng = np.random.default_rng(24)
    buf = _r(rng, 3000 * f + 1, device=cuda)
    h = buf[1:].view(3000, f)
    assert h.data_ptr() % 16 == 4
    nbr, mask = _sampled(rng, 3000, 500, 10, cuda)
    got = kernels.sddmm(h, nbr, mask)
    assert torch.equal(got, kernels.sddmm(h.clone(), nbr, mask))
    assert torch.equal(got, ref.sddmm_ref(h, nbr, mask))


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


def test_lm_wrappers_refuse_and_lay_out_as_their_meta_branches(cuda):
    """The CUDA branch and the ``meta`` branch (the dry run's) of each LM
    wrapper refuse the same arguments with the same exception, and give
    outputs of the same shape, dtype and strides."""
    meta = torch.device("meta")

    def both(fn, *args, **kw):
        outs = []
        for dev in (cuda, meta):
            try:
                outs.append(fn(*[a.to(dev) for a in args], **kw))
            except (TypeError, ValueError) as e:
                outs.append((type(e), str(e)))
        return outs

    rng = np.random.default_rng(6)
    q = _r(rng, 1, 40, 4, 64, device=cuda).permute(0, 2, 1, 3)
    k = _r(rng, 1, 2, 40, 64, device=cuda)
    table = torch.tensor([[0, 1]], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([20], dtype=torch.int32, device=cuda)
    pages = _r(rng, 2, 16, 2, 64, device=cuda)
    cases = [
        (kernels.rmsnorm, (_r(rng, 3, 64, device=cuda),
                           _r(rng, 64, device=cuda)), {}),
        (kernels.rmsnorm, (_r(rng, 3, 64, device=cuda).half(),
                           _r(rng, 64, device=cuda)), {}),
        (kernels.flash_attention, (q, k, k), {"causal": True}),
        (kernels.flash_attention, (_r(rng, 1, 2, 8, 80, device=cuda),) * 3,
         {}),
        (kernels.decode_attention, (_r(rng, 1, 4, 64, device=cuda), pages,
                                    pages, table, lengths), {}),
        (kernels.decode_attention, (_r(rng, 1, 4, 64, device=cuda), pages,
                                    pages, table.long(), lengths), {}),
    ]
    for fn, args, kw in cases:
        on_card, on_meta = both(fn, *args, **kw)
        if isinstance(on_card, tuple):
            assert on_card == on_meta, (on_card, on_meta)
        else:
            assert (on_card.shape, on_card.dtype, on_card.stride()) == \
                (on_meta.shape, on_meta.dtype, on_meta.stride())


# ------------------------------------------------------- the LM path's kernels
@pytest.mark.parametrize("shape", [(3, 64), (17, 256), (64, 512), (500, 3072),
                                   (4, 1, 3072), (1, 3072), (4096, 3072),
                                   (5, 3075), (2, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    """The reference sweep, the LM's prefill, last-position and decode rows
    at F = 3072, 4096 rows, and F = 3075 and 17 (rows not a whole number
    of 4-element vectors)."""
    rng = np.random.default_rng(6)
    x = _r(rng, *shape, device=cuda, dtype=dtype)
    w = _r(rng, shape[-1], device=cuda)
    before = kernels.launch_counts()["rmsnorm"]
    got = kernels.rmsnorm(x, w)
    assert got.dtype == dtype and got.shape == x.shape
    assert kernels.launch_counts()["rmsnorm"] == before + 1
    _close(got, ref.rmsnorm_ref(x, w), 1e-5 if dtype == torch.float32
           else 2e-2)


@pytest.mark.parametrize("rows", [4, 500])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_copy_width_does_not_change_bits(cuda, rows, dtype):
    """Rows 4 bytes past a 16-byte boundary take element loads and stores;
    the sum of squares runs in the same order, so the output has the same
    bits as from an aligned copy of the same rows."""
    rng = np.random.default_rng(14)
    skip = 4 // torch.tensor([], dtype=dtype).element_size()
    buf = _r(rng, rows * 3072 + skip, device=cuda, dtype=dtype)
    x = buf[skip:].view(rows, 3072)
    w = _r(rng, 3072, device=cuda)
    assert x.data_ptr() % 16 == 4
    got = kernels.rmsnorm(x, w)
    assert torch.equal(got, kernels.rmsnorm(x.clone(), w))
    _close(got, ref.rmsnorm_ref(x, w), 1e-5 if dtype == torch.float32
           else 2e-2)


@pytest.mark.parametrize("b,hq,hkv,t,d", [(1, 2, 2, 64, 32), (2, 4, 2, 100, 64),
                                          (1, 8, 1, 33, 16), (1, 6, 2, 40, 16),
                                          (1, 24, 8, 500, 128),
                                          (1, 4, 2, 1, 64), (1, 6, 2, 65, 128),
                                          (2, 3, 1, 127, 32),
                                          (1, 4, 2, 130, 256),
                                          (2, 6, 2, 500, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(cuda, b, hq, hkv, t, d, causal):
    """The reference sweep, G = 3, llama3.2-3b's prefill (T = 500, 24 heads
    over 8, D = 128), one query, ragged tails one past and one short of
    the 32- and 64-row tiles (T = 65, 127), D = 256 (the largest shared-
    memory footprint) and G = 3 at T = 500."""
    rng = np.random.default_rng(7)
    q = _r(rng, b, hq, t, d, device=cuda)
    k, v = _r(rng, b, hkv, t, d, device=cuda), _r(rng, b, hkv, t, d,
                                                   device=cuda)
    before = kernels.launch_counts()["flash_attention"]
    got = kernels.flash_attention(q, k, v, causal=causal)
    assert kernels.launch_counts()["flash_attention"] == before + 1
    _close(got, ref.attention_ref(q, k, v, causal=causal), 3e-5)


def test_flash_attention_reads_the_model_layout_in_place(cuda):
    """(B,T,H,D) activations go in as permuted views; the output keeps
    that layout and equals the contiguous call."""
    rng = np.random.default_rng(8)
    q = _r(rng, 2, 77, 6, 32, device=cuda).permute(0, 2, 1, 3)
    k = _r(rng, 2, 77, 2, 32, device=cuda).permute(0, 2, 1, 3)
    v = _r(rng, 2, 77, 2, 32, device=cuda).permute(0, 2, 1, 3)
    got = kernels.flash_attention(q, k, v)
    assert got.stride() == q.stride()
    assert torch.equal(got, kernels.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous()))
    _close(got, ref.attention_ref(q, k, v), 3e-5)


def test_flash_attention_copy_width_does_not_change_bits(cuda):
    """Rows 4 bytes past a 16-byte boundary take 4-byte copies; the output
    has the same bits as from aligned copies of the same numbers."""
    rng = np.random.default_rng(13)
    def unaligned(*shape):
        buf = _r(rng, int(np.prod(shape)) + 1, device=cuda)
        return buf[1:].view(*shape)
    q, k, v = unaligned(1, 6, 70, 64), unaligned(1, 2, 70, 64), \
        unaligned(1, 2, 70, 64)
    assert q.data_ptr() % 16 != 0
    got = kernels.flash_attention(q, k, v)
    assert torch.equal(got, kernels.flash_attention(q.clone(), k.clone(),
                                                    v.clone()))
    _close(got, ref.attention_ref(q, k, v), 3e-5)


@pytest.mark.parametrize("window", [0, 1, 8, 1024, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", list(HEAD_DIMS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_window_and_bf16_match_plain(cuda, dtype, d, causal,
                                                     window):
    """Every compiled head dim in bf16 (the dense LM path's operands) and
    fp32, causal and full, windows of 1, 8 and 1024 keys (gemma3's local
    layers), one at least T, and none; T = 1100 is no multiple of the 16-,
    32- or 128-row query tile and passes the 1024 window.  bf16 output is
    held at 2e-2 (the kernel's products on the tensor cores, P rounded to
    bf16; the output rounds once on each side), fp32 at 3e-5."""
    rng = np.random.default_rng(21)
    t = 1100
    q = _r(rng, 1, 4, t, d, device=cuda, dtype=dtype)
    k, v = (_r(rng, 1, 2, t, d, device=cuda, dtype=dtype) for _ in range(2))
    before = kernels.launch_counts()["flash_attention"]
    got = kernels.flash_attention(q, k, v, causal=causal, window=window)
    assert kernels.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype
    _close(got, ref.attention_ref(q, k, v, causal=causal, window=window),
           2e-2 if dtype == torch.bfloat16 else 3e-5)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 129])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 128, 256])
def test_flash_attention_bf16_tile_edges(cuda, t, causal, d):
    """The bf16 tensor-core kernel at one query and one short of, at and
    one past its 64-row warpgroup and 128-row block (and its 64- and
    128-key tiles), at the smallest, the LM's and gemma3's head dims."""
    rng = np.random.default_rng(23)
    q = _r(rng, 1, 4, t, d, device=cuda, dtype=torch.bfloat16)
    k, v = (_r(rng, 1, 2, t, d, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    before = kernels.launch_counts()["flash_attention"]
    got = kernels.flash_attention(q, k, v, causal=causal)
    assert kernels.launch_counts()["flash_attention"] == before + 1
    _close(got, ref.attention_ref(q, k, v, causal=causal), 2e-2)


@pytest.mark.parametrize("s", [1, 37, 64, 129, 300])
@pytest.mark.parametrize("d", [64, 256])
def test_flash_attention_bf16_cross_attention(cuda, s, d):
    """Non-causal with S != T (the encoder-decoder's cross-attention):
    keys fewer and more than the 100 queries, ragged against the tiles."""
    rng = np.random.default_rng(24)
    q = _r(rng, 2, 4, 100, d, device=cuda, dtype=torch.bfloat16)
    k, v = (_r(rng, 2, 4, s, d, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    _close(kernels.flash_attention(q, k, v, causal=False),
           ref.attention_ref(q, k, v, causal=False), 2e-2)


@pytest.mark.parametrize("g", [1, 2, 3, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_query_groups(cuda, g, causal):
    """G = Hq / Hkv of 1 to 4 (llama's 3 is no power of two), 2 KV heads,
    T = 190 (ragged), D = 128."""
    rng = np.random.default_rng(25)
    q = _r(rng, 2, 2 * g, 190, 128, device=cuda, dtype=torch.bfloat16)
    k, v = (_r(rng, 2, 2, 190, 128, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    _close(kernels.flash_attention(q, k, v, causal=causal),
           ref.attention_ref(q, k, v, causal=causal), 2e-2)


@pytest.mark.parametrize("b,hq,hkv,t,d,window", [(4, 16, 8, 1536, 256, 0),
                                                 (4, 16, 8, 1536, 256, 1024),
                                                 (4, 24, 8, 512, 128, 0)])
def test_flash_attention_bf16_main_path_shapes(cuda, b, hq, hkv, t, d,
                                               window):
    """gemma3-12b's prefill (D 256, T 1536; causal, and its local layers'
    window of 1024) and llama3.2-3b's training step (D 128, T 512, G 3),
    in the model's (B, T, H, D) layout, against the plain version."""
    rng = np.random.default_rng(26)
    q = _r(rng, b, t, hq, d, device=cuda,
           dtype=torch.bfloat16).permute(0, 2, 1, 3)
    k, v = (_r(rng, b, t, hkv, d, device=cuda,
               dtype=torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
    got = kernels.flash_attention(q, k, v, window=window)
    assert got.stride() == q.stride()
    _close(got, ref.attention_ref(q, k, v, window=window), 2e-2)


@pytest.mark.parametrize("d", [32, 128, 256])
def test_flash_attention_bf16_reads_the_model_layout_in_place(cuda, d):
    """The bf16 kernel takes permuted (B,T,H,D) views as they are (a
    tensor map over the strides) and gives the contiguous call's bits."""
    rng = np.random.default_rng(27)
    q = _r(rng, 2, 77, 6, d, device=cuda,
           dtype=torch.bfloat16).permute(0, 2, 1, 3)
    k, v = (_r(rng, 2, 77, 2, d, device=cuda,
               dtype=torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
    got = kernels.flash_attention(q, k, v)
    assert got.stride() == q.stride()
    assert torch.equal(got, kernels.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous()))
    _close(got, ref.attention_ref(q, k, v), 2e-2)


@pytest.mark.parametrize("d", [16, 64, 256])
def test_flash_attention_bf16_unaligned_rows_same_bits(cuda, d):
    """bf16 rows 2 bytes past a 16-byte boundary, which TMA refuses, take
    the checked copies into the same shared-memory layout: the output has
    the bits of the TMA path on aligned copies of the same numbers."""
    rng = np.random.default_rng(28)
    def unaligned(*shape):
        buf = _r(rng, int(np.prod(shape)) + 1, device=cuda,
                 dtype=torch.bfloat16)
        return buf[1:].view(*shape)
    q, k, v = unaligned(1, 6, 70, d), unaligned(1, 2, 70, d), \
        unaligned(1, 2, 70, d)
    assert k.data_ptr() % 16 != 0
    got = kernels.flash_attention(q, k, v)
    assert torch.equal(got, kernels.flash_attention(q.clone(), k.clone(),
                                                    v.clone()))
    _close(got, ref.attention_ref(q, k, v), 2e-2)


@pytest.mark.parametrize("d,causal,window", [(64, False, 0), (128, True, 0),
                                             (256, True, 0),
                                             (256, True, 1024)])
def test_flash_attention_bf16_fits_the_fp32_softmax(cuda, d, causal,
                                                    window):
    """The bf16 kernel against the fp32 softmax and fp32 P.V rounded once
    (no rounding of P at all), within the same 2e-2: P in bf16 is the one
    rounding the kernel adds, and it fits the gate."""
    rng = np.random.default_rng(29)
    q = _r(rng, 1, 4, 1100, d, device=cuda, dtype=torch.bfloat16)
    k, v = (_r(rng, 1, 2, 1100, d, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    got = kernels.flash_attention(q, k, v, causal=causal, window=window)
    _close(got, ref.attention_ref(q.float(), k.float(), v.float(),
                                  causal=causal, window=window), 2e-2)


def test_flash_attention_window_at_least_t_is_causal_bits(cuda):
    """A window of T or more hides nothing: the same bits as no window."""
    rng = np.random.default_rng(22)
    q, k, v = (_r(rng, 2, 4, 300, 128, device=cuda, dtype=torch.bfloat16)
               for _ in range(3))
    assert torch.equal(kernels.flash_attention(q, k, v, window=300),
                       kernels.flash_attention(q, k, v))


@pytest.mark.parametrize("b,hq,hkv,d,ps,pp", [(2, 4, 2, 32, 8, 4),
                                              (3, 8, 2, 64, 16, 6),
                                              (1, 4, 4, 128, 32, 3),
                                              (2, 6, 2, 32, 8, 5),
                                              (4, 24, 8, 128, 16, 34)])
def test_decode_attention_kernel_matches_plain(cuda, b, hq, hkv, d, ps, pp):
    """The reference sweep, G = 3 and llama3.2-3b's decode (B = 4, page
    size 16, up to 34 pages); lengths end mid-page, and the table pads
    with page 0, which another sequence owns."""
    rng = np.random.default_rng(9)
    p_total = b * pp + 2
    q = _r(rng, b, hq, d, device=cuda)
    kp, vp = _r(rng, p_total, ps, hkv, d, device=cuda), \
        _r(rng, p_total, ps, hkv, d, device=cuda)
    pt = rng.permutation(p_total)[: b * pp].reshape(b, pp)
    lengths = rng.integers(1, ps * pp, b)
    lengths[0] = ps * (pp // 2) + ps // 2 + 1            # mid-page
    pt[0, pp // 2 + 1:] = 0                              # padded with page 0
    pt_t = torch.tensor(pt, dtype=torch.int32, device=cuda)
    len_t = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = kernels.launch_counts()["decode_attention"]
    got = kernels.decode_attention(q, kp, vp, pt_t, len_t)
    assert kernels.launch_counts()["decode_attention"] == before + 1
    _close(got, ref.decode_attention_ref(q, kp, vp, pt_t, len_t), 3e-5)


def _paged(rng, lengths, *, hq, hkv, d, ps=16, pad=0, device,
           dtype=torch.float32):
    """q (B,Hq,D), K/V pools of distinct shuffled pages for each sequence
    plus two spare, a page table of each sequence's pages padded with page
    0 (another sequence's page) to the longest plus ``pad`` columns, and
    the lengths as int32."""
    need = [-(-n // ps) for n in lengths]
    total = sum(need) + 2
    kp, vp = (_r(rng, total, ps, hkv, d, device=device, dtype=dtype)
              for _ in range(2))
    order = rng.permutation(total)
    pt = np.zeros((len(lengths), max(need) + pad), np.int32)
    start = 0
    for i, n in enumerate(need):
        pt[i, :n] = order[start:start + n]
        start += n
    return (_r(rng, len(lengths), hq, d, device=device, dtype=dtype), kp, vp,
            torch.tensor(pt, device=device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


@pytest.mark.parametrize("length", [1, 16, SPLIT - 1, SPLIT, SPLIT + 1, 4096])
@pytest.mark.parametrize("group", [3, 1])
def test_decode_attention_split_edges(cuda, length, group):
    """Lengths at the page and split boundaries (one position, one page,
    one short of a split, a split, one past it) and 4,096 positions (256
    pages, 64 splits), beside a second sequence of 37, G = 3 and G = 1,
    the table padded with page 0."""
    rng = np.random.default_rng(15)
    args = _paged(rng, [length, 37], hq=2 * group, hkv=2, d=128, pad=1,
                  device=cuda)
    _close(kernels.decode_attention(*args), ref.decode_attention_ref(*args),
           3e-5)


@pytest.mark.parametrize("hq,hkv,d", [(40, 8, 128), (24, 2, 64), (4, 2, 20)])
def test_decode_attention_head_groups_and_odd_head_dim(cuda, hq, hkv, d):
    """G = 5 (eight-head register tile, three heads idle), G = 12 (two
    chunks of heads a split) and D = 20 (rows not a whole number of
    16-byte copies)."""
    rng = np.random.default_rng(16)
    args = _paged(rng, [150, 3, 64], hq=hq, hkv=hkv, d=d, device=cuda)
    _close(kernels.decode_attention(*args), ref.decode_attention_ref(*args),
           3e-5)


def test_decode_attention_sequence_bits_do_not_depend_on_batch(cuda):
    """Each sequence of a batch of 4 alone, with a page table just wide
    enough for it, gives the same bits as inside the batch."""
    rng = np.random.default_rng(17)
    q, kp, vp, pt, lengths = _paged(rng, [517, 64, 1000, 5], hq=24, hkv=8,
                                    d=128, device=cuda)
    full = kernels.decode_attention(q, kp, vp, pt, lengths)
    for i, n in enumerate(lengths.tolist()):
        alone = kernels.decode_attention(
            q[i:i + 1].contiguous(), kp, vp,
            pt[i:i + 1, :-(-n // 16)].contiguous(), lengths[i:i + 1])
        assert torch.equal(full[i:i + 1], alone), i


def test_decode_attention_bits_do_not_depend_on_table_padding(cuda):
    """The same lengths with the page table padded to PP and to PP + 7
    (page 0 in the padding) give the same bits."""
    rng = np.random.default_rng(18)
    q, kp, vp, pt, lengths = _paged(rng, [517, 200, 33, 64], hq=24, hkv=8,
                                    d=128, device=cuda)
    wide = torch.cat([pt, torch.zeros((4, 7), dtype=pt.dtype, device=cuda)],
                     1)
    assert torch.equal(kernels.decode_attention(q, kp, vp, pt, lengths),
                       kernels.decode_attention(q, kp, vp, wide, lengths))


def test_decode_attention_empty_sequence_gives_zeros(cuda):
    """A sequence of length 0 gives zeros (the Pallas kernel's flush of an
    empty (m, l, acc)), as the plain version does; its batch neighbour
    the plain version's answer."""
    rng = np.random.default_rng(19)
    q, kp, vp, pt, lengths = _paged(rng, [1, 90], hq=6, hkv=2, d=128,
                                    device=cuda)
    lengths[0] = 0
    got = kernels.decode_attention(q, kp, vp, pt, lengths)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got, ref.decode_attention_ref(q, kp, vp, pt, lengths), 3e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5),
                                       (torch.bfloat16, 3e-5)])
@pytest.mark.parametrize("hq,hkv,d", [(16, 8, 256), (4, 1, 128),
                                      (64, 8, 128), (6, 2, 64)])
def test_decode_attention_partial_matches_plain(cuda, dtype, tol, hq, hkv,
                                                d):
    """The partial entry against its plain version, out and lse, at the
    split serving step's head groups (gemma3-12b's 16/8 at D 256, a
    slot's 4 heads of one KV head, internvl2-76b's 64/8) and lengths
    across split boundaries, one of them 0 (zeros and -inf); out in fp32
    whatever the pools' type, never rounded, so held at the fp32
    tolerance for bf16 pools too; counted in the partial's launches."""
    rng = np.random.default_rng(31)
    args = _paged(rng, [0, 300, 65, 1000], hq=hq, hkv=hkv, d=d, pad=1,
                  device=cuda, dtype=dtype)
    counts = kernels.launch_counts()
    out, lse = kernels.decode_attention_partial(*args)
    after = kernels.launch_counts()
    assert after["decode_attention_partial"] == \
        counts["decode_attention_partial"] + 1
    assert after["decode_attention"] == counts["decode_attention"]
    assert out.dtype == lse.dtype == torch.float32
    want_out, want_lse = ref.decode_attention_partial_ref(*args)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert bool(torch.isneginf(lse[0]).all())
    _close(out, want_out, tol)
    _close(lse[1:], want_lse[1:], tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-5),
                                       (torch.bfloat16, 2e-2)])
def test_decode_attention_partials_merged_equal_the_whole(cuda, dtype, tol):
    """A dense cache of 2,048 positions split into 16 blocks of 128 (the
    split serving step's global cache at model degree 16), each block's
    partial, merged in block order, against decode_attention over the
    whole cache: lengths ending inside the first block (15 blocks at
    length 0), mid-way and at the end."""
    from repro_torch.kernels.decode_attention import merge_partials
    from repro_torch.models import layers as L
    rng = np.random.default_rng(32)
    b, s_len, hkv, g, d, n = 3, 2048, 8, 2, 256, 16
    kc, vc = (_r(rng, b, s_len, hkv, d, device=cuda, dtype=dtype)
              for _ in range(2))
    q = _r(rng, b, hkv * g, d, device=cuda, dtype=dtype)
    lengths = torch.tensor([5, 1000, s_len], dtype=torch.int32, device=cuda)
    whole = kernels.decode_attention(q, *L._page_view(kc, vc), lengths)
    blk = s_len // n
    parts = [kernels.decode_attention_partial(
        q, *L._page_view(kc[:, i * blk:(i + 1) * blk].contiguous(),
                         vc[:, i * blk:(i + 1) * blk].contiguous()),
        torch.clamp(lengths - i * blk, 0, blk).to(torch.int32))
        for i in range(n)]
    got = merge_partials([o for o, _ in parts], [s for _, s in parts],
                         dtype=dtype)
    _close(got, whole, tol)


def _plan(args):
    """decode_attention_partial's (pages a split, splits, cluster) for
    the arguments (q, pools, table, lengths)."""
    from repro_torch.kernels.decode_attention import partial_plan
    q, kp, _, pt, _ = args
    return partial_plan(kp.shape[1], q.shape[2], q.element_size(),
                        pt.shape[1])


def _widened(args, pad):
    """The same call with ``pad`` more columns of page 0 in the table."""
    q, kp, vp, pt, lengths = args
    wide = torch.cat([pt, torch.zeros((pt.shape[0], pad), dtype=pt.dtype,
                                      device=pt.device)], 1)
    return q, kp, vp, wide, lengths


def _same_bits(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,ps,length,pad", [
    (16, 8, 256, 16, 128, 8),       # gemma3-12b's global block, 8 splits
    (16, 8, 256, 16, 37, 40),
    (32, 8, 128, 1, 3, 200),        # the MoE's 3 positions, pages of one
    (40, 8, 128, 8, 8, 120)])       # G = 5, jamba's pages of 8
def test_decode_attention_partial_cluster_and_two_kernels_same_bits(
        cuda, dtype, hq, hkv, d, ps, length, pad):
    """One sequence's partial through the one-launch cluster path and,
    with its page table padded past the cluster limit, through the split
    and combine kernels at the same split: the same bits, out and lse,
    and the plain version's answer."""
    rng = np.random.default_rng(33)
    args = _paged(rng, [length], hq=hq, hkv=hkv, d=d, ps=ps, device=cuda,
                  dtype=dtype)
    wide = _widened(args, pad)
    assert _plan(args)[2] and not _plan(wide)[2]
    assert _plan(args)[0] == _plan(wide)[0]
    got = kernels.decode_attention_partial(*args)
    _same_bits(got, kernels.decode_attention_partial(*wide))
    want = ref.decode_attention_partial_ref(*args)
    _close(got[0], want[0], 3e-5)
    _close(got[1], want[1], 3e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_partial_bits_do_not_depend_on_batch_or_width(
        cuda, dtype):
    """Each sequence of a batch of 4 (gemma3-12b's heads, blocks of up to
    112 positions, 7 pages) alone, with a page table just wide enough for
    it, and the batch with its table padded by 1 and by 9 pages (the
    second past the cluster limit) give the same bits, out and lse."""
    rng = np.random.default_rng(34)
    args = _paged(rng, [112, 3, 77, 16], hq=16, hkv=8, d=256, device=cuda,
                  dtype=dtype)
    assert _plan(_widened(args, 1))[2] and not _plan(_widened(args, 9))[2]
    q, kp, vp, pt, lengths = args
    full = kernels.decode_attention_partial(*args)
    for pad in (1, 9):
        _same_bits(full, kernels.decode_attention_partial(
            *_widened(args, pad)))
    for i, n in enumerate(lengths.tolist()):
        out, lse = kernels.decode_attention_partial(
            q[i:i + 1].contiguous(), kp, vp,
            pt[i:i + 1, :-(-n // 16)].contiguous(), lengths[i:i + 1])
        assert torch.equal(full[0][i:i + 1], out), i
        assert torch.equal(full[1][i:i + 1], lse), i


@pytest.mark.parametrize("pad", [0, 12])
def test_decode_attention_partial_empty_block_inside_a_cluster(cuda, pad):
    """A sequence at length 0 beside sequences with positions (its
    cluster's blocks all past its end, theirs partly): zeros and -inf
    there, the plain version's answer elsewhere, on the cluster path and
    (the table padded) the two-kernel path."""
    rng = np.random.default_rng(35)
    args = _widened(_paged(rng, [20, 100, 1], hq=16, hkv=8, d=256,
                           device=cuda, dtype=torch.bfloat16), pad)
    args[4][0] = 0
    assert _plan(args)[2] == (pad == 0)
    out, lse = kernels.decode_attention_partial(*args)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert bool(torch.isneginf(lse[0]).all())
    assert bool(torch.isfinite(lse[1:]).all())
    want_out, want_lse = ref.decode_attention_partial_ref(*args)
    _close(out, want_out, 3e-5)
    _close(lse[1:], want_lse[1:], 3e-5)


@pytest.mark.parametrize("pad", [0, 12])
def test_decode_attention_partial_masks_pages_outside_the_pool(cuda, pad):
    """Page ids outside the pool (-1 and the pool's size) mask their
    slots: the partial equals the plain version over the table without
    those pages (their positions taken off the length), on both paths;
    a block whose every page is masked gives zeros and -inf."""
    rng = np.random.default_rng(36)
    q, kp, vp, pt, lengths = _paged(rng, [100, 80, 40], hq=16, hkv=8,
                                    d=256, device=cuda, dtype=torch.bfloat16)
    n_pool = kp.shape[0]
    masked = pt.clone()
    masked[0, 2], masked[1, 0] = -1, n_pool          # a middle, a first page
    masked[2, :3] = n_pool                           # every page of a block
    args = _widened((q, kp, vp, masked, lengths), pad)
    assert _plan(args)[2] == (pad == 0)
    out, lse = kernels.decode_attention_partial(*args)
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    assert bool(torch.isneginf(lse[2]).all())
    for i, drop in ((0, 2), (1, 0)):
        keep = [j for j in range(pt.shape[1]) if j != drop]
        want_out, want_lse = ref.decode_attention_partial_ref(
            q[i:i + 1], kp, vp, pt[i:i + 1, keep].contiguous(),
            lengths[i:i + 1] - 16)
        _close(out[i:i + 1], want_out, 3e-5)
        _close(lse[i:i + 1], want_lse, 3e-5)


def test_decode_attention_copy_width_does_not_change_bits(cuda):
    """Pools 4 bytes past a 16-byte boundary take 4-byte copies; the output
    has the same bits as from aligned copies of the same pools."""
    rng = np.random.default_rng(20)
    q, kp, vp, pt, lengths = _paged(rng, [300, 70], hq=24, hkv=8, d=128,
                                    device=cuda)

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, device=cuda)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)
    ku, vu = unaligned(kp), unaligned(vp)
    assert ku.data_ptr() % 16 == 4
    got = kernels.decode_attention(q, ku, vu, pt, lengths)
    assert torch.equal(got, kernels.decode_attention(q, kp, vp, pt, lengths))
    _close(got, ref.decode_attention_ref(q, kp, vp, pt, lengths), 3e-5)


@pytest.mark.parametrize("hq,hkv,d,ps", [(16, 8, 256, 16), (24, 8, 128, 16),
                                         (6, 2, 64, 8), (4, 4, 16, 16)])
def test_decode_attention_bf16_paged_matches_plain(cuda, hq, hkv, d, ps):
    """bf16 pools and q: gemma3-12b's heads (G = 2, D = 256), llama3.2-3b's,
    a smaller page and D = 16; lengths across split boundaries, the table
    padded with page 0; the output in bf16 within 2e-2 of the plain
    version (fp32 inside, each side rounds once)."""
    rng = np.random.default_rng(23)
    args = _paged(rng, [1, 300, 65, 1000], hq=hq, hkv=hkv, d=d, ps=ps, pad=1,
                  device=cuda, dtype=torch.bfloat16)
    before = kernels.launch_counts()["decode_attention"]
    got = kernels.decode_attention(*args)
    assert kernels.launch_counts()["decode_attention"] == before + 1
    assert got.dtype == torch.bfloat16
    _close(got, ref.decode_attention_ref(*args), 2e-2)


@pytest.mark.parametrize("s_len,dtype", [(2048, torch.bfloat16),
                                         (48, torch.bfloat16),
                                         (1024, torch.float32)])
def test_decode_attention_over_the_dense_cache_view(cuda, s_len, dtype):
    """A dense (B,S,KVH,hd) cache viewed as pages of gcd(S, 16) slots, each
    sequence one contiguous chain (the dense path's decode): the kernel
    equals its plain version and the plain masked attention over the
    cache itself; a ring of S slots, full, is lengths = S."""
    from math import gcd
    rng = np.random.default_rng(24)
    b, hkv, g, d = 4, 8, 2, 256
    kc, vc = (_r(rng, b, s_len, hkv, d, device=cuda, dtype=dtype)
              for _ in range(2))
    q = _r(rng, b, hkv * g, d, device=cuda, dtype=dtype)
    ps = gcd(s_len, 16)
    n = s_len // ps
    pt = (torch.arange(b, device=cuda, dtype=torch.int32)[:, None] * n
          + torch.arange(n, device=cuda, dtype=torch.int32)[None, :])
    lengths = torch.tensor([1, s_len // 2 + 3, s_len - 1, s_len],
                           dtype=torch.int32, device=cuda)
    pages = (kc.view(b * n, ps, hkv, d), vc.view(b * n, ps, hkv, d))
    got = kernels.decode_attention(q, *pages, pt, lengths)
    want = ref.decode_attention_ref(q, *pages, pt, lengths)
    tol = 2e-2 if dtype == torch.bfloat16 else 3e-5
    _close(got, want, tol)
    pos = torch.arange(s_len, device=cuda)
    scores = torch.einsum("bhd,bshd->bhs", q.float(),
                          kc.float().repeat_interleave(g, 2)) * d ** -0.5
    scores = torch.where(pos < lengths[:, None, None].long(), scores,
                         ref.NEG_INF)
    dense = torch.einsum("bhs,bshd->bhd", torch.softmax(scores, -1),
                         vc.float().repeat_interleave(g, 2))
    _close(got, dense.to(dtype), tol)


def test_lm_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from repro_torch.models import layers as L
    rng = np.random.default_rng(10)
    x = _r(rng, 4, 32, device=cuda)
    with pytest.raises(TypeError):
        kernels.rmsnorm(x.double(), x[0])
    with pytest.raises(ValueError):
        kernels.rmsnorm(x, x[0, :5])
    q = _r(rng, 1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError):                       # head dim 48
        kernels.flash_attention(q, q, q)
    q = _r(rng, 1, 2, 8, 32, device=cuda)
    with pytest.raises(TypeError):
        kernels.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):                        # mixed dtypes
        kernels.flash_attention(q, q.bfloat16(), q.bfloat16())
    pages = _r(rng, 3, 4, 2, 32, device=cuda)
    with pytest.raises(TypeError):
        kernels.decode_attention(q[:, :, 0].contiguous(), pages, pages,
                                 torch.zeros((1, 2), dtype=torch.int64,
                                             device=cuda),
                                 torch.ones(1, dtype=torch.int32,
                                            device=cuda))
    qg = _r(rng, 1, 8, 2, 2, 32, device=cuda)
    kv = _r(rng, 1, 8, 2, 32, device=cuda)
    before = kernels.launch_counts()
    # what neither attention kernel computes raises, naming what was asked
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="kv_len"):
        L._sdpa(qg, kv, kv, causal=True, window=0, kv_len=one)   # t > 1
    with pytest.raises(NotImplementedError, match="window"):
        L._sdpa(qg[:, :1], kv, kv, causal=True, window=4, q_pos0=one,
                kv_len=one)
    with pytest.raises(NotImplementedError, match="q_pos0"):
        L._sdpa(qg, kv, kv, causal=True, window=0, q_pos0=3)
    assert kernels.launch_counts() == before


def _paged_run(cfg, params, dev, prompt, steps=4):
    """``PagedLM`` on ``dev`` (16-slot pages): the prompt's prefill, then
    ``steps`` greedy decode steps; the tokens and each step's logits on
    the host."""
    from repro_torch.launch.serve import PagedLM
    from repro_torch.store.pagedkv import PagePool
    pool = PagePool(num_pages=64, page_size=16, num_layers=cfg.num_layers,
                    num_kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.resolved_head_dim, device=dev)
    eng = PagedLM(cfg, params, pool)
    seq = eng.mgr.add_sequence(0, prompt)
    logits = [eng.prefill_logits(seq).cpu()]
    seq.generated.append(int(torch.argmax(logits[0])))
    for _ in range(steps):
        logits.append(eng.decode_logits([seq])[0].cpu())
        seq.generated.append(int(torch.argmax(logits[-1])))
    return seq.generated, logits


def _lm_case(name, **widths):
    """A smoke config (widened by ``widths``), its seed-0 parameters on
    the CPU and a prompt of 37 tokens, or of 100 where widened."""
    from repro_torch.configs import SMOKES
    from repro_torch.models import build
    cfg = SMOKES[name].replace(**widths)
    rng = np.random.default_rng(0)
    prompt = list(rng.integers(0, cfg.vocab_size, 100 if widths else 37))
    return cfg, build(cfg).init_params(0, "cpu"), prompt


def test_paged_lm_on_the_card_matches_the_cpu(cuda):
    """The smoke llama3.2-3b through the kernels against the plain path on
    the CPU, from the same weights: tokens equal, logits within 1e-4."""
    from repro_torch.models import layers as L
    cfg, cpu_params, prompt = _lm_case("llama3.2-3b")
    runs = {dev: _paged_run(cfg, L.tree_map(lambda t: t.to(dev), cpu_params),
                            dev, prompt) for dev in ("cpu", "cuda")}
    assert runs["cuda"][0] == runs["cpu"][0]
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        _close(a, b, 1e-4)


# sha256 of the fp32 logits of ``_paged_run`` (prefill and 4 steps) before
# the attention kernels took bf16 and windows: the port at its parent
# commit on NVIDIA H100 80GB HBM3, 700 W.  Smoke llama3.2-3b (head dim 16),
# and widened to head dim 128 (llama3.2-3b's) over a 100-token prompt.
PAGED_FP32_DIGESTS = {
    "smoke": ("a63774feeabb38803749b0113f7ced93"
              "7073bf28e8341c2805d131a921f8ce71"),
    "hd128": ("5895ca73adf9ac5248c1bc2bca301fc3"
              "f1c3310e60b04a233acb727df43cd25b"),
}
PAGED_FP32_WIDTHS = {"smoke": {},
                     "hd128": {"d_model": 256, "num_heads": 6,
                               "num_kv_heads": 2, "head_dim": 128}}


def paged_fp32_digest(case: str) -> str:
    from repro_torch.models import layers as L
    cfg, params, prompt = _lm_case("llama3.2-3b", **PAGED_FP32_WIDTHS[case])
    _, logits = _paged_run(cfg, L.tree_map(lambda t: t.cuda(), params),
                           "cuda", prompt)
    import hashlib
    return hashlib.sha256(b"".join(x.float().numpy().tobytes()
                                   for x in logits)).hexdigest()


@pytest.mark.parametrize("case", list(PAGED_FP32_WIDTHS))
def test_paged_lm_fp32_bits_unchanged(cuda, case):
    """fp32 ``PagedLM`` on the card gives the bits it gave before the
    flash and decode kernels were templated on bf16 and took a window."""
    assert paged_fp32_digest(case) == PAGED_FP32_DIGESTS[case]


def test_paged_lm_serves_gemma3_on_the_card(cuda, monkeypatch):
    """gemma3's 5:1 local:global layers (smoke, window 8) through
    ``PagedLM`` on the card: prefill runs the windowed flash kernel on the
    local layers; decode attends over every page, as the reference's paged
    engine does (it ignores the window); tokens equal the plain path's on
    the CPU and logits within 1e-4."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    cfg, cpu_params, prompt = _lm_case("gemma3-12b")
    windows, lengths = [], []
    flash, decode = ops.flash_attention, ops.decode_attention

    def flash_rec(*args, **kwargs):
        windows.append(kwargs.get("window", 0))
        return flash(*args, **kwargs)

    def decode_rec(*args):
        lengths.append(args[4].tolist())
        return decode(*args)

    monkeypatch.setattr(ops, "flash_attention", flash_rec)
    monkeypatch.setattr(ops, "decode_attention", decode_rec)
    runs = {dev: _paged_run(cfg, L.tree_map(lambda t: t.to(dev), cpu_params),
                            dev, prompt) for dev in ("cpu", "cuda")}
    assert runs["cuda"][0] == runs["cpu"][0]
    for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
        _close(a, b, 1e-4)
    assert sorted(set(windows)) == [0, cfg.window_size]
    assert windows.count(cfg.window_size) == 5 * windows.count(0)
    assert all(n[0] > cfg.window_size for n in lengths)     # every page


def test_replicated_array_service_on_the_card_matches_the_cpu(cuda):
    """A 2-shard, 2-way replicated array service on the card, under
    Hetero, against the CPU single-device service on the same graph and
    weights: every model within 2e-5, served by the GNN kernels."""
    from repro_torch.core import gnn
    from repro_torch.core.service import HolisticGNNService, make_service_dfg
    from repro_torch.kernels.ops import program_config
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, 400, 3000), rng.zipf(1.4, 3000) % 400],
                     axis=1).astype(np.int64)
    emb = rng.standard_normal((400, 24)).astype(np.float32)
    reqs = [{"targets": rng.integers(0, 400, 6).tolist(), "seed": i}
            for i in range(5)]
    cpu = HolisticGNNService(h_threshold=16, pad_to=32, device="cpu")
    card = HolisticGNNService(h_threshold=16, pad_to=32, n_shards=2,
                              replication=2, device=cuda)
    try:
        for svc in (cpu, card):
            svc.update_graph(edges, emb)
            program_config(svc.xbuilder, "hetero")
        kernels.reset_launch_counts()
        for model in ("gcn", "gin", "ngcf"):
            params = gnn.init_params(model, [24, 16, 8], seed=1, device="cpu")
            weights = {k: v.numpy() for k, v in
                       gnn.dfg_feeds(model, params, None, []).items()
                       if k != "H"}
            dfg = make_service_dfg(model, 2, [5, 5]).save()
            for a, b in zip(card.run_batch(dfg, reqs, weights=weights),
                            cpu.run_batch(dfg, reqs, weights=weights)):
                np.testing.assert_allclose(a["Result"], b["Result"],
                                           rtol=2e-5, atol=2e-5)
        counts = kernels.launch_counts()
        assert all(counts[k] > 0 for k in ("agg_combine", "spmm", "gemm",
                                           "sddmm")), counts
    finally:
        card.close()


# slice shapes of the SPMD path at full width (N, F, D, O): layer 1 at
# F = 420 / m over D = 3072 / d, layer 2 at F = 128 / m over D = 512 / d,
# for the meshes (1, 4), (2, 2) and (2, 4)
SPMD_SHAPES = [(16384, 105, 3072, 128), (16384, 210, 1536, 128),
               (16384, 105, 1536, 128), (3072, 32, 512, 64),
               (3072, 64, 256, 64), (3072, 32, 256, 64)]


@pytest.mark.parametrize("n,f,d,o", SPMD_SHAPES)
def test_slice_shaped_kernels_match_plain(cuda, n, f, d, o):
    """What a slot of the SPMD engine gives agg_combine_partial, spmm and
    gemm: F a slice of the model axis (105 is odd: scalar gathers, spmm
    width 1), D a block of the data axis, and w a contiguous row slice of
    a padded weight (the last of m blocks, so not at the buffer's start)."""
    rng = np.random.default_rng(18)
    m = 4 if f % 4 else 2
    h = _r(rng, n, f, device=cuda)
    nbr, mask = _ell(rng, n, d, 10, cuda)
    w_full = _r(rng, f * m, o, device=cuda) * 0.1
    w = w_full[(m - 1) * f:]
    assert w.is_contiguous() and w.data_ptr() != w_full.data_ptr()
    before = kernels.launch_counts()
    _close(kernels.agg_combine_partial(h, nbr, mask, w),
           ref.agg_combine_ref(h, nbr, mask, w, None), 2e-5)
    for mode in ("mean", "sum"):
        assert torch.equal(kernels.spmm(h, nbr, mask, mode=mode),
                           ref.spmm_ref(h, nbr, mask, mode=mode))
    a = kernels.spmm(h, nbr, mask)
    _close(kernels.gemm(a, w), ref.gemm_ref(a, w), 1e-5)
    after = kernels.launch_counts()
    assert (after["agg_combine"] - before["agg_combine"],
            after["spmm"] - before["spmm"],
            after["gemm"] - before["gemm"]) == (1, 3, 1)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("model", ["gcn", "gin", "ngcf"])
def test_meshed_engine_on_the_card_matches_unmeshed(cuda, model, shape):
    """The SPMD engine over slots on the one card, under Hetero, against
    the unmeshed card service on the same graph and weights: within 2e-5
    (bit for bit at (1, 1)), with each kernel launched d*m times as often
    (sddmm not at d > 1, where the data-striped SDDMM is a plain step).
    Widths 26 and 18 are odd slices on the 4-way model axis."""
    from repro_torch.core import gnn
    from repro_torch.core.service import HolisticGNNService, make_service_dfg
    from repro_torch.kernels.ops import program_config
    from repro_torch.launch.mesh import make_host_mesh
    d, m = shape
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, 600, 4000), rng.zipf(1.4, 4000) % 600],
                     axis=1).astype(np.int64)
    emb = rng.standard_normal((600, 26)).astype(np.float32)
    reqs = [{"targets": rng.integers(0, 600, 6).tolist(), "seed": i}
            for i in range(5)]
    plain = HolisticGNNService(h_threshold=16, pad_to=32, device=cuda)
    meshed = HolisticGNNService(
        h_threshold=16, pad_to=32, device=cuda,
        mesh=make_host_mesh(shape=shape, devices=[cuda] * (d * m)))
    params = gnn.init_params(model, [26, 18, 10], seed=1, device="cpu")
    weights = {k: v.numpy() for k, v in
               gnn.dfg_feeds(model, params, None, []).items() if k != "H"}
    dfg = make_service_dfg(model, 2, [5, 5]).save()
    counts = []
    for svc in (plain, meshed):
        svc.update_graph(edges, emb)
        program_config(svc.xbuilder, "hetero")
        svc.run_batch(dfg, reqs, weights=weights)          # warm: the plan
        kernels.reset_launch_counts()
        counts.append((svc.run_batch(dfg, reqs, weights=weights),
                       kernels.launch_counts()))
    (want, n_plain), (got, n_mesh) = counts
    for a, b in zip(got, want):
        if shape == (1, 1):
            np.testing.assert_array_equal(a["Result"], b["Result"])
        else:
            np.testing.assert_allclose(a["Result"], b["Result"],
                                       rtol=2e-5, atol=2e-5)
    for k in ("agg_combine", "spmm", "gemm", "sddmm"):
        scale = 0 if k == "sddmm" and d > 1 else d * m
        assert n_mesh[k] == n_plain[k] * scale, (k, n_mesh, n_plain)
    assert n_mesh["agg_combine" if model == "gcn" else "spmm"] > 0
    assert meshed.stats()["engine"]["mesh"] == {"data": d, "model": m}


# ------------------------------------------------ gradients and training
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,t,d,causal,window", [
    (4, 2, 100, 64, True, 0), (6, 2, 77, 128, True, 16),
    (4, 4, 50, 32, False, 0), (8, 2, 300, 128, True, 0)])
def test_kernel_functions_gradients_match_plain(cuda, dtype, tol, hq, hkv, t,
                                                d, causal, window):
    """The rmsnorm and flash_attention Functions on the card (forward the
    kernel, backward plain torch) against autograd through the plain
    versions on the same inputs and output gradients: within ``tol`` of
    each gradient's largest element; the forward is the kernel's."""
    rng = np.random.default_rng(40)
    before = kernels.launch_counts()

    def grads(fn, args, dy):
        args = [a.detach().requires_grad_(True) for a in args]
        out = fn(*args)
        return out, torch.autograd.grad(out, args, dy)

    x = _r(rng, 3, t, 96, device=cuda, dtype=dtype)
    w = _r(rng, 96, device=cuda)
    q = _r(rng, 2, hq, t, d, device=cuda, dtype=dtype)
    k, v = (_r(rng, 2, hkv, t, d, device=cuda, dtype=dtype)
            for _ in range(2))
    cases = [(lambda a, b: kernels.rmsnorm(a, b, eps=1e-6),
              lambda a, b: ref.rmsnorm_ref(a, b, eps=1e-6), [x, w],
              _r(rng, *x.shape, device=cuda, dtype=dtype)),
             (lambda a, b, c: kernels.flash_attention(
                 a, b, c, causal=causal, window=window),
              lambda a, b, c: ref.attention_ref(a, b, c, causal=causal,
                                                window=window),
              [q, k, v], _r(rng, *q.shape, device=cuda, dtype=dtype))]
    for fn, plain, args, dy in cases:
        out, got = grads(fn, args, dy)
        _close(out, fn(*[a.detach() for a in args]), 0)  # the kernel's
        _, want = grads(plain, args, dy)
        for a, b in zip(got, want):
            bar = tol * float(b.float().abs().max())
            assert float((a.float() - b.float()).abs().max()) <= bar
    after = kernels.launch_counts()
    assert after["rmsnorm"] > before["rmsnorm"]
    assert after["flash_attention"] > before["flash_attention"]


def test_decode_attention_refuses_a_gradient_on_the_card(cuda):
    q = torch.randn(1, 2, 32, device=cuda, requires_grad=True)
    pages = torch.randn(2, 16, 1, 32, device=cuda)
    table = torch.tensor([[0, 1]], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([20], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        kernels.decode_attention(q, pages, pages, table, lengths)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "xlstm-125m"])
def test_recurrent_cached_path_matches_full_forward_on_the_card(cuda, name,
                                                                dtype, tol):
    """jamba and xlstm SMOKE on the card: prefill of 12 tokens and 5
    decode steps against the model's own full forward (fp32 element by
    element at the kernels-vs-plain tolerance, 5e-2 for jamba's capacity
    MoE as ``tests/test_models.py`` holds it: a token's drop depends on
    the batch it is routed in; bf16 within 2e-2 of the logits' scale),
    through the kernels (jamba's attention layer: flash at prefill,
    decode_attention at decode)."""
    from repro_torch.configs import SMOKES
    from repro_torch.models import build, layers as L, transformer as T
    cfg = SMOKES[name].replace(dtype=dtype)
    api = build(cfg)
    params = api.init_params(0, cuda)
    rng = np.random.default_rng(41)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 17)),
                        dtype=torch.int32, device=cuda)
    x = L.embed_apply(params["embed"], toks, cfg)
    x, _, _ = T.decoder_forward(params, cfg, x)
    full = L.logits_apply(params["embed"], x, cfg).float()
    caches = L.init_tree(api.cache_defs(2, 32), 0, cuda)
    kernels.reset_launch_counts()
    lg, caches = api.prefill(params, {"tokens": toks[:, :12]}, caches)
    got = [lg[:, 0].float()]
    lengths = torch.full((2,), 12, dtype=torch.int32, device=cuda)
    for i in range(12, 17):
        lg, caches = api.decode(params, {"tokens": toks[:, i:i + 1],
                                         "lengths": lengths}, caches)
        got.append(lg[:, 0].float())
        lengths = lengths + 1
    n = kernels.launch_counts()
    assert n["rmsnorm"] > 0
    if name.startswith("jamba"):
        assert n["flash_attention"] > 0 and n["decode_attention"] > 0
    got = torch.stack(got, 1)
    want = full[:, 11:]
    if dtype == "float32":
        _close(got, want, 5e-2 if cfg.moe is not None else tol)
    else:
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())


@pytest.mark.parametrize("name", ["llama3.2-3b", "xlstm-125m",
                                  "jamba-v0.1-52b"])
def test_trainer_gives_every_leaf_a_gradient_on_the_card(cuda, name):
    """Three steps of the Trainer on the card (SMOKE, bf16 activations,
    remat on): the step raises if any leaf had no gradient, so finishing
    is the check; the norms and attention ran through the kernels, and
    the loss stays finite."""
    from repro_torch.configs import SMOKES
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build
    from repro_torch.train import Trainer
    tr = Trainer(build(SMOKES[name]), ShapeConfig("t", "train", 32, 4),
                 device=cuda)
    kernels.reset_launch_counts()
    _, opt, step = tr.run(3)
    n = kernels.launch_counts()
    assert step == 3 and int(opt["step"]) == 3
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0
               for m in tr.metrics_log)
    assert n["rmsnorm"] > 0 and n["decode_attention"] == 0
    if name != "xlstm-125m":
        assert n["flash_attention"] > 0


@pytest.mark.parametrize("name", ["gemma3-12b", "llama3.2-3b"])
@pytest.mark.parametrize("shape,long_mode", [((1, 2), False),
                                             ((1, 4), False),
                                             ((2, 2), True)])
def test_mesh_serve_on_the_card_matches_the_cpu(cuda, name, shape,
                                                long_mode):
    """``MeshServe`` split over the model axis on slots of the card (the
    smokes in fp32, prefill 2 x 12 into caches of 24 and 3 steps; batch
    1 in long mode): each step's logits within 1e-4 of the same split
    step on CPU slots (the plain versions), rmsnorm, flash_attention and
    decode_attention launched (the partial entry where a cache splits by
    positions: at (1, 4), whose 2 KV heads do not divide 4, and in long
    mode)."""
    from repro_torch.configs import SMOKES
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import MeshServe
    from repro_torch.models import build
    from repro_torch.train import sharded as S
    cfg = SMOKES[name].replace(dtype="float32")
    d, m = shape
    b = 1 if long_mode else 2
    api = build(cfg, tp=m)
    params = api.init_params(0, "cpu")
    rng = np.random.default_rng(33)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (b, 15)),
                        dtype=torch.int32)

    def run(dev):
        mesh = make_host_mesh(devices=[dev] * (d * m), shape=shape)
        ms = MeshServe(api, mesh, long_mode=long_mode)
        assert ms.split
        p = ms.lay_out_params(_on(params, dev))
        c = ms.init_caches(b, 24)
        out = []
        with torch.no_grad():
            lg, c = ms.prefill(p, ms.lay_out_inputs(
                {"tokens": toks[:, :12].to(dev)}), c)
            out.append(S.gather(lg).cpu())
            lengths = torch.full((b,), 12, dtype=torch.int32, device=dev)
            for i in range(12, 15):
                lg, c = ms.decode(p, ms.lay_out_inputs(
                    {"tokens": toks[:, i:i + 1].to(dev),
                     "lengths": lengths}), c)
                out.append(S.gather(lg).cpu())
                lengths = lengths + 1
        return out

    kernels.reset_launch_counts()
    got = run("cuda:0")
    launches = kernels.launch_counts()
    assert launches["rmsnorm"] > 0 and launches["flash_attention"] > 0
    by_positions = long_mode or m == 4
    assert launches["decode_attention_partial" if by_positions
                    else "decode_attention"] > 0, launches
    for a, w in zip(got, run("cpu")):
        _close(a, w, 1e-4)


def _on(tree, dev):
    from repro_torch.models import layers as L
    return L.tree_map(lambda t: t.to(dev), tree)
