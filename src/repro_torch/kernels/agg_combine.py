"""Fused aggregate-combine — one GCN layer per launch, on Hopper.

Replaces the Pallas kernel ``repro/kernels/agg_combine.py::
_agg_combine_kernel`` (``pallas_call`` at ``agg_combine.py:95``).  CUDA
source: ``csrc/agg_combine.cu``.

Computes ``relu(spmm(h, nbr, mask, mode) @ w + b)`` without writing the
aggregate to device memory.  Bound on the H100: bytes at the service's
shapes (the gathered rows of h; the combine is 2*D*F*O fp32 flops
against 67 TFLOP/s).  A block of BD destination rows gathers their
aggregate into shared memory and computes all O columns from it; the TPU
kernel got that reuse from its in-order grid, which blocks do not have.
Gather and combine run at once, in different warps: producer warps
gather the aggregate 128 columns at a time (every slot's 16-byte load in
flight before the in-order sum, so the aggregate is ``spmm_ref``'s bit
for bit) while consumer warps run the combine on register tiles, fed by
``cp.async`` stages of w, on the chunks already gathered.  The tile
follows (F, O) alone (:func:`agg_tile`), so a row's result never depends
on D.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import SPMM_MODES, agg_combine_ref

launches = 0

# The tiles the kernel is built for, by index: (rows a block BD, output
# columns a tile BN, rows a consumer thread TM, k a stage of w BK, stages
# of w, producer warps); a consumer thread owns TM x 4 outputs.  _build.py
# writes this table into the C entry's switch (agg_tiles.inc), so it is
# the one list of tiles.  0 (O > 64) and 1 (O <= 64) are the service's; 2,
# one row a block, takes any O where a large F (above 2,144 at O > 64,
# 6,400 at O <= 64) leaves no room for the first, up to F = 50,960.
TILES = ((24, 128, 3, 16, 3, 12), (8, 64, 1, 32, 3, 8),
         (1, 128, 1, 16, 3, 4))
CHUNK = 128                   # aggregate columns a producer signal covers
MAX_SMEM = 227 * 1024         # shared memory a block may use on an H100


def threads(tile: tuple) -> int:
    """Consumer threads, then the producer warps', of a tile's shape."""
    rows, cols, tm, _, _, warps = tile
    return rows // tm * cols // 4 + 32 * warps


def smem_bytes(tile: tuple, f: int) -> int:
    """Shared memory of a block of a tile's shape, as ``Tile::smem`` in
    ``csrc/agg_combine.cu`` lays it out: the aggregate (rows of F rounded
    up to at least one k stage, plus 4 floats), the stages of w (BK x
    (BN + 4) floats) and an mbarrier for each 128-column chunk of the
    aggregate."""
    rows, cols, _, bk, stages, _ = tile
    lda = -(-max(f, 1) // bk) * bk + 4
    return 4 * (rows * lda + stages * bk * (cols + 4)) + 8 * -(-(lda - 4)
                                                             // CHUNK)


def agg_tile(f: int, o: int) -> int:
    """The tile (an index into TILES) for F input and O output features:
    from (F, O) alone, never from D, so a row's bits do not move with the
    batch.  At the service's widths, 24 rows of 128 columns a block with
    12 producer and 8 consumer warps at F = 420, O = 128 (128 blocks at
    the 3,072-row layer, one an SM), 8 rows of 64 columns with 8 producer
    and 4 consumer warps at F = 128, O = 64 (64 blocks at the 512-row
    layer); on the H100 these beat 16- and 32-row tiles, 8 producer warps
    and a split of O over blocks at the first, 4- and 16-row tiles at the
    second (``tools/torch_kernel_tiles.py agg``).  Where its aggregate and
    stages of w pass MAX_SMEM (a large F), one row a block; raises where
    not even that fits."""
    for tile in (0 if o > 64 else 1, 2):
        if smem_bytes(TILES[tile], f) <= MAX_SMEM:
            return tile
    raise ValueError(f"agg_combine: F={f} does not fit one row of aggregate "
                     "in shared memory")


def agg_combine(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
                w: torch.Tensor, b: torch.Tensor, *,
                mode: str = "mean") -> torch.Tensor:
    """h (N,F); nbr,mask (D,K); w (F,O); b (O,) -> relu(agg@w+b) (D,O)."""
    return _agg_combine(h, nbr, mask, w, b, mode=mode)


def agg_combine_partial(h: torch.Tensor, nbr: torch.Tensor,
                        mask: torch.Tensor, w: torch.Tensor, *,
                        mode: str = "mean") -> torch.Tensor:
    """Slice-shaped SPMD entry: ``agg @ w`` with no bias/relu epilogue
    (a nonlinearity cannot be applied to a partial sum)."""
    return _agg_combine(h, nbr, mask, w, None, mode=mode)


def _agg_combine(h, nbr, mask, w, b, *, mode):
    global launches
    if mode not in SPMM_MODES:
        raise ValueError(f"agg_combine mode {mode!r} not in {SPMM_MODES}")
    if h.device.type == "cpu":
        return agg_combine_ref(h, nbr, mask, w, b, mode=mode)
    _build.check_ell("agg_combine", h, nbr, mask)
    _build.check("agg_combine", "w", w, dtype=torch.float32, ndim=2,
                 device=h.device)
    (n, f), (d, k), o = h.shape, nbr.shape, w.shape[1]
    if w.shape[0] != f:
        raise ValueError(f"agg_combine: w {tuple(w.shape)} does not take "
                         f"F={f}")
    if b is not None:
        _build.check("agg_combine", "b", b, dtype=torch.float32, ndim=1,
                     device=h.device)
        if b.shape[0] != o:
            raise ValueError(f"agg_combine: b {tuple(b.shape)} != O={o}")
    tile = agg_tile(f, o)
    out = torch.empty((d, o), dtype=torch.float32, device=h.device)
    if d == 0 or o == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(h.device):
        rc = lib.repro_agg_combine_f32(
            h.data_ptr(), nbr.data_ptr(), mask.data_ptr(), w.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(),
            n, f, d, k, o, int(mode == "mean"), int(b is not None), tile,
            _build.stream(h.device))
    _build.raise_on(rc, "agg_combine")
    launches += 1
    return out
