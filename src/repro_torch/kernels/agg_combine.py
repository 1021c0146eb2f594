"""Fused aggregate-combine — one GCN layer per launch, on Hopper.

Replaces the Pallas kernel ``repro/kernels/agg_combine.py::
_agg_combine_kernel`` (``pallas_call`` at ``agg_combine.py:95``).  CUDA
source: ``csrc/agg_combine.cu``.

Computes ``relu(spmm(h, nbr, mask, mode) @ w + b)`` without writing the
aggregate to device memory.  Bound on the H100: bytes at the service's
shapes (the gathered rows of h dominate; the combine is 2*D*F*O fp32
flops against 67 TFLOP/s).  Each block reduces its 16 destination rows
(fewer at wide F) into shared memory and then loops over the output
tiles of w itself: the TPU kernel got that reuse from its in-order grid,
which blocks do not have.  Rows per block depend on F alone, so a row's
result never depends on D.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import SPMM_MODES, agg_combine_ref

launches = 0


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
    lib = _build.library()
    if lib.repro_agg_combine_rows(f) == 0:
        raise ValueError(f"agg_combine: F={f} does not fit one row of "
                         "aggregate in shared memory")
    out = torch.empty((d, o), dtype=torch.float32, device=h.device)
    if d == 0 or o == 0:
        return out
    with torch.cuda.device(h.device):
        rc = lib.repro_agg_combine_f32(
            h.data_ptr(), nbr.data_ptr(), mask.data_ptr(), w.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(),
            n, f, d, k, o, int(mode == "mean"), int(b is not None),
            _build.stream(h.device))
    _build.raise_on(rc, "agg_combine")
    launches += 1
    return out
