"""ELL/page-format SpMM — the "vector processor" aggregation, on Hopper.

Replaces the Pallas kernel ``repro/kernels/spmm.py::_spmm_kernel``
(``pallas_call`` at ``spmm.py:56``).  CUDA source: ``csrc/spmm.cu``.

Bound on the H100: bytes.  Each output element costs K gathered loads
for 2K flops, far under the fp32 ridge, so the floor is the gathered rows
of h plus nbr/mask in and the (D,F) result out, over 3.35 TB/s.  The TPU
kernel kept an (N, bf) slab of h resident in VMEM; on the card the 50 MB
L2 plays that part, and the kernel's job is to keep the gathers in
flight: a thread owns a vector of 4, 2 or 1 floats of one output row
(:func:`spmm_width`), the threads are laid flat over (row, vector) so
that no warp runs partly empty whatever F is, and each thread issues
five slots' gathers before it sums them.  It matches ``spmm_ref`` bit
for bit (same rounding order, no fused multiply-add) at every width.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import SPMM_MODES, spmm_ref

launches = 0

# Below this many float4 vectors a launch leaves the card mostly idle: a
# quarter of the threads it holds at once (132 SMs of the H100, 1,536
# threads each at the kernel's 40 registers a thread).
FEW_VECTORS = 132 * 1536 // 4


def spmm_width(f: int, d: int) -> int:
    """Floats a thread owns (one gather of 4, 2 or 1 floats a slot) for F
    features and D rows: from (F, D) alone, never N.  Every width gives
    the same bits (each output element is the same in-order chain), so
    the choice is speed only: the widest that F allows, but two floats
    where float4s would be fewer than FEW_VECTORS, so that twice the
    threads have their gathers in flight.  On the H100 float4s take the
    3,072-row layer (F 420) in 0.0086 ms against 0.0116 for two floats;
    at the 512-row layer (F 128, 16,384 float4s) two floats take 0.00236
    ms warm and 0.00302 with h past the L2, against 0.00243 and 0.00367
    (``tools/torch_kernel_tiles.py spmm``)."""
    width = next(w for w in (4, 2, 1) if f % w == 0)
    if width == 4 and d * f // 4 < FEW_VECTORS:
        width = 2
    return width


def spmm(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor, *,
         mode: str = "mean") -> torch.Tensor:
    """h (N,F); nbr,mask (D,K) -> (D,F), ``mode`` "mean" or "sum"."""
    global launches
    if mode not in SPMM_MODES:
        raise ValueError(f"spmm mode {mode!r} not in {SPMM_MODES}")
    if h.device.type == "cpu":
        return spmm_ref(h, nbr, mask, mode=mode)
    _build.check_ell("spmm", h, nbr, mask)
    (n, f), (d, k) = h.shape, nbr.shape
    out = torch.empty((d, f), dtype=torch.float32, device=h.device)
    if d == 0 or f == 0:
        return out
    width = spmm_width(f, d)
    while h.data_ptr() % (4 * width):      # a row view of a wider buffer
        width //= 2
    lib = _build.library()
    with torch.cuda.device(h.device):
        rc = lib.repro_spmm_f32(h.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                                out.data_ptr(), n, f, d, k,
                                int(mode == "mean"), width,
                                _build.stream(h.device))
    _build.raise_on(rc, "spmm")
    launches += 1
    return out
