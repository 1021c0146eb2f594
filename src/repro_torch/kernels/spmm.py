"""ELL/page-format SpMM — the "vector processor" aggregation, on Hopper.

Replaces the Pallas kernel ``repro/kernels/spmm.py::_spmm_kernel``
(``pallas_call`` at ``spmm.py:56``).  CUDA source: ``csrc/spmm.cu``.

Bound on the H100: bytes.  Each output element costs K gathered loads
for 2K flops, far under the fp32 ridge, so the floor is the gathered rows
of h plus nbr/mask in and the (D,F) result out, over 3.35 TB/s.  The TPU
kernel kept an (N, bf) slab of h resident in VMEM; on the card the 50 MB
L2 plays that part, and the kernel's job is to issue the gathers
coalesced: one block per (destination row, 128-feature slice),
neighbouring threads on neighbouring features.  It matches ``spmm_ref``
bit for bit (same rounding order, no fused multiply-add).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import SPMM_MODES, spmm_ref

launches = 0


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
    lib = _build.library()
    with torch.cuda.device(h.device):
        rc = lib.repro_spmm_f32(h.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                                out.data_ptr(), n, f, d, k,
                                int(mode == "mean"), _build.stream(h.device))
    _build.raise_on(rc, "spmm")
    launches += 1
    return out
