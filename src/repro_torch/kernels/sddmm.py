"""SDDMM — per-edge products for NGCF's similarity term, on Hopper.

Replaces the Pallas kernel ``repro/kernels/sddmm.py::_sddmm_kernel``
(``pallas_call`` at ``sddmm.py:49``).  CUDA source: ``csrc/sddmm.cu``.

Bound on the H100: bytes.  Two multiplies per output element; the floor
is writing the (D,K,F) result (it dominates: K times the gathered input)
plus reading the gathered and destination rows, over 3.35 TB/s.  The
kernel is one elementwise pass with coalesced reads and writes along F,
one block per (row, slot, 128-feature slice).  The reference pads h when
D > N; in the service D <= N always holds (the destination rows are a
prefix of h), so the wrapper raises instead of padding a copy.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import sddmm_ref

launches = 0


def sddmm(h: torch.Tensor, nbr: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """h (N,F); nbr,mask (D,K) with D <= N -> (D,K,F)."""
    global launches
    if nbr.shape[0] > h.shape[0]:
        raise ValueError(f"sddmm needs D <= N, got D={nbr.shape[0]} "
                         f"N={h.shape[0]}")
    if h.device.type == "cpu":
        return sddmm_ref(h, nbr, mask)
    _build.check_ell("sddmm", h, nbr, mask)
    (n, f), (d, k) = h.shape, nbr.shape
    _build.check_sizes("sddmm", d * k)
    out = torch.empty((d, k, f), dtype=torch.float32, device=h.device)
    if d * k == 0 or f == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(h.device):
        rc = lib.repro_sddmm_f32(h.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                                 out.data_ptr(), n, f, d, k,
                                 _build.stream(h.device))
    _build.raise_on(rc, "sddmm")
    launches += 1
    return out
