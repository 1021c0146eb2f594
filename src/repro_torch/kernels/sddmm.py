"""SDDMM — per-edge products for NGCF's similarity term, on Hopper.

Replaces the Pallas kernel ``repro/kernels/sddmm.py::_sddmm_kernel``
(``pallas_call`` at ``sddmm.py:49``).  CUDA source: ``csrc/sddmm.cu``.

Bound on the H100: bytes.  Two multiplies per output element; the floor
is writing the (D,K,F) result (it dominates: K times the gathered input)
plus reading the gathered and destination rows, over 3.35 TB/s.  One
warp owns a destination row, 4 warps a block (on the H100 the fastest at
the 3,072-row GNN layer, ``tools/torch_kernel_tiles.py sddmm``): it
reads h[i] once into registers as 16-byte vectors, shuffles each slot's
index and mask from one load a warp, keeps two slots' gathers in flight
and writes the output with streaming stores, so the write-once result
does not evict h from L2.  It matches ``sddmm_ref`` bit for bit.
The reference pads h when D > N; in the service D <= N always holds (the
destination rows are a prefix of h), so the wrapper raises instead of
padding a copy.
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
