"""Kernel wrappers + the paper's User-logic "bitstreams", on Hopper.

Counterpart of ``repro/kernels/ops.py``, with the same devices and
priorities:

  * **Octa-HGNN**  — software-only: every C-kernel is the Shell torch path
    (an empty bitstream, so the Fig. 16 comparison shares the dispatch
    machinery).
  * **Lsap-HGNN**  — a large systolic array only: GEMM goes to the CUDA
    GEMM kernel, and the irregular aggregation (SpMM/SDDMM) is forced
    through dense one-hot products on that same kernel — the paper's
    "systolic arrays cannot traverse graphs" effect.
  * **Hetero-HGNN** — vector + systolic: SpMM/SDDMM and the fused
    AggCombine on the vector kernels, GEMM on the GEMM kernel (highest
    priority), the winning configuration.

The LM path's kernels (rmsnorm, flash_attention, decode_attention and
its partial entry) are imported here too: ``models/layers.py`` and ``launch/serve.py`` call them
as attributes of this module, the way the bitstreams call the GNN ones.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.xbuilder import Bitstream
from .agg_combine import agg_combine, agg_combine_partial
from .decode_attention import decode_attention, decode_attention_partial
from .flash_attention import flash_attention
from .gemm import gemm
from .rmsnorm import rmsnorm
from .sddmm import sddmm
from .spmm import spmm


# ----------------------------------------------------------- dense fallbacks
def _spmm_via_gemm(h, nbr, mask, *, mode: str = "mean"):
    """Lsap path: aggregation lowered onto the systolic array as a dense
    one-hot matmul — correct but wasteful (the paper's Fig. 16 point)."""
    n = h.shape[0]
    onehot = F.one_hot(nbr.long(), n).to(h.dtype) * mask[..., None]  # (D,K,N)
    a = onehot.sum(dim=1)                                             # (D,N)
    if mode == "mean":
        a = a / torch.clamp(mask.sum(dim=1), min=1.0)[:, None]
    return gemm(a, h)


def _sddmm_via_gemm(h, nbr, mask):
    n = h.shape[0]
    d, k = nbr.shape
    onehot = F.one_hot(nbr.reshape(-1).long(), n).to(h.dtype)        # (D*K,N)
    g = gemm(onehot, h).reshape(d, k, -1)
    return g * h[:d][:, None, :] * mask[..., None]


# ------------------------------------------------------------- bitstreams
def octa_bitstream() -> Bitstream:
    return Bitstream(device="octa-o3", priority=60, kernels={})


def lsap_bitstream() -> Bitstream:
    return Bitstream(device="systolic", priority=300, kernels={
        "GEMM": lambda a, b: gemm(a, b),
        "SpMM": _spmm_via_gemm,
        "SpMM_Mean": lambda h, n, m: _spmm_via_gemm(h, n, m, mode="mean"),
        "SpMM_Sum": lambda h, n, m: _spmm_via_gemm(h, n, m, mode="sum"),
        "SDDMM": _sddmm_via_gemm,
    })


def hetero_bitstream() -> Bitstream:
    return Bitstream(device="vector", priority=150, kernels={
        "SpMM": lambda h, n, m, mode="mean": spmm(h, n, m, mode=mode),
        "SpMM_Mean": lambda h, n, m: spmm(h, n, m, mode="mean"),
        "SpMM_Sum": lambda h, n, m: spmm(h, n, m, mode="sum"),
        "SDDMM": lambda h, n, m: sddmm(h, n, m),
        "RMSNorm": lambda x, w: rmsnorm(x, w),
        # fused aggregate-combine: one whole GCN layer per kernel launch —
        # the engine's fusion pass targets this C-operation when present.
        "AggCombine": lambda h, n, m, w, b: agg_combine(h, n, m, w, b,
                                                        mode="mean"),
        # slice-shaped SPMD entry: agg@w partial product, no epilogue.
        "AggCombinePartial": lambda h, n, m, w: agg_combine_partial(
            h, n, m, w, mode="mean"),
    })


def hetero_gemm_bitstream() -> Bitstream:
    """The systolic half of Hetero (program both this and hetero_bitstream)."""
    return Bitstream(device="systolic", priority=300, kernels={
        "GEMM": lambda a, b: gemm(a, b),
    })


BITSTREAMS = {
    "octa": [octa_bitstream],
    "lsap": [lsap_bitstream],
    "hetero": [hetero_bitstream, hetero_gemm_bitstream],
}


def program_config(xbuilder, name: str) -> float:
    """Program a named accelerator configuration; returns reconfig seconds."""
    for dev in list(xbuilder.loaded):
        xbuilder.unprogram(dev)
    total = 0.0
    for mk in BITSTREAMS[name]:
        total += xbuilder.program(mk())
    return total


__all__ = ["gemm", "spmm", "sddmm", "agg_combine", "agg_combine_partial",
           "rmsnorm", "flash_attention", "decode_attention",
           "decode_attention_partial", "BITSTREAMS",
           "program_config", "octa_bitstream", "lsap_bitstream",
           "hetero_bitstream", "hetero_gemm_bitstream"]
