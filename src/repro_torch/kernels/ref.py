"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Counterpart of ``repro/kernels/ref.py``.  Each function is the semantic
ground truth of one CUDA kernel: the CPU tests hold it against the JAX
reference, ``chip_smoke.py`` holds each kernel against it on the card,
and a kernel's wrapper takes it for a tensor that lies on the CPU.

Every reduction here runs in a fixed order that does not depend on the
number of rows (a loop over K, or over the neighbour slots), so a row's
result never changes with the batch it rides in: ``run_batch`` is held
bit-identical to serial ``run``.  torch's own CPU matmul is not
row-invariant (its blocking changes with M), hence ``gemm_ref`` is a
sequence of rank-1 updates.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30

SPMM_MODES = ("mean", "sum")


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M,K) @ (K,N) -> (M,N) fp32, summed over K in order (like
    ``jnp.dot(a, b, preferred_element_type=float32)``)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    a32, b32 = a.float(), b.float()
    acc = a32.new_zeros((a32.shape[0], b32.shape[1]))
    for j in range(a32.shape[1]):
        acc = acc + a32[:, j:j + 1] * b32[j]
    return acc


def spmm_ref(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
             *, mode: str = "mean") -> torch.Tensor:
    """ELL/page-format neighbour aggregation: h (N,F), nbr/mask (D,K) ->
    (D,F).  Slots are multiplied by the mask, never skipped; ``mean``
    divides by max(sum(mask), 1)."""
    if mode not in SPMM_MODES:
        raise ValueError(f"spmm mode {mode!r} not in {SPMM_MODES}")
    d, k = nbr.shape
    acc = h.new_zeros((d, h.shape[1]))
    deg = mask.new_zeros((d,))
    for j in range(k):
        acc = acc + h.index_select(0, nbr[:, j].long()) * mask[:, j, None]
        deg = deg + mask[:, j]
    if mode == "sum":
        return acc
    return acc / torch.clamp(deg, min=1.0)[:, None]


def sddmm_ref(h: torch.Tensor, nbr: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Per-edge product with the destination rows: out[i,k,:] =
    h[nbr[i,k]] * h[i] * mask[i,k], shape (D,K,F); needs D <= N."""
    d, k = nbr.shape
    g = h.index_select(0, nbr.reshape(-1).long()).view(d, k, -1)
    return g * h[:d, None, :] * mask[..., None]


def agg_combine_ref(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
                    w: torch.Tensor, b: torch.Tensor | None, *,
                    mode: str = "mean") -> torch.Tensor:
    """One GCN layer: relu(spmm(h, nbr, mask) @ w + b) in h's dtype.
    ``b=None`` drops the epilogue and returns ``agg @ w`` alone, the
    ``AggCombinePartial`` product."""
    z = gemm_ref(spmm_ref(h.float(), nbr, mask, mode=mode), w)
    if b is not None:
        z = torch.relu(z + b.float())
    return z.to(h.dtype)
