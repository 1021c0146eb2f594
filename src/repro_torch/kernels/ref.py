"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Counterpart of ``repro/kernels/ref.py``.  Each function is the semantic
ground truth of one CUDA kernel: the CPU tests hold it against the JAX
reference, ``chip_smoke.py`` holds each kernel against it on the card,
and a kernel's wrapper takes it for a tensor that lies on the CPU.

Every GNN reduction here runs in a fixed order that does not depend on
the number of rows (a loop over K, or over the neighbour slots), so a row's
result never changes with the batch it rides in: ``run_batch`` is held
bit-identical to serial ``run``.  torch's own CPU matmul is not
row-invariant (its blocking changes with M), hence ``gemm_ref`` is a
sequence of rank-1 updates.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30

SPMM_MODES = ("mean", "sum")


def wide(dtype: torch.dtype) -> torch.dtype:
    """The type a plain version computes in: fp32, or float64 for float64
    inputs (so ``torch.autograd.gradcheck`` can hold a backward to it)."""
    return torch.promote_types(dtype, torch.float32)


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


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * w over the last dim, in fp32 (float64
    for a float64 x), cast back to x's dtype."""
    ct = wide(x.dtype)
    xf = x.to(ct)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.to(ct)).to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B,H,T,D) x (B,Hkv,S,D) -> (B,H,T,D) in q's dtype, fp32 inside
    (float64 for float64 operands); GQA
    by head repeat (head h reads KV head h // (H/Hkv)); causal means key j
    is visible to query i when j <= i, and ``window > 0`` adds
    i - j < window.  bf16 operands take the bf16 kernel's numerics over
    the whole row: p = exp(s - max) in fp32, rounded to bf16 before P.V
    (the tensor cores' operand, as the MXU's at default precision), l
    summed from the fp32 p, fp32 accumulation, the output rounded once."""
    hq, t, d = q.shape[1:]
    rep = hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    ct = wide(q.dtype)
    s = torch.einsum("bhtd,bhsd->bhts", q.to(ct), k.to(ct)) * d ** -0.5
    tt = torch.arange(t, device=q.device)[:, None]
    ss = torch.arange(k.shape[2], device=q.device)[None, :]
    if causal:
        s = torch.where(tt >= ss, s, NEG_INF)
    if window > 0:
        s = torch.where(tt - ss < window, s, NEG_INF)
    if q.dtype == torch.bfloat16:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.einsum("bhts,bhsd->bhtd", p.bfloat16().to(ct), v.to(ct))
        return (o / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, v.to(ct)).to(q.dtype)


def paged_gather(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(P,ps,Hkv,D) pages + (B,PP) table -> (B, PP*ps, Hkv, D) logical KV."""
    b, pp = page_table.shape
    sel = pages[page_table.reshape(-1).long()]          # (B*PP, ps, Hkv, D)
    ps, hkv, d = sel.shape[1:]
    return sel.reshape(b, pp * ps, hkv, d)


def decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Single-token paged decode attention: q (B,Hq,D); pages
    (P,ps,Hkv,D); page_table (B,PP); lengths (B,) -> (B,Hq,D), keys at
    positions >= lengths[b] masked."""
    d = q.shape[-1]
    k = paged_gather(k_pages, page_table)               # (B,S,Hkv,D)
    v = paged_gather(v_pages, page_table)
    rep = q.shape[1] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * d ** -0.5
    pos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    s = torch.where(pos < lengths.long()[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, v.float())
    # a sequence with no position sees nothing: zeros, as the kernel writes
    return torch.where((lengths > 0)[:, None, None], out, 0.0).to(q.dtype)


def decode_attention_partial_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor,
                                 lengths: torch.Tensor):
    """``decode_attention_ref`` over a block of a sequence's positions, as
    a merge across blocks needs it: (out, lse), out (B,Hq,D) fp32
    normalised over the positions < lengths[b], lse (B,Hq) fp32 the
    log-sum-exp of their scaled scores; at lengths[b] == 0, zeros and
    -inf."""
    d = q.shape[-1]
    k = paged_gather(k_pages, page_table)
    v = paged_gather(v_pages, page_table)
    rep = q.shape[1] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * d ** -0.5
    pos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    seen = pos < lengths.long()[:, None, None]
    s = torch.where(seen, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(s - m)
    l = e.sum(dim=-1)
    out = torch.einsum("bhs,bshd->bhd", e, v.float())
    out = torch.where(l[..., None] > 0, out / l.clamp(min=1e-30)[..., None],
                      0.0)
    lse = torch.where(l > 0, m[..., 0] + torch.log(l.clamp(min=1e-30)),
                      float("-inf"))
    return out, lse
