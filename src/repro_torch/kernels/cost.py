"""What each kernel call needs: the bytes it must move (each input read
once, each output written once) and the operations it must do, from its
arguments.  ``chip_smoke.py`` turns them into each kernel's bound on the
card; the dry run (``launch/dryrun.py``) adds them to a traced step's
flops and bytes, since a kernel launch is no aten op that a dispatch
mode sees.
"""
from __future__ import annotations

import torch


# ------------------------------------------------------------ GNN kernels
def gathered_rows(nbr, mask, prefix: int = 0) -> int:
    """Distinct rows of h that unmasked slots (and a destination prefix)
    need: what this call's data must read, each row once."""
    rows = nbr[mask != 0].long()
    if prefix:
        rows = torch.cat([rows, torch.arange(prefix, device=nbr.device)])
    return int(torch.unique(rows).numel())


def call_cost(name: str, args) -> tuple[float, float]:
    """(bytes, fp32 flops) a GNN kernel call needs: each input read once,
    each output written once."""
    if name == "gemm":
        a, b = args
        m, k = a.shape
        n = b.shape[1]
        return (m * k + k * n + m * n) * a.element_size(), 2.0 * m * n * k
    h, nbr, mask = args[:3]
    f = h.shape[1]
    d, k = nbr.shape
    nnz = int((mask != 0).sum())
    ell = nbr.numel() * 4 + mask.numel() * 4
    if name == "spmm":
        return gathered_rows(nbr, mask) * f * 4 + ell + d * f * 4, \
            2.0 * nnz * f
    if name == "sddmm":
        return (gathered_rows(nbr, mask, prefix=d) * f * 4 + ell
                + d * k * f * 4), 2.0 * nnz * f
    w = args[3]
    o = w.shape[1]
    bias = o * 4 if len(args) > 4 and args[4] is not None else 0
    return (gathered_rows(nbr, mask) * f * 4 + ell + f * o * 4 + bias
            + d * o * 4), 2.0 * nnz * f + 2.0 * d * f * o


# ------------------------------------------------------------- LM kernels
def _sum_positive(a: int, b: int, alpha: int, beta: int) -> int:
    """Sum of max(0, alpha * i + beta) over the integers a <= i < b, for
    alpha in (-1, 0, 1)."""
    if alpha == 1:
        a = max(a, 1 - beta)
    elif alpha == -1:
        b = min(b, beta)
    elif beta <= 0:
        return 0
    if b <= a:
        return 0
    return alpha * (a + b - 1) * (b - a) // 2 + beta * (b - a)


def visible_pairs(t: int, s: int, *, causal: bool, window: int) -> int:
    """(query, key) pairs the flash kernel's mask leaves visible for t
    queries at positions 0..t-1 over s keys: key j is visible to query i
    when j <= i (causal) and i - j < window (window > 0).  In closed
    form: the count a query sees is linear between the breakpoints i = s
    (causal) and i = window - 1, and clipped at 0."""
    cuts = {0, t}
    if causal:
        cuts.add(min(max(s, 0), t))
    if window > 0:
        cuts.add(min(max(window - 1, 0), t))
    cuts = sorted(cuts)
    total = 0
    for a, b in zip(cuts, cuts[1:]):
        a_h, b_h = (1, 0) if causal and a < s else (0, s - 1)   # last key
        a_l, b_l = (1, 1 - window) if window > 0 and a >= window - 1 \
            else (0, 0)                                          # first key
        total += _sum_positive(a, b, a_h - a_l, b_h - b_l + 1)
    return total


def decode_positions(k_pages, page_table, lengths) -> int:
    """Cached positions a decode_attention call reads: each sequence's
    length, clipped to its page table's capacity; on ``meta`` tensors,
    which hold no lengths, the capacity itself."""
    cap = page_table.shape[1] * k_pages.shape[1]
    if lengths.device.type == "meta":
        return lengths.shape[0] * cap
    return int(lengths.clamp(min=0, max=cap).sum())


def lm_call_cost(name: str, args, kwargs) -> tuple[float, float]:
    """(bytes, flops) one LM kernel call needs: each input read once, each
    output written once, at its element size (decode_attention_partial's
    out and lse in fp32); attention counts the key positions this call's
    mask, window and lengths leave visible."""
    if name == "rmsnorm":
        x, w = args
        return 2 * x.numel() * x.element_size() + w.numel() * 4, 4.0 * x.numel()
    if name == "flash_attention":
        q, k, v = args
        b, hq, t, d = q.shape
        pairs = visible_pairs(t, k.shape[2], causal=kwargs.get("causal", True),
                              window=kwargs.get("window", 0))
        return ((2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
                4.0 * b * hq * pairs * d)
    q, k_pages, _, pt, lengths = args
    hkv, d = k_pages.shape[2], k_pages.shape[3]
    n = decode_positions(k_pages, pt, lengths)
    out = q.numel() * q.element_size()
    if name == "decode_attention_partial":      # out and lse in fp32
        out = (q.numel() + q.shape[0] * q.shape[1]) * 4
    return ((2 * n * hkv * d + q.numel()) * q.element_size() + out
            + (pt.numel() + lengths.numel()) * 4, 4.0 * n * q.shape[1] * d)


def lm_dot_flops(name: str, args, kwargs) -> float:
    """The flops of a call's products at their full shapes, as an HLO
    dot counts them: every query against every key (flash), every
    position the page table holds (decode); rmsnorm has none."""
    if name == "flash_attention":
        q, k, _ = args
        b, hq, t, d = q.shape
        return 4.0 * b * hq * t * k.shape[2] * d
    if name in ("decode_attention", "decode_attention_partial"):
        q, k_pages, _, pt, _ = args
        return 4.0 * q.shape[0] * q.shape[1] * pt.shape[1] \
            * k_pages.shape[1] * q.shape[2]
    return 0.0
