"""Paged decode attention — the KV page table as GraphStore's VID->LPN
chain, on Hopper.

Replaces the Pallas kernel ``repro/kernels/decode_attention.py::
_decode_kernel`` (``pallas_call`` at ``decode_attention.py:90``).  CUDA
source: ``csrc/decode_attention.cu``.

One new token per sequence: q (B,Hq,D) against the (P,ps,Hkv,D) K and
V page pools through page_table (B,PP) int32, masked by lengths (B,)
int32; q and the pools are all fp32 or all bf16 (the dense LM path's
caches, viewed as pages), fp32 inside, the output in q's dtype.
Bound on the H100: bytes (each of the sequence's K and V rows is read
once for 4*G*D flops per position).  Each sequence's pages are split
over blocks (flash-decoding): a block owns ``pages_per_split(ps, D,
element size)`` pages of one (batch, KV head), brings their K and V rows
into shared memory with TMA bulk copies and writes a partial (m, l, acc)
for its query heads; a combine kernel, launched by the same C call,
merges the splits in order.
The grid comes from the page table's width; each block reads its
sequence's length on the card, so the wrapper never reads ``lengths`` on
the host.  Pages at or past ``lengths[b]`` are never read, so the page
table's padding may name any page.  Split boundaries depend on the
pools' page size, head dim and element size only, so a sequence's
output bits do not depend on its batch or on the table's padded width.
The TPU kernel's scalar-prefetched page table becomes a plain load of
the page ids by each block.

:func:`decode_attention_partial` is the same kernel over one slot's
block of a sequence-split cache (a serving step split over the model
axis), writing the normalised fp32 accumulator and the log-sum-exp, what
:func:`merge_partials` needs to merge the slots' blocks.  A slot's block
is short (3 to 128 positions on the split serving step), so the partial
has its own split of ``partial_pages_per_split(ps, D, element size)``
pages (16 positions at most), and where a sequence's splits fit one
thread-block cluster (``CLUSTER_SPLITS``) its C entry runs them in one
launch, merging the splits in the cluster's shared memory with the
combine kernel's arithmetic: no workspace.  Wider page tables take the
split and combine kernels at the same split, so the path never changes
a bit (:func:`partial_plan`).  The merge across slots is plain torch on
the gathering slot, the counterpart of GSPMD's reduction across devices,
not of a Pallas kernel.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import decode_attention_partial_ref, decode_attention_ref

launches = 0
partial_launches = 0

PAGES_PER_SPLIT = 4           # pages a block owns: 64 positions at ps = 16
SPLIT_SMEM = 160 * 1024       # at most this many bytes of K and V rows a block
PARTIAL_SPLIT = 16            # positions a partial's split owns, at most
CLUSTER_SPLITS = 8            # splits a cluster merges: the portable limit
BLOCK_SMEM = 232448           # shared memory a block can have on the H100
MAX_HEAD_DIM = 512
_ENTRY = {torch.float32: "repro_decode_attention_f32",
          torch.bfloat16: "repro_decode_attention_bf16"}
_PARTIAL_ENTRY = {torch.float32: "repro_decode_attention_partial_f32",
                  torch.bfloat16: "repro_decode_attention_partial_bf16"}


def _fit(n: int, ps: int, d: int, elem_size: int) -> int:
    """``n`` pages, halved while a split's K and V rows (D elements of
    ``elem_size`` bytes, rounded up to 16 bytes) would take more than
    SPLIT_SMEM bytes of shared memory."""
    per = 16 // elem_size
    while n > 1 and 2 * n * ps * (-(-d // per) * per) * elem_size > SPLIT_SMEM:
        n //= 2
    return n


def pages_per_split(ps: int, d: int, elem_size: int = 4) -> int:
    """Pages of a split: PAGES_PER_SPLIT, halved while the split's K and V
    rows would take more than SPLIT_SMEM bytes of shared memory.  A
    function of the pools' page size, head dim and element size only, so
    the split boundaries of a sequence never move with its batch or with
    the page table's width."""
    return _fit(PAGES_PER_SPLIT, ps, d, elem_size)


def partial_pages_per_split(ps: int, d: int, elem_size: int = 4) -> int:
    """Pages of a split of :func:`decode_attention_partial`: PARTIAL_SPLIT
    positions (one page where a page holds more), halved as
    :func:`pages_per_split` is; a function of the same three only."""
    return _fit(max(1, PARTIAL_SPLIT // ps), ps, d, elem_size)


def cluster_smem(pps: int, ps: int, d: int, elem_size: int,
                 n_split: int) -> int:
    """Bytes of shared memory a block of the one-launch partial takes
    (``csrc/decode_attention.cu``'s ``split_bytes`` and block 0's slots)
    at the largest head chunk (8 query heads): K rows or the P @ V
    partials, V rows, q, scores and page ids, then n_split (m, l,
    acc[D]) for each head."""
    per = 16 // elem_size
    lds, sl, gt = -(-d // per) * per, pps * ps, 8
    used = (max(sl * lds * elem_size, 128 // (lds // 4) * gt * lds * 4)
            + (sl + gt) * lds * elem_size + 4 * gt * sl + 4 * pps)
    return -(-used // 16) * 16 + 4 * n_split * gt * (d + 2)


def partial_plan(ps: int, d: int, elem_size: int,
                 pp: int) -> tuple[int, int, bool]:
    """(pages a split, splits, cluster) of a partial call over a page
    table of ``pp`` pages: the splits run as one cluster, in one launch,
    where there are 1 to CLUSTER_SPLITS of them and a block's shared
    memory holds them (:func:`cluster_smem`); else as the split and
    combine kernels over a workspace.  The split length depends on ps, D
    and the element size alone, whichever path the table's width picks."""
    pps = partial_pages_per_split(ps, d, elem_size)
    n_split = -(-pp // pps)
    return pps, n_split, (1 <= n_split <= CLUSTER_SPLITS and cluster_smem(
        pps, ps, d, elem_size, n_split) <= BLOCK_SMEM)


def workspace(q, k_pages, page_table,
              pps: int | None = None) -> tuple[torch.Tensor, int]:
    """(ws, pages a split): the fp32 scratch the launch writes each
    split's partial (m, l and D accumulators) into, B*Hq*n_split*(D+2)
    on q's device, where the combine kernel reads them; ``pps`` pages a
    split, by default :func:`pages_per_split`'s.  The ``meta`` branch
    allocates it too, so that a trace's live bytes hold it."""
    b, hq, d = q.shape
    if pps is None:
        pps = pages_per_split(k_pages.shape[1], d, q.element_size())
    n_split = -(-page_table.shape[1] // pps)
    return torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32,
                       device=q.device), pps


def _checked(q, k_pages, v_pages, page_table, lengths) -> None:
    """Every check the kernel's launch makes, for a CUDA call and a
    ``meta`` one alike."""
    dev, i32 = q.device, torch.int32
    dt = q.dtype if q.dtype in _ENTRY else torch.float32
    _build.check("decode_attention", "q", q, dtype=dt, ndim=3, device=dev)
    _build.check("decode_attention", "k_pages", k_pages, dtype=dt, ndim=4,
                 device=dev)
    _build.check("decode_attention", "v_pages", v_pages, dtype=dt, ndim=4,
                 device=dev)
    _build.check("decode_attention", "page_table", page_table, dtype=i32,
                 ndim=2, device=dev)
    _build.check("decode_attention", "lengths", lengths, dtype=i32, ndim=1,
                 device=dev)
    b, hq, d = q.shape
    n_pool, ps, hkv, d2 = k_pages.shape
    pp = page_table.shape[1]
    if (tuple(v_pages.shape) != tuple(k_pages.shape) or d2 != d or hkv == 0
            or hq % hkv or page_table.shape[0] != b
            or lengths.shape[0] != b):
        raise ValueError(
            f"decode_attention shapes q {tuple(q.shape)} pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} page_table "
            f"{tuple(page_table.shape)} lengths {tuple(lengths.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {d} > {MAX_HEAD_DIM}")
    _build.check_sizes("decode_attention", b * hq, n_pool * ps, d, pp * ps)


def _no_grad(q, k_pages, v_pages, name: str) -> None:
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pages, v_pages)):
        raise RuntimeError(f"{name} has no gradient (no training path "
                           "decodes); call it under torch.no_grad() or on "
                           "inputs that do not require one")


def _device(q, name: str) -> None:
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: tensors on {q.device}; the kernel takes "
                         "CUDA tensors (meta ones for its checks alone) and "
                         "the plain version CPU ones")


def _launch(entry, q, k_pages, v_pages, page_table, lengths, outs, ws,
            pps, *flags) -> None:
    """The C entry ``entry`` on the arguments, ``outs`` and ``ws`` device
    pointers (``ws`` None for none), ``flags`` the int arguments after
    the pages a split (the partial's cluster)."""
    b, hq, d = q.shape
    n_pool, ps, hkv, _ = k_pages.shape
    pp = page_table.shape[1]
    lib = _build.library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, entry)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), *outs, ws, b, hkv,
            hq // hkv, d, n_pool, ps, pp, pps, *flags, 1.0 / d ** 0.5,
            _build.stream(q.device))
    _build.raise_on(rc, entry)


def decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q (B,Hq,D); pages (P,ps,Hkv,D); page_table (B,PP); lengths (B,)
    -> (B,Hq,D), zeros for a sequence at length 0.  On ``meta`` tensors:
    the kernel's checks, an empty output and the launch's scratch
    (:func:`workspace`), no launch.  No gradient: no training path
    decodes, so a call that asks for one (an input that requires it,
    grad mode on) raises."""
    global launches
    _no_grad(q, k_pages, v_pages, "decode_attention")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_pages, v_pages, page_table, lengths)
    _device(q, "decode_attention")
    _checked(q, k_pages, v_pages, page_table, lengths)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ws, pps = workspace(q, k_pages, page_table)
    if q.device.type == "meta":
        return out
    _launch(_ENTRY[q.dtype], q, k_pages, v_pages, page_table, lengths,
            (out.data_ptr(),), ws.data_ptr(), pps)
    launches += 1
    return out


def decode_attention_partial(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, page_table: torch.Tensor,
                             lengths: torch.Tensor):
    """:func:`decode_attention` over a block of each sequence's positions:
    (out, lse), out (B,Hq,D) fp32 normalised over the block's positions
    < lengths[b], lse (B,Hq) fp32 the log-sum-exp of their scaled
    scores; zeros and -inf at lengths[b] == 0.  The same checks and
    ``meta`` branch as :func:`decode_attention`, at
    :func:`partial_plan`'s split: one launch and no scratch where the
    splits fit a cluster, else the workspace; counted in
    ``partial_launches``."""
    global partial_launches
    _no_grad(q, k_pages, v_pages, "decode_attention_partial")
    if q.device.type == "cpu":
        return decode_attention_partial_ref(q, k_pages, v_pages, page_table,
                                            lengths)
    _device(q, "decode_attention_partial")
    _checked(q, k_pages, v_pages, page_table, lengths)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    pps, _, cluster = partial_plan(k_pages.shape[1], q.shape[2],
                                   q.element_size(), page_table.shape[1])
    ws = None if cluster else workspace(q, k_pages, page_table, pps)[0]
    if q.device.type == "meta":
        return out, lse
    _launch(_PARTIAL_ENTRY[q.dtype], q, k_pages, v_pages, page_table,
            lengths, (out.data_ptr(), lse.data_ptr()),
            None if ws is None else ws.data_ptr(), pps, int(cluster))
    partial_launches += 1
    return out, lse


def merge_partials(outs, lses, dtype: torch.dtype | None = None):
    """The attention over the union of blocks of positions, from each
    block's :func:`decode_attention_partial` (out (B,H,D) and lse (B,H),
    fp32), given in slot order: sum_i exp(lse_i - m) out_i / sum_i
    exp(lse_i - m) with m the largest lse, summed in slot order in fp32
    and rounded once to ``dtype`` (default: fp32); zeros where no block
    sees a position (every lse -inf).  Plain torch."""
    m = lses[0]
    for s in lses[1:]:
        m = torch.maximum(m, s)
    m = torch.where(torch.isfinite(m), m, 0.0)
    acc = den = None
    for o, s in zip(outs, lses):
        w = torch.exp(s - m)
        term = o * w[..., None]
        acc = term if acc is None else acc + term
        den = w if den is None else den + w
    out = torch.where(den[..., None] > 0, acc / den.clamp(min=1e-30)[..., None],
                      0.0)
    return out.to(dtype or torch.float32)
