"""Paged decode attention — the KV page table as GraphStore's VID->LPN
chain, on Hopper.

Replaces the Pallas kernel ``repro/kernels/decode_attention.py::
_decode_kernel`` (``pallas_call`` at ``decode_attention.py:90``).  CUDA
source: ``csrc/decode_attention.cu``.

One new token per sequence: q (B,Hq,D) fp32 against the (P,ps,Hkv,D) K
and V page pools through page_table (B,PP) int32, masked by lengths (B,)
int32.  Bound on the H100: bytes (each of the sequence's K and V rows is
read once for 4*G*D flops per position).  One block per (batch, KV head)
holds its G = Hq/Hkv query heads and walks the sequence's pages with an
online softmax; pages at or past ``lengths[b]`` are never read, so the
page table's padding may name any page.  The TPU kernel's
scalar-prefetched page table becomes a plain load of the page id by the
block.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import decode_attention_ref

launches = 0


def decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q (B,Hq,D); pages (P,ps,Hkv,D); page_table (B,PP); lengths (B,)
    -> (B,Hq,D)."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_pages, v_pages, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: tensors on {q.device}; the "
                         "kernel takes CUDA tensors and the plain version "
                         "CPU ones")
    dev, f32, i32 = q.device, torch.float32, torch.int32
    _build.check("decode_attention", "q", q, dtype=f32, ndim=3, device=dev)
    _build.check("decode_attention", "k_pages", k_pages, dtype=f32, ndim=4,
                 device=dev)
    _build.check("decode_attention", "v_pages", v_pages, dtype=f32, ndim=4,
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
    _build.check_sizes("decode_attention", b * hkv, n_pool * ps, d, pp)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.repro_decode_attention_f32(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b,
            hkv, hq // hkv, d, n_pool, ps, pp, 1.0 / d ** 0.5,
            _build.stream(dev))
    _build.raise_on(rc, "decode_attention")
    launches += 1
    return out
