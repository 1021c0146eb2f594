"""Paged KV-cache manager — GraphStore's VID->LPN mapping generalized to
LM serving, with the page pools resident on the engine's device.

Counterpart of ``repro/store/pagedkv.py``.  The allocator is the
reference's: each sequence (the H-type high-degree vertex) owns a chain
of fixed-size pages recorded in its page table; pages come from a free
list on demand as the sequence grows and go back to it when the
sequence is released, and ``page_table`` pads with page 0.

What differs: the K and V pools are device tensors of shape
``(L, P, page_size, KVH, head_dim)``, the layout the decode_attention
kernel reads, so attention reads the resident pool instead of a host
copy per layer and step.  A block of ``T`` new KV rows is written with
one indexed store per layer (:meth:`PagedKVManager.write_slots`), not
a loop per token; :meth:`PagedKVManager.slots` computes where the rows
go once for all layers.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device


@dataclass
class PagePool:
    num_pages: int
    page_size: int
    num_layers: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "float32"
    device: str | torch.device | None = None     # None: the card

    def __post_init__(self):
        self.device = resolve_device(self.device)
        shp = (self.num_layers, self.num_pages, self.page_size,
               self.num_kv_heads, self.head_dim)
        dt = getattr(torch, self.dtype)
        self.k = torch.zeros(shp, dtype=dt, device=self.device)
        self.v = torch.zeros(shp, dtype=dt, device=self.device)
        self._free: list[int] = list(range(self.num_pages - 1, -1, -1))
        self.alloc_count = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise MemoryError("KV page pool exhausted")
        self.alloc_count += 1
        return self._free.pop()

    def free(self, pages) -> None:
        self._free.extend(int(p) for p in pages)


@dataclass
class Sequence:
    sid: int
    tokens: list
    pages: list = field(default_factory=list)   # page-table chain (H-type)
    length: int = 0                             # KV slots filled
    done: bool = False
    generated: list = field(default_factory=list)


class PagedKVManager:
    def __init__(self, pool: PagePool):
        self.pool = pool
        self.seqs: dict[int, Sequence] = {}

    def add_sequence(self, sid: int, tokens) -> Sequence:
        seq = Sequence(sid=sid, tokens=list(tokens))
        self.seqs[sid] = seq
        return seq

    def ensure_capacity(self, seq: Sequence, new_len: int) -> None:
        ps = self.pool.page_size
        while len(seq.pages) * ps < new_len:
            seq.pages.append(self.pool.alloc())

    def slots(self, seqs, starts, counts):
        """(page, offset) index tensors on the pool's device for
        ``counts[i]`` rows of ``seqs[i]`` from logical position
        ``starts[i]``, concatenated in order; grows the page chains."""
        ps = self.pool.page_size
        pages, offs = [], []
        for seq, start, t in zip(seqs, starts, counts):
            self.ensure_capacity(seq, start + t)
            pos = np.arange(start, start + t)
            pages.append(np.asarray(seq.pages, np.int64)[pos // ps])
            offs.append(pos % ps)
        dev = self.pool.k.device
        return (torch.from_numpy(np.concatenate(pages)).to(dev),
                torch.from_numpy(np.concatenate(offs)).to(dev))

    def write_slots(self, layer: int, slots, k: torch.Tensor,
                    v: torch.Tensor) -> None:
        """Write (N, KVH, hd) rows of ``layer`` at ``slots`` (from
        :meth:`slots`), one indexed store per pool."""
        pages, offs = slots
        self.pool.k[layer, pages, offs] = k.to(self.pool.k.dtype)
        self.pool.v[layer, pages, offs] = v.to(self.pool.v.dtype)

    def write_kv(self, seq: Sequence, layer: int, k: torch.Tensor,
                 v: torch.Tensor, start: int) -> None:
        """Write (T, KVH, hd) at logical positions [start, start+T)."""
        self.write_slots(layer, self.slots([seq], [start], [k.shape[0]]),
                         k, v)

    def page_table(self, seqs, max_pages: int) -> np.ndarray:
        """(B, max_pages) int32 table for the kernel (pad with page 0)."""
        pt = np.zeros((len(seqs), max_pages), np.int32)
        for i, s in enumerate(seqs):
            pt[i, : len(s.pages)] = s.pages
        return pt

    def release(self, seq: Sequence) -> None:
        self.pool.free(seq.pages)
        seq.pages = []
        self.seqs.pop(seq.sid, None)

    def utilization(self) -> float:
        used = self.pool.num_pages - self.pool.free_pages
        return used / self.pool.num_pages
