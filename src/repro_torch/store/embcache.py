"""Device-DRAM page cache — hot embedding (and adjacency) pages pinned near
the accelerator, fronting GraphStore's batched scatter-reads.

Copy of ``repro/store/embcache.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

The paper's CSSD keeps its DRAM close to the FPGA user logic; at serving
time the same hot vertices recur across requests (power-law access), so a
bounded LRU over 4 KB pages turns most of a warm request's embedding gather
into DRAM hits instead of flash commands.

The structure mirrors what the FPGA would hold in BRAM/DRAM, and is fully
vectorized — a whole scatter-read resolves with array ops, no per-page
Python:

  * a page **slab** ``(capacity, SLOTS_PER_PAGE)`` holding cached page data;
  * an LPN -> slot **mapping table** (dense ndarray over the device's LPN
    space, grown on demand) giving O(batch) vectorized lookup;
  * per-slot **last-use ticks** (one tick per read call) driving batched
    LRU eviction: when a read needs more slots than are free, the least
    recently used slots are reclaimed in one ``argpartition``.

Mechanics:

  * ``read_pages`` is a drop-in for ``BlockDevice.read_pages``: hits are
    gathered from the slab, the misses of one request are fetched with ONE
    queued dev.read_pages (the PR-1 fast path is preserved) and inserted;
  * invalidation is hooked at the device write layer (``BlockDevice.on_write``
    fires for every ``write_page``/``write_span``/``free_page`` and for the
    page-relocating ``_grow``), so every mutable-graph path — unit updates,
    L-page splits, H promotions, embedding RMWs — drops exactly the pages it
    touched and serving stays correct without per-call-site bookkeeping;
  * hit/miss/byte counters are exposed through ``GraphStoreStats.cache``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from ..concurrency import witness_lock
from .blockdev import PAGE_BYTES, SLOTS_PER_PAGE, SLOT_DTYPE


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0
    bytes_from_cache: int = 0
    bytes_from_dev: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "bytes_from_cache": self.bytes_from_cache,
                "bytes_from_dev": self.bytes_from_dev,
                "hit_rate": self.hit_rate}


class EmbeddingPageCache:
    """Bounded LRU page cache: slab + dense LPN->slot table (thread-safe)."""

    def __init__(self, capacity_pages: int = 4096):
        if capacity_pages < 1:
            raise ValueError("capacity must be at least one page")
        self.capacity = int(capacity_pages)
        self._slab = np.empty((self.capacity, SLOTS_PER_PAGE), SLOT_DTYPE)
        self._slot_lpn = np.full(self.capacity, -1, np.int64)  # slot -> lpn
        self._last_use = np.zeros(self.capacity, np.int64)     # slot -> tick
        self._lpn_slot = np.full(1024, -1, np.int64)           # lpn -> slot
        self._free: list[int] = list(range(self.capacity))
        self._tick = 0
        self._lock = witness_lock("embcache._lock", threading.RLock())
        self.stats = CacheStats()

    def __len__(self) -> int:
        return self.capacity - len(self._free)

    def _table_for(self, max_lpn: int) -> np.ndarray:
        if max_lpn >= len(self._lpn_slot):
            grown = np.full(max(max_lpn + 1, 2 * len(self._lpn_slot)), -1,
                            np.int64)
            grown[: len(self._lpn_slot)] = self._lpn_slot
            self._lpn_slot = grown
        return self._lpn_slot

    def read_pages(self, dev, lpns, *, tag: str = "embed") -> np.ndarray:
        """Cache-fronted batched scatter-read -> (len(lpns), SLOTS_PER_PAGE)."""
        lpns = np.asarray(lpns, dtype=np.int64).reshape(-1)
        if not len(lpns):
            return np.empty((0, SLOTS_PER_PAGE), SLOT_DTYPE)
        with self._lock:
            self._tick += 1
            table = self._table_for(int(lpns.max()))
            slots = table[lpns]
            hit = slots >= 0
            n_hit = int(hit.sum())
            block = np.empty((len(lpns), SLOTS_PER_PAGE), SLOT_DTYPE)
            if n_hit:
                block[hit] = self._slab[slots[hit]]
                self._last_use[slots[hit]] = self._tick
            self.stats.hits += n_hit
            self.stats.bytes_from_cache += n_hit * PAGE_BYTES
            miss = ~hit
            n_miss = len(lpns) - n_hit
            if n_miss:
                miss_lpns = lpns[miss]
                fetched = dev.read_pages(miss_lpns, tag=tag)
                block[miss] = fetched
                self.stats.misses += n_miss
                self.stats.bytes_from_dev += n_miss * PAGE_BYTES
                self._insert(miss_lpns, fetched)
        return block

    def _insert(self, lpns: np.ndarray, pages: np.ndarray) -> None:
        """Install fetched pages; batched LRU eviction frees slots needed.

        ``lpns`` may exceed capacity (a scan bigger than the cache): only
        the trailing ``capacity`` pages are kept — the rest would be evicted
        within this very call anyway.
        """
        if len(lpns) > self.capacity:
            lpns, pages = lpns[-self.capacity:], pages[-self.capacity:]
        need = len(lpns) - len(self._free)
        if need > 0:                          # reclaim the LRU slots in bulk
            used = np.nonzero(self._slot_lpn >= 0)[0]
            order = np.argpartition(self._last_use[used], need - 1)[:need]
            victims = used[order]
            self._lpn_slot[self._slot_lpn[victims]] = -1
            self._slot_lpn[victims] = -1
            self._free.extend(victims.tolist())
            self.stats.evictions += need
        slots = np.array([self._free.pop() for _ in range(len(lpns))],
                         dtype=np.int64)
        self._slab[slots] = pages
        self._slot_lpn[slots] = lpns
        self._last_use[slots] = self._tick
        self._lpn_slot[lpns] = slots

    def clone_empty(self) -> "EmbeddingPageCache":
        """A fresh, cold cache with this cache's capacity — the rebuild
        path attaches one to a failed shard's replacement device (the old
        device's DRAM, and thus its cache contents, died with it)."""
        return EmbeddingPageCache(self.capacity)

    def invalidate(self, lpn0: int, n_pages: int = 1) -> None:
        """Drop [lpn0, lpn0 + n_pages) — the device-write hook."""
        with self._lock:
            lo = min(lpn0, len(self._lpn_slot))
            hi = min(lpn0 + n_pages, len(self._lpn_slot))
            if lo >= hi:
                return
            slots = self._lpn_slot[lo:hi]
            doomed = slots[slots >= 0]
            if len(doomed):
                self._slot_lpn[doomed] = -1
                self._lpn_slot[lo:hi] = -1
                self._free.extend(doomed.tolist())
                self.stats.invalidations += len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._lpn_slot[:] = -1
            self._slot_lpn[:] = -1
            self._free = list(range(self.capacity))
