"""GraphStore — graph-centric archiving on a page block device (paper §4.1).

Copy of ``repro/store/graphstore.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

Implements the paper's dual mapping:

  * **H-type** (high-degree vertices): per-vertex chain of pages, each page
    ``[count, next_lpn, n0, n1, ...]``.  The mapping table entry is
    VID -> head LPN (we additionally keep a tail pointer so appends are O(1),
    reads still walk the chain as in the paper).
  * **L-type** (low-degree vertices): many vertices packed in one page.
    Neighbor chunks grow from slot 0; meta grows from the page end:
    ``slot[-1]=n_nodes, slot[-2]=data_len,`` then per node *i*
    ``slot[-3-2i]=vid, slot[-4-2i]=chunk_offset``.  The L-type table key is
    the *largest* VID stored in the page (range search, paper Fig. 8).
  * **gmap**: VID -> {H, L} selector bitmap.

Embeddings are stored sequentially in the *embedding space* (top of the
device, paper Fig. 7) with no page-level mapping: the location of VID *v*'s
feature row is computed from ``v`` directly.

Bulk ingest (``update_graph``) overlaps graph preprocessing (edge array ->
undirected, self-looped, sorted adjacency) with the heavy embedding-table
write, reproducing the paper's Fig. 18 behaviour: from the user's viewpoint
the bulk latency ~= data transfer + embedding write.
"""
from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..concurrency import witness_lock
from .blockdev import BlockDevice, SLOTS_PER_PAGE, SLOT_DTYPE
from .sampler import _ramp

# H-type page layout
_H_COUNT, _H_NEXT, _H_DATA = 0, 1, 2
H_CAP = SLOTS_PER_PAGE - _H_DATA          # neighbors per H page

# L-type page layout (meta from the end)
_L_NNODES = SLOTS_PER_PAGE - 1
_L_DATALEN = SLOTS_PER_PAGE - 2


def _l_meta_vid(i: int) -> int:
    return SLOTS_PER_PAGE - 3 - 2 * i


def _l_meta_off(i: int) -> int:
    return SLOTS_PER_PAGE - 4 - 2 * i


def neighbors_from_plan(vids_arr: np.ndarray, block, desc) -> list[np.ndarray]:
    """Materialise per-vid neighbor arrays out of a fetched plan.

    Shared back half of the batched GetNeighbors: the single-device store
    feeds it one ``_fetch_plan`` result; the sharded coordinator feeds it a
    recomposition of N per-shard plans (descriptor rows re-based into the
    concatenated block) — either way the output equals ``get_neighbors``
    per vid.
    """
    out: list = [None] * len(vids_arr)
    for pos, d in enumerate(desc):
        if d is None:
            out[pos] = np.empty(0, dtype=SLOT_DTYPE)
        elif d[0] == "L":
            _, row, start, end = d
            out[pos] = block[row, start:end].copy()
        else:
            _, rows, counts = d
            got = [block[r, _H_DATA: _H_DATA + int(c)]
                   for r, c in zip(rows, counts)]
            out[pos] = (np.concatenate(got) if got
                        else np.empty(0, dtype=SLOT_DTYPE))
    return out


def select_from_plan(vids_arr: np.ndarray, block, desc, fanout: int,
                     rng: np.random.Generator | None = None, *,
                     segments=None, rngs=None):
    """Fanout selection over a fetched plan — the back half of the fused
    near-storage sample (see ``GraphStore.sample_neighbors_batch``).

    A pure function of (plan, rng): hubs are Floyd-sampled BY INDEX against
    their chain page counts, uniform draws are consumed one ``fanout``
    block per over-full vertex in frontier order (or per-request segment
    order when ``segments``/``rngs`` are given).  The sharded coordinator
    recomposes N per-shard plans into one global (block, desc) and runs
    this same code, which is why an N-shard sample is bit-identical to the
    single-device sample under the same seed.
    """
    flatb = block.reshape(-1) if block is not None else None
    npos = len(vids_arr)

    # numeric plan arrays (pure-int loop; all math below is vector)
    lens = np.zeros(npos, dtype=np.int64)
    is_l = np.zeros(npos, dtype=bool)
    base = np.zeros(npos, dtype=np.int64)   # L: flat addr of chunk
    for pos, d in enumerate(desc):
        if d is None:
            continue
        if d[0] == "L":
            is_l[pos] = True
            lens[pos] = d[3] - d[2]
            base[pos] = d[1] * SLOTS_PER_PAGE + d[2]
        else:
            lens[pos] = int(d[2].sum())
    over = lens > fanout
    lens_sel = np.where(lens == 0, 1, np.minimum(lens, fanout))
    out_offs = np.concatenate([[0], np.cumsum(lens_sel)[:-1]])
    sel = np.empty(int(lens_sel.sum()), dtype=SLOT_DTYPE)

    # degenerate rows: self-loop
    empty = lens == 0
    sel[out_offs[empty]] = vids_arr[empty]

    # under-full rows copied through (one flat gather; H multi-chunk
    # under-full rows are rare — degree <= fanout but H-mapped)
    for cls in np.nonzero(~over & ~empty & ~is_l)[0]:
        _, rows, counts = desc[cls]
        o, c0 = int(out_offs[cls]), 0
        for r, c in zip(rows, counts):
            sel[o + c0: o + c0 + int(c)] = \
                block[r, _H_DATA: _H_DATA + int(c)]
            c0 += int(c)
    ul = ~over & ~empty & is_l
    if ul.any():
        lv = lens[ul]
        src = np.repeat(base[ul], lv) + _ramp(lv)
        sel[np.repeat(out_offs[ul], lv) + _ramp(lv)] = flatb[src]

    # over-full rows: Floyd by index, vectorized across the frontier
    # (k steps of whole-row vector math, no per-vertex python)
    n_over = int(over.sum())
    if n_over:
        if rngs is not None:
            bounds = np.concatenate([[0], np.cumsum(segments)])
            parts = [g.random(int(over[bounds[s]: bounds[s + 1]]
                                  .sum()) * fanout)
                     for s, g in enumerate(rngs)]
            u = np.concatenate(parts).reshape(-1, fanout)
        else:
            u = rng.random(n_over * fanout).reshape(-1, fanout)
        m_arr = lens[over]
        idx = np.empty((n_over, fanout), dtype=np.int64)
        for j2 in range(fanout):
            t = (u[:, j2] * (m_arr - fanout + j2 + 1)).astype(np.int64)
            if j2:
                dup = (idx[:, :j2] == t[:, None]).any(axis=1)
                t = np.where(dup, m_arr - fanout + j2, t)
            idx[:, j2] = t
        over_pos = np.nonzero(over)[0]
        ol = over & is_l
        if ol.any():
            ol_in_over = is_l[over_pos]
            src = base[ol][:, None] + idx[ol_in_over]
            dst = out_offs[ol][:, None] + np.arange(fanout)[None, :]
            sel[dst.reshape(-1)] = flatb[src.reshape(-1)]
        for r_i, cls in enumerate(over_pos):
            if is_l[cls]:
                continue
            _, rows, counts = desc[cls]      # hub: index by page
            cum = np.cumsum(counts)
            p = np.searchsorted(cum, idx[r_i], side="right")
            off = idx[r_i] - np.where(p > 0, cum[p - 1], 0)
            o = int(out_offs[cls])
            sel[o: o + fanout] = block[rows[p], _H_DATA + off]
    return sel, lens_sel


@dataclass
class BulkTimeline:
    """Timestamped phase spans of a bulk ingest (for Fig. 18)."""
    transfer: tuple[float, float] = (0.0, 0.0)
    graph_pre: tuple[float, float] = (0.0, 0.0)
    write_feature: tuple[float, float] = (0.0, 0.0)
    write_graph: tuple[float, float] = (0.0, 0.0)
    total: float = 0.0
    user_visible: float = 0.0     # transfer + embedding write (+ graph flush tail)


@dataclass
class GraphStoreStats:
    l_evictions: int = 0
    unit_updates: int = 0
    pages_h: int = 0
    pages_l: int = 0
    bulk: BulkTimeline = field(default_factory=BulkTimeline)
    cache: object | None = None   # CacheStats once a page cache is attached


class GraphStore:
    def __init__(self, dev: BlockDevice | None = None, *, h_threshold: int = 128,
                 feature_dim: int = 0):
        self.dev = dev or BlockDevice()
        self.h_threshold = int(h_threshold)
        self.gmap: dict[int, str] = {}                 # vid -> 'H' | 'L'
        self.h_table: dict[int, tuple[int, int]] = {}  # vid -> (head_lpn, tail_lpn)
        # full chain LPN list per H vid (device-DRAM mapping metadata, like
        # the tail pointer): lets batched GetNeighbors fetch whole chains in
        # one queued read instead of one pointer-chase round per page.
        self.h_chain: dict[int, list[int]] = {}
        self._l_keys: list[int] = []                   # sorted max-vid per L page
        self._l_lpns: list[int] = []                   # parallel LPN list
        self.feature_dim = int(feature_dim)
        self._emb_base: int | None = None              # first LPN of embedding span
        self._emb_rows = 0
        self.num_vertices = 0
        self.stats = GraphStoreStats()
        self._free_vids: list[int] = []                # deleted VIDs, reused (paper)
        self._lock = witness_lock("graphstore._lock", threading.RLock())
        self.cache = None                              # device-DRAM page cache
        self._cache_graph = True
        # device growth relocates the embedding space to the new top; the
        # table base must shift with it (without this, a neighbor-space
        # grow AFTER bulk ingest leaves _emb_base pointing at the zeroed
        # old span and every later embedding read returns garbage)
        self.dev.on_grow = self._on_dev_grow

    def _on_dev_grow(self, extra_pages: int) -> None:
        if self._emb_base is not None:
            self._emb_base += extra_pages

    def attach_cache(self, cache, *, cache_graph_pages: bool = True) -> None:
        """Front batched page reads with a device-DRAM LRU (serving hot set).

        Invalidation rides the device's write hook, so every mutable-graph
        path (unit updates, splits, promotions, embedding RMWs, device
        growth) drops exactly the pages it dirtied.
        """
        self.cache = cache
        self._cache_graph = cache_graph_pages
        self.stats.cache = cache.stats
        self.dev.on_write = cache.invalidate

    def attach_cache_pages(self, capacity_pages: int,
                           **kw) -> None:
        """Attach a fresh device-DRAM page cache of ``capacity_pages``
        (uniform entry point with the sharded store, which splits the
        budget across its shards' devices)."""
        from .embcache import EmbeddingPageCache
        self.attach_cache(EmbeddingPageCache(capacity_pages), **kw)

    def _read_pages_cached(self, lpns, tag: str) -> np.ndarray:
        if self.cache is not None and (tag == "embed" or self._cache_graph):
            return self.cache.read_pages(self.dev, lpns, tag=tag)
        return self.dev.read_pages(lpns, tag=tag)

    # ================================================================= helpers
    def _classify(self, degree: int) -> str:
        return "H" if degree > self.h_threshold else "L"

    def _new_l_page(self) -> tuple[int, np.ndarray]:
        lpn = self.dev.alloc_front()
        page = np.zeros(SLOTS_PER_PAGE, dtype=SLOT_DTYPE)
        self.stats.pages_l += 1
        return lpn, page

    @staticmethod
    def _l_free_slots(page: np.ndarray) -> int:
        n, dlen = int(page[_L_NNODES]), int(page[_L_DATALEN])
        return SLOTS_PER_PAGE - 2 - 2 * n - dlen

    @staticmethod
    def _l_scan(page: np.ndarray, vid: int) -> tuple[int, int, int] | None:
        """Return (meta_index, chunk_start, chunk_len) of vid in an L page
        (vectorized: the FPGA scans page meta in hardware; a Python loop
        here would dominate every near-storage GetNeighbors)."""
        n, dlen = int(page[_L_NNODES]), int(page[_L_DATALEN])
        if n == 0:
            return None
        vid_idx = _L_NNODES - 2 - 2 * np.arange(n)      # slot of meta vid i
        vids = page[vid_idx]
        offs = page[vid_idx - 1]
        hit = np.nonzero(vids == vid)[0]
        if not len(hit):
            return None
        i = int(hit[0])
        start = int(offs[i])
        later = offs[(offs > start) & (offs <= dlen)]
        # chunk end = smallest offset beyond start (tombstones included —
        # their offsets remain valid boundaries) or the data length.
        end = int(later.min()) if len(later) else dlen
        return i, start, end - start

    def _l_lookup_page(self, vid: int) -> tuple[int, np.ndarray] | None:
        """Range search the L table (paper Fig. 8): first key >= vid."""
        k = bisect.bisect_left(self._l_keys, vid)
        if k == len(self._l_keys):
            return None
        lpn = self._l_lpns[k]
        return lpn, self.dev.read_page(lpn).copy()

    # ============================================================ bulk ingest
    def update_graph(self, edge_array: np.ndarray,
                     embeddings: np.ndarray | None = None,
                     *, already_undirected: bool = False) -> BulkTimeline:
        """Paper's UpdateGraph(EdgeArray, Embeddings) bulk RPC.

        Overlaps adjacency-list conversion with the (much larger) embedding
        write by running them on two threads, as GraphStore overlaps the
        conversion compute with the storage write burst.
        """
        tl = BulkTimeline()
        t0 = time.perf_counter()

        # --- "transfer": the edge array + embedding list arriving over RoP.
        # No defensive copy: preprocess_edges never mutates its input, so
        # the only allocation is the dtype conversion asarray may need —
        # peak host memory stays one edge array, not two.
        edge_array = np.asarray(edge_array, dtype=np.int64).reshape(-1, 2)
        if embeddings is not None:
            embeddings = np.ascontiguousarray(embeddings, dtype=np.float32)
        tl.transfer = (0.0, time.perf_counter() - t0)

        csr_box: dict = {}

        def graph_pre():
            s = time.perf_counter() - t0
            csr_box["csr"] = preprocess_edges(
                edge_array, already_undirected=already_undirected)
            csr_box["span"] = (s, time.perf_counter() - t0)

        def write_feature():
            s = time.perf_counter() - t0
            if embeddings is not None:
                self._write_embedding_table(embeddings)
            csr_box["wf"] = (s, time.perf_counter() - t0)

        th_g = threading.Thread(target=graph_pre)
        th_f = threading.Thread(target=write_feature)
        th_g.start(); th_f.start()
        th_f.join()
        user_visible_at = time.perf_counter() - t0     # embedding write done
        th_g.join()

        tl.graph_pre = csr_box["span"]
        tl.write_feature = csr_box.get("wf", (0.0, 0.0))

        # --- flush adjacency pages (small vs embeddings; paper Fig. 18c)
        s = time.perf_counter() - t0
        indptr, indices = csr_box["csr"]
        self._write_adjacency(indptr, indices)
        tl.write_graph = (s, time.perf_counter() - t0)

        tl.total = time.perf_counter() - t0
        tl.user_visible = max(user_visible_at, tl.transfer[1])
        self.stats.bulk = tl
        return tl

    def _write_embedding_table(self, embeddings: np.ndarray) -> None:
        n, d = embeddings.shape
        if self.feature_dim and d != self.feature_dim:
            raise ValueError(f"feature dim {d} != store dim {self.feature_dim}")
        self.feature_dim = d
        flat = embeddings.reshape(-1).view(np.int32)
        n_pages = -(-flat.size // SLOTS_PER_PAGE)
        base = self.dev.alloc_back(n_pages)
        self.dev.write_span(base, flat, tag="embed")
        self._emb_base = base
        self._emb_rows = n

    def _write_adjacency(self, indptr: np.ndarray, indices: np.ndarray) -> None:
        n = len(indptr) - 1
        degrees = np.diff(indptr)
        self.num_vertices = max(self.num_vertices, n)

        h_vids = np.nonzero(degrees > self.h_threshold)[0]
        l_vids = np.nonzero((degrees > 0) & (degrees <= self.h_threshold))[0]

        # ---- H-type: per-vertex page chains
        for vid in h_vids:
            nbrs = indices[indptr[vid]: indptr[vid + 1]]
            self.gmap[int(vid)] = "H"
            self._write_h_chain(int(vid), nbrs)

        # ---- L-type: greedy packing in ascending VID order (cumsum splits)
        if len(l_vids):
            sizes = degrees[l_vids] + 2                      # data + 2 meta slots
            csum = np.concatenate([[0], np.cumsum(sizes)])
            cap = SLOTS_PER_PAGE - 2
            start = 0
            while start < len(l_vids):
                hi = np.searchsorted(csum, csum[start] + cap, side="right") - 1
                hi = max(hi, start + 1)                       # at least one node
                lpn, page = self._new_l_page()
                dlen = 0
                cnt = 0
                for vid in l_vids[start:hi]:
                    nbrs = indices[indptr[vid]: indptr[vid + 1]]
                    page[_l_meta_vid(cnt)] = vid
                    page[_l_meta_off(cnt)] = dlen
                    page[dlen: dlen + len(nbrs)] = nbrs
                    dlen += len(nbrs)
                    cnt += 1
                    self.gmap[int(vid)] = "L"
                page[_L_NNODES] = cnt
                page[_L_DATALEN] = dlen
                self.dev.write_page(lpn, page)
                self._l_keys.append(int(l_vids[hi - 1]))
                self._l_lpns.append(lpn)
                start = hi

    # ================================================================ queries
    def get_neighbors(self, vid: int) -> np.ndarray:
        """Paper GetNeighbors(VID) unit RPC."""
        with self._lock:
            kind = self.gmap.get(int(vid))
            if kind is None:
                return np.empty(0, dtype=SLOT_DTYPE)
            if kind == "H":
                out = []
                lpn, _ = self.h_table[int(vid)]
                while lpn >= 0:
                    page = self.dev.read_page(lpn)
                    cnt = int(page[_H_COUNT])
                    out.append(page[_H_DATA: _H_DATA + cnt].copy())
                    lpn = int(page[_H_NEXT])
                return np.concatenate(out) if out else np.empty(0, dtype=SLOT_DTYPE)
            hit = self._l_lookup_page(vid)
            if hit is None:
                return np.empty(0, dtype=SLOT_DTYPE)
            _, page = hit
            found = self._l_scan(page, int(vid))
            if found is None:
                return np.empty(0, dtype=SLOT_DTYPE)
            _, start, ln = found
            return page[start: start + ln].copy()

    def _fetch_plan(self, vids_arr: np.ndarray):
        """Shared front half of the batched near-storage queries.

        Plans the whole request from the in-DRAM mapping tables (L range
        table + H chain lists), fetches every needed page with a single
        queued scatter-read, and locates each vid's data:

        Returns ``(block, desc)`` with ``desc[i]`` one of
          * ``None``                       — unknown vid,
          * ``("L", row, start, end)``     — chunk slice of ``block[row]``,
          * ``("H", rows, counts)``        — chain page rows + chunk counts.
        """
        h_items: list[tuple[int, int]] = []     # (position, vid)
        l_pos: list[int] = []
        l_vids: list[int] = []
        desc: list = [None] * len(vids_arr)
        for pos, v in enumerate(vids_arr.tolist()):
            kind = self.gmap.get(v)
            if kind == "H":
                h_items.append((pos, v))
            elif kind == "L":
                l_pos.append(pos)
                l_vids.append(v)

        keys = np.asarray(self._l_keys, dtype=np.int64)
        lq = np.asarray(l_vids, dtype=np.int64)
        k = np.searchsorted(keys, lq)           # first key >= vid
        miss = k == len(keys)
        l_lpns = sorted({self._l_lpns[ki] for ki in k[~miss].tolist()})
        h_lpns = sorted({lpn for _, vid in h_items
                         for lpn in self.h_chain[vid]})

        lpns = l_lpns + h_lpns                  # ONE queued scatter-read
        if not lpns:
            return None, desc
        block = self._read_pages_cached(lpns, "graph")
        row_of = {lpn: i for i, lpn in enumerate(lpns)}

        if len(lq):
            self._l_locate_batch(block, row_of, l_pos, lq, k, miss, desc)
        for pos, vid in h_items:
            rows = np.array([row_of[lpn] for lpn in self.h_chain[vid]],
                            dtype=np.int64)
            desc[pos] = ("H", rows, block[rows, _H_COUNT].astype(np.int64))
        return block, desc

    def get_neighbors_batch(self, vids) -> list[np.ndarray]:
        """Batched GetNeighbors — the near-storage fast path.

        One scatter-read serves the whole request (vs one page walk per
        VID): L-type vids share their owning pages' single vectorized meta
        scan, H-type chains are materialised straight from the fetched
        block — the batched-DMA behaviour of the FPGA's hardware
        GetNeighbors engine.

        Returns a list of neighbor arrays aligned with ``vids`` (empty array
        for unknown VIDs), each equal to ``get_neighbors(vid)``.
        """
        vids_arr = np.asarray(vids, dtype=np.int64).reshape(-1)
        block, desc = self.fetch_plan(vids_arr)
        return neighbors_from_plan(vids_arr, block, desc)

    def fetch_plan(self, vids_arr):
        """Locked plan fetch over vids this store holds — the *fetch* phase
        of the batched queries (one queued scatter-read).  The sharded
        coordinator calls this once per shard, concurrently; the returned
        block is a snapshot copy, so selection can run outside the lock.
        """
        with self._lock:
            return self._fetch_plan(
                np.asarray(vids_arr, dtype=np.int64).reshape(-1))

    def chain_pages(self, vids: np.ndarray, pgs: np.ndarray) -> np.ndarray:
        """Explicit H-chain page reads: page ``pgs[i]`` of ``vids[i]``'s
        chain, as ONE queued (cached) scatter-read.  The replicated
        coordinator's page-granular replica spread assigns individual
        chain pages to shards; this is the device-side command that
        serves a shard's share of them."""
        with self._lock:
            lpns = np.fromiter(
                (self.h_chain[int(v)][int(p)]
                 for v, p in zip(vids.tolist(), pgs.tolist())),
                dtype=np.int64, count=len(vids))
            return self._read_pages_cached(lpns, "graph")

    def plan_info(self, vids: np.ndarray) -> dict:
        """Planning metadata for a batch of vids, no page I/O: per-vid
        H-chain page count (0 when not H-mapped here) and the L-table
        range-search index (``searchsorted`` over the page keys; -1 when
        this store has no L pages).  Lets an array coordinator plan a
        replica-spread fetch with ONE call per vertex class instead of
        reaching into ``h_chain``/``_l_keys`` directly."""
        with self._lock:
            chain_len = np.fromiter(
                (len(self.h_chain.get(int(v), ())) for v in vids.tolist()),
                dtype=np.int64, count=len(vids))
            if self._l_keys:
                l_page = np.searchsorted(
                    np.asarray(self._l_keys, dtype=np.int64), vids)
            else:
                l_page = np.full(len(vids), -1, dtype=np.int64)
            return {"chain_len": chain_len,
                    "l_page": l_page.astype(np.int64)}

    def import_h_chain(self, vid: int, pages: np.ndarray) -> None:
        """Write a page-exact H chain from raw exported page data (slot
        layout and per-page counts preserved, next pointers re-addressed)
        — the import half of replica rebuild streaming.  Replicas keep
        IDENTICAL chain page layouts, which is what lets the spread fetch
        serve page i of a chain from any live owner.  Replace-safe: any
        chain the vid already owns is freed first, so a migration redo
        after a mid-copy failure cannot leak or double-map pages."""
        with self._lock:
            if self.gmap.get(vid) == "H":
                old, _ = self.h_table.pop(vid)
                self.h_chain.pop(vid, None)
                while old >= 0:
                    pg = self.dev.read_page(old)
                    nxt = int(pg[_H_NEXT])
                    self.dev.free_page(old)
                    old = nxt
            new_lpns = [self.dev.alloc_front() for _ in range(len(pages))]
            for i, lpn in enumerate(new_lpns):
                page = np.asarray(pages[i], dtype=SLOT_DTYPE).copy()
                page[_H_NEXT] = new_lpns[i + 1] if i + 1 < len(new_lpns) \
                    else -1
                self.dev.write_page(lpn, page)
            self.h_table[vid] = (new_lpns[0], new_lpns[-1])
            self.h_chain[vid] = new_lpns
            self.gmap[vid] = "H"
            self.stats.pages_h += len(new_lpns)

    def import_l_vertex(self, vid: int, nbrs: np.ndarray) -> None:
        """Install a complete L-type neighbor list for ``vid`` (the
        adjacency import half of class migration).  Replace-safe: any
        prior mapping — L node or H chain — is removed first, so a redo
        after a mid-copy failure converges to the same state."""
        with self._lock:
            vid = int(vid)
            kind = self.gmap.get(vid)
            if kind == "H":
                lpn, _ = self.h_table.pop(vid)
                self.h_chain.pop(vid, None)
                while lpn >= 0:
                    pg = self.dev.read_page(lpn)
                    nxt = int(pg[_H_NEXT])
                    self.dev.free_page(lpn)
                    lpn = nxt
                self.gmap.pop(vid, None)
            elif kind == "L":
                hit = self._l_lookup_page(vid)
                if hit is not None:
                    lpn, page = hit
                    self._l_remove_node(page, lpn, vid)
                self.gmap.pop(vid, None)
            chunk = np.asarray(nbrs, dtype=SLOT_DTYPE).reshape(-1)
            if not self._l_keys:
                self._l_insert_new_page([vid], [chunk])
            elif vid > self._l_keys[-1]:
                lpn = self._l_lpns[-1]
                page = self.dev.read_page(lpn).copy()
                if self._l_free_slots(page) >= len(chunk) + 2:
                    self._l_append_node(page, vid, chunk)
                    self.dev.write_page(lpn, page)
                    self._l_keys[-1] = vid
                else:
                    self._l_insert_new_page([vid], [chunk])
            else:
                k = bisect.bisect_left(self._l_keys, vid)
                self._l_split_insert(k, vid, chunk)
            self.gmap[vid] = "L"
            self.num_vertices = max(self.num_vertices, vid + 1)

    def drop_class(self, cls: int, modulus: int) -> int:
        """Free every vertex whose vid ≡ ``cls`` (mod ``modulus``) — the
        source-side release after a migrated class's routing flip commits.
        Embedding stripe pages are left in place (no longer addressed;
        the next rebuild compacts them).  Returns the vertex count
        dropped."""
        with self._lock:
            vids = [v for v in list(self.gmap) if v % modulus == cls]
            for v in vids:
                self._drop_vertex_pages(v)
            return len(vids)

    def extend_embedding_table(self, n_rows: int) -> int:
        """Grow the embedding table by ``n_rows`` zero rows and return the
        row index of the first new row (the migration import base).  The
        table is rewritten to a fresh span; the old span is abandoned
        (the simulated device reclaims it on the next rebuild)."""
        with self._lock:
            d = self.feature_dim
            if d == 0:
                raise ValueError("no feature dim set; load a table first")
            if n_rows <= 0:
                return self._emb_rows
            old_rows = self._emb_rows
            old = np.empty((old_rows, d), dtype=np.float32)
            if old_rows:
                self._get_embeds_locked(
                    np.arange(old_rows, dtype=np.int64), old)
            grown = np.concatenate(
                [old, np.zeros((n_rows, d), dtype=np.float32)], axis=0)
            self._write_embedding_table(grown)
            return old_rows

    def write_embed_rows(self, row0: int, rows: np.ndarray) -> None:
        """Overwrite the contiguous embedding rows ``[row0, row0+len)``
        in place (page-granular RMW) — the bulk import half of embedding
        migration.  Raises ``KeyError`` if no table is loaded and
        ``IndexError`` if the range exceeds the table."""
        if self._emb_base is None:
            raise KeyError("no embedding table loaded")
        with self._lock:
            d = self.feature_dim
            rows = np.ascontiguousarray(rows, dtype=np.float32).reshape(-1, d)
            m = len(rows)
            if m == 0:
                return
            if row0 < 0 or row0 + m > self._emb_rows:
                raise IndexError(
                    f"rows [{row0}, {row0 + m}) outside table "
                    f"of {self._emb_rows}")
            lo = row0 * d
            p0 = lo // SLOTS_PER_PAGE
            within = lo - p0 * SLOTS_PER_PAGE
            n_pages = -(-(within + m * d) // SLOTS_PER_PAGE)
            flat = self.dev.read_span(self._emb_base + p0, n_pages,
                                      tag="embed").copy()
            flat[within: within + m * d] = rows.reshape(-1).view(np.int32)
            for i in range(n_pages):
                self.dev.write_page(
                    self._emb_base + p0 + i,
                    flat[i * SLOTS_PER_PAGE: (i + 1) * SLOTS_PER_PAGE],
                    tag="embed")

    def sample_neighbors_batch(self, vids, fanout: int,
                               rng: np.random.Generator | None = None, *,
                               segments=None, rngs=None):
        """Fused near-storage GetNeighbors + fanout subsampling (B-1 half).

        The decisive hub optimisation: a power-law hub with a 30K-neighbor
        chain is *sampled by index* (Floyd, O(fanout)) against the chain's
        page counts, so only the selected slots are ever touched — the full
        neighbor list is never materialised.  Uniform draws are consumed in
        vid order, one ``fanout`` block per over-full vertex, identical to
        the reference sampler's per-vertex stream.

        Multi-request mode (the serving batcher): ``vids`` may concatenate
        several requests' frontiers — ``segments`` gives the per-request row
        counts and ``rngs`` the per-request generators.  Each segment's
        draws then come from its own stream, exactly as a solo call over
        that segment would consume them, so a coalesced super-request stays
        bit-identical per request while the page fetch remains ONE queued
        scatter-read for everything.

        Returns ``(sel, lens)``: selected neighbors flattened row-major and
        per-vid selection lengths (empty/unknown vids yield a self-loop).
        """
        vids_arr = np.asarray(vids, dtype=np.int64).reshape(-1)
        block, desc = self.fetch_plan(vids_arr)
        return select_from_plan(vids_arr, block, desc, fanout, rng,
                                segments=segments, rngs=rngs)

    def _l_locate_batch(self, block, row_of, l_pos, lq, k, miss, desc) -> None:
        """Vectorized L-page meta scan over every fetched page at once.

        Builds the global (vid -> page row, chunk start, chunk end) tables
        with a handful of array ops — the range partition makes per-page
        ascending vids globally sorted, so one ``searchsorted`` resolves all
        queries — and records ("L", row, start, end) descriptors.
        """
        kis = sorted(set(k[~miss].tolist()))
        rows = np.array([row_of[self._l_lpns[ki]] for ki in kis],
                        dtype=np.int64)
        if not len(rows):
            return
        n_m = block[rows, _L_NNODES].astype(np.int64)
        dlen_m = block[rows, _L_DATALEN].astype(np.int64)
        nmax = int(n_m.max())
        j = np.arange(nmax)
        vid_slot = _L_NNODES - 2 - 2 * j                # meta slot of node j
        vids_m = block[rows[:, None], vid_slot[None, :]].astype(np.int64)
        offs_m = block[rows[:, None], vid_slot[None, :] - 1].astype(np.int64)
        in_meta = j[None, :] < n_m[:, None]
        live = in_meta & (vids_m >= 0)

        # chunk ends.  Fast path: bulk-packed pages keep offsets strictly
        # ascending in meta order (no tombstones, no relocations), so node
        # j's chunk ends where node j+1's begins — no sort needed.  Any
        # mutated page (unit updates relocate chunks and leave tombstones)
        # falls back to the general boundary sort below.
        clean = np.all((~in_meta[:, 1:])
                       | (offs_m[:, 1:] > offs_m[:, :-1]), axis=1) \
            if nmax > 1 else np.ones(len(rows), dtype=bool)
        clean &= np.all(live == in_meta, axis=1)
        if clean.all():
            rown, coln = np.nonzero(live)
            flat_vids = vids_m[rown, coln]
            if not np.any(flat_vids[1:] < flat_vids[:-1]):
                ends_m = np.concatenate(
                    [offs_m[:, 1:], np.zeros((len(rows), 1), np.int64)],
                    axis=1)
                last = np.maximum(n_m - 1, 0)
                ends_m[np.arange(len(rows)), last] = dlen_m
                flat_offs = offs_m[rown, coln]
                flat_ends = ends_m[rown, coln]
                q = np.searchsorted(flat_vids, lq)
                qc = np.clip(q, 0, max(len(flat_vids) - 1, 0))
                found = (~miss) & (len(flat_vids) > 0) \
                    & (flat_vids[qc] == lq)
                prow = rown[qc]
                start = flat_offs[qc]
                end = flat_ends[qc]
                for i, pos in enumerate(l_pos):
                    if found[i]:
                        desc[pos] = ("L", int(rows[prow[i]]), int(start[i]),
                                     int(end[i]))
                return

        # general path: valid boundaries flattened with a per-row key so
        # one global sort + one searchsorted serve every query.
        big = SLOTS_PER_PAGE + 1
        bound_ok = in_meta & (offs_m <= dlen_m[:, None])
        bkey = np.where(bound_ok,
                        np.arange(len(rows))[:, None] * big + offs_m,
                        np.iinfo(np.int64).max)
        bkey = np.sort(bkey.reshape(-1))                # sentinels sort last
        n_bounds = int(bound_ok.sum())
        bkey = bkey[:n_bounds]                          # drop sentinels

        # live nodes flattened; the range partition + per-page ascending
        # packing make vids globally sorted already (checked; argsort only
        # as a fallback for adversarial layouts)
        rown, coln = np.nonzero(live)
        flat_vids = vids_m[rown, coln]
        flat_offs = offs_m[rown, coln]
        if np.any(flat_vids[1:] < flat_vids[:-1]):      # pragma: no cover
            sort2 = np.argsort(flat_vids, kind="stable")
            flat_vids, flat_offs, rown = (flat_vids[sort2], flat_offs[sort2],
                                          rown[sort2])
        svids = flat_vids

        q = np.searchsorted(svids, lq)
        qc = np.clip(q, 0, max(len(svids) - 1, 0))
        found = (~miss) & (len(svids) > 0) & (svids[qc] == lq)
        prow = rown[qc]                                 # row within `sub`
        start = flat_offs[qc]
        e = np.searchsorted(bkey, prow * big + start, side="right")
        ec = np.clip(e, 0, max(n_bounds - 1, 0))
        in_row = (e < n_bounds) & (bkey[ec] // big == prow)
        end = np.where(in_row, bkey[ec] % big, dlen_m[prow])

        for i, pos in enumerate(l_pos):
            if found[i]:
                desc[pos] = ("L", int(rows[prow[i]]), int(start[i]),
                             int(end[i]))

    def get_embed(self, vid: int) -> np.ndarray:
        """Paper GetEmbed(VID): read only the pages covering row ``vid``."""
        if self._emb_base is None:
            raise KeyError("no embedding table loaded")
        with self._lock:
            d = self.feature_dim
            lo, hi = vid * d, (vid + 1) * d
            p0, p1 = lo // SLOTS_PER_PAGE, -(-hi // SLOTS_PER_PAGE)
            flat = self.dev.read_span(self._emb_base + p0, p1 - p0, tag="embed")
            row = flat[lo - p0 * SLOTS_PER_PAGE: hi - p0 * SLOTS_PER_PAGE]
            return row.view(np.float32).copy()

    def get_embeds(self, vids: np.ndarray) -> np.ndarray:
        """Coalesced batched embedding gather.

        All rows' covering pages are merged (duplicates and overlaps
        collapsed) into one queued scatter-read; rows are then sliced out of
        the fetched block with a vectorized gather.  The sequential layout
        of the embedding space (paper Fig. 7) means adjacent VIDs share
        pages, so the merged page set is far smaller than one span per row.
        """
        if self._emb_base is None:
            raise KeyError("no embedding table loaded")
        vids = np.asarray(vids, dtype=np.int64).reshape(-1)
        d = self.feature_dim
        out = np.empty((len(vids), d), dtype=np.float32)
        if not len(vids):
            return out
        with self._lock:
            return self._get_embeds_locked(vids, out)

    def _get_embeds_locked(self, vids: np.ndarray, out: np.ndarray) -> np.ndarray:
        d = self.feature_dim
        lo = vids * d
        p0 = lo // SLOTS_PER_PAGE
        p1 = (lo + d + SLOTS_PER_PAGE - 1) // SLOTS_PER_PAGE
        span = int((p1 - p0).max())                     # pages per row (>=1)
        cand = p0[:, None] + np.arange(span)[None, :]   # (rows, span)
        pages = np.unique(cand[cand < p1[:, None]])     # merged page set
        block = self._read_pages_cached(self._emb_base + pages, "embed")
        # a row's pages are consecutive integers, hence adjacent rows of the
        # fetched block — so each embedding row is CONTIGUOUS in the block's
        # flat view and one broadcast gather slices every row at once
        fstart = np.searchsorted(pages, p0) * SLOTS_PER_PAGE \
            + (lo - p0 * SLOTS_PER_PAGE)
        flatb = block.reshape(-1)
        # gather through a sliding-window VIEW: one fancy index over
        # virtual rows, instead of materialising a (rows, d) int64 index
        # matrix (which costs more to build than the gather itself —
        # ~10x on feature-heavy tables)
        win = np.lib.stride_tricks.sliding_window_view(flatb, d) \
            if len(flatb) >= d else None
        if win is not None:
            out[...] = win[fstart].view(np.float32)
        else:                                           # tiny device edge
            out[...] = flatb[fstart[:, None] + np.arange(d)[None, :]] \
                .view(np.float32)
        return out

    # ============================================================== unit ops
    def _l_collect(self, page: np.ndarray) -> list[tuple[int, np.ndarray]]:
        """All live (vid, neighbor-chunk) pairs of an L page."""
        n = int(page[_L_NNODES])
        out = []
        for i in range(n):
            vid = int(page[_l_meta_vid(i)])
            if vid < 0:
                continue                                   # tombstone
            meta = self._l_scan(page, vid)
            _, start, ln = meta
            out.append((vid, page[start: start + ln].copy()))
        return out

    @staticmethod
    def _l_build_page(nodes: list[tuple[int, np.ndarray]]) -> np.ndarray:
        page = np.zeros(SLOTS_PER_PAGE, dtype=SLOT_DTYPE)
        dlen = 0
        for i, (vid, ch) in enumerate(nodes):
            page[_l_meta_vid(i)] = vid
            page[_l_meta_off(i)] = dlen
            page[dlen: dlen + len(ch)] = ch
            dlen += len(ch)
        page[_L_NNODES] = len(nodes)
        page[_L_DATALEN] = dlen
        return page

    def _l_split_insert(self, k: int, vid: int, chunk: np.ndarray) -> None:
        """Insert (vid, chunk) into L page k; split the page if full.

        Paper adaptation: the paper evicts one neighbor set to a fresh page,
        which breaks the range-search partition under out-of-order VIDs; we
        use a range-preserving page split instead (same cost profile: one
        extra page + one table insert)."""
        lpn = self._l_lpns[k]
        page = self.dev.read_page(lpn).copy()
        nodes = [nc for nc in self._l_collect(page) if nc[0] != vid]
        nodes.append((vid, chunk))
        nodes.sort(key=lambda nc: nc[0])
        need = sum(len(c) + 2 for _, c in nodes) + 2
        if need <= SLOTS_PER_PAGE:
            self.dev.write_page(lpn, self._l_build_page(nodes))
            if vid > self._l_keys[k]:
                self._l_keys[k] = vid
            return
        self.stats.l_evictions += 1
        sizes = np.array([len(c) + 2 for _, c in nodes])
        csum = np.cumsum(sizes)
        half = int(np.searchsorted(csum, csum[-1] / 2)) + 1
        half = min(max(half, 1), len(nodes) - 1)
        low, high = nodes[:half], nodes[half:]
        new_lpn, _ = self._new_l_page()
        self.dev.write_page(new_lpn, self._l_build_page(low))
        self.dev.write_page(lpn, self._l_build_page(high))
        self._l_keys[k] = max(self._l_keys[k], high[-1][0])
        self._l_keys.insert(k, low[-1][0])
        self._l_lpns.insert(k, new_lpn)

    def add_vertex(self, vid: int, embed: np.ndarray | None = None) -> None:
        """AddVertex: self-loop only, starts as L-type (paper).  Ascending
        VIDs append to the last page; out-of-order VIDs split-insert into
        the page covering their range."""
        with self._lock:
            vid = int(vid)
            if vid in self.gmap:
                return
            self.stats.unit_updates += 1
            loop = np.array([vid], dtype=SLOT_DTYPE)
            if not self._l_keys:
                self._l_insert_new_page([vid], [loop])
            elif vid > self._l_keys[-1]:
                lpn = self._l_lpns[-1]
                page = self.dev.read_page(lpn).copy()
                if self._l_free_slots(page) >= 3:
                    self._l_append_node(page, vid, loop)
                    self.dev.write_page(lpn, page)
                    self._l_keys[-1] = vid
                else:
                    self._l_insert_new_page([vid], [loop])
            else:
                k = bisect.bisect_left(self._l_keys, vid)
                self._l_split_insert(k, vid, loop)
            self.gmap[vid] = "L"
            self.num_vertices = max(self.num_vertices, vid + 1)
            if embed is not None:
                self.update_embed(vid, embed)

    def _l_insert_new_page(self, vids, chunks) -> None:
        lpn, page = self._new_l_page()
        dlen = 0
        for i, (v, ch) in enumerate(zip(vids, chunks)):
            page[_l_meta_vid(i)] = v
            page[_l_meta_off(i)] = dlen
            page[dlen: dlen + len(ch)] = ch
            dlen += len(ch)
        page[_L_NNODES] = len(vids)
        page[_L_DATALEN] = dlen
        self.dev.write_page(lpn, page)
        key = int(max(vids))
        k = bisect.bisect_left(self._l_keys, key)
        self._l_keys.insert(k, key)
        self._l_lpns.insert(k, lpn)

    @staticmethod
    def _l_append_node(page: np.ndarray, vid: int, chunk: np.ndarray) -> None:
        n, dlen = int(page[_L_NNODES]), int(page[_L_DATALEN])
        page[_l_meta_vid(n)] = vid
        page[_l_meta_off(n)] = dlen
        page[dlen: dlen + len(chunk)] = chunk
        page[_L_NNODES] = n + 1
        page[_L_DATALEN] = dlen + len(chunk)

    def add_edge(self, dst: int, src: int) -> None:
        """AddEdge: undirected — inserts src into N(dst) and dst into N(src)."""
        with self._lock:
            self.stats.unit_updates += 1
            for v in (dst, src):
                if v not in self.gmap:
                    self.add_vertex(v)
            self._insert_neighbor(int(dst), int(src))
            if dst != src:
                self._insert_neighbor(int(src), int(dst))

    def _insert_neighbor(self, vid: int, nbr: int) -> None:
        if self.gmap[vid] == "H":
            head, tail = self.h_table[vid]
            page = self.dev.read_page(tail).copy()
            cnt = int(page[_H_COUNT])
            if cnt < H_CAP:
                page[_H_DATA + cnt] = nbr
                page[_H_COUNT] = cnt + 1
                self.dev.write_page(tail, page)
            else:
                lpn = self.dev.alloc_front()
                newp = np.zeros(SLOTS_PER_PAGE, dtype=SLOT_DTYPE)
                newp[_H_COUNT] = 1
                newp[_H_NEXT] = -1
                newp[_H_DATA] = nbr
                self.dev.write_page(lpn, newp)
                page[_H_NEXT] = lpn
                self.dev.write_page(tail, page)
                self.h_table[vid] = (head, lpn)
                self.h_chain[vid].append(lpn)
                self.stats.pages_h += 1
            return
        # ---- L-type
        k = bisect.bisect_left(self._l_keys, vid)
        lpn = self._l_lpns[k]
        page = self.dev.read_page(lpn).copy()
        meta = self._l_scan(page, vid)
        assert meta is not None, f"vid {vid} missing from L page"
        mi, start, ln = meta

        if ln + 1 > self.h_threshold:
            # degree crossed the threshold: promote to H-type
            nbrs = np.concatenate([page[start: start + ln],
                                   np.array([nbr], dtype=SLOT_DTYPE)])
            self._l_remove_node(page, lpn, vid)
            self._promote_to_h(vid, nbrs)
            return

        if self._l_free_slots(page) >= 1:
            dlen = int(page[_L_DATALEN])
            if start + ln == dlen:                       # chunk is last: append
                page[dlen] = nbr
                page[_L_DATALEN] = dlen + 1
            else:                                        # relocate chunk to end
                chunk = page[start: start + ln].copy()
                self._l_shift_left(page, start, ln)
                dlen = int(page[_L_DATALEN])
                page[dlen: dlen + ln] = chunk
                page[dlen + ln] = nbr
                page[_l_meta_off(mi)] = dlen
                page[_L_DATALEN] = dlen + ln + 1
            self.dev.write_page(lpn, page)
            return

        # no space: range-preserving split of this page (paper adaptation
        # of the neighbor-set eviction; see _l_split_insert)
        chunk = np.concatenate([page[start: start + ln],
                                np.array([nbr], dtype=SLOT_DTYPE)])
        self._l_split_insert(k, vid, chunk)

    def _promote_to_h(self, vid: int, nbrs: np.ndarray) -> None:
        self._write_h_chain(vid, nbrs)
        self.gmap[vid] = "H"

    def _write_h_chain(self, vid: int, nbrs: np.ndarray) -> None:
        """Write a fresh H chain for ``vid`` and record its mapping."""
        head = tail = -1
        chain: list[int] = []
        for c0 in range(0, len(nbrs), H_CAP):
            chunk = nbrs[c0: c0 + H_CAP]
            lpn = self.dev.alloc_front()
            page = np.zeros(SLOTS_PER_PAGE, dtype=SLOT_DTYPE)
            page[_H_COUNT] = len(chunk)
            page[_H_NEXT] = -1
            page[_H_DATA: _H_DATA + len(chunk)] = chunk
            self.dev.write_page(lpn, page)
            self.stats.pages_h += 1
            chain.append(lpn)
            if head < 0:
                head = lpn
            else:
                prev = self.dev.read_page(tail).copy()
                prev[_H_NEXT] = lpn
                self.dev.write_page(tail, prev)
            tail = lpn
        self.h_table[vid] = (head, tail)
        self.h_chain[vid] = chain

    def _l_shift_left(self, page: np.ndarray, start: int, ln: int) -> None:
        """Remove chunk [start, start+ln) from the data region, fix offsets."""
        dlen = int(page[_L_DATALEN])
        page[start: dlen - ln] = page[start + ln: dlen].copy()
        page[_L_DATALEN] = dlen - ln
        n = int(page[_L_NNODES])
        for j in range(n):
            off = int(page[_l_meta_off(j)])
            if off > start:
                page[_l_meta_off(j)] = off - ln

    def _l_remove_node(self, page: np.ndarray, lpn: int, vid: int) -> None:
        meta = self._l_scan(page, vid)
        if meta is None:
            return
        mi, start, ln = meta
        self._l_shift_left(page, start, ln)
        page[_l_meta_vid(mi)] = -1                       # tombstone (paper: reuse)
        page[_l_meta_off(mi)] = int(page[_L_DATALEN])
        self.dev.write_page(lpn, page)

    def delete_edge(self, dst: int, src: int) -> None:
        with self._lock:
            self.stats.unit_updates += 1
            self._remove_neighbor(int(dst), int(src))
            if dst != src:
                self._remove_neighbor(int(src), int(dst))

    def _remove_neighbor(self, vid: int, nbr: int) -> None:
        kind = self.gmap.get(vid)
        if kind is None:
            return
        if kind == "H":
            lpn, _ = self.h_table[vid]
            while lpn >= 0:
                page = self.dev.read_page(lpn).copy()
                cnt = int(page[_H_COUNT])
                data = page[_H_DATA: _H_DATA + cnt]
                hit = np.nonzero(data == nbr)[0]
                if len(hit):
                    i = int(hit[0])
                    data[i] = data[cnt - 1]
                    page[_H_COUNT] = cnt - 1
                    self.dev.write_page(lpn, page)
                    return
                lpn = int(page[_H_NEXT])
            return
        hit = self._l_lookup_page(vid)
        if hit is None:
            return
        lpn, page = hit
        meta = self._l_scan(page, vid)
        if meta is None:
            return
        mi, start, ln = meta
        data = page[start: start + ln]
        pos = np.nonzero(data == nbr)[0]
        if not len(pos):
            return
        i = int(pos[0])
        page[start + i: start + ln - 1] = page[start + i + 1: start + ln].copy()
        self._l_shift_tail_one(page, start, ln)
        self.dev.write_page(lpn, page)

    def _l_shift_tail_one(self, page: np.ndarray, start: int, ln: int) -> None:
        """Shrink chunk at ``start`` by one slot, compacting the data region."""
        dlen = int(page[_L_DATALEN])
        page[start + ln - 1: dlen - 1] = page[start + ln: dlen].copy()
        page[_L_DATALEN] = dlen - 1
        n = int(page[_L_NNODES])
        for j in range(n):
            off = int(page[_l_meta_off(j)])
            if off >= start + ln:
                page[_l_meta_off(j)] = off - 1

    def delete_vertex(self, vid: int) -> None:
        with self._lock:
            vid = int(vid)
            self.stats.unit_updates += 1
            nbrs = self.get_neighbors(vid)
            for nbr in nbrs:
                if int(nbr) != vid:
                    self._remove_neighbor(int(nbr), vid)
            self._drop_vertex_pages(vid)

    def _drop_vertex_pages(self, vid: int) -> None:
        """Release ``vid``'s own mapping + pages (not its neighbors' backlinks
        — the sharded coordinator removes those on each neighbor's owning
        shard before calling this on the owner)."""
        kind = self.gmap.pop(vid, None)
        if kind == "H":
            lpn, _ = self.h_table.pop(vid)
            self.h_chain.pop(vid, None)
            while lpn >= 0:
                page = self.dev.read_page(lpn)
                nxt = int(page[_H_NEXT])
                self.dev.free_page(lpn)
                lpn = nxt
        elif kind == "L":
            hit = self._l_lookup_page(vid)
            if hit is not None:
                lpn, page = hit
                self._l_remove_node(page, lpn, vid)
        self._free_vids.append(vid)

    def update_embed(self, vid: int, embed: np.ndarray) -> None:
        """UpdateEmbed(VID, Embed): in-place page RMW of one feature row."""
        if self._emb_base is None:
            raise KeyError("no embedding table loaded")
        with self._lock:
            d = self.feature_dim
            row = np.ascontiguousarray(embed, dtype=np.float32).reshape(-1)
            assert row.size == d
            lo = vid * d
            p0 = lo // SLOTS_PER_PAGE
            within = lo - p0 * SLOTS_PER_PAGE
            n_pages = -(-(within + d) // SLOTS_PER_PAGE)
            flat = self.dev.read_span(self._emb_base + p0, n_pages,
                                      tag="embed").copy()
            flat[within: within + d] = row.view(np.int32)
            for i in range(n_pages):
                self.dev.write_page(
                    self._emb_base + p0 + i,
                    flat[i * SLOTS_PER_PAGE: (i + 1) * SLOTS_PER_PAGE],
                    tag="embed")

    # ============================================================== export
    def to_adjacency(self) -> dict[int, set[int]]:
        """Full adjacency export (oracle/validation only — reads every page)."""
        out: dict[int, set[int]] = {}
        for vid in list(self.gmap):
            out[vid] = set(int(x) for x in self.get_neighbors(vid))
        return out


# ---------------------------------------------------------------- preprocessing
# The paper's G-1..G-4 UpdateGraph pipeline, exposed as SHARD-LOCAL pieces
# so the distributed ingest path (store/ingest.py) can run each stage where
# the data is: the coordinator ships raw edge chunks, every shard mirrors
# and buckets its chunks device-side ([G-2]/[G-3] routing), peers exchange
# buckets, and each shard sorts + builds its partition-local CSR
# ([G-3]/[G-4]) with the exact arithmetic the monolithic path uses — which
# is what makes the chunked load bit-identical to ``preprocess_edges`` +
# ``partition_csr``.

def mirror_edges(edge_array: np.ndarray, *,
                 already_undirected: bool = False) -> np.ndarray:
    """[G-2] mirror {dst,src}->{src,dst}: directed pair list of the
    undirected edge set (no-op when the input is already symmetric)."""
    e = np.asarray(edge_array, dtype=np.int64).reshape(-1, 2)
    if already_undirected or e.size == 0:
        return e
    return np.concatenate([e, e[:, ::-1]], axis=0)


def bucket_pairs(pairs: np.ndarray, n_shards: int, *,
                 replication: int = 1, placement=None) -> list[np.ndarray]:
    """[G-3] routing: directed pairs grouped by destination shard.

    Under the default map, replica ``r`` of row ``vid`` lives on shard
    ``(vid + r) % N``, so each pair is routed to the R shards that own
    its row — shard ``s`` receives the residue classes
    ``{(s - r) % N, r < R}``, exactly the classes ``partition_csr`` keeps.
    A ``placement`` (:class:`repro.store.placement.PlacementMap`) replaces
    that rule: pairs route by ``vid % C`` through the map's owner table
    (role order preserved, so stripe layouts follow ``pairs_of``).
    """
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if placement is not None:
        cls = pairs[:, 0] % placement.n_classes
        out = []
        for s in range(n_shards):
            parts = [pairs[cls == c] for c, _r in placement.pairs_of(s)]
            parts = [p for p in parts if len(p)]
            out.append(np.concatenate(parts) if parts
                       else np.empty((0, 2), dtype=np.int64))
        return out
    cls = pairs[:, 0] % n_shards
    out: list[np.ndarray] = []
    for s in range(n_shards):
        parts = [pairs[cls == (s - r) % n_shards]
                 for r in range(int(replication))]
        parts = [p for p in parts if len(p)]
        out.append(np.concatenate(parts) if parts
                   else np.empty((0, 2), dtype=np.int64))
    return out


def csr_from_pairs(pairs: np.ndarray, num_vertices: int, *,
                   n_shards: int = 1, classes=None,
                   add_self_loops: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """[G-3]+[G-4] sort stage: directed pairs -> sorted, deduped CSR in
    the GLOBAL row space (non-owned rows keep zero-degree indptr slots,
    as ``partition_csr`` leaves them).

    ``classes`` restricts the [G-4] self-loop injection to the residue
    classes this shard owns; ``None`` injects loops for every vertex (the
    single-device/global case).  The key arithmetic (``row * n + nbr`` +
    ``np.unique``) is shared with the monolithic path, so a shard sorting
    only its own bucket produces exactly the owned-row restriction of the
    globally sorted CSR.
    """
    n = int(num_vertices)
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if add_self_loops and n:
        if classes is None:
            loops = np.arange(n, dtype=np.int64)
        else:
            own = [np.arange(c, n, n_shards, dtype=np.int64)
                   for c in sorted(int(c) for c in classes)]
            loops = (np.concatenate(own) if own
                     else np.empty(0, dtype=np.int64))
        pairs = np.concatenate(
            [pairs, np.stack([loops, loops], axis=1)], axis=0)
    if pairs.size == 0:
        return np.zeros(n + 1, dtype=np.int64), np.empty(0, dtype=SLOT_DTYPE)
    key = pairs[:, 0] * n + pairs[:, 1]
    key = np.unique(key)                      # sort + dedup (the "radix sort")
    src = key // n
    dst = (key % n).astype(SLOT_DTYPE)
    counts = np.bincount(src, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return indptr, dst


def preprocess_edges(edge_array: np.ndarray, *, already_undirected: bool = False,
                     add_self_loops: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Paper Fig. 2 graph preprocessing: edge array -> sorted undirected CSR.

    [G-1] load edge array  [G-2] mirror {dst,src}->{src,dst}
    [G-3] merge + sort -> VID-indexed structure  [G-4] inject self-loops.
    Returns (indptr, indices) CSR over max(VID)+1 vertices.  Never mutates
    its input (every stage concatenates into fresh arrays).
    """
    e = np.asarray(edge_array, dtype=np.int64).reshape(-1, 2)
    if e.size == 0:
        return np.zeros(1, dtype=np.int64), np.empty(0, dtype=SLOT_DTYPE)
    n = int(e.max()) + 1
    return csr_from_pairs(
        mirror_edges(e, already_undirected=already_undirected), n,
        add_self_loops=add_self_loops)
