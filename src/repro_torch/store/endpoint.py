"""ShardEndpoint — the shard-access protocol of the CSSD array.

Copy of ``repro/store/endpoint.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

The paper's core interface claim is "RPC over PCIe": hosts program GNNs
against a graph semantic library with *no knowledge of the storage
configuration* (§3.3).  PRs 3-4 broke that abstraction one level down —
the array coordinator called shard ``GraphStore`` objects as in-process
Python attributes, so the array could never span hosts.  This module
makes the partition boundary a real message boundary:

  * ``ShardService`` — the device-side method surface of ONE shard: a
    ``GraphStore`` behind a named-method API (batched ``fetch``, planning
    metadata, unit mutations, bulk writes, stats snapshots, and the
    chunked rebuild export/import used for shard-to-shard recovery).
    Every method takes and returns only RoP-serializable values;
  * ``LocalShardEndpoint`` — the in-process implementation: direct calls
    into a ``ShardService`` (zero-copy, the pre-endpoint behavior), with
    the same per-method call accounting a remote link would report;
  * ``ShardHost`` + ``RopShardEndpoint`` — the multi-host implementation:
    every call is serialized over a per-shard ``MultiQueueRoP`` SQ/CQ
    pair + ``PCIeChannel`` mmap buffers and handled by the shard host's
    firmware poll thread.  Batched reads are *submitted* to all shards
    and *awaited* together, so the array still pays max(shard costs).

The coordinator (``store/sharded.py``) speaks ONLY this protocol — no
``.gmap`` / ``.h_chain`` / ``.dev`` attribute access — which is what lets
``ShardedGraphStore``/``ReplicatedGraphStore`` drive an array whose
shards live behind real links.  Because both endpoint flavours run the
same ``ShardService`` code over the same page layouts, an array of
``RopShardEndpoint`` shards is **bit-identical** to the same array of
``LocalShardEndpoint`` shards under the same seed (healthy, degraded,
and post-rebuild — ``tests/test_endpoint.py``).

Timing model: the ``fetch`` handler defers its device's simulated flash +
command time and ships the total back as ``io_us``; the coordinator
awaits every shard's completion and sleeps once for the slowest shard —
the same analytic concurrency model the flash channels use inside one
device (divide, don't sum).  Non-batched commands pay their simulated
latency where they execute (the shard host's poll thread), so mutations
on different shards still overlap while two commands on one shard queue
behind each other.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from .blockdev import (BlockDevice, DeviceFailedError, SLOTS_PER_PAGE,
                       SLOT_DTYPE)
from .graphstore import GraphStore, bucket_pairs, csr_from_pairs, mirror_edges
from .placement import PlacementMap, rows_of_class

_REBUILD_CHUNK_PAGES = 512        # default pages per rebuild stream chunk
_EXCHANGE_CHUNK_EDGES = 1 << 18   # default pairs per peer-exchange pull


class _IngestSession:
    """Device-side state of ONE distributed bulk load on one shard.

    Holds the shard's own directed-pair bucket (``local``), the pending
    buckets destined for each peer (``outbound``), and the preallocated
    per-role embedding stripes — everything the commit needs to run the
    [G-3]/[G-4] sort + CSR build and the bulk page packing entirely
    device-side.
    """

    def __init__(self, shard: int, n_shards: int, replication: int,
                 already_undirected: bool, emb_rows: int, feature_dim: int,
                 placement: PlacementMap | None = None):
        self.shard = int(shard)
        self.n_shards = int(n_shards)
        self.replication = int(replication)
        self.already_undirected = bool(already_undirected)
        self.placement = placement
        self.edges_in = 0                       # raw edges streamed in
        self.exchanged_in = 0                   # pairs pulled from peers
        self.local: list[np.ndarray] = []       # pair chunks this shard owns
        self.outbound: list[list[np.ndarray]] = \
            [[] for _ in range(self.n_shards)]
        self.out_ready: list[np.ndarray | None] = [None] * self.n_shards
        # per-stripe embedding staging in canonical (class, role) order.
        # Default map: stripe index == role r, class (shard - r) % N,
        # local row = vid // N — the exact layout _emb_shard_rows ships
        # on the monolithic path.  A custom placement replaces the class
        # set and modulus but keeps the same role-major stripe order
        # (PlacementMap.pairs_of).
        self.feature_dim = int(feature_dim)
        self.emb_rows = int(emb_rows)
        if placement is not None:
            self.modulus = placement.n_classes
            self.class_pairs = placement.pairs_of(self.shard)
        else:
            self.modulus = self.n_shards
            self.class_pairs = [((self.shard - r) % self.n_shards, r)
                                for r in range(self.replication)]
        self.stripes: list[np.ndarray] = []
        for c, _r in self.class_pairs:
            rows = rows_of_class(self.emb_rows, c, self.modulus)
            self.stripes.append(
                np.zeros((rows, self.feature_dim), dtype=np.float32))

    def owned_classes(self) -> set[int]:
        return {c for c, _r in self.class_pairs}


# ------------------------------------------------------------ plan packing
def pack_plan(desc: list) -> dict:
    """Array-pack a ``fetch_plan`` descriptor list for the wire.

    A desc entry is ``None`` / ``("L", row, start, end)`` /
    ``("H", rows, counts)``; shipping them as JSON tuples would put
    O(vids) structure in the packet header, so they are flattened into a
    handful of ndarray payload buffers instead (the header stays O(1)).
    """
    l_idx, l_row, l_start, l_end = [], [], [], []
    h_idx, h_len, h_rows, h_counts = [], [], [], []
    for i, d in enumerate(desc):
        if d is None:
            continue
        if d[0] == "L":
            l_idx.append(i)
            l_row.append(int(d[1]))
            l_start.append(int(d[2]))
            l_end.append(int(d[3]))
        else:
            h_idx.append(i)
            h_len.append(len(d[1]))
            h_rows.append(np.asarray(d[1], dtype=np.int64))
            h_counts.append(np.asarray(d[2], dtype=np.int64))
    return {
        "n": len(desc),
        "l_idx": np.asarray(l_idx, dtype=np.int64),
        "l_row": np.asarray(l_row, dtype=np.int64),
        "l_start": np.asarray(l_start, dtype=np.int64),
        "l_end": np.asarray(l_end, dtype=np.int64),
        "h_idx": np.asarray(h_idx, dtype=np.int64),
        "h_len": np.asarray(h_len, dtype=np.int64),
        "h_rows": (np.concatenate(h_rows) if h_rows
                   else np.empty(0, dtype=np.int64)),
        "h_counts": (np.concatenate(h_counts) if h_counts
                     else np.empty(0, dtype=np.int64)),
    }


def unpack_plan(packed: dict) -> list:
    """Inverse of ``pack_plan`` — reconstructs the descriptor list."""
    desc: list = [None] * int(packed["n"])
    for i, row, start, end in zip(np.asarray(packed["l_idx"]).tolist(),
                                  np.asarray(packed["l_row"]).tolist(),
                                  np.asarray(packed["l_start"]).tolist(),
                                  np.asarray(packed["l_end"]).tolist()):
        desc[i] = ("L", row, start, end)
    h_rows = np.asarray(packed["h_rows"], dtype=np.int64)
    h_counts = np.asarray(packed["h_counts"], dtype=np.int64)
    off = 0
    for i, ln in zip(np.asarray(packed["h_idx"]).tolist(),
                     np.asarray(packed["h_len"]).tolist()):
        desc[i] = ("H", h_rows[off: off + ln], h_counts[off: off + ln])
        off += ln
    return desc


def clone_dev_profile(old: BlockDevice) -> BlockDevice:
    """A fresh replacement device with the failed one's perf profile."""
    return BlockDevice(
        old.num_pages, simulate_latency=old.simulate_latency,
        page_read_us=old.page_read_us, page_write_us=old.page_write_us,
        command_latency_us=old.command_latency_us,
        trace_events=old.stats.events.maxlen is None)


# ---------------------------------------------------------- device side
class ShardService:
    """The RPC-exposed surface of one CSSD shard.

    Wraps a partition-local ``GraphStore``; every public method is a
    shard RPC (dispatched by ``RPCServer`` on remote hosts, called
    directly by ``LocalShardEndpoint`` in-process).  Methods only accept
    and return wire types — the coordinator never sees the store object.
    """

    def __init__(self, store: GraphStore):
        self.store = store
        # peer links for shard-to-shard rebuild streaming: list of objects
        # with ``.call(method, **kw)`` (AsyncRPCClient for remote arrays,
        # a direct caller for local ones), index-aligned with the array.
        self.peers: list | None = None
        # the RoP this service is drained from, when it is remote
        # (``ShardHost`` sets it) — lets ``counters`` report live SQ/CQ
        # depth so gossip can steer reads away from hot shards
        self.rop = None
        # active distributed bulk-load session (ingest_begin..ingest_commit)
        self._ingest: _IngestSession | None = None

    # ------------------------------------------------------ batched fetch
    def fetch(self, l_vids=None, h_vids=None, h_pgs=None, emb_rows=None,
              pack: bool = False) -> dict:
        """ONE batched read command covering every page the coordinator
        needs from this shard: an adjacency plan fetch (``l_vids``),
        explicit H-chain page reads (``h_vids``/``h_pgs``, the replicated
        page-granular spread), and/or an embedding row gather
        (``emb_rows``) — each its own queued scatter-read, all under one
        deferred-latency account whose total ships back as ``io_us`` so
        the coordinator can pay max over shards.  This is why per-shard
        RPC count is O(1) per batched read, never O(pages)."""
        out: dict = {"block": None, "desc": None, "hblk": None, "emb": None}
        store = self.store
        with store.dev.defer_latency() as acct:
            if l_vids is not None and len(l_vids):
                block, desc = store.fetch_plan(
                    np.asarray(l_vids, dtype=np.int64))
                out["block"] = block
                out["desc"] = pack_plan(desc) if pack else desc
            if h_vids is not None and len(h_vids):
                out["hblk"] = store.chain_pages(
                    np.asarray(h_vids, dtype=np.int64),
                    np.asarray(h_pgs, dtype=np.int64))
            if emb_rows is not None and len(emb_rows):
                out["emb"] = store.get_embeds(
                    np.asarray(emb_rows, dtype=np.int64))
        out["io_us"] = acct.us
        return out

    def plan_info(self, vids) -> dict:
        """Planning metadata for a batch of vids (no page I/O): per-vid
        H-chain page count (0 when not H-mapped) and L-table range-search
        index (-1 when the shard has no L pages).  The replicated
        coordinator calls this once per vertex class per batched read —
        the in-DRAM mapping tables stay device-side."""
        return self.store.plan_info(np.asarray(vids, dtype=np.int64))

    # ----------------------------------------------------------- unit ops
    def get_neighbors(self, vid):
        """Sorted neighbor list of one locally-owned vid."""
        return self.store.get_neighbors(int(vid))

    def get_embed_row(self, row):
        """One embedding row by SHARD-LOCAL row index (the coordinator
        does the vid -> (shard, row) placement math)."""
        return self.store.get_embed(int(row))

    def add_vertex(self, vid) -> None:
        """Insert one vid into the local partition (idempotent)."""
        self.store.add_vertex(int(vid))

    def insert_neighbor(self, vid, nbr, count: bool = False) -> None:
        """Add ``nbr`` to ``vid``'s local adjacency; ``count=True``
        bills it as the unit update (one logical op counted once across
        the replica fan-out)."""
        st = self.store
        with st._lock:
            if count:
                st.stats.unit_updates += 1
            st._insert_neighbor(int(vid), int(nbr))

    def remove_neighbor(self, vid, nbr, count: bool = False) -> None:
        """Remove ``nbr`` from ``vid``'s local adjacency (see
        ``insert_neighbor`` for ``count``)."""
        st = self.store
        with st._lock:
            if count:
                st.stats.unit_updates += 1
            st._remove_neighbor(int(vid), int(nbr))

    def drop_vertex_pages(self, vid, count: bool = False) -> None:
        """Drop every adjacency page of ``vid`` (vertex delete)."""
        st = self.store
        with st._lock:
            if count:
                st.stats.unit_updates += 1
            st._drop_vertex_pages(int(vid))

    def update_embed_row(self, row, embed) -> None:
        """Overwrite one embedding row by shard-local row index."""
        self.store.update_embed(int(row), np.asarray(embed))

    # --------------------------------------------------------- bulk writes
    def write_adjacency(self, indptr, indices) -> None:
        """Bulk-pack a pre-partitioned CSR into the local page store
        (coordinator-side ingest path)."""
        self.store._write_adjacency(np.asarray(indptr, dtype=np.int64),
                                    np.asarray(indices))

    def write_embedding_table(self, rows) -> None:
        """Bulk-write the shard-local embedding stripe table."""
        self.store._write_embedding_table(
            np.ascontiguousarray(rows, dtype=np.float32))

    # ------------------------------------------------ distributed bulk load
    # The G-1..G-4 pipeline run WHERE THE DATA IS: the coordinator streams
    # bounded RAW edge chunks (ingest_edges) and embedding stripe slices
    # (ingest_emb_rows); each shard mirrors + buckets device-side, peers
    # exchange cross-shard buckets over the peer links (ingest_take /
    # ingest_exchange — the chunked-rebuild pull discipline), and
    # ingest_commit sorts, builds the partition-local CSR and bulk-packs
    # the pages locally.  The coordinator never touches an edge beyond
    # slicing chunks, so its shipped bytes are the raw arrays — no
    # preprocessed CSR ever crosses the coordinator link.

    def _require_ingest(self) -> _IngestSession:
        if self._ingest is None:
            raise RuntimeError("no ingest session open (ingest_begin first)")
        return self._ingest

    def ingest_begin(self, shard, n_shards, replication: int = 1,
                     already_undirected: bool = False, emb_rows: int = 0,
                     feature_dim: int = 0, placement=None) -> dict:
        """Open a bulk-load session on this shard.

        ``placement`` (a ``PlacementMap`` payload dict, or ``None`` for
        the default ``vid % N`` layout) selects the ownership rule the
        session buckets and stripes under; it is omitted from the wire
        at the default map, so legacy callers are unaffected."""
        if self._ingest is not None:
            raise RuntimeError("ingest session already open on this shard")
        if self.store.dev.failed:
            raise DeviceFailedError("shard device failed; cannot ingest")
        pmap = None
        if placement is not None:
            pmap = (placement if isinstance(placement, PlacementMap)
                    else PlacementMap.from_payload(placement))
        self._ingest = _IngestSession(shard, n_shards, replication,
                                      already_undirected, emb_rows,
                                      feature_dim, placement=pmap)
        return {"shard": int(shard)}

    def ingest_edges(self, chunk) -> dict:
        """One bounded raw edge chunk: [G-2] mirrored and [G-3] bucketed
        device-side.  Pairs whose row this shard owns stay local; the rest
        accumulate in per-peer outbound buckets for the exchange."""
        ss = self._require_ingest()
        raw = np.asarray(chunk, dtype=np.int64).reshape(-1, 2)
        ss.edges_in += len(raw)
        pairs = mirror_edges(raw, already_undirected=ss.already_undirected)
        max_vid = int(raw.max()) if raw.size else -1
        for t, b in enumerate(bucket_pairs(pairs, ss.n_shards,
                                           replication=ss.replication,
                                           placement=ss.placement)):
            if not len(b):
                continue
            if t == ss.shard:
                ss.local.append(b)
            else:
                ss.outbound[t].append(b)
        return {"edges": int(len(raw)), "max_vid": max_vid}

    def ingest_emb_rows(self, role, row0, rows) -> dict:
        """Stage a slice of one embedding stripe in local-row order.
        ``role`` is the stripe index in canonical (class, role) order —
        under the default map that is the replica role holding class
        ``(shard - role) % N``."""
        ss = self._require_ingest()
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        r0 = int(row0)
        ss.stripes[int(role)][r0: r0 + len(rows)] = rows
        return {"rows": int(len(rows))}

    def ingest_take(self, for_shard, cursor, max_edges) -> dict:
        """Peer-pull export: one bounded slice of the pairs this shard
        bucketed for ``for_shard`` (the exchange counterpart of
        ``export_adj_chunk``)."""
        ss = self._require_ingest()
        t = int(for_shard)
        if ss.out_ready[t] is None:
            parts = ss.outbound[t]
            ss.out_ready[t] = (np.concatenate(parts) if parts
                               else np.empty((0, 2), dtype=np.int64))
            ss.outbound[t] = []
        buf = ss.out_ready[t]
        c = max(0, int(cursor))
        out = buf[c: c + max(1, int(max_edges))]
        done = c + len(out) >= len(buf)
        if done:                         # free the shipped bucket
            ss.out_ready[t] = np.empty((0, 2), dtype=np.int64)
        return {"pairs": out, "next": c + len(out), "done": bool(done)}

    def ingest_exchange(self, max_edges: int = _EXCHANGE_CHUNK_EDGES) -> dict:
        """Pull every peer's bucket for THIS shard over the peer links,
        in bounded chunks.

        The coordinator calls this one shard at a time: the puller's poll
        thread drives its (otherwise idle) peers' queues — the same
        single-puller discipline as the chunked rebuild, which is what
        keeps N single-threaded shard hosts free of circular waits."""
        ss = self._require_ingest()
        if self.peers is None:
            raise RuntimeError("ingest_exchange needs peer links "
                               "(set_peers)")
        pulled = 0
        for p, peer in enumerate(self.peers):
            if p == ss.shard:
                continue
            cursor, done = 0, False
            while not done:
                chunk = peer.call("ingest_take", for_shard=ss.shard,
                                  cursor=cursor, max_edges=int(max_edges))
                pairs = np.asarray(chunk["pairs"],
                                   dtype=np.int64).reshape(-1, 2)
                if len(pairs):
                    ss.local.append(pairs)
                    pulled += len(pairs)
                cursor = int(chunk["next"])
                done = bool(chunk["done"])
        ss.exchanged_in += pulled
        return {"pulled": int(pulled)}

    def ingest_commit(self, num_vertices) -> dict:
        """[G-3]/[G-4] + bulk pack, all device-local: sort + dedup the
        owned pairs into the partition CSR (global row space, owned-class
        self-loops) and write the pages through the SAME packing code the
        monolithic path uses — overlapping the embedding-table burst with
        the sort exactly as ``GraphStore.update_graph`` does.  Identical
        inputs to identical code: the resulting pages are bit-identical
        to the monolithic ``write_adjacency``/``write_embedding_table``.
        """
        ss = self._require_ingest()
        st = self.store
        n = int(num_vertices)
        t0 = time.perf_counter()
        box: dict = {"wf_s": 0.0, "wf_us": 0.0}

        def write_feature():
            s0 = time.perf_counter()
            # simulated flash time is DEFERRED (thread-local accumulator):
            # the array's devices burn their write bursts concurrently, so
            # the coordinator pays one max(per-shard flash_us) after the
            # commit round — the same analytic model the batched read
            # fan-out uses — instead of N inline sleeps serializing here
            with st.dev.defer_latency() as acct:
                if ss.feature_dim and ss.emb_rows:
                    st._write_embedding_table(
                        np.concatenate(ss.stripes) if len(ss.stripes) > 1
                        else ss.stripes[0])
            box["wf_s"] = time.perf_counter() - s0
            box["wf_us"] = acct.us

        th = threading.Thread(target=write_feature)
        th.start()
        s0 = time.perf_counter()
        pairs = (np.concatenate(ss.local) if ss.local
                 else np.empty((0, 2), dtype=np.int64))
        indptr, indices = csr_from_pairs(
            pairs, n, n_shards=ss.modulus, classes=ss.owned_classes())
        box["sort_s"] = time.perf_counter() - s0
        th.join()
        s0 = time.perf_counter()
        with st.dev.defer_latency() as acct:
            st._write_adjacency(indptr, indices)
        st.num_vertices = max(st.num_vertices, n)
        self._ingest = None
        # one command stream per device: feature + graph bursts serialize
        # on THIS device, so its total flash time is their sum
        flash_us = box["wf_us"] + acct.us
        return {"edges": int(indptr[-1]), "edges_in": ss.edges_in,
                "exchanged_in": ss.exchanged_in,
                "sort_s": box["sort_s"],
                "write_feature_s": box["wf_s"] + box["wf_us"] * 1e-6,
                "write_graph_s": time.perf_counter() - s0 + acct.us * 1e-6,
                "flash_us": flash_us,
                "total_s": time.perf_counter() - t0 + flash_us * 1e-6}

    def ingest_abort(self) -> dict:
        """Drop the session (coordinator cleanup after a failed load)."""
        open_ = self._ingest is not None
        self._ingest = None
        return {"aborted": bool(open_)}

    # --------------------------------------------------- mutation firehose
    def apply_mutations(self, kinds, arg0, arg1, flags, emb=None) -> dict:
        """ONE device-side command applying a firehose WINDOW of unit
        mutations in submission order (store/ingest.py batches them
        per shard per time window).

        Packed parallel arrays; per op ``kinds[i]``:
          0  add_vertex(arg0)           (no-op when the vid exists)
          1  insert_neighbor(arg0, arg1)
          2  remove_neighbor(arg0, arg1)
          3  drop_vertex_pages(arg0)
          4  update_embed_row(arg0, <next row of emb>)
        ``flags`` bit 0 marks the logical-owner application that counts
        toward ``unit_updates`` (same accounting as the unit RPCs).  The
        whole window runs under the store lock, so a concurrent read sees
        window boundaries, never a half-applied op; page writes invalidate
        the shard's cache through the ordinary ``on_write`` hook."""
        st = self.store
        kinds = np.asarray(kinds, dtype=np.int64)
        arg0 = np.asarray(arg0, dtype=np.int64)
        arg1 = np.asarray(arg1, dtype=np.int64)
        flags = np.asarray(flags, dtype=np.int64)
        erows = None if emb is None else np.asarray(emb, dtype=np.float32)
        applied, j = 0, 0
        with st._lock:
            for k, a, b, f in zip(kinds.tolist(), arg0.tolist(),
                                  arg1.tolist(), flags.tolist()):
                if k == 0:
                    st.add_vertex(a)
                elif k == 1:
                    if f & 1:
                        st.stats.unit_updates += 1
                    st._insert_neighbor(a, b)
                elif k == 2:
                    if f & 1:
                        st.stats.unit_updates += 1
                    st._remove_neighbor(a, b)
                elif k == 3:
                    if f & 1:
                        st.stats.unit_updates += 1
                    st._drop_vertex_pages(a)
                elif k == 4:
                    st.update_embed(a, erows[j])
                    j += 1
                else:
                    raise ValueError(f"unknown mutation kind {k}")
                applied += 1
        return {"applied": applied}

    # ----------------------------------------------------------- telemetry
    def stats(self) -> dict:
        """Full shard telemetry snapshot: store page/update counters,
        device IO counters, cache stats (or None), and the failed flag —
        the per-shard block the service ``stats`` RPC aggregates."""
        st = self.store.stats
        dev = self.store.dev.stats
        return {
            "store": {"pages_l": st.pages_l, "pages_h": st.pages_h,
                      "unit_updates": st.unit_updates,
                      "l_evictions": st.l_evictions,
                      "num_vertices": self.store.num_vertices,
                      "feature_dim": self.store.feature_dim,
                      "h_threshold": self.store.h_threshold},
            "device": {"read_pages": dev.read_pages,
                       "written_pages": dev.written_pages,
                       "read_bytes": dev.read_bytes,
                       "written_bytes": dev.written_bytes},
            "cache": (self.store.cache.stats.snapshot()
                      if self.store.cache is not None else None),
            "failed": self.store.dev.failed,
        }

    def counters(self) -> dict:
        """Lightweight load + health probe for the coordinator's gossip
        loop and the supervisor's monitor: cumulative read load, the
        device's failed flag (stats attributes stay readable after
        ``fail()``, so a dead shard is detectable with zero serving
        traffic), and current command-queue pressure when this service
        sits behind a RoP."""
        out = {"read_pages": self.store.dev.stats.read_pages,
               "failed": self.store.dev.failed,
               "inflight": 0, "sq_depth": 0}
        if self.rop is not None:
            snap = self.rop.stats_snapshot()
            out["inflight"] = snap["in_flight"]
            out["sq_depth"] = sum(q["sq_depth"] for q in snap["queues"])
        return out

    # --------------------------------------------------------------- cache
    def attach_cache(self, capacity_pages, cache_graph_pages: bool = True):
        """Attach a device-DRAM page cache of ``capacity_pages``."""
        from .embcache import EmbeddingPageCache
        self.store.attach_cache(EmbeddingPageCache(int(capacity_pages)),
                                cache_graph_pages=cache_graph_pages)

    def cache_stats(self) -> dict | None:
        """Cache counter snapshot, or ``None`` when no cache attached."""
        if self.store.cache is None:
            return None
        return self.store.cache.stats.snapshot()

    def clear_cache(self) -> None:
        """Drop every cached page (counters survive)."""
        if self.store.cache is not None:
            self.store.cache.clear()

    # --------------------------------------------------------------- fault
    def fail(self) -> None:
        """Drop the device (fault injection / drain).  The page cache is
        device DRAM — it died with the device."""
        self.store.dev.fail()
        if self.store.cache is not None:
            self.store.cache.clear()

    # -------------------------------------------------------------- export
    def export_adjacency(self) -> list:
        """Full adjacency export (oracle/validation only)."""
        adj = self.store.to_adjacency()
        return [[int(v), np.asarray(sorted(nb), dtype=SLOT_DTYPE)]
                for v, nb in adj.items()]

    # ------------------------------------------------- rebuild stream: src
    def export_adj_chunk(self, cls, n_shards, start_vid, max_pages) -> dict:
        """One bounded chunk of this shard's class-``cls`` adjacency, in
        ascending-vid order from ``start_vid``: L vids as materialised
        neighbor lists (re-laid by the importer's bulk packing), H chains
        as RAW page-exact data (replicas must keep layout-identical
        chains — the page-granular spread fetch depends on it).  Returns
        ``done`` + the next cursor, so the destination pulls the
        partition one chunk at a time instead of materialising it."""
        st = self.store
        cls, n_shards = int(cls), int(n_shards)
        budget = max(1, int(max_pages))
        l_vids: list[int] = []
        l_nbrs: list[np.ndarray] = []
        h_vids: list[int] = []
        h_lens: list[int] = []
        h_pages: list[np.ndarray] = []
        used = 0
        next_vid = -1
        done = True
        with st._lock:
            # vid list AND kinds in one snapshot: consulting the live map
            # per-vid outside the lock could see a concurrent L->H
            # promotion and ship a half-of-each view of that vertex
            kinds = {v: k for v, k in st.gmap.items()
                     if v % n_shards == cls and v >= int(start_vid)}
        vids_c = sorted(kinds)
        pend_l: list[int] = []
        for v in vids_c:
            if used >= budget:
                next_vid, done = v, False
                break
            kind = kinds[v]
            if kind == "L":
                pend_l.append(v)
                used += 1            # L vids are cheap; count conservatively
            elif kind == "H":
                with st._lock:
                    chain = list(st.h_chain[v])
                    pages = st.dev.read_pages(
                        np.asarray(chain, dtype=np.int64), tag="graph")
                h_vids.append(v)
                h_lens.append(len(chain))
                h_pages.append(np.array(pages))
                used += len(chain)
        if pend_l:
            l_vids = pend_l
            l_nbrs = st.get_neighbors_batch(pend_l)
        return {
            "l_vids": np.asarray(l_vids, dtype=np.int64),
            "l_lens": np.asarray([len(x) for x in l_nbrs], dtype=np.int64),
            "l_nbrs": (np.concatenate(l_nbrs).astype(SLOT_DTYPE) if l_nbrs
                       else np.empty(0, dtype=SLOT_DTYPE)),
            "h_vids": np.asarray(h_vids, dtype=np.int64),
            "h_lens": np.asarray(h_lens, dtype=np.int64),
            "h_pages": (np.concatenate(h_pages) if h_pages
                        else np.empty((0, SLOTS_PER_PAGE), dtype=SLOT_DTYPE)),
            "next_vid": next_vid, "done": done,
        }

    def export_emb_rows(self, rows):
        """Embedding rows by explicit local row index — the migration
        export (moved classes are non-contiguous under coarse extents)."""
        return self.store.get_embeds(np.asarray(rows, dtype=np.int64))

    # ---------------------------------------------- class migration: dst
    def emb_reserve_rows(self, n_rows) -> dict:
        """Grow this shard's embedding table by ``n_rows`` zero rows and
        return the base row index of the new region (the import target
        of one migrating class's stripe)."""
        return {"base": int(self.store.extend_embedding_table(int(n_rows)))}

    def _import_adj_chunk(self, l_vids, l_lens, l_nbrs, h_vids, h_lens,
                          h_pages) -> dict:
        """Import one ``export_adj_chunk`` payload into the LIVE store
        (unlike ``rebuild``, which materialises a fresh one): L vids are
        re-laid through the unit insert path, H chains cloned page-exact.
        Replace-safe, so a chunk redo after a source failover converges."""
        st = self.store
        l_vids = np.asarray(l_vids, dtype=np.int64)
        l_lens = np.asarray(l_lens, dtype=np.int64)
        l_nbrs = np.asarray(l_nbrs, dtype=SLOT_DTYPE)
        h_vids = np.asarray(h_vids, dtype=np.int64)
        h_lens = np.asarray(h_lens, dtype=np.int64)
        h_pages = np.asarray(h_pages, dtype=SLOT_DTYPE)
        off = 0
        for v, ln in zip(l_vids.tolist(), l_lens.tolist()):
            st.import_l_vertex(int(v), l_nbrs[off: off + ln])
            off += ln
        off = 0
        for v, ln in zip(h_vids.tolist(), h_lens.tolist()):
            st.import_h_chain(int(v), h_pages[off: off + ln])
            off += ln
        return {"l": int(len(l_vids)), "h": int(len(h_vids))}

    def migrate_pull(self, cls, modulus, src, start_vid, max_pages) -> dict:
        """Pull ONE bounded adjacency chunk of class ``cls`` from peer
        ``src`` over the peer link and import it into the live store.

        The coordinator drives the cursor loop (so it can pace, probe
        bit-identity at every chunk boundary, and fail the source over),
        but only O(1) metadata crosses the coordinator link — the page
        data moves shard-to-shard.  Returns the next cursor, ``done``,
        and the payload byte count for the migration's accounting."""
        if self.peers is None:
            raise RuntimeError("migrate_pull needs peer links (set_peers)")
        chunk = self.peers[int(src)].call(
            "export_adj_chunk", cls=int(cls), n_shards=int(modulus),
            start_vid=int(start_vid), max_pages=int(max_pages))
        h_pages = np.asarray(chunk["h_pages"], dtype=SLOT_DTYPE)
        l_nbrs = np.asarray(chunk["l_nbrs"], dtype=SLOT_DTYPE)
        self._import_adj_chunk(chunk["l_vids"], chunk["l_lens"], l_nbrs,
                               chunk["h_vids"], chunk["h_lens"], h_pages)
        return {"next_vid": int(chunk["next_vid"]),
                "done": bool(chunk["done"]),
                "l": int(len(chunk["l_vids"])),
                "h": int(len(chunk["h_vids"])),
                "pages": int(len(h_pages)),
                "bytes": int(l_nbrs.nbytes + h_pages.nbytes)}

    def migrate_pull_emb(self, src, cls, modulus, src_base, src_mod,
                         row0, take, dst_row0) -> dict:
        """Pull ``take`` embedding rows of class ``cls`` (class-local
        rows ``[row0, row0+take)``) from peer ``src`` and write them at
        local rows ``[dst_row0, ...)``.  Source rows are computed from
        O(1) extent metadata (``src_base + vid // src_mod``), so the
        coordinator ships no row lists."""
        if self.peers is None:
            raise RuntimeError("migrate_pull_emb needs peer links")
        vids = int(cls) + int(modulus) * (
            int(row0) + np.arange(int(take), dtype=np.int64))
        src_rows = int(src_base) + vids // int(src_mod)
        vals = np.asarray(self.peers[int(src)].call(
            "export_emb_rows", rows=src_rows), dtype=np.float32)
        self.store.write_embed_rows(int(dst_row0), vals)
        return {"rows": int(len(vals)), "bytes": int(vals.nbytes)}

    def drop_class(self, cls, modulus) -> dict:
        """Free every vertex of ``cls`` (mod ``modulus``) — the source
        side's release once the class's routing flip commits."""
        return {"dropped": int(self.store.drop_class(int(cls),
                                                     int(modulus)))}

    # ------------------------------------------------- rebuild stream: dst
    def rebuild(self, plan: dict) -> dict:
        """Re-materialise this shard from survivor peers, streaming.

        ``plan`` (built by the coordinator — pure metadata, no page data):
        ``n_shards``, ``num_vertices``, ``chunk_pages``, ``feature_dim``,
        optional ``pace_s``, and per owned class ``{cls, src, src_row0,
        rows}`` in stripe-role order.  The destination pulls bounded
        chunks from each class's survivor endpoint over the PEER links —
        survivor pages never transit the coordinator — cloning H chains
        page-exactly and re-laying L vids + embedding stripes through the
        bulk packing.  ``pace_s`` sleeps between chunk pulls: the rebuild
        throttle point, so recovery reads trickle onto survivor devices
        instead of monopolising them while serving reads queue behind.
        """
        if self.peers is None:
            raise RuntimeError("rebuild needs peer links (set_peers)")
        old = self.store
        t0 = time.perf_counter()
        n_shards = int(plan["n_shards"])
        chunk_pages = int(plan.get("chunk_pages") or _REBUILD_CHUNK_PAGES)
        pace_s = float(plan.get("pace_s") or 0.0)
        n_chunks = 0
        new = GraphStore(clone_dev_profile(old.dev),
                         h_threshold=old.h_threshold)
        vids_all: list[int] = []
        lens_all: list[int] = []
        nbrs_all: list[np.ndarray] = []
        n_cloned = 0
        stripes: list[np.ndarray] = []
        d = int(plan.get("feature_dim") or 0)
        for entry in plan["classes"]:
            src = self.peers[int(entry["src"])]
            cursor, done = 0, False
            while not done:
                if pace_s and n_chunks:
                    time.sleep(pace_s)
                n_chunks += 1
                chunk = src.call("export_adj_chunk", cls=int(entry["cls"]),
                                 n_shards=n_shards, start_vid=cursor,
                                 max_pages=chunk_pages)
                done = bool(chunk["done"])
                cursor = int(chunk["next_vid"])
                lv = np.asarray(chunk["l_vids"], dtype=np.int64)
                if len(lv):
                    vids_all.extend(lv.tolist())
                    lens_all.extend(
                        np.asarray(chunk["l_lens"]).tolist())
                    nbrs_all.append(np.asarray(chunk["l_nbrs"],
                                               dtype=SLOT_DTYPE))
                hv = np.asarray(chunk["h_vids"], dtype=np.int64)
                if len(hv):
                    pages = np.asarray(chunk["h_pages"], dtype=SLOT_DTYPE)
                    off = 0
                    for v, ln in zip(hv.tolist(),
                                     np.asarray(chunk["h_lens"]).tolist()):
                        new.import_h_chain(int(v), pages[off: off + ln])
                        off += ln
                        n_cloned += 1
            if d and int(entry.get("rows", 0)):
                rows_n = int(entry["rows"])
                # rows-mode entries carry (src_base, src_mod) extent
                # metadata so moved classes with coarse (non-contiguous)
                # stripes stream too; legacy src_row0 entries are the
                # contiguous special case src_mod == n_shards
                if "src_row0" in entry:
                    src_base, src_mod = int(entry["src_row0"]), n_shards
                else:
                    src_base = int(entry["src_base"])
                    src_mod = int(entry["src_mod"])
                vids = int(entry["cls"]) + n_shards * np.arange(
                    rows_n, dtype=np.int64)
                src_rows = src_base + vids // src_mod
                max_rows = max(1, chunk_pages * SLOTS_PER_PAGE // max(d, 1))
                parts = []
                for off in range(0, rows_n, max_rows):
                    if pace_s and n_chunks:
                        time.sleep(pace_s)
                    n_chunks += 1
                    parts.append(np.asarray(
                        src.call("export_emb_rows",
                                 rows=src_rows[off: off + max_rows]),
                        dtype=np.float32))
                stripes.append(np.concatenate(parts) if len(parts) > 1
                               else parts[0])
        if vids_all:
            order = np.argsort(np.asarray(vids_all), kind="stable")
            vids_srt = np.asarray(vids_all, dtype=np.int64)[order]
            lens_arr = np.asarray(lens_all, dtype=np.int64)
            n_glob = max(int(plan["num_vertices"]), int(vids_srt[-1]) + 1)
            deg = np.zeros(n_glob, dtype=np.int64)
            deg[vids_srt] = lens_arr[order]
            indptr = np.concatenate([[0], np.cumsum(deg)])
            nbr_cat = (np.concatenate(nbrs_all) if nbrs_all
                       else np.empty(0, dtype=SLOT_DTYPE))
            bounds = np.concatenate([[0], np.cumsum(lens_arr)])
            indices = np.concatenate(
                [nbr_cat[bounds[i]: bounds[i + 1]] for i in order]) \
                .astype(np.int32) if len(nbr_cat) else nbr_cat
            new._write_adjacency(indptr, indices)
        if stripes:
            new._write_embedding_table(np.concatenate(stripes))
        new.num_vertices = max(new.num_vertices, int(plan["num_vertices"]),
                               old.num_vertices)
        if old.cache is not None:
            new.attach_cache(old.cache.clone_empty())
        self.store = new
        return {"vertices": len(vids_all) + n_cloned,
                "h_chains_cloned": n_cloned,
                "pages_written": new.dev.stats.written_pages,
                "chunks": n_chunks, "pace_s": pace_s,
                "seconds": time.perf_counter() - t0}


class _DirectPeer:
    """In-process peer link: ``.call`` dispatches straight into a
    ``ShardService`` (the local-array analogue of a peer RoP client)."""

    def __init__(self, service: ShardService):
        self._service = service

    def call(self, method: str, *, timeout: float | None = None, **kw):
        return getattr(self._service, method)(**kw)


# ------------------------------------------------------------- host side
class ShardEndpoint:
    """Coordinator-facing protocol of one shard (see module docstring).

    Subclasses implement ``call`` (synchronous command), ``fetch_submit``
    / ``fetch_result`` (asynchronous batched read), ``set_peers``, and
    lifecycle.  Everything else is shared convenience built on ``call``.
    """

    # -- transport (subclass responsibility) -----------------------------
    def call(self, method: str, **kw):
        """Synchronous shard command: dispatch ``method`` on the shard's
        ``ShardService`` and return its result (raises what it raises)."""
        raise NotImplementedError

    def call_submit(self, method: str, **kw):
        """Asynchronous command: write it and return a handle.  Lets the
        coordinator fan a per-shard metadata round (plan_info, gossip
        counters) out to every shard and pay ONE round-trip, not N."""
        raise NotImplementedError

    def call_result(self, handle):
        """Await one ``call_submit`` handle and return its result."""
        raise NotImplementedError

    def fetch_submit(self, **kw):
        """Submit one batched-read (``fetch``) command and return a
        handle; the coordinator awaits all shards together and pays
        max(shard costs), not the sum."""
        raise NotImplementedError

    def fetch_result(self, handle) -> dict:
        """Await one ``fetch_submit`` handle -> the shard's fetch block."""
        raise NotImplementedError

    def set_peers(self, endpoints: list["ShardEndpoint"]) -> None:
        """(Re)wire this shard's peer links for shard-to-shard streaming
        (rebuild, migration, ingest exchange).  Idempotent — called again
        after every elastic grow/shrink."""
        raise NotImplementedError

    def close(self) -> None:
        """Release transport resources (base: no-op)."""
        pass

    # -- shared convenience ----------------------------------------------
    def stats(self) -> dict:
        """The shard's full telemetry snapshot (``ShardService.stats``)."""
        return self.call("stats")

    def rpc_calls(self) -> int:
        """Total host-side commands issued to this shard (fig25)."""
        return sum(s.calls for s in self.method_stats.values())


class LocalShardEndpoint(ShardEndpoint):
    """In-process shard: direct ``ShardService`` dispatch, zero-copy.

    Keeps the same per-method call accounting the RoP link keeps, so a
    local array and a remote array report identically in ``stats``."""

    def __init__(self, store: GraphStore | None = None, *,
                 dev: BlockDevice | None = None, h_threshold: int = 128,
                 feature_dim: int = 0):
        from ..rpc.client import ClientStats      # shared stub accounting
        self.service = ShardService(
            store or GraphStore(dev or BlockDevice(),
                                h_threshold=h_threshold,
                                feature_dim=feature_dim))
        self._stats = ClientStats()

    @property
    def local_store(self) -> GraphStore:
        """The wrapped in-process ``GraphStore`` (tests/admin)."""
        return self.service.store

    @property
    def method_stats(self) -> dict:
        """Per-method call accounting (same shape as the RoP client's)."""
        return self._stats.method_stats

    def call(self, method: str, **kw):
        """Direct ``ShardService`` dispatch with RoP-identical per-method
        accounting; ``stats`` results gain the same ``rpc`` injection the
        remote RPC server performs."""
        t0 = time.perf_counter()
        ok = True
        try:
            out = getattr(self.service, method)(**kw)
        except Exception:
            ok = False
            raise
        finally:
            self._stats.record(method, time.perf_counter() - t0, ok)
        if method == "stats":                 # mirror RPCServer's injection
            out["rpc"] = self._stats.stats_snapshot()
        return out

    def call_submit(self, method: str, **kw):
        """In-process "submission" computes immediately — device latency
        is deferred into ``io_us`` where it matters, so awaiting N local
        shards still costs max(shard costs)."""
        return self.call(method, **kw)

    def call_result(self, handle):
        """Handles ARE results in-process."""
        return handle

    def fetch_submit(self, **kw):
        """Batched read, computed inline (see ``call_submit``)."""
        return self.call("fetch", pack=False, **kw)

    def fetch_result(self, handle) -> dict:
        """Handles ARE results in-process."""
        return handle

    def set_peers(self, endpoints) -> None:
        """Wire direct in-process peer links (RoP peers get a real
        peer-queue client).  Idempotent."""
        self.service.peers = [
            _DirectPeer(ep.service) if isinstance(ep, LocalShardEndpoint)
            else ep.peer_link() for ep in endpoints]


class ShardHost:
    """Device side of one REMOTE CSSD shard: a ``GraphStore`` behind an
    ``RPCServer``, drained from its own ``MultiQueueRoP`` by a firmware
    poll thread — the per-shard half of the paper's RoP link."""

    def __init__(self, dev: BlockDevice | None = None, *,
                 h_threshold: int = 128, feature_dim: int = 0,
                 n_queues: int = 2, queue_depth: int = 64):
        from ..rpc import MultiQueueRoP, RPCServer
        self.service = ShardService(GraphStore(dev or BlockDevice(),
                                               h_threshold=h_threshold,
                                               feature_dim=feature_dim))
        self.server = RPCServer(self.service)
        self.rop = MultiQueueRoP(n_queues=n_queues, depth=queue_depth)
        self.service.rop = self.rop       # queue pressure visible in counters
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        """Launch the firmware poll thread (idempotent)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def poll():
            from ..rpc.transport import serialize
            while not self._stop.is_set():
                got = self.rop.pop_submission(timeout=0.05)
                if got is None:
                    continue
                qid, cmd_id, packet = got
                try:
                    reply = self.server.handle(packet)
                except Exception as e:  # noqa: BLE001 — reply-path fault:
                    # the host must stay up and the waiter must wake, or
                    # one bad reply wedges every later command on this
                    # shard (serialization faults surface to the caller)
                    reply = serialize({"ok": False,
                                       "error": f"{type(e).__name__}: {e}"})
                self.rop.post_completion(qid, cmd_id, reply)

        self._thread = threading.Thread(target=poll, name="shard-host",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Signal and join the poll thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class RopShardEndpoint(ShardEndpoint):
    """One shard behind a real RoP link: every command serialized over a
    dedicated SQ/CQ pair + PCIeChannel mmap buffers to the shard host's
    poll thread.  ``fetch_submit`` writes the command and returns; the
    coordinator awaits all shards' completions together and pays
    max(shard costs) — batched-read concurrency across hosts."""

    def __init__(self, host: ShardHost, *, qid: int = 0, peer_qid: int = 1):
        from ..rpc import AsyncRPCClient
        from ..rpc.transport import PCIeChannel
        self.host = host                  # lifecycle + peer wiring only
        self._peer_qid = peer_qid
        self.client = AsyncRPCClient(host.rop, qid,
                                     tx=PCIeChannel(), rx=PCIeChannel())
        host.start()

    @property
    def method_stats(self) -> dict:
        """Per-method call accounting from the RoP client stub."""
        return self.client.method_stats

    def _map_error(self, e: RuntimeError):
        if str(getattr(e, "remote_error", "")) \
                .startswith("DeviceFailedError"):
            raise DeviceFailedError(str(e)) from e
        raise e

    def call(self, method: str, **kw):
        """One synchronous command over the RoP link (remote
        ``DeviceFailedError`` re-raised as the typed local exception)."""
        try:
            return self.client.call(method, **kw)
        except RuntimeError as e:
            self._map_error(e)

    def call_submit(self, method: str, **kw):
        """Write one command into the SQ and return its handle."""
        return self.client.submit(method, **kw)

    def call_result(self, handle):
        """Await one submitted command's CQ completion."""
        try:
            return self.client.result(handle)
        except RuntimeError as e:
            self._map_error(e)

    def fetch_submit(self, **kw):
        """Submit one packed batched-read command (awaited via
        ``fetch_result``; plans travel packed over the wire)."""
        return self.client.submit("fetch", pack=True, **kw)

    def fetch_result(self, handle) -> dict:
        """Await a fetch completion and unpack its plan descriptor."""
        try:
            out = self.client.result(handle)
        except RuntimeError as e:
            self._map_error(e)
        if out["desc"] is not None:
            out["desc"] = unpack_plan(out["desc"])
        return out

    def peer_link(self):
        """A client another shard host can pull rebuild chunks through —
        its own queue pair on this shard's RoP, so peer traffic never
        contends with the coordinator's command queue."""
        from ..rpc import AsyncRPCClient
        from ..rpc.transport import PCIeChannel
        return AsyncRPCClient(self.host.rop,
                              self._peer_qid % len(self.host.rop.pairs),
                              tx=PCIeChannel(), rx=PCIeChannel())

    def set_peers(self, endpoints) -> None:
        """Wire this shard host's peer clients (one queue-pair client
        per RoP peer, direct dispatch to local peers).  Idempotent."""
        self.host.service.peers = [
            _DirectPeer(ep.service) if isinstance(ep, LocalShardEndpoint)
            else ep.peer_link() for ep in endpoints]

    def channel_bytes(self) -> int:
        """Bytes moved over THIS endpoint's coordinator link (both
        directions) — what the rebuild-streaming test bounds."""
        return (self.client.tx.stats.bytes_moved
                + self.client.rx.stats.bytes_moved)

    def close(self) -> None:
        """Stop the shard host's poll thread."""
        self.host.stop()


# -------------------------------------------------------------- builders
def make_local_endpoints(n_shards: int, devs: list | None = None, *,
                         h_threshold: int = 128,
                         feature_dim: int = 0) -> list[LocalShardEndpoint]:
    """An in-process CSSD array: one ``LocalShardEndpoint`` per shard
    over fresh (or caller-provided) simulated devices."""
    devs = devs or [BlockDevice() for _ in range(n_shards)]
    return [LocalShardEndpoint(dev=d, h_threshold=h_threshold,
                               feature_dim=feature_dim) for d in devs]


def make_rop_endpoints(n_shards: int, devs: list | None = None, *,
                       h_threshold: int = 128, feature_dim: int = 0,
                       n_queues: int = 2,
                       queue_depth: int = 64) -> list[RopShardEndpoint]:
    """A multi-host CSSD array: one ``ShardHost`` (own RoP SQ/CQ pairs +
    poll thread) per shard, fronted by ``RopShardEndpoint`` stubs."""
    devs = devs or [BlockDevice() for _ in range(n_shards)]
    eps = [RopShardEndpoint(ShardHost(d, h_threshold=h_threshold,
                                      feature_dim=feature_dim,
                                      n_queues=n_queues,
                                      queue_depth=queue_depth))
           for d in devs]
    for ep in eps:
        ep.set_peers(eps)
        ep._peers_wired = True
    return eps
