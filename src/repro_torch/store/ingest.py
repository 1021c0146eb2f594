"""Distributed device-side ingest: sharded bulk load + mutation firehose.

Copy of ``repro/store/ingest.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

The paper's G-1..G-4 UpdateGraph pipeline (batch -> bucket -> radix-sort ->
CSR build) exists precisely because shipping a huge graph through the host
is the bottleneck — yet through PR 6 the array still preprocessed every
edge globally on the coordinator and shipped each shard one monolithic
``write_adjacency``/``write_embedding_table``.  This module moves the
pipeline to where the data is:

**Bulk load** (``distributed_update_graph``): the coordinator streams RAW
edge chunks round-robin to every shard concurrently over the existing
endpoint links (plus each shard's embedding stripe slices); each shard
mirrors + buckets device-side ([G-2]/[G-3] routing), peers exchange
cross-shard buckets over the peer links (the chunked-rebuild pull
discipline), and every shard sorts, builds its partition-local CSR and
bulk-packs its L/H pages + R replica embedding stripes locally, in
parallel ([G-3]/[G-4] + packing).  Coordinator bytes are O(E) raw chunks —
zero preprocessed CSR bytes — and the graph-pre sort scales with N.
Because routing reproduces ``partition_csr``'s class ownership, the
shard-local sort shares the monolithic key arithmetic, owned-class
self-loops are injected at commit, and the same packing code lays the
pages, the chunked load is **bit-identical** to the monolithic
``update_graph`` — same pages, same reads (tests/test_ingest.py).

**Mutation firehose** (``MutationFirehose``): the same machinery
generalised to a continuous high-rate mutation stream (social feeds,
fraud edges).  Ops accumulate in a coordinator-side log; every time
window the log is decomposed into ONE ordered sub-op list per shard
(replica fan-out folded in) and applied as ONE device-side
``apply_mutations`` command per shard — a concurrent ``_submit_round``
under the ordinary ``_write_gate``/flow-control discipline, so batched
reads flow between windows and overload sheds as typed
``BackpressureError``.  Each shard receives exactly the projection of the
global submission order onto its partition and applies it under the
device store lock, so a read at any window boundary is bit-identical to
applying the same mutations one at a time.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from ..concurrency import witness_lock
from ..rpc.queues import BackpressureError
from .blockdev import sleep_us
from .graphstore import BulkTimeline

DEFAULT_CHUNK_EDGES = 1 << 16        # raw edges per streamed chunk
DEFAULT_EMB_CHUNK_ROWS = 1 << 13     # embedding rows per streamed slice


# ============================================================== bulk load
def distributed_update_graph(store, edge_array, embeddings=None, *,
                             already_undirected: bool = False,
                             chunk_edges: int = DEFAULT_CHUNK_EDGES,
                             emb_chunk_rows: int = DEFAULT_EMB_CHUNK_ROWS
                             ) -> BulkTimeline:
    """Chunked distributed bulk load over a sharded array (see module
    docstring).  Drop-in result-compatible with ``update_graph``; call
    through ``ShardedGraphStore.update_graph_chunked`` so the maintenance
    gate is held.

    Phases (BulkTimeline): ``transfer`` is the raw chunk streaming,
    ``graph_pre`` the peer exchange + the slowest shard's device-side
    sort, ``write_feature``/``write_graph`` the slowest shard's page
    bursts during the parallel commit.
    """
    tl = BulkTimeline()
    t0 = time.perf_counter()
    N = store.n_shards
    R = int(getattr(store, "replication", 1))
    ce = max(1, int(chunk_edges))
    er = max(1, int(emb_chunk_rows))

    edges = np.asarray(edge_array, dtype=np.int64).reshape(-1, 2)
    emb = None
    if embeddings is not None:
        emb = np.ascontiguousarray(embeddings, dtype=np.float32)
        store._feature_dim = int(emb.shape[1])
        store._prepare_emb_layout(len(emb))
    d = 0 if emb is None else int(emb.shape[1])

    # placement plumbing: the session always buckets by the store's
    # current placement map, but the map only goes over the wire when it
    # is NOT the legacy modular layout — default arrays keep the exact
    # legacy ingest_begin payload (and bit-identical page layouts).
    pmap = store._routing.pmap
    begin_kw = dict(n_shards=N, replication=R,
                    already_undirected=bool(already_undirected),
                    emb_rows=0 if emb is None else len(emb),
                    feature_dim=d)
    if not pmap.is_modular(N):
        begin_kw["placement"] = pmap.to_payload()
    C = pmap.n_classes

    store._submit_round([
        (s, "ingest_begin", dict(begin_kw, shard=s)) for s in range(N)])
    try:
        # ---- transfer: stream raw chunks + stripe slices, all shards in
        # parallel (each shard's sequence on its own thread; the max-vid
        # scan rides the device-side bucketing, so the coordinator does
        # no per-edge work at all)
        n_chunks = -(-len(edges) // ce)
        max_vid = [-1] * N

        def stream_shard(s):
            ep = store.endpoints[s]
            mv = -1
            for i in range(s, n_chunks, N):
                out = ep.call("ingest_edges",
                              chunk=edges[i * ce: (i + 1) * ce])
                mv = max(mv, int(out["max_vid"]))
            if emb is not None:
                # one stripe per owned (class, role) pair, canonical
                # order — the session's stripe index is the wire "role"
                for j, (c, _r) in enumerate(pmap.pairs_of(s)):
                    stripe = emb[c::C]
                    for r0 in range(0, len(stripe), er):
                        ep.call("ingest_emb_rows", role=j, row0=r0,
                                rows=stripe[r0: r0 + er])
            max_vid[s] = mv

        store._map(stream_shard, range(N))
        tl.transfer = (0.0, time.perf_counter() - t0)

        # ---- exchange: one shard at a time pulls its buckets from its
        # (idle) peers — the single-puller schedule that keeps N
        # single-threaded shard hosts free of circular waits; only this
        # memcpy-like stage is sequential, the sort/pack below is not
        x0 = time.perf_counter() - t0
        for s in range(N):
            store.endpoints[s].call("ingest_exchange")
        x1 = time.perf_counter() - t0

        # ---- commit: every shard sorts + packs in parallel
        n_glob = max(max_vid) + 1
        c0 = time.perf_counter() - t0
        outs = store._map(
            lambda s: store.endpoints[s].call("ingest_commit",
                                              num_vertices=n_glob),
            range(N))
        # shards deferred their simulated flash time (their page bursts
        # run concurrently, one device each); the coordinator pays the
        # slowest shard's — the array's analytic device-time model
        sleep_us(max(o.get("flash_us", 0.0) for o in outs))
    except BaseException:
        for ep in store.endpoints:           # best-effort session cleanup
            try:
                ep.call("ingest_abort")
            except Exception:  # noqa: BLE001
                pass
        raise

    tl.graph_pre = (x0, x1 + max(o["sort_s"] for o in outs))
    tl.write_feature = (c0, c0 + max(o["write_feature_s"] for o in outs))
    tl.write_graph = (c0, time.perf_counter() - t0)
    tl.total = time.perf_counter() - t0
    tl.user_visible = max(tl.transfer[1], tl.write_feature[1])
    store._num_vertices = max(store._num_vertices, n_glob)
    store._bulk = tl
    return tl


# ======================================================= mutation firehose
@dataclass
class FirehoseCounters:
    """Cumulative firehose accounting (surfaced by ``snapshot``)."""

    submitted: int = 0        # logical ops logged
    applied: int = 0          # logical ops applied device-side
    subops: int = 0           # per-replica sub-ops applied
    windows: int = 0          # apply_mutations rounds issued
    barriers: int = 0         # delete_vertex barrier flushes
    shed: int = 0             # submissions rejected (log full)


class _ShardOps:
    """One shard's packed sub-op window (parallel arrays + embed rows)."""

    __slots__ = ("kinds", "arg0", "arg1", "flags", "emb")

    def __init__(self):
        self.kinds: list[int] = []
        self.arg0: list[int] = []
        self.arg1: list[int] = []
        self.flags: list[int] = []
        self.emb: list[np.ndarray] = []

    def add(self, kind, a0, a1=0, flag=0, emb=None):
        self.kinds.append(int(kind))
        self.arg0.append(int(a0))
        self.arg1.append(int(a1))
        self.flags.append(int(flag))
        if emb is not None:
            self.emb.append(np.asarray(emb, dtype=np.float32))

    def kwargs(self) -> dict:
        kw = dict(kinds=np.asarray(self.kinds, dtype=np.int64),
                  arg0=np.asarray(self.arg0, dtype=np.int64),
                  arg1=np.asarray(self.arg1, dtype=np.int64),
                  flags=np.asarray(self.flags, dtype=np.int64))
        if self.emb:
            kw["emb"] = np.stack(self.emb)
        return kw


class MutationFirehose:
    """Windowed mutation batching over the array (see module docstring).

    Submit ops through the unit-op-shaped methods (``add_edge``,
    ``delete_edge``, ``add_vertex``, ``update_embed``,
    ``delete_vertex``); they accumulate in a bounded coordinator-side log
    and are applied by ``flush`` — on the ``window_s`` timer once
    ``start`` is called, or explicitly.  A full log sheds new submissions
    as typed ``BackpressureError`` (``reason.source = "firehose_log"``) —
    the write-side admission control.

    ``delete_vertex`` is a BARRIER: its decomposition reads the CURRENT
    neighbor set, so the pending window is flushed first, the delete
    applied serially through the store, and batching resumes.
    """

    def __init__(self, store, *, window_s: float = 0.05,
                 max_window_ops: int = 4096, max_log_ops: int = 65536):
        self.store = store
        self.window_s = float(window_s)
        self.max_window_ops = max(1, int(max_window_ops))
        self.max_log_ops = max(1, int(max_log_ops))
        self.counters = FirehoseCounters()    # guarded-by: _lock
        self._log: list[tuple] = []           # guarded-by: _lock
        self._lock = witness_lock("ingest._lock", threading.Lock())
        # one flush at a time: the timer thread and an explicit flush must
        # not interleave their windows (order is the whole contract)
        self._flush_lock = witness_lock(
            "ingest._flush_lock", threading.Lock())
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MutationFirehose":
        """Run the window timer: a daemon thread flushes every
        ``window_s`` seconds.  Timer-flush errors are stashed on
        ``last_error`` (ops stay logged) so the stream survives transient
        backpressure; ``close`` re-raises by flushing in the caller."""
        if self._thread is None:
            self._stop.clear()

            def loop():
                while not self._stop.wait(self.window_s):
                    try:
                        self.flush()
                    except Exception as e:  # noqa: BLE001 — see docstring
                        self.last_error = e

            self._thread = threading.Thread(target=loop,
                                            name="firehose-window",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the window timer WITHOUT draining the log (see
        ``close`` for the draining variant)."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._thread = None

    def close(self) -> dict:
        """Stop the timer, apply everything still logged (errors now
        propagate), and return the final counter snapshot."""
        self.stop()
        self.flush()
        return self.snapshot()

    def snapshot(self) -> dict:
        """Counter + config snapshot: submitted/applied/subops/windows/
        barriers/shed, current log depth, and the window limits (the
        ``firehose`` block of the service ``stats`` RPC)."""
        c = self.counters
        with self._lock:
            depth = len(self._log)
        return {"submitted": c.submitted, "applied": c.applied,
                "subops": c.subops, "windows": c.windows,
                "barriers": c.barriers, "shed": c.shed,
                "log_depth": depth, "window_s": self.window_s,
                "max_window_ops": self.max_window_ops,
                "max_log_ops": self.max_log_ops}

    # ----------------------------------------------------------- submission
    def _submit(self, op: tuple) -> None:
        with self._lock:
            if len(self._log) >= self.max_log_ops:
                self.counters.shed += 1
                raise BackpressureError(
                    f"firehose log full ({self.max_log_ops} ops pending); "
                    f"back off and retry",
                    reason={"source": "firehose_log",
                            "depth": len(self._log),
                            "limit": self.max_log_ops})
            self._log.append(op)
            self.counters.submitted += 1

    def _check_embed(self, vid: int) -> None:
        """Replicated arrays bounds-check embed rows at the unit RPC; the
        firehose keeps that contract at submission time, so a bad row is
        rejected to the submitter instead of poisoning a later window."""
        check = getattr(self.store, "_check_emb_vid", None)
        if check is not None:
            check(vid)

    def add_vertex(self, vid, embed=None) -> None:
        """Log one AddVertex (+ optional embedding row).  Raises
        ``BackpressureError`` when the log is full, ``IndexError`` for an
        out-of-range embed row."""
        if embed is not None:
            self._check_embed(int(vid))
        self._submit(("add_vertex", int(vid),
                      None if embed is None
                      else np.asarray(embed, dtype=np.float32)))

    def add_edge(self, dst, src) -> None:
        """Log one undirected AddEdge (raises ``BackpressureError``
        when the log is full)."""
        self._submit(("add_edge", int(dst), int(src)))

    def delete_edge(self, dst, src) -> None:
        """Log one undirected DeleteEdge (``BackpressureError`` when
        the log is full)."""
        self._submit(("delete_edge", int(dst), int(src)))

    def update_embed(self, vid, embed) -> None:
        """Log one UpdateEmbed (bounds-checked at submission; raises
        ``BackpressureError`` when the log is full)."""
        self._check_embed(int(vid))
        self._submit(("update_embed", int(vid),
                      np.asarray(embed, dtype=np.float32)))

    def delete_vertex(self, vid) -> None:
        """Log one DeleteVertex — applied as a BARRIER at flush time
        (pending window drains first; see class docstring)."""
        self._submit(("delete_vertex", int(vid)))

    # ---------------------------------------------------------------- apply
    def flush(self) -> int:
        """Apply every logged op in submission order, at most
        ``max_window_ops`` logical ops per device-side window.  Returns
        the number of logical ops applied."""
        applied = 0
        with self._flush_lock:
            while True:
                with self._lock:
                    window = self._log[: self.max_window_ops]
                    del self._log[: len(window)]
                if not window:
                    return applied
                applied += self._apply_window(window)

    def _replicas(self, vid: int) -> list[tuple[int, int]]:
        """(shard, local embedding row) of every live replica of ``vid``
        — primary first, resolved through the store's current routing
        (placement-map and reshard aware); plain sharded arrays have
        exactly the owner."""
        st = self.store
        if hasattr(st, "_emb_locate"):
            return st._emb_locate(vid)
        return [(int(vid) % st.n_shards, int(vid) // st.n_shards)]

    def _apply_window(self, window: list[tuple]) -> int:
        st = self.store
        if not hasattr(st, "endpoints"):
            # single-device store: no per-shard decomposition to batch —
            # the window degenerates to ordered serial replay
            for op in window:
                kind, args = op[0], op[1:]
                if kind == "add_vertex":
                    st.add_vertex(args[0], args[1])
                else:
                    getattr(st, kind)(*args)
            with self._lock:
                self.counters.applied += len(window)
                self.counters.windows += 1
            return len(window)

        per_shard: dict[int, _ShardOps] = {}

        def ops_of(s: int) -> _ShardOps:
            if s not in per_shard:
                per_shard[s] = _ShardOps()
            return per_shard[s]

        def dispatch():
            if not per_shard:
                return
            items = [(s, "apply_mutations", ops.kwargs())
                     for s, ops in sorted(per_shard.items())]
            outs = st._submit_round(items)
            with self._lock:
                self.counters.windows += 1
                self.counters.subops += sum(o["applied"] for o in outs)
            per_shard.clear()

        def vertex(v, embed=None):
            reps = self._replicas(v)
            for s, _off in reps:
                ops_of(s).add(0, v)
            st._num_vertices = max(st._num_vertices, v + 1)
            if embed is not None:
                embed_row(v, embed, reps)

        def embed_row(v, embed, reps=None):
            for s, row in (reps or self._replicas(v)):
                ops_of(s).add(4, row, emb=embed)

        applied = 0
        # the whole window — replica decomposition AND dispatch — runs
        # under one write gate: the gate waits out any in-flight class
        # migration and holds the mutation lock, so a reshard's routing
        # flip can never land between decomposing an op against the old
        # owners and applying it (nested gates, e.g. the delete_vertex
        # barrier, re-enter without waiting)
        with st._write_gate():
            for op in window:
                kind = op[0]
                if kind == "add_vertex":
                    vertex(op[1], op[2])
                elif kind == "add_edge":
                    dst, src = op[1], op[2]
                    vertex(dst)
                    if src != dst:
                        vertex(src)
                    for s, _row in self._replicas(dst):
                        ops_of(s).add(1, dst, src, flag=1)
                    if dst != src:
                        for s, _row in self._replicas(src):
                            ops_of(s).add(1, src, dst)
                elif kind == "delete_edge":
                    dst, src = op[1], op[2]
                    for s, _row in self._replicas(dst):
                        ops_of(s).add(2, dst, src, flag=1)
                    if dst != src:
                        for s, _row in self._replicas(src):
                            ops_of(s).add(2, src, dst)
                elif kind == "update_embed":
                    embed_row(op[1], op[2])
                elif kind == "delete_vertex":
                    # BARRIER: decomposition reads the current neighbor
                    # set, so everything logged before it applies first
                    dispatch()
                    with self._lock:
                        self.counters.barriers += 1
                    st.delete_vertex(op[1])
                else:
                    raise ValueError(f"unknown firehose op {kind!r}")
                applied += 1
            dispatch()
        with self._lock:
            self.counters.applied += applied
        return applied
