"""ShardedGraphStore — hash-partitioned coordinator over a CSSD array.

Copy of ``repro/store/sharded.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

The paper serves a hundred-billion-edge graph from ONE CSSD and argues
scale-out as an array of such devices (§8; Fig. 18's channel-parallel
bandwidth argument, one level up).  This coordinator makes that concrete:
the graph lives partitioned across N shards, each behind its own
``ShardEndpoint`` (``store/endpoint.py``) — a partition-local
``GraphStore`` reached either in-process (``LocalShardEndpoint``,
zero-copy) or over a per-shard RoP link (``RopShardEndpoint``:
MultiQueueRoP SQ/CQ pair + PCIeChannel, its own host poll thread).  The
coordinator speaks ONLY the endpoint protocol — no shard attribute
access — so the array can span hosts, and every batched query fans out
so each shard pays its command latency *concurrently* — the same
amortisation the flash channels give inside one device.

Partitioning is by vertex hash (``vid % n_shards``):

  * **adjacency** — vid's neighbor chunks live on shard ``vid % N``, keyed
    by the GLOBAL vid.  Neighbor values are global vids, so no translation
    table exists anywhere; the owned-vid subset ``{s, s+N, ...}`` is still
    ascending, so the shard-local L-page range search is unchanged;
  * **embeddings** — vid's feature row is row ``vid // N`` of its shard's
    sequential embedding space.  Round-robin striping keeps each shard's
    row space dense, so the shard-local address math (row -> page span) is
    exactly the single-device math;
  * **mutable ops** (unit updates, bulk ingest, embed RMWs) route to the
    owning shard's endpoint; each device's ``on_write`` hook invalidates
    that shard's page cache, precisely as on one device.

Read-side batched queries run in three explicit phases:

  plan   — partition the query positions by owning shard (pure table math,
           no I/O);
  fetch  — ONE batched ``fetch`` command per shard, SUBMITTED to every
           shard and AWAITED together; each shard's simulated flash +
           command time is deferred device-side and shipped back as
           ``io_us``, and the array pays a single wait equal to the
           slowest shard — the same analytic concurrency model as the
           flash channels inside one device (divide, don't sum);
  build  — per-shard plans are recomposed into one global (block, desc) —
           descriptor rows re-based into the concatenated block — and fed
           to the SAME ``select_from_plan``/``neighbors_from_plan`` code
           the single-device store runs.

Because the recomposed plan is position-identical to the single-device
plan (same per-vid neighbor lists, same order) and the selection consumes
its rng stream in global frontier order, an N-shard sample is
**bit-identical** to the 1-device sample under the same seed — and, since
both endpoint flavours run the same device-side code, a remote
(``RopShardEndpoint``) array is bit-identical to a local one
(``tests/test_sharded_store.py``, ``tests/test_endpoint.py``).

``ReplicatedGraphStore`` (below) extends the array with R-way replica
placement: page-granular replica-spread reads against hub skew (fed by a
gossiped, staleness-bounded view of the shards' read counters), write
fan-out, and a ``fail_shard``/``rebuild_shard`` fault path whose rebuild
streams survivor pages shard-to-shard over the endpoints' peer links —
same plan->fetch->build contract, same bit-identity (see its docstring).
"""
from __future__ import annotations

import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np

from ..concurrency import witness_condition, witness_lock
from ..rpc.queues import BackpressureError, QueueFullError
from .blockdev import (BlockDevice, DeviceFailedError, SLOTS_PER_PAGE,
                       sleep_us)
from .endpoint import LocalShardEndpoint, make_local_endpoints
from .graphstore import (BulkTimeline, GraphStoreStats, _H_COUNT,
                         neighbors_from_plan, preprocess_edges,
                         select_from_plan)
from .placement import (PlacementMap, common_refine, grow_plan, heat_plan,
                        modular, plan_moves, rows_of_class, shrink_plan)
from .sampler import _ramp


@dataclass
class FlowControl:
    """End-to-end flow-control policy of the array coordinator.

    ``max_inflight_per_shard`` bounds how many batched-read rounds may
    have a command outstanding against one shard host at once (the
    in-flight window; 0 disables); a round that cannot take a window
    slot within ``window_timeout_s`` sheds as ``BackpressureError``
    instead of piling onto the shard's SQ rings.  A ``QueueFullError``
    from a ring is retried with exponential backoff
    (``backoff_base_s * 2^attempt``, capped at ``backoff_max_s``, plus
    up to ``jitter`` fraction of random extra so colliding submitters
    decorrelate) at most ``submit_retries`` times, then surfaces as
    typed ``BackpressureError`` too.  The penalty knobs feed replica
    selection: each gossiped queued command counts as
    ``queue_depth_penalty_pages`` of pre-existing load, and a
    supervisor-suspect shard starts ``suspect_penalty_pages`` deep — so
    reads steer away from hot or suspect shards *before* rings fill,
    unless a vertex class has no other live candidate."""

    max_inflight_per_shard: int = 8
    window_timeout_s: float = 5.0
    submit_retries: int = 4
    backoff_base_s: float = 0.002
    backoff_max_s: float = 0.1
    jitter: float = 0.5
    queue_depth_penalty_pages: float = 8.0
    suspect_penalty_pages: float = 1e5


def partition_csr(indptr: np.ndarray, indices: np.ndarray,
                  n_shards: int, shard: int, *, replication: int = 1,
                  placement: PlacementMap | None = None):
    """Mask a global CSR down to the rows shard ``shard`` owns.

    Non-owned rows keep indptr slots with zero degree, so the row index
    space stays global and ``GraphStore._write_adjacency`` (which skips
    degree-0 rows) lays out exactly the owned vertices.

    With ``replication=R`` the shard owns R residue classes — replica ``r``
    of vertex ``vid`` lives on shard ``(vid + r) % N``, so shard ``s``
    holds the classes ``{(s - r) % N, r < R}``.  The owned vid subset is
    still ascending, so the shard-local L-page range search is unchanged.

    A ``placement`` map replaces that modular rule: the shard owns the
    classes ``placement.classes_of(shard)`` under modulus
    ``placement.n_classes`` (``replication`` is then ignored — the map
    already encodes every replica role).
    """
    n = len(indptr) - 1
    degrees = np.diff(indptr)
    if placement is not None:
        modulus = placement.n_classes
        classes = placement.classes_of(shard)
    else:
        modulus = n_shards
        classes = [(shard - r) % n_shards for r in range(replication)]
    own = np.isin(np.arange(n) % modulus, classes)
    deg_s = np.where(own, degrees, 0)
    indptr_s = np.concatenate([[0], np.cumsum(deg_s)])
    row_of = np.repeat(np.arange(n), degrees)
    return indptr_s, indices[own[row_of]]


class _Routing:
    """One immutable routing generation of the array.

    Readers snapshot the coordinator's ``_routing`` reference once per
    operation and use only the snapshot, so an in-flight batched read
    keeps addressing the OLD owner of a migrating class while the
    resharder copies it; the atomic reference swap (under ``_mutate``,
    bumping ``epoch``) is the per-class flip.  Fields:

    * ``pmap`` — the :class:`PlacementMap` (class/role → shard),
    * ``ew_mod`` / ``ew_base`` — per (class, role) embedding extents:
      the local row of vid on its role-``r`` shard is
      ``ew_base[c, r] + vid // ew_mod[c, r]`` (coarse pre-refinement
      stripes keep their old modulus; migrated-in classes get dense
      ``mod = n_classes`` regions),
    * ``epoch`` — monotonically increasing flip counter,
    * ``heat`` — per-class accumulated read weight (the gossip-derived
      signal ``heat_plan`` partitions on); rides the routing object so
      its length always matches ``pmap.n_classes``.
    """

    __slots__ = ("pmap", "ew_mod", "ew_base", "epoch", "heat")

    def __init__(self, pmap: PlacementMap, ew_mod: np.ndarray,
                 ew_base: np.ndarray, epoch: int, heat: np.ndarray):
        self.pmap = pmap
        self.ew_mod = ew_mod
        self.ew_base = ew_base
        self.epoch = int(epoch)
        self.heat = heat


def _class_flow(supplies: dict, cand_of: dict, caps: np.ndarray):
    """Max-flow of class supplies into shard capacities (Edmonds-Karp on
    the tiny classes->candidates->shards graph).  Returns (total_flow,
    {(class, shard): amount})."""
    classes = list(supplies)
    n_cls, n_sh = len(classes), len(caps)
    v = n_cls + n_sh + 2
    src, snk = 0, v - 1
    cap = np.zeros((v, v))
    for i, c in enumerate(classes):
        cap[src, 1 + i] = supplies[c]
        for s in cand_of[c]:
            cap[1 + i, 1 + n_cls + s] = supplies[c]
    for s in range(n_sh):
        cap[1 + n_cls + s, snk] = caps[s]
    total = 0.0
    while True:
        parent = np.full(v, -1)
        parent[src] = src
        queue = [src]
        while queue and parent[snk] < 0:
            u = queue.pop(0)
            for w_ in np.nonzero(cap[u] > 1e-9)[0]:
                if parent[w_] < 0:
                    parent[w_] = u
                    queue.append(int(w_))
        if parent[snk] < 0:
            break
        aug, x = np.inf, snk
        while x != src:
            aug = min(aug, cap[parent[x], x])
            x = parent[x]
        x = snk
        while x != src:
            cap[parent[x], x] -= aug
            cap[x, parent[x]] += aug
            x = parent[x]
        total += aug
    flows = {(c, int(s)): float(cap[1 + n_cls + s, 1 + i])
             for i, c in enumerate(classes) for s in cand_of[c]
             if cap[1 + n_cls + s, 1 + i] > 1e-9}
    return total, flows


def _minmax_quotas(supplies: dict, cand_of: dict,
                   start: np.ndarray) -> dict:
    """Exact min-max assignment of per-class weights onto their candidate
    shards above existing ``start`` loads: binary search on the common
    load level, each probe a max-flow feasibility check.  Returns
    ``{class: additions aligned with cand_of[class]}``.  Greedy per-class
    waterfills are myopic on the replica ring (adjacent classes share
    candidates) and can overshoot an early shard a later class needs; the
    flow formulation is optimal for any replication factor."""
    total = float(sum(supplies.values()))
    if not supplies or total <= 0:
        return {c: np.zeros(len(cand_of[c])) for c in supplies}
    lo = float(np.min(start))
    hi = float(np.max(start)) + total
    eps = 1e-6 * max(1.0, total)
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        got, _fl = _class_flow(supplies, cand_of,
                               np.maximum(0.0, mid - start))
        if got >= total - eps:
            hi = mid
        else:
            lo = mid
    _, flows = _class_flow(supplies, cand_of,
                           np.maximum(0.0, hi + eps - start))
    return {c: np.asarray([flows.get((c, int(s)), 0.0)
                           for s in cand_of[c]])
            for c in supplies}


_CACHE_KEYS = ("hits", "misses", "evictions", "invalidations",
               "bytes_from_cache", "bytes_from_dev")


def aggregate_cache_snapshots(snaps) -> dict:
    """Sum per-shard cache snapshots into one array-level view (None
    entries — shards without a cache — are skipped).  Single source of
    truth for the counter key set, shared with the service ``stats``."""
    tot = dict.fromkeys(_CACHE_KEYS, 0)
    for snap in snaps:
        if snap is None:
            continue
        for k in tot:
            tot[k] += snap[k]
    n = tot["hits"] + tot["misses"]
    tot["hit_rate"] = tot["hits"] / n if n else 0.0
    return tot


class _AggCacheStats:
    """Aggregated view over the shards' per-device cache counters,
    pulled through the endpoint ``cache_stats`` snapshots."""

    def __init__(self, endpoints):
        self._endpoints = endpoints

    def snapshot(self) -> dict:
        return aggregate_cache_snapshots(
            ep.call("cache_stats") for ep in self._endpoints)

    @property
    def hit_rate(self) -> float:
        return self.snapshot()["hit_rate"]

    @property
    def hits(self) -> int:
        return self.snapshot()["hits"]

    @property
    def misses(self) -> int:
        return self.snapshot()["misses"]

    @property
    def invalidations(self) -> int:
        return self.snapshot()["invalidations"]


class _ShardedCacheView:
    """Duck-type of ``EmbeddingPageCache`` for telemetry/maintenance call
    sites (``.stats`` snapshots, ``.clear()``) spanning every shard."""

    def __init__(self, endpoints):
        self._endpoints = endpoints
        self.stats = _AggCacheStats(endpoints)

    def clear(self) -> None:
        for ep in self._endpoints:
            ep.call("clear_cache")


class ShardedGraphStore:
    """Drop-in for ``GraphStore`` across the query/mutation surface the
    service layer uses, backed by ``n_shards`` shard endpoints.

    Construction (exactly one backing form):

    Args:
        n_shards: shard count when the store builds its own local
            endpoints (defaults to 2; inferred from ``devs`` or
            ``endpoints`` when those are given).
        devs: explicit ``BlockDevice`` list, one per shard (local
            endpoints are built around them).
        endpoints: pre-built ``ShardEndpoint`` list (local, remote, or
            mixed); adopted as-is, including their ``h_threshold``.
        h_threshold: L/H degree threshold pushed to owned endpoints.
        feature_dim: embedding width for owned endpoints (0 until a
            table is loaded).
        placement: optional :class:`repro.store.placement.PlacementMap`
            replacing the default ``vid % N`` ownership (must have one
            role column for the unreplicated store).
        flow: :class:`FlowControl` policy (defaults applied when None).

    Raises:
        ValueError: conflicting backing arguments, zero shards, or a
            placement map that is not total over the array.
    """

    def __init__(self, n_shards: int | None = None,
                 devs: list | None = None, *, endpoints: list | None = None,
                 h_threshold: int = 128, feature_dim: int = 0,
                 placement: PlacementMap | None = None,
                 flow: FlowControl | None = None):
        if endpoints is not None:
            if devs is not None:
                raise ValueError("pass either endpoints=[...] or "
                                 "devs=[...], not both")
            if n_shards is not None and n_shards != len(endpoints):
                raise ValueError(f"n_shards={n_shards} conflicts with "
                                 f"{len(endpoints)} endpoints")
            if not endpoints:
                raise ValueError("need at least one shard")
            self.endpoints = list(endpoints)
            self.n_shards = len(self.endpoints)
        else:
            if devs is not None:
                if n_shards is not None and n_shards != len(devs):
                    raise ValueError(f"n_shards={n_shards} conflicts with "
                                     f"{len(devs)} explicit devices")
                n_shards = len(devs)
            elif n_shards is None:
                n_shards = 2
            if n_shards < 1:
                raise ValueError("need at least one shard")
            self.n_shards = int(n_shards)
            devs = devs or [BlockDevice() for _ in range(self.n_shards)]
            self.endpoints = make_local_endpoints(
                self.n_shards, devs, h_threshold=h_threshold,
                feature_dim=feature_dim)
        self.h_threshold = int(h_threshold)
        self._bulk = BulkTimeline()
        # composite mutations span shards; one coordinator lock restores
        # the single-store mutation atomicity (membership check + inserts
        # as one critical section).  Readers do NOT take it — a hop fetch
        # racing an add_edge may observe the half-inserted undirected edge,
        # the inherent visibility model of an array of devices.
        self._mutate = witness_lock("sharded._mutate", threading.RLock())
        # maintenance gate: a streaming shard rebuild holds it for the
        # whole stream, mutations take it FIRST (always _maintenance ->
        # _mutate, never the reverse) and therefore block until the
        # replacement is re-admitted — the survivors stay the exact
        # current state, no replay log — while reads, which take only
        # _mutate, keep flowing throughout the rebuild.
        self._maintenance = witness_lock(
            "sharded._maintenance", threading.RLock())
        # end-to-end flow control: per-shard in-flight windows + typed
        # backpressure (see FlowControl).  ``health`` is the optional
        # supervisor (serve/supervisor.py attaches itself here); the
        # store reports shard errors to it and reads its suspect set —
        # duck-typed, so the store layer never imports the serve layer.
        self.flow = flow or FlowControl()
        self.health = None
        self.backpressure_events = 0         # guarded-by: _bp_lock
        self.backpressure_retries = 0        # guarded-by: _bp_lock
        self._bp_lock = witness_lock(        # misc small-state guard
            "sharded._bp_lock", threading.Lock())
        self._rebuilding: set[int] = set()
        self._windows = [
            threading.BoundedSemaphore(self.flow.max_inflight_per_shard)
            if self.flow.max_inflight_per_shard > 0 else None
            for _ in range(self.n_shards)]
        # cumulative simulated array wait (each fetch pays max over shards):
        # the device-model latency, free of host scheduler noise — what the
        # scale-out benchmarks compare across array configurations.
        self.io_wait_us = 0.0                # guarded-by: _bp_lock
        # coordinator-side bookkeeping (no synchronous shard peeks): the
        # coordinator is the only writer, so it tracks the global vertex
        # count and feature dim itself and boots them from one stats
        # snapshot per endpoint.  Caller-supplied endpoints are adopted
        # as built — the coordinator takes THEIR h_threshold rather than
        # pushing its own default over a layout the shards may already
        # have ingested with.
        own_endpoints = endpoints is None
        self._feature_dim = int(feature_dim)
        self._num_vertices = 0
        self._failed = [False] * self.n_shards
        for s, ep in enumerate(self.endpoints):
            if not getattr(ep, "_peers_wired", False):
                ep.set_peers(self.endpoints)
                ep._peers_wired = True
            snap = ep.stats()
            self._num_vertices = max(self._num_vertices,
                                     int(snap["store"]["num_vertices"]))
            self._feature_dim = max(self._feature_dim,
                                    int(snap["store"]["feature_dim"]))
            self._failed[s] = bool(snap["failed"])
            if not own_endpoints:
                self.h_threshold = int(snap["store"]["h_threshold"])
        # routing generation + reshard machinery.  ``replication`` and
        # ``_emb_rows`` live on the base class so the routing/locate math
        # is shared; the replicated subclass overwrites them before its
        # own ``_init_routing`` call.
        self.replication = 1
        self._emb_rows = 0
        # reader barrier: batched reads register with ``_read_routing``
        # so a class flip can quiesce every in-flight read that may hold
        # a pre-flip routing snapshot before the old owner's pages are
        # dropped.  Independent lock — NEVER held together with _mutate.
        self._rd_cv = witness_condition(
            "sharded._rd_cv", threading.Condition(threading.Lock()))
        self._rd_active = 0
        self._rd_barrier = False
        # per-class write gates during a copy window + reshard state.
        self._mig_classes: set[int] = set()
        self._mig_cv = threading.Condition(self._mutate)
        self._resharding = False
        self._reshard_stats: dict = {}
        if not hasattr(self, "_init_routing_deferred"):
            self._init_routing(1, placement)

    # ------------------------------------------------------------- routing
    def _init_routing(self, replication: int, placement) -> None:
        """Install the initial routing generation: the given placement
        map (validated against the array) or the legacy modular map
        ``owner[c, r] = (c + r) % N``, with canonical embedding extents.

        Raises:
            ValueError: placement map that is not total, out of range,
                or has the wrong number of role columns.
        """
        pmap = placement if placement is not None else modular(
            self.n_shards, replication)
        if pmap.owner.shape[1] != replication:
            raise ValueError(
                f"placement map has {pmap.owner.shape[1]} role columns, "
                f"store replication is {replication}")
        pmap.validate(self.n_shards)
        self._routing = self._canonical_routing(pmap, self._emb_rows, 0)

    def _canonical_routing(self, pmap: PlacementMap, n_rows: int,
                           epoch: int, heat: np.ndarray | None = None
                           ) -> _Routing:
        """Build a ``_Routing`` whose embedding extents are the canonical
        dense layout: every class striped at modulus ``n_classes``, each
        shard's stripes concatenated in ``pairs_of`` order (role-major,
        class-ascending — exactly the legacy ``_stripe_off`` cumsum at
        the default modular map)."""
        C, R = pmap.n_classes, pmap.owner.shape[1]
        ew_mod = np.full((C, R), C, dtype=np.int64)
        ew_base = np.zeros((C, R), dtype=np.int64)
        for s in range(self.n_shards):
            acc = 0
            for c, r in pmap.pairs_of(s):
                ew_base[c, r] = acc
                acc += rows_of_class(n_rows, c, C)
        if heat is None:
            heat = np.zeros(C, dtype=np.float64)
        return _Routing(pmap, ew_mod, ew_base, epoch, heat)

    def _swap_routing(self, rt: _Routing) -> None:
        """Atomically publish a new routing generation (callers hold
        ``_mutate``; readers pick it up on their next snapshot)."""
        self._routing = rt

    @contextmanager
    def _read_routing(self):
        """Register a routing-snapshot read: yields the current routing
        and holds the read barrier open until the reader finishes, so a
        class flip can wait out every read planned against the pre-flip
        owners before dropping their pages."""
        cv = self._rd_cv
        with cv:
            while self._rd_barrier:
                cv.wait()
            self._rd_active += 1
            rt = self._routing
        try:
            yield rt
        finally:
            with cv:
                self._rd_active -= 1
                cv.notify_all()

    @contextmanager
    def _quiesce_reads(self):
        """Block new snapshot reads and wait for in-flight ones to drain
        (used between a routing flip and dropping the vacated pages).
        Never entered while holding ``_mutate`` — a draining reader may
        need it."""
        cv = self._rd_cv
        with cv:
            while self._rd_barrier:
                cv.wait()
            self._rd_barrier = True
            while self._rd_active > 0:
                cv.wait()
        try:
            yield
        finally:
            with cv:
                self._rd_barrier = False
                cv.notify_all()

    def _check_not_resharding(self, what: str) -> None:
        if self._resharding:
            raise RuntimeError(
                f"{what} rejected: online reshard in progress")

    def _emb_locate(self, vid: int, rt: _Routing | None = None):
        """Live (shard, local embedding row) candidates for ``vid``,
        primary role first.

        Raises:
            DeviceFailedError: every replica of the vid's class is on a
                failed shard.
        """
        rt = rt or self._routing
        c = int(vid) % rt.pmap.n_classes
        out = []
        for r in range(rt.pmap.owner.shape[1]):
            s = int(rt.pmap.owner[c, r])
            if not self._failed[s]:
                out.append((s, int(rt.ew_base[c, r])
                            + int(vid) // int(rt.ew_mod[c, r])))
        if not out:
            raise DeviceFailedError(
                f"all replicas of vid {vid} (class {c}) are failed")
        return out

    # ------------------------------------------------------------- topology
    @property
    def failed_shards(self) -> list[bool]:
        """Per-shard failed flags (True = dropped by ``fail_shard``)."""
        return list(self._failed)

    @property
    def shards(self) -> list:
        """The in-process ``GraphStore`` objects (tests/benchmarks only —
        coordinator code never touches them).  Raises for remote arrays,
        whose stores live behind the RoP link."""
        try:
            return [ep.local_store for ep in self.endpoints]
        except AttributeError:
            raise RuntimeError("shards are remote (RopShardEndpoint); "
                               "use the endpoint stats API") from None

    @property
    def devs(self) -> list:
        """The shards' ``BlockDevice``s (in-process arrays only)."""
        return [sh.dev for sh in self.shards]

    def owner_of(self, vid: int) -> int:
        """Primary owner shard of ``vid`` under the current routing
        (equals ``vid % n_shards`` at the default modular placement)."""
        rt = self._routing
        return int(rt.pmap.owner[int(vid) % rt.pmap.n_classes, 0])

    def _owner_ep(self, vid: int):
        return self.endpoints[self.owner_of(vid)]

    def _map(self, fn, items):
        """Bulk-ingest fan-out: per-shard write bursts (ms-scale simulated
        sleeps, GIL released) overlap on real threads.  The pool is
        transient — created per phase, joined before returning — so idle
        stores hold no threads.  The read fan-out does NOT use threads:
        batched reads are submitted to every endpoint and awaited
        together instead (see ``_endpoint_fetch``)."""
        items = list(items)
        if len(items) <= 1:
            return [fn(x) for x in items]
        with ThreadPoolExecutor(max_workers=len(items),
                                thread_name_prefix="shard") as pool:
            return list(pool.map(fn, items))

    @property
    def feature_dim(self) -> int:
        """Embedding feature dimension (0 until a table is loaded)."""
        return self._feature_dim

    @property
    def num_vertices(self) -> int:
        """Vertex-id space size as of the last bulk load + unit adds."""
        return self._num_vertices

    def shard_stats(self) -> list[dict]:
        """One ``stats`` snapshot per shard endpoint — the telemetry the
        service layer aggregates (identical shape local or remote)."""
        return [ep.stats() for ep in self.endpoints]

    @property
    def stats(self) -> GraphStoreStats:
        """Array-aggregated ``GraphStoreStats`` (summed over one
        endpoint ``stats`` snapshot per shard)."""
        snaps = self.shard_stats()
        out = GraphStoreStats(
            l_evictions=sum(s["store"]["l_evictions"] for s in snaps),
            unit_updates=sum(s["store"]["unit_updates"] for s in snaps),
            pages_h=sum(s["store"]["pages_h"] for s in snaps),
            pages_l=sum(s["store"]["pages_l"] for s in snaps),
            bulk=self._bulk)
        if any(s["cache"] is not None for s in snaps):
            out.cache = _AggCacheStats(self.endpoints)
        return out

    def close(self) -> None:
        """Release endpoint resources (remote hosts stop their poll
        threads; local endpoints are no-ops)."""
        for ep in self.endpoints:
            ep.close()

    # ---------------------------------------------------------------- cache
    @property
    def cache(self):
        """Aggregated device-DRAM cache view, or ``None`` when no
        cache is attached (see ``attach_cache_pages``)."""
        if self.endpoints[0].call("cache_stats") is None:
            return None
        return _ShardedCacheView(self.endpoints)

    def attach_cache_pages(self, capacity_pages: int, **kw) -> None:
        """Split one device-DRAM budget evenly across the shards — each
        device fronts its own reads and invalidates through its own
        ``on_write`` hook, so coherence needs no cross-shard traffic."""
        per_shard = max(1, int(capacity_pages) // self.n_shards)
        for ep in self.endpoints:
            ep.call("attach_cache", capacity_pages=per_shard, **kw)

    # ----------------------------------------------------------- bulk ingest
    def _prepare_emb_layout(self, n_rows: int) -> None:
        """Called once per bulk ingest with the embedding row count,
        before any shard's table write: records the row count and
        installs fresh canonical embedding extents for the current
        placement map (``vid // N`` per stripe at the default map)."""
        with self._mutate:
            self._emb_rows = int(n_rows)
            rt = self._routing
            self._swap_routing(self._canonical_routing(
                rt.pmap, self._emb_rows, rt.epoch + 1, rt.heat))

    def _emb_shard_rows(self, embeddings: np.ndarray, s: int) -> np.ndarray:
        """The embedding rows shard ``s`` stores, in local-row order:
        one round-robin stripe per owned (class, role) pair, in
        canonical ``pairs_of`` order (``embeddings[s::N]`` at the
        default unreplicated map)."""
        pmap = self._routing.pmap
        C = pmap.n_classes
        return np.concatenate(
            [embeddings[c::C] for c, _r in pmap.pairs_of(s)]) \
            if pmap.pairs_of(s) else embeddings[:0]

    def _adj_shard_csr(self, indptr: np.ndarray, indices: np.ndarray,
                       s: int):
        """The global-CSR mask shard ``s`` writes as adjacency (all owned
        classes under the current placement map)."""
        return partition_csr(indptr, indices, self.n_shards, s,
                             placement=self._routing.pmap)

    def update_graph(self, edge_array: np.ndarray,
                     embeddings: np.ndarray | None = None,
                     *, already_undirected: bool = False) -> BulkTimeline:
        """Bulk UpdateGraph across the array.

        The global edge preprocessing runs once, overlapped with the
        (much larger) embedding write exactly as on one device — except the
        embedding table is striped ``embeddings[s::N]`` and every shard's
        sequential write burst proceeds in parallel on its own device.

        Raises:
            RuntimeError: an online reshard is migrating classes.
        """
        self._check_not_resharding("bulk ingest")
        tl = BulkTimeline()
        t0 = time.perf_counter()

        # No defensive copy: preprocess_edges never mutates its input, so
        # the coordinator holds ONE edge array during bulk load (the copy
        # here used to double peak host memory for nothing).
        edge_array = np.asarray(edge_array, dtype=np.int64).reshape(-1, 2)
        if embeddings is not None:
            embeddings = np.ascontiguousarray(embeddings, dtype=np.float32)
            self._feature_dim = int(embeddings.shape[1])
            self._prepare_emb_layout(len(embeddings))
        tl.transfer = (0.0, time.perf_counter() - t0)

        box: dict = {}

        def graph_pre():
            s = time.perf_counter() - t0
            box["csr"] = preprocess_edges(
                edge_array, already_undirected=already_undirected)
            box["span"] = (s, time.perf_counter() - t0)

        def write_feature():
            s = time.perf_counter() - t0
            if embeddings is not None:
                self._map(lambda sh: self.endpoints[sh].call(
                    "write_embedding_table",
                    rows=self._emb_shard_rows(embeddings, sh)),
                    range(self.n_shards))
            box["wf"] = (s, time.perf_counter() - t0)

        th_g = threading.Thread(target=graph_pre)
        th_f = threading.Thread(target=write_feature)
        th_g.start(); th_f.start()
        th_f.join()
        user_visible_at = time.perf_counter() - t0
        th_g.join()
        tl.graph_pre = box["span"]
        tl.write_feature = box.get("wf", (0.0, 0.0))

        s0 = time.perf_counter() - t0
        indptr, indices = box["csr"]
        self._num_vertices = max(self._num_vertices, len(indptr) - 1)

        def write_adj(s):
            ip, ix = self._adj_shard_csr(indptr, indices, s)
            self.endpoints[s].call("write_adjacency", indptr=ip, indices=ix)

        self._map(write_adj, range(self.n_shards))
        tl.write_graph = (s0, time.perf_counter() - t0)
        tl.total = time.perf_counter() - t0
        tl.user_visible = max(user_visible_at, tl.transfer[1])
        self._bulk = tl
        return tl

    def update_graph_chunked(self, edge_array: np.ndarray,
                             embeddings: np.ndarray | None = None,
                             *, already_undirected: bool = False,
                             chunk_edges: int | None = None,
                             emb_chunk_rows: int | None = None
                             ) -> BulkTimeline:
        """Distributed device-side bulk load: the coordinator streams RAW
        edge chunks and embedding stripe slices; every shard buckets,
        sorts and packs its partition locally, exchanging cross-shard
        pairs with its peers (store/ingest.py).  Bit-identical pages and
        reads vs ``update_graph``, with coordinator bytes O(E) raw chunks
        (zero preprocessed CSR) and the graph-pre sort scaling with N.

        Held behind the maintenance gate like any bulk ingest; reads
        (which take only the mutation lock) keep flowing throughout."""
        from .ingest import distributed_update_graph
        kw: dict = {}
        if chunk_edges is not None:
            kw["chunk_edges"] = int(chunk_edges)
        if emb_chunk_rows is not None:
            kw["emb_chunk_rows"] = int(emb_chunk_rows)
        with self._maintenance:
            self._check_not_resharding("bulk ingest")
            if any(self._failed):
                raise DeviceFailedError(
                    "bulk ingest needs every shard live; rebuild_shard "
                    "first")
            return distributed_update_graph(
                self, edge_array, embeddings,
                already_undirected=already_undirected, **kw)

    def firehose(self, **kw) -> "object":
        """A ``MutationFirehose`` over this array: windowed write batching
        with per-shard device-side application (store/ingest.py)."""
        from .ingest import MutationFirehose
        return MutationFirehose(self, **kw)

    # ------------------------------------------------------ batched queries
    def _partition(self, vids: np.ndarray,
                   rt: _Routing | None = None
                   ) -> list[tuple[int, np.ndarray]]:
        """plan phase: query positions grouped by primary-owner shard
        under routing snapshot ``rt`` (no I/O).  Also accumulates the
        per-class read heat the heat-aware resharder partitions on."""
        rt = rt or self._routing
        cls = vids % rt.pmap.n_classes
        np.add.at(rt.heat, cls, 1.0)
        owner = rt.pmap.owner[cls, 0]
        parts = [(s, np.nonzero(owner == s)[0])
                 for s in range(self.n_shards)]
        return [(s, pos) for s, pos in parts if len(pos)]

    # ------------------------------------------------------- flow control
    @contextmanager
    def _write_gate(self, vids=None):
        """Mutation critical section: maintenance gate first, then the
        mutation lock (the one legal order — see ``_maintenance``).

        While a reshard copies a class, writes touching that class wait
        on ``_mig_cv`` until its flip (``vids=None`` — e.g. a
        delete_vertex whose neighbor set is unknown up front — waits out
        ANY migrating class).  Nested gates never wait: a migration
        window cannot begin while ``_mutate`` is held, so reentrant
        callers already inside the gate see ``_mig_classes`` unchanged.
        """
        with self._maintenance:
            with self._mutate:
                if vids is None:
                    while self._mig_classes:
                        self._mig_cv.wait()
                else:
                    while any(int(v) % self._routing.pmap.n_classes
                              in self._mig_classes for v in vids):
                        self._mig_cv.wait()
                yield

    def _notify_shard_error(self, shard: int, exc: Exception) -> None:
        """Report a shard-attributed ``DeviceFailedError`` to the attached
        supervisor (if any) — the error-mapping half of failure detection.
        Never raises: health reporting must not break the serving path."""
        sup = self.health
        if sup is not None:
            try:
                sup.record_error(int(shard), exc)
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                pass

    def _shed(self, msg: str, reason: dict) -> BackpressureError:
        with self._bp_lock:
            self.backpressure_events += 1
        return BackpressureError(msg, reason=reason)

    def _bp_backoff(self, attempt: int) -> None:
        """Exponential backoff + jitter between submit retries."""
        fl = self.flow
        with self._bp_lock:
            self.backpressure_retries += 1
        delay = min(fl.backoff_max_s, fl.backoff_base_s * (2 ** attempt))
        time.sleep(delay * (1.0 + fl.jitter * random.random()))

    def _acquire_windows(self, shards) -> list:
        """Take one in-flight window slot per distinct target shard; on
        timeout release what was taken and shed typed backpressure.
        Returns the semaphore OBJECTS, not shard indices — a reshard may
        remap ``_windows`` while this round is in flight, and the release
        must hit the semaphores actually acquired."""
        taken: list = []
        for s in shards:
            win = self._windows[s]
            if win is None:
                continue
            if not win.acquire(timeout=self.flow.window_timeout_s):
                for t in taken:
                    t.release()
                raise self._shed(
                    f"shard {s} in-flight window full "
                    f"(limit {self.flow.max_inflight_per_shard}, waited "
                    f"{self.flow.window_timeout_s}s)",
                    {"source": "inflight_window", "shard": int(s),
                     "limit": self.flow.max_inflight_per_shard})
            taken.append(win)
        return taken

    def _release_windows(self, taken) -> None:
        for win in taken:
            win.release()

    def _submit_round(self, items: list) -> list:
        """One concurrent metadata round: submit ``(shard, method,
        kwargs)`` to every listed endpoint, then await all completions.

        A ``QueueFullError`` part-way through the submits must not abort
        the round half-issued: the handles already written are reaped
        (their completions consumed), then the FULL shard set is retried
        after exponential backoff — bounded by ``flow.submit_retries``,
        after which it sheds as typed ``BackpressureError``.  A shard
        that fails mid-round is reported to the supervisor and the
        remaining completions are reaped before the error propagates."""
        for attempt in range(self.flow.submit_retries + 1):
            handles: list = []
            try:
                for s, method, kw in items:
                    handles.append(
                        (s, self.endpoints[s].call_submit(method, **kw)))
            except QueueFullError as e:
                self._reap_call_handles(handles)
                if attempt >= self.flow.submit_retries:
                    raise self._shed(
                        f"submit round over {len(items)} shards still "
                        f"queue-full after {attempt + 1} attempts: {e}",
                        {"source": "queue_full", "shard": int(items[len(handles)][0]),
                         "attempts": attempt + 1, "qid": e.qid}) from e
                self._bp_backoff(attempt)
                continue
            except Exception as e:
                self._reap_call_handles(handles)
                if isinstance(e, DeviceFailedError):
                    self._notify_shard_error(items[len(handles)][0], e)
                raise
            outs: list = []
            try:
                for s, h in handles:
                    outs.append(self.endpoints[s].call_result(h))
            except Exception as e:
                self._reap_call_handles(handles[len(outs) + 1:])
                if isinstance(e, DeviceFailedError):
                    self._notify_shard_error(handles[len(outs)][0], e)
                raise
            return outs
        raise AssertionError("unreachable")

    def _reap_call_handles(self, handles) -> None:
        """Consume outstanding ``call_submit`` completions (best-effort)
        so abandoned replies never sit in the CQs forever."""
        for s, h in handles:
            try:
                self.endpoints[s].call_result(h)
            except Exception:  # noqa: BLE001 — best-effort reap
                pass

    def probe_shards(self) -> list[dict]:
        """Supervisor heartbeat: one concurrent ``counters`` round over
        EVERY endpoint (failed devices answer too — stats attributes stay
        readable after ``fail()``), independent of the gossip cache.
        Per-shard dicts carry ``failed`` + queue pressure; an endpoint
        whose probe itself errors reports ``{"error": ...}`` instead of
        taking the array down."""
        handles: list = []
        for s, ep in enumerate(self.endpoints):
            try:
                handles.append((s, ep.call_submit("counters"), None))
            except Exception as e:  # noqa: BLE001 — probe must not throw
                handles.append((s, None, e))
        out: list[dict] = []
        for s, h, err in handles:
            if err is None:
                try:
                    c = dict(self.endpoints[s].call_result(h))
                    c["shard"] = s
                    out.append(c)
                    continue
                except Exception as e:  # noqa: BLE001
                    err = e
            out.append({"shard": s, "error": f"{type(err).__name__}: {err}"})
        return out

    def _endpoint_fetch(self, reqs, *, pay: bool = True):
        """fetch phase: ONE batched ``fetch`` command per shard, submitted
        to every endpoint, then awaited together.

        Each shard's simulated flash + command time is deferred
        device-side and ships back as ``io_us``; the array pays one wait
        equal to the slowest shard — the devices execute their queued
        commands concurrently, mirroring how the flash channels inside
        one device are modelled (divide, don't sum).  ``reqs`` is a list
        of ``(shard, fetch-kwargs)``; returns (payloads, worst_io_us).

        Flow control wraps the round end to end: one in-flight window
        slot per target shard bounds how many rounds can stack onto one
        shard host, and a ``QueueFullError`` part-way through the
        submits reaps what was issued and retries the round with
        backoff before shedding as typed ``BackpressureError``.
        """
        slots = self._acquire_windows([s for s, _ in reqs])
        try:
            handles = self._submit_fetches(reqs)
            outs, worst = self._await_fetches(handles)
        finally:
            self._release_windows(slots)
        if pay:
            with self._bp_lock:
                self.io_wait_us += worst
            sleep_us(worst)
        return outs, worst

    def _submit_fetches(self, reqs) -> list:
        for attempt in range(self.flow.submit_retries + 1):
            handles: list = []
            try:
                for s, kw in reqs:
                    handles.append((s, self.endpoints[s].fetch_submit(**kw)))
                return handles
            except QueueFullError as e:
                self._reap_fetch_handles(handles)
                if attempt >= self.flow.submit_retries:
                    raise self._shed(
                        f"batched fetch still queue-full after "
                        f"{attempt + 1} attempts: {e}",
                        {"source": "queue_full",
                         "shard": int(reqs[len(handles)][0]),
                         "attempts": attempt + 1, "qid": e.qid}) from e
                self._bp_backoff(attempt)
            except Exception as e:
                # a local endpoint computes at submit time, so a drained
                # device surfaces HERE rather than at await
                self._reap_fetch_handles(handles)
                if isinstance(e, DeviceFailedError):
                    self._notify_shard_error(reqs[len(handles)][0], e)
                raise
        raise AssertionError("unreachable")

    def _await_fetches(self, handles):
        outs, worst = [], 0.0
        try:
            for s, h in handles:
                payload = self.endpoints[s].fetch_result(h)
                worst = max(worst, float(payload["io_us"]))
                outs.append(payload)
        except BaseException as e:
            # a shard failed mid-await (drain path): reap every
            # outstanding completion before re-raising, or their reply
            # payloads sit in the CQs forever — each failover retry would
            # leak the healthy shards' full page blocks.  The handle
            # whose await raised is already consumed.
            self._reap_fetch_handles(handles[len(outs) + 1:])
            if isinstance(e, DeviceFailedError):
                self._notify_shard_error(handles[len(outs)][0], e)
            raise
        return outs, worst

    def _reap_fetch_handles(self, handles) -> None:
        for s, h in handles:
            try:
                self.endpoints[s].fetch_result(h)
            except Exception:  # noqa: BLE001 — best-effort reap
                pass

    def _fan_fetch(self, vids_arr: np.ndarray):
        """plan -> per-shard fetch -> build: the shared front half of the
        batched queries (see module docstring).  Returns a global
        (block, desc) position-identical to a single device's
        ``_fetch_plan`` over the same vids.
        """
        with self._read_routing() as rt:
            parts = self._partition(vids_arr, rt)

            # fetch: ONE batched command per shard, all shards concurrent
            payloads, _ = self._endpoint_fetch(
                [(s, {"l_vids": vids_arr[pos]}) for s, pos in parts])

        # build: re-base each shard's descriptor rows into the concatenated
        # block and scatter them back to their global positions
        desc: list = [None] * len(vids_arr)
        blocks = []
        row_off = 0
        for (s, pos), pl in zip(parts, payloads):
            blk, dsc = pl["block"], pl["desc"]
            for p, d in zip(pos.tolist(), dsc):
                if d is None:
                    continue
                if d[0] == "L":
                    desc[p] = ("L", d[1] + row_off, d[2], d[3])
                else:
                    desc[p] = ("H", d[1] + row_off, d[2])
            if blk is not None:
                blocks.append(blk)
                row_off += blk.shape[0]
        if not blocks:
            return None, desc
        # single contributing shard: its block is already global
        block = blocks[0] if len(blocks) == 1 else np.concatenate(blocks)
        return block, desc

    def get_neighbors(self, vid: int) -> np.ndarray:
        """Neighbor list of one vid from its owning shard."""
        with self._read_routing() as rt:
            c = int(vid) % rt.pmap.n_classes
            ep = self.endpoints[int(rt.pmap.owner[c, 0])]
            return ep.call("get_neighbors", vid=int(vid))

    def get_neighbors_batch(self, vids) -> list[np.ndarray]:
        """Batched neighbor read: one fetch command per shard, results
        recomposed in input order (bit-identical to the single-device
        store)."""
        vids_arr = np.asarray(vids, dtype=np.int64).reshape(-1)
        block, desc = self._fan_fetch(vids_arr)
        return neighbors_from_plan(vids_arr, block, desc)

    def sample_neighbors_batch(self, vids, fanout: int,
                               rng: np.random.Generator | None = None, *,
                               segments=None, rngs=None):
        """Fused fetch+subsample across the array — one batched command per
        shard per hop, then the single-device selection over the recomposed
        plan (rng consumed in global frontier order: bit-identical)."""
        vids_arr = np.asarray(vids, dtype=np.int64).reshape(-1)
        block, desc = self._fan_fetch(vids_arr)
        return select_from_plan(vids_arr, block, desc, fanout, rng,
                                segments=segments, rngs=rngs)

    # ----------------------------------------------------------- embeddings
    def get_embed(self, vid: int) -> np.ndarray:
        """One embedding row from the vid's owning shard."""
        with self._read_routing() as rt:
            s, row = self._emb_locate(vid, rt)[0]
            return self.endpoints[s].call("get_embed_row", row=row)

    def get_embeds(self, vids: np.ndarray) -> np.ndarray:
        """Coalesced gather across the array: each shard serves its owned
        rows (local row from the routing extents; ``vid // N`` at the
        default map) with ONE batched command, concurrently; rows
        scatter back to their query positions."""
        d = self.feature_dim
        if not d:
            raise KeyError("no embedding table loaded")
        vids = np.asarray(vids, dtype=np.int64).reshape(-1)
        out = np.empty((len(vids), d), dtype=np.float32)
        if not len(vids):
            return out
        with self._read_routing() as rt:
            cls = vids % rt.pmap.n_classes
            parts = self._partition(vids, rt)
            reqs = []
            for s, pos in parts:
                c = cls[pos]
                reqs.append((s, {"emb_rows": rt.ew_base[c, 0]
                                 + vids[pos] // rt.ew_mod[c, 0]}))
            payloads, _ = self._endpoint_fetch(reqs)
        for (s, pos), pl in zip(parts, payloads):
            out[pos] = pl["emb"]
        return out

    def update_embed(self, vid: int, embed: np.ndarray) -> None:
        """Overwrite one embedding row on the vid's owner (all live
        replicas when replicated)."""
        with self._write_gate((vid,)):
            for s, row in self._emb_locate(vid):
                self.endpoints[s].call("update_embed_row", row=row,
                                       embed=embed)

    # ------------------------------------------------------------- unit ops
    def add_vertex(self, vid: int, embed: np.ndarray | None = None) -> None:
        """Insert an isolated vertex (idempotent), optionally with its
        embedding row."""
        with self._write_gate((vid,)):
            vid = int(vid)
            ep = self._owner_ep(vid)
            ep.call("add_vertex", vid=vid)       # adjacency under global vid
            self._num_vertices = max(self._num_vertices, vid + 1)
            if embed is not None:
                for s, row in self._emb_locate(vid):
                    self.endpoints[s].call("update_embed_row", row=row,
                                           embed=embed)

    def add_edge(self, dst: int, src: int) -> None:
        """Undirected insert: each endpoint's chunk updates on ITS owning
        shard (two independent single-page RMWs, possibly on different
        devices)."""
        with self._write_gate((dst, src)):
            dst, src = int(dst), int(src)
            for v in (dst, src):
                # device-side add_vertex no-ops when the vid exists
                self._owner_ep(v).call("add_vertex", vid=v)
                self._num_vertices = max(self._num_vertices, v + 1)
            self._owner_ep(dst).call("insert_neighbor", vid=dst, nbr=src,
                                     count=True)
            if dst != src:
                self._owner_ep(src).call("insert_neighbor", vid=src,
                                         nbr=dst, count=False)

    def delete_edge(self, dst: int, src: int) -> None:
        """Undirected removal of edge (dst, src) from both owners."""
        with self._write_gate((dst, src)):
            dst, src = int(dst), int(src)
            self._owner_ep(dst).call("remove_neighbor", vid=dst, nbr=src,
                                     count=True)
            if dst != src:
                self._owner_ep(src).call("remove_neighbor", vid=src,
                                         nbr=dst, count=False)

    def delete_vertex(self, vid: int) -> None:
        """Remove ``vid`` everywhere: backlinks on each neighbor's owning
        shard first, then the owner drops the vertex's own pages.  The
        neighbor set (and so the touched class set) is unknown up front,
        so the gate waits out ANY in-flight class migration."""
        with self._write_gate():
            vid = int(vid)
            nbrs = self._owner_ep(vid).call("get_neighbors", vid=vid)
            for nbr in np.asarray(nbrs).tolist():
                nbr = int(nbr)
                if nbr == vid:
                    continue
                self._owner_ep(nbr).call("remove_neighbor", vid=nbr,
                                         nbr=vid, count=False)
            self._owner_ep(vid).call("drop_vertex_pages", vid=vid,
                                     count=True)

    # --------------------------------------------------------------- export
    def to_adjacency(self) -> dict[int, set[int]]:
        """Full adjacency as ``{vid: neighbor set}`` (test/verification
        helper — walks every shard)."""
        out: dict[int, set[int]] = {}
        for ep in self.endpoints:
            for v, nb in ep.call("export_adjacency"):
                out[int(v)] = set(np.asarray(nb).tolist())
        return out

    # ------------------------------------------------------ online reshard
    def placement_stats(self) -> dict:
        """Routing/placement telemetry: class count, routing epoch,
        whether the map is still the legacy modular layout, per-shard
        owned-class counts, live-migration state, accumulated read heat
        and the last reshard's report."""
        rt = self._routing
        with self._mutate:
            migrating = sorted(self._mig_classes)
        with self._bp_lock:
            resharding = self._resharding
            last = dict(self._reshard_stats)
        return {
            "n_classes": int(rt.pmap.n_classes),
            "replication": int(self.replication),
            "epoch": int(rt.epoch),
            "modular": bool(rt.pmap.is_modular(self.n_shards)),
            "classes_per_shard": [len(rt.pmap.classes_of(s))
                                  for s in range(self.n_shards)],
            "resharding": resharding,
            "migrating_classes": migrating,
            "heat_total": float(rt.heat.sum()),
            "last_reshard": last,
        }

    def _live_sources(self, c: int, dst: int) -> list[int]:
        """Live shards holding class ``c`` under the CURRENT routing,
        excluding ``dst`` — the candidate copy sources, primary first."""
        row = self._routing.pmap.owner[c]
        out = []
        for s in (int(x) for x in row):
            if s != dst and not self._failed[s] and s not in out:
                out.append(s)
        if not out:
            raise DeviceFailedError(
                f"no live source holds vertex class {c}")
        return out

    def _migrate_copy(self, m, C: int, chunk_pages: int, pace_s: float,
                      on_progress, acc: dict) -> tuple[int, int]:
        """Stream one copy move: the destination pulls class ``m.cls``'s
        adjacency chunks and embedding rows from a live source over the
        peer links (page data never transits the coordinator).  Returns
        the (ew_base, ew_mod) extent the class gets on ``m.dst`` at flip
        time.  Fails over to another live replica of the class if the
        source dies mid-stream (chunk pulls are replace-safe, so a
        partially-pulled range is simply re-pulled)."""
        c, dst = int(m.cls), int(m.dst)
        dep = self.endpoints[dst]
        srcs = self._live_sources(c, dst)
        if int(m.src) in srcs:       # plan's source first
            srcs.remove(int(m.src))
            srcs.insert(0, int(m.src))

        # ---- adjacency: cursor loop over bounded page chunks
        cursor, done, last_err = 0, False, None
        for src in srcs:
            try:
                while not done:
                    out = dep.call("migrate_pull", cls=c, modulus=C,
                                   src=src, start_vid=cursor,
                                   max_pages=chunk_pages)
                    cursor, done = int(out["next_vid"]), bool(out["done"])
                    acc["chunks"] += 1
                    acc["pages_shipped"] += int(out["pages"])
                    acc["adj_bytes"] += int(out["bytes"])
                    acc["bytes_shipped"] += int(out["bytes"])
                    if on_progress is not None:
                        on_progress({"event": "chunk", "cls": c,
                                     "src": src, "dst": dst,
                                     "next_vid": cursor, "done": done,
                                     "bytes": int(out["bytes"])})
                    if pace_s:
                        time.sleep(pace_s)
                break
            except DeviceFailedError as e:
                self._notify_shard_error(src, e)
                last_err = e
        else:
            raise last_err

        # ---- embeddings: reserve a dense region on dst, pull row chunks
        base = 0
        rows = rows_of_class(self._emb_rows, c, C)
        if rows and self._feature_dim:
            base = int(dep.call("emb_reserve_rows", n_rows=rows)["base"])
            d = max(1, self._feature_dim)
            take = max(1, (chunk_pages * SLOTS_PER_PAGE) // d)
            rt = self._routing
            row0, last_err = 0, None
            while row0 < rows:
                n = min(take, rows - row0)
                for src in self._live_sources(c, dst):
                    r2 = [r for r in range(rt.pmap.owner.shape[1])
                          if int(rt.pmap.owner[c, r]) == src][0]
                    try:
                        out = dep.call(
                            "migrate_pull_emb", src=src, cls=c, modulus=C,
                            src_base=int(rt.ew_base[c, r2]),
                            src_mod=int(rt.ew_mod[c, r2]),
                            row0=row0, take=n, dst_row0=base + row0)
                        acc["emb_bytes"] += int(out["bytes"])
                        acc["bytes_shipped"] += int(out["bytes"])
                        acc["chunks"] += 1
                        break
                    except DeviceFailedError as e:
                        self._notify_shard_error(src, e)
                        last_err = e
                else:
                    raise last_err
                row0 += n
                if on_progress is not None:
                    on_progress({"event": "emb_chunk", "cls": c,
                                 "dst": dst, "rows_done": row0,
                                 "rows": rows})
                if pace_s:
                    time.sleep(pace_s)
        return base, C

    def reshard(self, *, add: list | None = None,
                remove: list | None = None,
                placement: PlacementMap | None = None,
                rebalance: bool = False, refine: int = 4,
                chunk_pages: int | None = None, pace_s: float = 0.0,
                on_progress=None) -> dict:
        """Elastic online reshard: change the array's shard set or its
        placement map under live traffic, with zero downtime.

        Exactly one mode:

        Args:
            add: new ``ShardEndpoint`` list to grow onto (attached
                immediately; the planner steals the hottest classes from
                the most-loaded existing shards).
            remove: shard indices to drain and detach (their classes
                move to the least-loaded survivors; indices compact when
                the last class flips).
            placement: explicit target :class:`PlacementMap` (same
                replication; refined to a common class count with the
                current map).
            rebalance: True = heat-weighted rebalance over the current
                shards using the accumulated read-heat histogram.
            refine: class-split factor for ``rebalance`` (finer classes
                let one hot class spread over several shards).
            chunk_pages: page budget per shard-to-shard chunk pull
                (defaults to ``rebuild_chunk_pages``, or 512).
            pace_s: sleep between chunk pulls so migration traffic
                trickles under serving reads (supervisor-style pacing).
            on_progress: optional callback receiving ``{"event":
                "chunk" | "emb_chunk" | "flip", ...}`` dicts — called
                OUTSIDE all coordinator locks, so probes may issue reads
                (the bit-identity-at-every-chunk-boundary hook).

        The protocol per migrating class: mark the class write-gated →
        destination pulls its pages/rows from a live owner over the peer
        links → the routing epoch flips the class to its new owners
        atomically under the mutation lock → in-flight reads planned
        against the old routing drain behind the read barrier → vacated
        shards free the class's pages.  Batched reads route to the OLD
        owner until the flip, so every read before, during, and after a
        chunk boundary stays bit-identical.

        Returns a report dict: ``classes_moved``, ``copies``,
        ``relabels``, ``pages_shipped``, ``bytes_shipped`` (split into
        ``adj_bytes``/``emb_bytes``), ``chunks``, ``epochs``,
        ``n_shards``, ``seconds``; or ``{"reshard_in_progress": True}``
        / ``{"reshard_rejected": ...}`` when it cannot start.

        Raises:
            ValueError: not exactly one mode, or an invalid target map.
            DeviceFailedError: a shard is failed at start, or a class
                loses its last live source mid-copy.
        """
        modes = sum([add is not None, remove is not None,
                     placement is not None, bool(rebalance)])
        if modes != 1:
            raise ValueError("reshard takes exactly one of add=, "
                             "remove=, placement=, rebalance=True")
        # ---- claim: brief maintenance hold serialises against bulk
        # ingest and any in-flight rebuild stream; from here on both
        # reject with reshard_in_progress until we clear the flag
        with self._maintenance:
            with self._bp_lock:
                if self._resharding:
                    return {"reshard_in_progress": True}
                if self._rebuilding:
                    return {"reshard_rejected": "rebuild_in_progress"}
                self._resharding = True
        t0 = time.perf_counter()
        try:
            return self._run_reshard(add, remove, placement, rebalance,
                                     refine, chunk_pages, pace_s,
                                     on_progress, t0)
        finally:
            with self._mutate:
                self._mig_classes.clear()
                self._mig_cv.notify_all()
            with self._bp_lock:
                self._resharding = False

    def _run_reshard(self, add, remove, placement, rebalance, refine,
                     chunk_pages, pace_s, on_progress, t0) -> dict:
        if any(self._failed):
            raise DeviceFailedError(
                "reshard needs every shard live at start; rebuild first")
        chunk_pages = int(chunk_pages
                          or getattr(self, "rebuild_chunk_pages", 512))
        n_old = self.n_shards
        epoch0 = self._routing.epoch

        # ---- grow: attach the new endpoints before planning, so copy
        # targets are addressable.  endpoints grows BEFORE n_shards so a
        # concurrent probe/gossip thread never indexes past the list.
        if add is not None:
            new_eps = list(add)
            if not new_eps:
                raise ValueError("add= needs at least one endpoint")
            with self._mutate:
                self.endpoints = self.endpoints + new_eps
                self.n_shards = len(self.endpoints)
                self._failed = self._failed + [False] * len(new_eps)
                self._windows = self._windows + [
                    threading.BoundedSemaphore(
                        self.flow.max_inflight_per_shard)
                    if self.flow.max_inflight_per_shard > 0 else None
                    for _ in new_eps]
            for ep in self.endpoints:
                ep.set_peers(self.endpoints)
                ep._peers_wired = True
            self._topology_changed()

        # ---- target map (planners refine internally as needed), then
        # refine the live routing to the common class count — a
        # metadata-only change: tiled extents keep every vid's row
        rt0 = self._routing
        cur = rt0.pmap
        heat = rt0.heat.copy()
        removed: list[int] = []
        if add is not None:
            target = grow_plan(cur, n_old, self.n_shards, heat)
        elif remove is not None:
            removed = sorted(set(int(s) for s in remove))
            if not removed:
                raise ValueError("remove= needs at least one shard")
            if any(not 0 <= s < self.n_shards for s in removed):
                raise ValueError(f"remove={removed} out of range")
            if len(removed) >= self.n_shards:
                raise ValueError("cannot remove every shard")
            target = shrink_plan(cur, removed, self.n_shards, heat)
        elif rebalance:
            live = [s for s in range(self.n_shards)
                    if not self._failed[s]]
            target = heat_plan(cur, heat, live, refine=max(1, int(refine)))
        else:
            if placement.replication != self.replication:
                raise ValueError(
                    f"target map has {placement.replication} roles, "
                    f"store replication is {self.replication}")
            placement.validate(self.n_shards)
            target = placement
        cur_f, target = common_refine(cur, target)
        C = cur_f.n_classes
        k = C // cur.n_classes
        if k > 1:
            with self._mutate:
                rt = self._routing
                self._swap_routing(_Routing(
                    cur_f, np.tile(rt.ew_mod, (k, 1)),
                    np.tile(rt.ew_base, (k, 1)), rt.epoch + 1,
                    np.tile(rt.heat / k, k)))

        moves, drops = plan_moves(cur_f, target)
        by_class: dict[int, list] = {}
        for m in moves:
            by_class.setdefault(int(m.cls), []).append(m)
        drops_of_class: dict[int, list[int]] = {}
        for s, cls_list in drops.items():
            for c in cls_list:
                drops_of_class.setdefault(int(c), []).append(int(s))

        acc = {"classes_moved": len(by_class), "copies": 0, "relabels": 0,
               "pages_shipped": 0, "bytes_shipped": 0, "adj_bytes": 0,
               "emb_bytes": 0, "chunks": 0}

        # ---- per class: gate writes -> copy -> flip -> drain -> drop
        for c in sorted(by_class):
            cls_moves = by_class[c]
            # taking _mutate here also waits out any write already past
            # its gate — writes hold _mutate for their whole fan-out
            with self._mutate:
                self._mig_classes.add(c)
            try:
                flip_ext: dict[int, tuple[int, int]] = {}
                for m in cls_moves:
                    if m.kind == "copy":
                        acc["copies"] += 1
                        flip_ext[m.role] = self._migrate_copy(
                            m, C, chunk_pages, pace_s, on_progress, acc)
                    else:
                        acc["relabels"] += 1
                # ---- the flip: one atomic routing swap moves every
                # changed role of this class to its new owner
                with self._mutate:
                    rt = self._routing
                    owner = rt.pmap.owner.copy()
                    nb, nm = rt.ew_base.copy(), rt.ew_mod.copy()
                    for m in cls_moves:
                        owner[c, m.role] = m.dst
                        if m.kind == "copy":
                            nb[c, m.role], nm[c, m.role] = flip_ext[m.role]
                        else:
                            nb[c, m.role] = rt.ew_base[c, m.src_role]
                            nm[c, m.role] = rt.ew_mod[c, m.src_role]
                    self._swap_routing(_Routing(
                        PlacementMap(C, owner), nm, nb,
                        rt.epoch + 1, rt.heat))
                    self._mig_classes.discard(c)
                    self._mig_cv.notify_all()
            except BaseException:
                with self._mutate:
                    self._mig_classes.discard(c)
                    self._mig_cv.notify_all()
                raise
            # drain reads planned against the pre-flip routing before
            # the vacated owners free the class's pages
            with self._quiesce_reads():
                pass
            for s in drops_of_class.get(c, ()):
                if not self._failed[s]:
                    try:
                        self.endpoints[s].call("drop_class", cls=c,
                                               modulus=C)
                    except Exception:  # noqa: BLE001 — frees are advisory
                        pass
            if on_progress is not None:
                on_progress({"event": "flip", "cls": c,
                             "epoch": self._routing.epoch})

        # ---- shrink finalise: drained shards detach, indices compact
        if removed:
            keep = [s for s in range(self.n_shards) if s not in removed]
            lut = np.full(self.n_shards, -1, dtype=np.int64)
            lut[keep] = np.arange(len(keep))
            with self._quiesce_reads():
                with self._mutate:
                    rt = self._routing
                    pm = PlacementMap(C, lut[rt.pmap.owner])
                    old_eps = self.endpoints
                    # n_shards shrinks BEFORE endpoints so concurrent
                    # iterators never index past the shorter list
                    self.n_shards = len(keep)
                    self.endpoints = [old_eps[s] for s in keep]
                    self._failed = [self._failed[s] for s in keep]
                    self._windows = [self._windows[s] for s in keep]
                    self._swap_routing(_Routing(
                        pm, rt.ew_mod, rt.ew_base, rt.epoch + 1, rt.heat))
            for ep in self.endpoints:
                ep.set_peers(self.endpoints)
                ep._peers_wired = True
            for s in removed:
                try:
                    old_eps[s].close()
                except Exception:  # noqa: BLE001 — detach is best-effort
                    pass
            self._topology_changed()

        acc["epochs"] = self._routing.epoch - epoch0
        acc["n_shards"] = self.n_shards
        acc["seconds"] = time.perf_counter() - t0
        with self._bp_lock:
            self._reshard_stats = dict(acc)
        return acc

    def _topology_changed(self) -> None:
        """Post-attach/detach hook: resize the supervisor's per-shard
        state and reset the replicated gossip feedback (both no-ops on
        the base store without them)."""
        sup = self.health
        if sup is not None and hasattr(sup, "resize"):
            try:
                sup.resize(self.n_shards)
            except Exception:  # noqa: BLE001 — telemetry best-effort
                pass
        if hasattr(self, "_reset_feedback"):
            self._reset_feedback()


class ReplicatedGraphStore(ShardedGraphStore):
    """R-way replicated CSSD array: the sharded store with redundancy,
    skewed-read load-spreading, and a failed-shard drain/rebuild path.

    Placement: replica ``r`` of vertex ``vid`` lives on shard
    ``(vid + r) % N`` — for both its adjacency pages (keyed by global vid,
    as in the base store) and its embedding row.  Shard ``s`` therefore
    holds the R residue classes ``{(s - r) % N}``; its embedding table is
    the concatenation of R round-robin stripes (role ``r`` stripe = class
    ``(s - r) % N``, local row ``stripe_off[s, r] + vid // N``), so the
    shard-local page math stays the single-device math per stripe.

    Reads: the plan stage runs a vectorized *replica-selection* pass over
    every page fetch of the request — H chains at PAGE granularity
    (replicas keep layout-identical chains, so page i can come from any
    live owner), L vids weighted by their shared page cost, embedding
    rows grouped by stripe page — assigned by an exact min-max solver
    (level binary-search + max-flow over the classes->candidates graph,
    ``_minmax_quotas``) on top of a GOSSIPED view of the shards' read
    counters: the coordinator pulls each endpoint's page-read counter at
    most every ``stats_staleness_s`` seconds (0 = every selection) and
    plans against that snapshot, so the feedback loop never reads shard
    state synchronously — the multi-host requirement.  The loop stays
    closed (estimation bias cannot accumulate, just bounded-staleness
    delayed), and since every replica holds identical data and the
    recomposed plan is position-identical to the single-device plan, the
    spread changes WHICH device pays each page, never the result: an
    R-replicated sample stays **bit-identical** to the 1-device store
    under the same seed.  The deferred-latency array cost is ``max`` over
    shards, so flattening the per-shard page distribution is a direct
    latency win on skewed mixes (fig24: balance 0.36 -> 1.00,
    batched-read IO ~1.4x at R=2).

    Writes fan out to every live replica under the coordinator mutation
    lock (each device's ``on_write`` hook invalidates its own page cache);
    a replica that fails mid-fan-out is skipped — its state died with the
    device and ``rebuild_shard`` re-materialises it from a survivor.

    Fault path: ``fail_shard(s)`` drops the device (every later command
    raises ``DeviceFailedError``) after checking each of its classes keeps
    a live replica; in-flight fetches that already planned onto the dying
    shard re-plan against survivors (``_with_failover``).  Degraded reads
    are served — bit-identically — by the surviving replicas.
    ``rebuild_shard(s)`` re-materialises the lost partition onto a fresh
    device by **shard-to-shard chunked streaming**: the coordinator sends
    the destination endpoint a pure-metadata plan, and the destination
    pulls bounded page chunks from each class's surviving endpoint over
    the peer links (batched L export re-laid through the bulk packing, H
    chains cloned page-exactly — preserving the cross-replica chain
    layout the page spread relies on — embedding stripes gathered from
    each class's survivor).  Survivor pages never transit the
    coordinator; restoring R-way redundancy costs the coordinator one
    RPC.
    """

    # base __init__ must not install a 1-role routing the replicated
    # store immediately replaces — it defers to our own _init_routing
    _init_routing_deferred = True

    def __init__(self, n_shards: int | None = None, devs: list | None = None,
                 *, endpoints: list | None = None, replication: int = 2,
                 h_threshold: int = 128, feature_dim: int = 0,
                 placement: PlacementMap | None = None,
                 stats_staleness_s: float = 0.0,
                 rebuild_chunk_pages: int = 512,
                 flow: FlowControl | None = None):
        """Same backing forms as :class:`ShardedGraphStore`, plus:

        Args:
            replication: replica count R (1 <= R <= N); every vertex
                class keeps R copies, one per role column.
            placement: optional R-role :class:`PlacementMap` replacing
                the default ``(c + r) % N`` replica ring.
            stats_staleness_s: max age of the gossiped read-counter
                snapshot replica selection plans against (0 = refresh
                every selection).
            rebuild_chunk_pages: page budget per shard-to-shard chunk
                pull during rebuild and reshard streams.

        Raises:
            ValueError: replication out of range, or a placement map
                whose role count differs from ``replication``.
        """
        super().__init__(n_shards, devs, endpoints=endpoints,
                         h_threshold=h_threshold, feature_dim=feature_dim,
                         flow=flow)
        r = int(replication)
        if not 1 <= r <= self.n_shards:
            raise ValueError(f"replication={r} needs 1 <= R <= "
                             f"n_shards={self.n_shards}")
        self.replication = r
        self._emb_rows = 0
        self._init_routing(r, placement)
        # gossiped selection feedback: every selection starts from a
        # staleness-bounded snapshot of the shards' ACTUAL page-read
        # counters since the last topology change (periodic ``counters``
        # pulls — never a synchronous shard peek).  Cache hits never
        # reach the device counter, so cached reads correctly stop
        # counting as device load.
        self.stats_staleness_s = float(stats_staleness_s)
        self.rebuild_chunk_pages = int(rebuild_chunk_pages)
        self.gossip_pulls = 0                      # guarded-by: _gossip_lock
        self._gossip_lock = witness_lock(
            "sharded._gossip_lock", threading.Lock())
        self._gossip_reads = np.zeros(self.n_shards)   # guarded-by: _gossip_lock
        self._gossip_depth = np.zeros(self.n_shards)   # guarded-by: _gossip_lock
        self._gossip_t = -np.inf                   # guarded-by: _gossip_lock
        self._gossip_inflight = False              # guarded-by: _gossip_lock
        self._read_base = np.zeros(0)              # guarded-by: _gossip_lock
        self._read_base = self._refresh_gossip(force=True).copy()

    # ------------------------------------------------------------- topology
    def replica_shards(self, vid: int) -> list[int]:
        """The shards holding ``vid``'s replicas, role order (primary
        first) — ``[(vid + r) % N]`` at the default modular map."""
        rt = self._routing
        c = int(vid) % rt.pmap.n_classes
        return [int(rt.pmap.owner[c, r]) for r in range(self.replication)]

    def _live_eps(self, vid: int, rt: _Routing | None = None):
        """(shard, role, endpoint) of ``vid``'s live replicas, primary
        first."""
        rt = rt or self._routing
        out = []
        c = int(vid) % rt.pmap.n_classes
        for r in range(self.replication):
            s = int(rt.pmap.owner[c, r])
            if not self._failed[s]:
                out.append((s, r, self.endpoints[s]))
        if not out:
            raise DeviceFailedError(f"no live replica for vertex {vid}")
        return out

    def _survivor_of_class(self, c: int, exclude: int) -> int:
        rt = self._routing
        for r in range(self.replication):
            s = int(rt.pmap.owner[c, r])
            if s != exclude and not self._failed[s]:
                return s
        raise DeviceFailedError(f"no live replica holds vertex class {c}")

    def _meta_shard(self, c: int, rt: _Routing | None = None) -> int:
        """A live replica holding class ``c``'s mapping tables — the
        planning metadata every replica agrees on (same op history)."""
        rt = rt or self._routing
        for r in range(self.replication):
            s = int(rt.pmap.owner[c, r])
            if not self._failed[s]:
                return s
        raise DeviceFailedError(f"no live replica for vertex class {c}")

    # ----------------------------------------------------- embedding layout
    def _rows_of_class(self, c: int) -> int:
        return rows_of_class(self._emb_rows, int(c),
                             self._routing.pmap.n_classes)

    def _check_emb_vid(self, vid: int) -> None:
        """Reject rows beyond the ingested table: in the striped replica
        layout the next local row belongs to ANOTHER role's stripe, so an
        unchecked write would silently corrupt a different vertex's
        replica (the single-device store merely writes past its table)."""
        if not 0 <= int(vid) < self._emb_rows:
            raise KeyError(f"vid {vid} outside the embedding table "
                           f"({self._emb_rows} rows)")

    def update_graph(self, edge_array, embeddings=None, *,
                     already_undirected: bool = False):
        """Bulk UpdateGraph across the replicated array (see the base
        class); every shard writes all R of its owned stripes.

        Raises:
            DeviceFailedError: a shard is failed (rebuild first).
            RuntimeError: an online reshard is migrating classes.
        """
        # behind the maintenance gate: a bulk ingest must not interleave
        # with a streaming rebuild (and a rebuild in progress means a
        # failed flag is still set, which the check below rejects)
        with self._maintenance:
            self._check_not_resharding("bulk ingest")
            if any(self._failed):
                raise DeviceFailedError(
                    "bulk ingest needs every shard live; rebuild_shard first")
            return super().update_graph(edge_array, embeddings,
                                        already_undirected=already_undirected)

    # ----------------------------------------------------- replica selection
    def _refresh_gossip(self, force: bool = False) -> np.ndarray:
        """Pull every endpoint's gossip counters when the cached snapshot
        is older than ``stats_staleness_s`` (or forced).  The only
        coupling between replica selection and shard state is this
        bounded-staleness gossip — fit for shards on other hosts.  One
        concurrent ``counters`` round (``_submit_round``: queue-full
        safe) refreshes both the page-read loads and the per-shard
        command-queue depth the selection penalises."""
        now = time.perf_counter()
        with self._gossip_lock:
            stale = force or (now - self._gossip_t) > self.stats_staleness_s
            if not stale or (self._gossip_inflight and not force):
                # fresh enough, or another thread is already mid-pull:
                # bounded-staleness gossip tolerates the current snapshot
                return self._gossip_reads
            self._gossip_inflight = True
        # the counters round fans out through the shard queues — an RPC
        # must never run under the leaf _gossip_lock, or every reader
        # selecting replicas serializes behind the network
        try:
            outs = self._submit_round(
                [(s, "counters", {}) for s in range(self.n_shards)])
        except BaseException:
            with self._gossip_lock:
                self._gossip_inflight = False
            raise
        with self._gossip_lock:
            self._gossip_inflight = False
            self._gossip_reads = np.array(
                [float(c["read_pages"]) for c in outs])
            self._gossip_depth = np.array(
                [float(c.get("sq_depth", 0)) + float(c.get("inflight", 0))
                 for c in outs])
            self._gossip_t = now
            self.gossip_pulls += 1
            return self._gossip_reads

    def _hist_loads(self) -> np.ndarray:
        """Per-shard starting loads of every selection, in pages: the
        gossiped page-read imbalance since the last topology change, plus
        the flow-control steering penalties — gossiped queue depth (hot
        shard hosts look pre-loaded) and supervisor-suspect status (a
        suspect shard is avoided unless its class has no other live
        candidate; the min-max solver does exactly that)."""
        def _pad(a: np.ndarray, n: int) -> np.ndarray:
            # a reshard may grow n_shards between gossip pulls; a fresh
            # shard starts with zero history until the feedback reset
            return (a if len(a) >= n
                    else np.concatenate([a, np.zeros(n - len(a))]))

        n = self.n_shards
        reads = _pad(self._refresh_gossip(), n)[:n]
        with self._gossip_lock:
            h = reads - _pad(self._read_base, n)[:n]
            depth = _pad(self._gossip_depth, n)[:n].copy()
        h = h - h.min()
        fl = self.flow
        if fl.queue_depth_penalty_pages:
            h = h + depth * fl.queue_depth_penalty_pages
        sup = self.health
        if sup is not None and fl.suspect_penalty_pages:
            for s in sup.suspect_shards():
                if 0 <= s < self.n_shards:
                    h[s] += fl.suspect_penalty_pages
        return h

    def _reset_feedback(self) -> None:
        reads = self._refresh_gossip(force=True)
        with self._gossip_lock:
            self._read_base = reads.copy()

    def _select_replicas(self, vids: np.ndarray, weights=None,
                         key=None) -> np.ndarray:
        """Vectorized plan-stage replica selection.

        Positions group by residue class (every member of a class shares
        the same R candidate shards); the per-class weights are assigned
        to live candidate shards by an exact min-max solver
        (``_minmax_quotas``) on top of the gossiped read-counter
        imbalance.  Within a class, positions stay contiguous in ``key``
        order (ascending vid for adjacency, stripe page for embeddings)
        so page-sharing neighbours land on the same shard, and the split
        points fall at the quota boundaries.

        Pure planning — the returned owner per position only decides which
        device pays the page fetch; replicas hold identical data.
        """
        rt = self._routing
        C, rep = rt.pmap.n_classes, self.replication
        vids = np.asarray(vids, dtype=np.int64).reshape(-1)
        cls = vids % C
        w = (np.ones(len(vids)) if weights is None
             else np.asarray(weights, dtype=np.float64))
        np.add.at(rt.heat, cls, w)
        live = [not f for f in self._failed]
        class_w = np.bincount(cls, weights=w, minlength=C)

        order = (np.argsort(cls, kind="stable") if key is None
                 else np.lexsort((np.asarray(key), cls)))
        sorted_cls = cls[order]
        lo = np.searchsorted(sorted_cls, np.arange(C), side="left")
        hi = np.searchsorted(sorted_cls, np.arange(C), side="right")

        # ---- per-class quotas: exact min-max via level search + max-flow
        occupied = [int(c) for c in range(C) if hi[c] > lo[c]]
        cand_of: dict[int, np.ndarray] = {}
        for c in occupied:
            row = rt.pmap.owner[c]
            cands = np.asarray([int(row[r]) for r in range(rep)
                                if live[int(row[r])]])
            if not len(cands):
                raise DeviceFailedError(
                    f"no live replica for vertex class {c}")
            cand_of[c] = cands
        quota = _minmax_quotas({c: float(class_w[c]) for c in occupied},
                               cand_of, self._hist_loads())

        # ---- split each class's positions at its quota boundaries
        owner = np.empty(len(vids), dtype=np.int64)
        for c in occupied:
            run = order[lo[c]: hi[c]]
            cands = cand_of[c]
            if len(cands) == 1:
                owner[run] = cands[0]
                continue
            cum_w = np.cumsum(w[run])
            cuts = np.searchsorted(cum_w, np.cumsum(quota[c])[:-1] + 1e-9)
            for sdx, seg in zip(cands.tolist(), np.split(run, cuts)):
                if len(seg):
                    owner[seg] = sdx
        return owner

    def _l_share_weights(self, vids: np.ndarray,
                         l_page: np.ndarray) -> np.ndarray:
        """Page cost of each L-vid's fetch, in PAGES: vids resolved to the
        same L page (``plan_info``'s range-table index — packings differ
        across replicas only in companion classes) split that page's
        single fetch between them, so L quotas stay commensurate with
        per-page H quotas."""
        w = np.ones(len(vids))
        cls = vids % self._routing.pmap.n_classes
        for c in np.unique(cls):
            idx = np.nonzero(cls == c)[0]
            pg = l_page[idx]
            if not len(pg) or (pg < 0).all():   # shard holds no L pages
                continue
            _, inv, cnt = np.unique(pg, return_inverse=True,
                                    return_counts=True)
            w[idx] = 1.0 / cnt[inv]
        return w

    def _with_failover(self, fn):
        """Run a read plan, re-planning if a shard fails under it.

        A fetch that already planned onto a shard when ``fail_shard`` hit
        raises ``DeviceFailedError`` from that device (surfaced through
        the endpoint, whatever the transport); the retry re-runs the
        selection, which now excludes it — the drain path of a degraded
        array.  Reads are idempotent, so the retry is safe.
        """
        last = None
        for _ in range(self.n_shards + 1):
            try:
                return fn()
            except DeviceFailedError as e:
                last = e
        raise last

    def _fan_fetch(self, vids_arr: np.ndarray):
        if self.replication == 1:
            return self._with_failover(
                lambda: ShardedGraphStore._fan_fetch(self, vids_arr))
        return self._with_failover(
            lambda: self._fan_fetch_spread(vids_arr))

    def _fan_fetch_spread(self, vids_arr: np.ndarray):
        """plan -> page-granular replica-spread fetch -> build.

        H chains are spread at PAGE granularity: every replica holds a
        layout-identical copy of the chain (same op history; rebuilds
        clone pages exactly), so page i can be served by any live owner —
        an independently assignable unit for the waterfill.  With
        whole-chain atoms a hub's pages would pin to one shard and the
        per-shard max (the array's deferred latency) could never drop
        below the chain length; per-page spread flattens hub-skewed
        fetches to ~total/N.  L vids stay vid-granular, weighted by their
        shared page cost.  The recomposed (block, desc) is
        position-identical to the single-device plan, so selection stays
        bit-identical.
        """
        # plan + fetch under the coordinator mutation lock: one vid's chain
        # pages are read under SEVERAL shards' locks, so a delete landing
        # between them could drop h_chain entries mid-plan (the base store
        # reads each vid inside ONE shard critical section and never had
        # this gap).  The simulated array wait is paid after release, so
        # mutations only ever wait out the (fast) planning math.
        with self._mutate:
            block, desc, worst = self._plan_and_fetch_spread(vids_arr)
        with self._bp_lock:
            self.io_wait_us += worst
        sleep_us(worst)
        return block, desc

    def _plan_and_fetch_spread(self, vids_arr: np.ndarray):
        rt = self._routing       # stable: flips also hold _mutate
        desc: list = [None] * len(vids_arr)
        # ---- planning metadata: ONE plan_info call per occupied vertex
        # class against a live replica (replica-invariant tables) — the
        # coordinator never reads shard mapping state directly
        cls_arr = vids_arr % rt.pmap.n_classes
        chain_len = np.zeros(len(vids_arr), dtype=np.int64)
        l_page = np.full(len(vids_arr), -1, dtype=np.int64)
        idxs, items = [], []
        for c in np.unique(cls_arr).tolist():
            idx = np.nonzero(cls_arr == c)[0]
            idxs.append(idx)
            items.append((self._meta_shard(int(c)), "plan_info",
                          {"vids": vids_arr[idx]}))
        # one concurrent round-trip (queue-full safe: a QueueFullError
        # part-way reaps the submitted handles and retries the full set)
        for idx, info in zip(idxs, self._submit_round(items)):
            chain_len[idx] = np.asarray(info["chain_len"], dtype=np.int64)
            l_page[idx] = np.asarray(info["l_page"], dtype=np.int64)

        uidx: dict[int, int] = {}
        u_vids: list[int] = []
        u_lens: list[int] = []
        pos_of_u: list[list[int]] = []
        l_pos: list[int] = []
        for pos, v in enumerate(vids_arr.tolist()):
            if chain_len[pos] == 0:
                l_pos.append(pos)
            else:
                u = uidx.get(v)
                if u is None:
                    u = uidx[v] = len(u_vids)
                    u_vids.append(v)
                    u_lens.append(int(chain_len[pos]))
                    pos_of_u.append([])
                pos_of_u[u].append(pos)

        # ---- ONE joint selection for the whole fetch: L vids (page-share
        # weighted) and H chain pages (unit weight) compete for the same
        # per-shard budget — planned separately, the hub pages would land
        # on top of an already-balanced L assignment and re-skew the fetch
        l_pos_arr = np.asarray(l_pos, dtype=np.int64)
        l_vids = vids_arr[l_pos_arr]
        item_vid = item_pg = item_row = u_lens_a = None
        sel_vids = [l_vids]
        sel_w = [self._l_share_weights(l_vids, l_page[l_pos_arr])
                 if len(l_vids) else np.empty(0)]
        sel_key = [2 * l_vids]                # even keys: L, by vid
        if u_vids:
            u_vids_a = np.asarray(u_vids, dtype=np.int64)
            u_lens_a = np.asarray(u_lens, dtype=np.int64)
            item_vid = u_vids_a[np.repeat(np.arange(len(u_vids)), u_lens_a)]
            item_pg = _ramp(u_lens_a)
            item_row = np.empty(len(item_vid), dtype=np.int64)
            sel_vids.append(item_vid)
            sel_w.append(np.ones(len(item_vid)))
            # odd keys, chain-contiguous: a vid's pages stay together and
            # split wherever the quotas land — page-granular spread
            sel_key.append(
                2 * (np.max(vids_arr) + 1
                     + np.repeat(np.arange(len(u_vids)), u_lens_a)
                     * (int(u_lens_a.max()) + 1) + item_pg) + 1)
        all_vids = np.concatenate(sel_vids)
        if not len(all_vids):
            return None, desc, 0.0
        owner = self._select_replicas(all_vids,
                                      weights=np.concatenate(sel_w),
                                      key=np.concatenate(sel_key))
        owner_l, owner_h = owner[: len(l_vids)], owner[len(l_vids):]
        parts: dict[int, dict] = {}
        for s in np.unique(owner_l).tolist():
            parts.setdefault(int(s), {})["l"] = np.nonzero(owner_l == s)[0]
        for s in np.unique(owner_h).tolist():
            parts.setdefault(int(s), {})["h"] = np.nonzero(owner_h == s)[0]

        # ---- fetch: ONE batched command per shard (l plan + its share of
        # chain pages together), submitted to all shards, awaited together
        shard_order = sorted(parts)
        reqs = []
        for s in shard_order:
            work = parts[s]
            kw: dict = {}
            if "l" in work:
                kw["l_vids"] = l_vids[work["l"]]
            if "h" in work:
                items = work["h"]
                kw["h_vids"] = item_vid[items]
                kw["h_pgs"] = item_pg[items]
            reqs.append((s, kw))
        payloads, worst = self._endpoint_fetch(reqs, pay=False)

        blocks: list[np.ndarray] = []
        row_off = 0
        for s, pl in zip(shard_order, payloads):
            work = parts[s]
            dsc, blk, hblk = pl["desc"], pl["block"], pl["hblk"]
            if dsc is not None:
                for plx, d in zip(work["l"].tolist(), dsc):
                    if d is None:
                        continue
                    pos = int(l_pos_arr[plx])
                    if d[0] == "L":
                        desc[pos] = ("L", d[1] + row_off, d[2], d[3])
                    else:                     # defensive: kind skew
                        desc[pos] = ("H", d[1] + row_off, d[2])
                if blk is not None:
                    blocks.append(blk)
                    row_off += blk.shape[0]
            if hblk is not None:
                item_row[work["h"]] = row_off + np.arange(len(hblk))
                blocks.append(hblk)
                row_off += hblk.shape[0]
        if not blocks:
            return None, desc, worst
        block = blocks[0] if len(blocks) == 1 else np.concatenate(blocks)
        if u_vids:
            starts = np.concatenate([[0], np.cumsum(u_lens_a)[:-1]])
            for u in range(len(u_vids)):
                rows = item_row[starts[u]: starts[u] + int(u_lens_a[u])]
                d = ("H", rows, block[rows, _H_COUNT].astype(np.int64))
                for pos in pos_of_u[u]:
                    desc[pos] = d
        return block, desc, worst

    # ------------------------------------------------------------ unit reads
    def _unit_call(self, s: int, ep, method: str, **kw):
        """Unit read against one replica, with the shard-attributed error
        reported to the supervisor before failover re-plans it."""
        try:
            return ep.call(method, **kw)
        except DeviceFailedError as e:
            self._notify_shard_error(s, e)
            raise

    def get_neighbors(self, vid: int) -> np.ndarray:
        """Neighbor list of one vid from a live replica, with failover."""
        def read():
            with self._read_routing() as rt:
                s, _r, ep = self._live_eps(vid, rt)[0]
                return self._unit_call(s, ep, "get_neighbors", vid=int(vid))
        return self._with_failover(read)

    def get_embed(self, vid: int) -> np.ndarray:
        """One embedding row from a live replica, with failover.

        Raises:
            KeyError: vid outside the ingested table.
        """
        self._check_emb_vid(vid)

        def read():
            with self._read_routing() as rt:
                s, row = self._emb_locate(vid, rt)[0]
                return self._unit_call(s, self.endpoints[s],
                                       "get_embed_row", row=row)
        return self._with_failover(read)

    def get_embeds(self, vids: np.ndarray) -> np.ndarray:
        """Replica-spread coalesced embedding gather (see class
        docstring); bit-identical rows, load-balanced page fetches.

        Raises:
            KeyError: no table loaded, or a vid outside it.
        """
        d = self.feature_dim
        if not d:
            raise KeyError("no embedding table loaded")
        vids = np.asarray(vids, dtype=np.int64).reshape(-1)
        out = np.empty((len(vids), d), dtype=np.float32)
        if not len(vids):
            return out
        if int(vids.min()) < 0 or int(vids.max()) >= self._emb_rows:
            self._check_emb_vid(int(vids.max()
                                    if vids.max() >= self._emb_rows
                                    else vids.min()))

        def gather():
            with self._read_routing() as rt:
                C = rt.pmap.n_classes
                cls = vids % C
                local = vids // C
                # group by stripe page so rows sharing a 4 KB page are
                # fetched together from ONE replica (no duplicate page
                # fetches); weigh rows in PAGES — page-mates split their
                # page's single fetch — so embedding quotas stay
                # commensurate with adjacency quotas
                page_key = (local * d) // SLOTS_PER_PAGE
                if d >= SLOTS_PER_PAGE:
                    w = np.full(len(vids), d / SLOTS_PER_PAGE)
                else:
                    # page-mates are same-CLASS rows on one stripe page;
                    # rows of different classes sharing a raw page index
                    # live on different shards' stripes and must not pool
                    # their weight
                    ck = cls * (int(page_key.max()) + 1) + page_key
                    _, inv, cnt = np.unique(ck, return_inverse=True,
                                            return_counts=True)
                    w = 1.0 / cnt[inv]
                owner = self._select_replicas(vids, weights=w, key=page_key)
                parts = [(s, np.nonzero(owner == s)[0])
                         for s in range(self.n_shards)]
                parts = [(s, pos) for s, pos in parts if len(pos)]
                reqs = []
                for s, pos in parts:
                    # which role serves each position on shard s
                    role = np.zeros(len(pos), dtype=np.int64)
                    for r in range(self.replication):
                        role[rt.pmap.owner[cls[pos], r] == s] = r
                    rows = rt.ew_base[cls[pos], role] \
                        + vids[pos] // rt.ew_mod[cls[pos], role]
                    reqs.append((s, {"emb_rows": rows}))
                payloads, _ = self._endpoint_fetch(reqs)
            for (s, pos), pl in zip(parts, payloads):
                out[pos] = pl["emb"]
            return out

        return self._with_failover(gather)

    # ----------------------------------------------------- mutation fan-out
    def _fanout(self, eps, fn) -> int:
        """Apply a mutation to every live replica; a replica that fails
        mid-fan-out is skipped (its state died with the device — rebuild
        recovers it from a survivor), so the live replicas never diverge."""
        ok = 0
        for s, r, ep in eps:
            try:
                fn(s, r, ep)
                ok += 1
            except DeviceFailedError as e:
                self._notify_shard_error(s, e)
                continue
        if not ok:
            raise DeviceFailedError("every replica failed mid-write")
        return ok

    def add_vertex(self, vid: int, embed=None) -> None:
        """Insert an isolated vertex on every live replica (idempotent),
        optionally with its embedding row."""
        with self._write_gate((vid,)):
            vid = int(vid)
            self._fanout(self._live_eps(vid),
                         lambda s, r, ep: ep.call("add_vertex", vid=vid))
            self._num_vertices = max(self._num_vertices, vid + 1)
            if embed is not None:
                self.update_embed(vid, embed)

    def update_embed(self, vid: int, embed: np.ndarray) -> None:
        """Overwrite one embedding row on every live replica.

        Raises:
            KeyError: vid outside the ingested table.
        """
        with self._write_gate((vid,)):
            vid = int(vid)
            self._check_emb_vid(vid)
            rt = self._routing
            c = vid % rt.pmap.n_classes

            def write(s, r, ep):
                ep.call("update_embed_row",
                        row=int(rt.ew_base[c, r])
                        + vid // int(rt.ew_mod[c, r]), embed=embed)
            self._fanout(self._live_eps(vid, rt), write)

    def add_edge(self, dst: int, src: int) -> None:
        """Undirected insert, fanned out to every live replica of both
        endpoints' classes."""
        with self._write_gate((dst, src)):
            dst, src = int(dst), int(src)
            for v in (dst, src):
                # device-side add_vertex no-ops when the vid exists
                self._fanout(self._live_eps(v),
                             lambda s, r, ep, v=v: ep.call("add_vertex",
                                                           vid=v))
                self._num_vertices = max(self._num_vertices, v + 1)

            def ins(vid, nbr, count):
                self._fanout(self._live_eps(vid),
                             lambda s, r, ep: ep.call(
                                 "insert_neighbor", vid=vid, nbr=nbr,
                                 count=count))
            ins(dst, src, True)
            if dst != src:
                ins(src, dst, False)

    def delete_edge(self, dst: int, src: int) -> None:
        """Undirected removal, fanned out to every live replica."""
        with self._write_gate((dst, src)):
            dst, src = int(dst), int(src)

            def rm(vid, nbr, count):
                self._fanout(self._live_eps(vid),
                             lambda s, r, ep: ep.call(
                                 "remove_neighbor", vid=vid, nbr=nbr,
                                 count=count))
            rm(dst, src, True)
            if dst != src:
                rm(src, dst, False)

    def delete_vertex(self, vid: int) -> None:
        """Remove ``vid`` and its backlinks on every live replica; the
        touched class set is unknown up front, so the gate waits out any
        in-flight class migration."""
        with self._write_gate():
            vid = int(vid)
            nbrs = self.get_neighbors(vid)
            for nbr in np.asarray(nbrs).tolist():
                nbr = int(nbr)
                if nbr == vid:
                    continue
                self._fanout(self._live_eps(nbr),
                             lambda s, r, ep, nbr=nbr: ep.call(
                                 "remove_neighbor", vid=nbr, nbr=vid,
                                 count=False))
            self._fanout(self._live_eps(vid),
                         lambda s, r, ep: ep.call("drop_vertex_pages",
                                                  vid=vid, count=True))

    # --------------------------------------------------------------- export
    def to_adjacency(self) -> dict[int, set[int]]:
        """Full adjacency export from the LIVE shards (replicas
        deduplicate via the set union) — test/verification helper."""
        out: dict[int, set[int]] = {}
        for s, ep in enumerate(self.endpoints):
            if self._failed[s]:
                continue
            for v, nb in ep.call("export_adjacency"):
                out[int(v)] = set(np.asarray(nb).tolist())
        return out

    # ---------------------------------------------------------- fault path
    def fail_shard(self, shard: int) -> dict:
        """Drop one device out of the array (fault injection / drain).

        Refuses when any vertex class owned by the shard would lose its
        last live replica — that is data loss, not degradation."""
        with self._mutate:
            s = int(shard)
            if not 0 <= s < self.n_shards:
                raise ValueError(f"shard {s} out of range")
            if self._failed[s]:
                return {"shard": s, "already_failed": True}
            rt = self._routing
            rep = self.replication
            owned = rt.pmap.classes_of(s)
            lost = []
            for c in owned:
                if not any(int(rt.pmap.owner[c, r2]) != s
                           and not self._failed[int(rt.pmap.owner[c, r2])]
                           for r2 in range(rep)):
                    lost.append(c)
            if lost:
                raise DeviceFailedError(
                    f"failing shard {s} would lose vertex class(es) "
                    f"{sorted(lost)} (replication={rep})")
            # device dies; its DRAM page cache died with it (endpoint-side)
            self.endpoints[s].call("fail")
            self._failed[s] = True
            self._reset_feedback()        # load history predates the fault
            return {"shard": s, "degraded_classes": sorted(owned)}

    def rebuild_shard(self, shard: int, *,
                      pacing_s: float | None = None) -> dict:
        """Re-materialise a failed shard from survivors — endpoint to
        endpoint.

        The coordinator only ships a pure-metadata plan (which survivor
        holds each owned class, stripe row spans, chunk budget, pacing);
        the destination endpoint pulls bounded page chunks from each
        survivor over the peer links and re-lays them (batched L export
        through the bulk packing — neighbor order is replica-invariant,
        every replica applied the same mutation sequence, and L degrees
        never exceed ``h_threshold`` so no vid is reclassified; H chains
        cloned page-exactly, preserving the cross-replica chain layout
        the page-granular spread fetch relies on; embedding stripes
        gathered from each class's survivor).  The replacement starts
        with a cold (fresh) page cache.

        Serving reads flow THROUGHOUT the stream: the rebuild holds the
        maintenance gate, not the mutation lock, so only mutations (and
        other maintenance) block until re-admission — which is also why
        no replay log is needed: the survivors stay the exact current
        state for the whole stream.  ``pacing_s`` sleeps between chunk
        pulls device-side so recovery traffic trickles onto the
        survivor devices instead of starving serving reads queued
        behind it.

        Idempotent under supervision races: a live shard returns
        ``{"already_live": True}`` and a shard already mid-stream
        returns ``{"rebuild_in_progress": True}`` — the auto-rebuild
        loop and an operator RPC may both fire, and neither must throw.
        """
        s = int(shard)
        if not 0 <= s < self.n_shards:
            raise ValueError(f"shard {s} out of range")
        with self._bp_lock:
            if s in self._rebuilding:
                return {"shard": s, "rebuild_in_progress": True}
            if self._resharding:
                # a reshard owns the peer links and the routing epoch;
                # the supervisor retries after it completes
                return {"shard": s, "rebuild_in_progress": True,
                        "reshard_in_progress": True}
        t0 = time.perf_counter()
        with self._maintenance:
            with self._mutate:
                if not self._failed[s]:
                    return {"shard": s, "already_live": True}
                rt = self._routing
                C = rt.pmap.n_classes
                pairs = rt.pmap.pairs_of(s)
                classes = []
                for c, _r in pairs:
                    src = self._survivor_of_class(c, exclude=s)
                    entry = {"cls": int(c), "src": int(src)}
                    if self._emb_rows and self._feature_dim:
                        r2 = [int(rr) for rr in range(self.replication)
                              if int(rt.pmap.owner[c, rr]) == src][0]
                        entry["src_base"] = int(rt.ew_base[c, r2])
                        entry["src_mod"] = int(rt.ew_mod[c, r2])
                        entry["rows"] = int(rows_of_class(
                            self._emb_rows, c, C))
                    classes.append(entry)
                plan = {"n_shards": C,
                        "num_vertices": int(self._num_vertices),
                        "chunk_pages": self.rebuild_chunk_pages,
                        "pace_s": float(pacing_s or 0.0),
                        "feature_dim": (self._feature_dim
                                        if self._emb_rows else 0),
                        "classes": classes}
            with self._bp_lock:
                self._rebuilding.add(s)
            try:
                # the stream: reads keep serving off the survivors while
                # the destination pulls chunks over the peer links
                info = dict(self.endpoints[s].call("rebuild", plan=plan))
            finally:
                with self._bp_lock:
                    self._rebuilding.discard(s)
            # the replacement laid its stripes canonically dense (one
            # class after another in pairs_of order): update its extents
            # if the pre-fault ones were coarse, BEFORE re-admission, so
            # no reader ever addresses the fresh device with stale math
            with self._mutate:
                rt = self._routing
                nb, nm = rt.ew_base.copy(), rt.ew_mod.copy()
                acc = 0
                for c, r in pairs:
                    nb[c, r] = acc
                    nm[c, r] = C
                    acc += rows_of_class(self._emb_rows, c, C)
                changed = not (np.array_equal(nb, rt.ew_base)
                               and np.array_equal(nm, rt.ew_mod))
                if changed:
                    self._swap_routing(_Routing(rt.pmap, nm, nb,
                                                rt.epoch + 1, rt.heat))
            if changed:
                with self._quiesce_reads():
                    pass
            with self._mutate:
                self._failed[s] = False
                self._reset_feedback()    # fresh topology, fresh history
            info["shard"] = s
            info["seconds"] = time.perf_counter() - t0
            return info
