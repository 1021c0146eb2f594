"""ServingRuntime — the concurrent serving loop of the CSSD: multi-queue
RoP transport + RPC dispatch + continuous-batching scheduler over one
``HolisticGNNService``.

Copy of ``repro/serve/runtime.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

Command routing mirrors the device firmware split:

  * ``run`` commands against a batchable (BatchPre-led) service DFG enter
    the scheduler's admission queue and complete asynchronously, coalesced
    into fused super-batches;
  * everything else — mutations, unit queries, ``stats``, non-service DFGs —
    dispatches immediately through the ordinary RPC server path, so a
    mutable-graph update is never stuck behind a model execution.

The runtime is shard- AND endpoint-transparent: against a
``ShardedGraphStore``-backed service, a fused group's per-hop sampling
submits one batched fetch to every shard endpoint and awaits them
together, mutable commands route to the owning shard's endpoint (whose
device ``on_write`` hook invalidates that shard's page cache), and the
``stats`` RPC carries per-shard cache + IO telemetry — plus, for arrays,
a per-endpoint link snapshot (``shard_links``) — next to the scheduler
QoS block.  Whether the shards are in-process (``LocalShardEndpoint``)
or remote behind their own RoP SQ/CQ pairs (``RopShardEndpoint``,
``examples/serve_gnn.py --remote-shards``), the serving results are
bit-identical.

It is failure-transparent too: against a replicated array
(``replication >= 2``), ``fail_shard``/``rebuild_shard`` dispatch as
immediate commands (never queued behind a model execution, like any
mutation), a fused group whose fetch was already planned onto the dying
shard re-plans against the survivors inside the store's failover retry,
and degraded groups keep returning bit-identical results — the
fault-injection CI gate drives exactly this path mid-serve.

Operating modes:

  * **threaded** (``start()``/``stop()``): a dispatcher thread drains the
    submission queues, a scheduler thread runs fused groups — the serving
    benchmark and example use this;
  * **stepped** (``pump()``): single-threaded deterministic draining —
    grouping and completion order become a pure function of submission
    order, which the bit-exactness and mutable-under-load tests rely on.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..concurrency import witness_lock
from ..rpc import RPCServer, MultiQueueRoP, AsyncRPCClient
from ..rpc.transport import serialize, deserialize
from .scheduler import BatchScheduler, AdmissionError

# commands counted by the write-side admission telemetry
_MUTATION_METHODS = frozenset({
    "add_vertex", "delete_vertex", "add_edge", "delete_edge",
    "update_embed", "update_graph", "flush_firehose"})


class ServingRuntime:
    def __init__(self, service, *, n_queues: int = 4, queue_depth: int = 64,
                 max_group: int = 16, max_pending: int = 256,
                 coalesce: bool = True, batch_window_s: float = 0.02,
                 immediate_workers: int = 4):
        self.service = service
        self.rop = MultiQueueRoP(n_queues=n_queues, depth=queue_depth)
        self.server = RPCServer(service)
        self.scheduler = BatchScheduler(service, max_group=max_group,
                                        max_pending=max_pending,
                                        coalesce=coalesce,
                                        batch_window_s=batch_window_s)
        # the service's `stats` RPC pulls QoS + transport counters from here
        service.qos_provider = self.qos_snapshot
        # rejected admissions carry the array's health next to queue depth
        self.scheduler.health_provider = self._health_summary
        # threaded mode runs non-run commands on this small pool: a
        # mutation blocked on the store's maintenance gate (a streaming
        # shard rebuild) must not wedge the dispatcher thread — stats
        # probes and reads keep flowing while the write waits it out
        self.immediate_workers = int(immediate_workers)
        self._immediate: ThreadPoolExecutor | None = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._next_q = itertools.count()
        # write-side admission telemetry: mutation commands dispatched and
        # shed (typed BackpressureError — e.g. a full firehose log or an
        # exhausted submit-retry budget rejects the write at admission)
        self._write_lock = witness_lock(
            "runtime._write_lock", threading.Lock())
        self.write_ops = 0                     # guarded-by: _write_lock
        self.write_shed = 0                    # guarded-by: _write_lock

    # ---------------------------------------------------------------- clients
    def client(self, qid: int | None = None) -> AsyncRPCClient:
        """A host-side async stub; queues are assigned round-robin."""
        if qid is None:
            qid = next(self._next_q) % len(self.rop.pairs)
        return AsyncRPCClient(self.rop, qid)

    # ----------------------------------------------------------- device side
    def _dispatch(self, qid: int, cmd_id: int, packet: bytes, *,
                  inline: bool = True) -> None:
        req = deserialize(packet)
        method, kwargs = req["method"], dict(req.get("kwargs") or {})
        if method == "run" and self.scheduler.accepts(kwargs.get("dfg")):
            priority = int(kwargs.pop("priority", 0))
            deadline_s = kwargs.pop("deadline_s", None)
            weights_key = kwargs.pop("weights_key", None)

            def on_done(resp: dict) -> None:
                self.rop.post_completion(qid, cmd_id, serialize(resp))

            try:
                self.scheduler.submit(
                    dfg=kwargs["dfg"], batch=kwargs["batch"],
                    weights=kwargs.get("weights"),
                    weights_ref=kwargs.get("weights_ref"),
                    seed=kwargs.get("seed", 0),
                    jit=kwargs.get("jit", True),
                    priority=priority, deadline_s=deadline_s,
                    weights_key=weights_key, on_done=on_done)
            except AdmissionError as e:
                on_done({"ok": False, "error": f"AdmissionError: {e}",
                         "reason": dict(e.reason)})
            return
        kwargs.pop("priority", None)          # QoS hints are runtime-level,
        kwargs.pop("deadline_s", None)        # not service kwargs
        kwargs.pop("weights_key", None)

        def immediate() -> None:
            resp = self.server.dispatch(method, kwargs)
            if method in _MUTATION_METHODS:
                with self._write_lock:
                    self.write_ops += 1
                    if not resp["ok"] and \
                            resp["error"].startswith("BackpressureError"):
                        self.write_shed += 1
            self.rop.post_completion(qid, cmd_id, serialize(resp))

        if inline or self._immediate is None:
            immediate()              # stepped mode stays deterministic
        else:
            self._immediate.submit(immediate)

    # ---------------------------------------------------------- stepped mode
    def pump(self) -> int:
        """Drain every queued submission, then schedule to empty.

        Deterministic: requests are admitted in queue round-robin order and
        grouped by the scheduler's pure (priority, seq) policy.  Returns the
        number of scheduler-completed requests.
        """
        while True:
            got = self.rop.pop_submission(timeout=0)
            if got is None:
                break
            self._dispatch(*got)
        return self.scheduler.drain()

    # ---------------------------------------------------------- threaded mode
    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        self._immediate = ThreadPoolExecutor(
            max_workers=self.immediate_workers,
            thread_name_prefix="rt-immediate")

        def dispatcher():
            while not self._stop.is_set():
                got = self.rop.pop_submission(timeout=0.05)
                if got is not None:
                    self._dispatch(*got, inline=False)

        def worker():
            # the worker drains submissions inline at every group boundary:
            # under load the dispatcher thread is starved of scheduling
            # quanta by the model execution, and groups would otherwise
            # form half-empty.  The dispatcher still guarantees liveness
            # for commands arriving DURING a group execution (mutations,
            # stats) — they never wait for the batcher.
            while not self._stop.is_set():
                while True:
                    got = self.rop.pop_submission(timeout=0)
                    if got is None:
                        break
                    self._dispatch(*got, inline=False)
                if self.scheduler.step():
                    continue
                if self.scheduler.wait_for_work(timeout=0.05):
                    time.sleep(0.0005)        # batching window still open

        for fn, name in ((dispatcher, "rop-dispatch"), (worker, "batcher")):
            th = threading.Thread(target=fn, name=name, daemon=True)
            th.start()
            self._threads.append(th)

    def stop(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=5.0)
        self._threads = []
        if self._immediate is not None:
            self._immediate.shutdown(wait=True)
            self._immediate = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -------------------------------------------------------------- telemetry
    def _health_summary(self) -> dict | None:
        """Compact per-shard health for AdmissionError reasons: failed
        shards from the store, states/suspects from the supervisor when
        one is attached.  None for single-device services."""
        store = getattr(self.service, "store", None)
        failed = getattr(store, "failed_shards", None)
        out: dict = {}
        if failed is not None:
            out["failed_shards"] = [i for i, f in enumerate(failed) if f]
        sup = getattr(store, "health", None)
        if sup is not None:
            out["states"] = sup.states()
            out["suspects"] = sup.suspect_shards()
        return out or None

    def qos_snapshot(self) -> dict:
        out = self.scheduler.qos.snapshot(
            queue_depth=self.scheduler.queue_depth)
        out["transport"] = self.rop.stats_snapshot()
        links = self.shard_link_snapshot()
        if links is not None:
            out["shard_links"] = links
        store = getattr(self.service, "store", None)
        if hasattr(store, "backpressure_events"):
            out["backpressure"] = {
                "events": store.backpressure_events,
                "retries": store.backpressure_retries,
                "max_inflight_per_shard":
                    store.flow.max_inflight_per_shard}
        with self._write_lock:
            out["write_admission"] = {"ops": self.write_ops,
                                      "shed": self.write_shed}
        fh = getattr(self.service, "firehose", None)
        if fh is not None:
            out["firehose"] = fh.snapshot()
        sup = getattr(store, "health", None)
        if sup is not None:
            out["health"] = sup.snapshot()
        if hasattr(self.service, "engine_stats"):
            # compute-plane placement + jit trace cache (mesh is None when
            # the engine runs unsharded) — operators watch evictions here
            # for pad-group drift blowing the trace cache
            out["engine"] = self.service.engine_stats()
        return out

    def shard_link_snapshot(self) -> list[dict] | None:
        """Host-side view of the coordinator->shard endpoint links: total
        commands issued and (for RoP endpoints) bytes through the mmap
        channels — the multi-host observability the ``stats`` RPC's QoS
        block carries next to the scheduler counters.  None for
        single-device services (there is no array)."""
        endpoints = getattr(self.service.store, "endpoints", None)
        if endpoints is None:
            return None
        links = []
        for s, ep in enumerate(endpoints):
            entry = {"shard": s, "calls": ep.rpc_calls()}
            if hasattr(ep, "channel_bytes"):
                entry["channel_bytes"] = ep.channel_bytes()
            links.append(entry)
        return links
