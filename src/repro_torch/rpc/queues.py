"""Multi-queue RPC-over-PCIe transport — the paper's RoP link (§3.3, Fig. 5)
generalised from one synchronous doorbell to N submission/completion queue
pairs, NVMe-style, so many logical clients can have commands in flight
against one CSSD at once.

Copy of ``repro/rpc/queues.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

Mechanics modeled:

  * ``QueuePair`` — one host-visible SQ/CQ ring pair: a bounded submission
    ring (full ring == backpressure, ``QueueFullError``) and a completion
    table keyed by command id (completions may land out of order — the
    scheduler reorders requests freely).  Each pair has its own condition
    variable, so a completion wakes only that pair's waiters — with many
    concurrent clients a shared doorbell would thrash every thread on every
    completion;
  * ``MultiQueueRoP`` — the device side: round-robin arbitration across
    submission queues (one firmware poll loop serves every queue, parked on
    a counting doorbell) plus an in-flight command table (cmd_id -> queue,
    method, submit time) so queue depth and per-command age are observable
    at any moment;
  * ``AsyncRPCClient`` — the host-side stub for one queue pair: ``submit``
    returns immediately with a command id, ``result`` blocks on the matching
    completion.  ``call`` is the synchronous convenience wrapper.

Packets are the same self-contained RoP byte format as the single-doorbell
path (``transport.serialize``); only the queueing discipline differs.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from ..concurrency import witness_condition, witness_lock
from .transport import serialize, deserialize, check_reply


class QueueFullError(RuntimeError):
    """Submission ring is full — backpressure surfaced to the submitter.

    Carries ``qid``/``depth`` so retry layers can report WHICH ring
    pushed back instead of a bare string."""

    def __init__(self, msg: str, *, qid: int | None = None,
                 depth: int | None = None):
        super().__init__(msg)
        self.qid = qid
        self.depth = depth


class BackpressureError(RuntimeError):
    """Typed end-to-end backpressure: a bounded submit window or ring
    stayed full through the configured retry budget.

    Raised by the array coordinator's flow control (never by the rings
    themselves — those raise ``QueueFullError`` per attempt) so the
    serving scheduler can shed load with a REASON (``.reason``: source,
    shard, attempts, queue depths) instead of letting a transport error
    crash the request path.  "Overloaded" stays distinguishable from
    "degraded array"."""

    def __init__(self, msg: str, *, reason: dict | None = None):
        super().__init__(msg)
        self.reason = dict(reason or {})


@dataclass
class QueuePairStats:
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    bytes_tx: int = 0          # host -> device (submission packets)
    bytes_rx: int = 0          # device -> host (completion packets)


class QueuePair:
    """One SQ/CQ ring pair with its own doorbell (condition variable)."""

    def __init__(self, qid: int, depth: int):
        self.qid = qid
        self.depth = int(depth)
        self.cv = witness_condition(           # guards sq + cq of THIS pair
            "queues.cv", threading.Condition())
        self.sq: deque = deque()               # (cmd_id, packet)
        self.cq: dict[int, bytes] = {}         # cmd_id -> reply packet
        self.abandoned: set[int] = set()       # waiters that timed out
        self.stats = QueuePairStats()


class MultiQueueRoP:
    """N queue pairs + in-flight command tracking over one device."""

    def __init__(self, n_queues: int = 4, depth: int = 64):
        if n_queues < 1:
            raise ValueError("need at least one queue pair")
        self.pairs = [QueuePair(q, depth) for q in range(n_queues)]
        # device-side doorbell: counts commands sitting in any SQ
        self._work = witness_condition("queues._work",
                                       threading.Condition())
        self._sq_count = 0
        self._next_cmd = 1
        self.inflight: dict[int, dict] = {}    # cmd_id -> {qid, method, t}
        self._rr = 0                           # round-robin arbitration cursor

    # ------------------------------------------------------------- host side
    def submit(self, qid: int, packet: bytes, *, method: str = "?") -> int:
        """Write a command into SQ ``qid``; returns its command id.

        Raises ``QueueFullError`` when the ring is full — the transport-level
        backpressure the serving scheduler's admission control builds on.
        """
        pair = self.pairs[qid]
        with pair.cv:
            if len(pair.sq) >= pair.depth:
                pair.stats.rejected += 1
                raise QueueFullError(
                    f"submission queue {qid} full (depth {pair.depth})")
            # in-flight registration + doorbell must precede SQ visibility:
            # a consumer already scanning may pop the command the instant it
            # appears, and its completion must find the tracking entry
            with self._work:
                cmd_id = self._next_cmd
                self._next_cmd += 1
                self.inflight[cmd_id] = {"qid": qid, "method": method,
                                         "t_submit": time.perf_counter()}
                self._sq_count += 1
                self._work.notify()
            pair.sq.append((cmd_id, packet))
            pair.stats.submitted += 1
            pair.stats.bytes_tx += len(packet)
        return cmd_id

    def wait_completion(self, qid: int, cmd_id: int, *,
                        timeout: float | None = None) -> bytes:
        """Block until command ``cmd_id`` completes on CQ ``qid``."""
        end = None if timeout is None else time.monotonic() + timeout
        pair = self.pairs[qid]
        with pair.cv:
            while cmd_id not in pair.cq:
                rem = None if end is None else end - time.monotonic()
                if rem is not None and rem <= 0:
                    # mark abandoned so the eventual completion is dropped
                    # instead of sitting in the CQ forever
                    pair.abandoned.add(cmd_id)
                    raise TimeoutError(f"command {cmd_id} not completed "
                                       f"within {timeout}s")
                pair.cv.wait(rem)
            return pair.cq.pop(cmd_id)

    def poll_completion(self, qid: int, cmd_id: int) -> bytes | None:
        """Non-blocking completion check (None while still in flight)."""
        pair = self.pairs[qid]
        with pair.cv:
            return pair.cq.pop(cmd_id, None)

    # ----------------------------------------------------------- device side
    def pop_submission(self, *, timeout: float | None = None):
        """Round-robin pop one command across every SQ (device poll loop).

        Returns ``(qid, cmd_id, packet)`` or None on timeout (``timeout=0``
        is a pure non-blocking poll).
        """
        end = None if timeout is None else time.monotonic() + timeout
        with self._work:
            while self._sq_count == 0:
                rem = None if end is None else end - time.monotonic()
                if rem is not None and rem <= 0:
                    return None
                self._work.wait(rem)
            self._sq_count -= 1       # one queued command is now reserved
        # a command is guaranteed present in some SQ (appends precede the
        # doorbell increment); scan from the arbitration cursor
        while True:
            n = len(self.pairs)
            for k in range(n):
                pair = self.pairs[(self._rr + k) % n]
                with pair.cv:
                    if pair.sq:
                        self._rr = (self._rr + k + 1) % n
                        cmd_id, packet = pair.sq.popleft()
                        return pair.qid, cmd_id, packet

    def post_completion(self, qid: int, cmd_id: int, packet: bytes) -> None:
        pair = self.pairs[qid]
        with pair.cv:
            pair.stats.completed += 1
            pair.stats.bytes_rx += len(packet)
            if cmd_id in pair.abandoned:       # waiter gave up: drop reply
                pair.abandoned.discard(cmd_id)
            else:
                pair.cq[cmd_id] = packet
                pair.cv.notify_all()  # wakes only this pair's waiters
        with self._work:
            self.inflight.pop(cmd_id, None)

    # -------------------------------------------------------------- telemetry
    @property
    def depth_in_flight(self) -> int:
        with self._work:
            return len(self.inflight)

    def stats_snapshot(self) -> dict:
        with self._work:
            now = time.perf_counter()
            oldest = max((now - c["t_submit"]
                          for c in self.inflight.values()), default=0.0)
            in_flight = len(self.inflight)
        return {
            "n_queues": len(self.pairs),
            "in_flight": in_flight,
            "oldest_in_flight_s": oldest,
            "queues": [{"qid": p.qid, "sq_depth": len(p.sq),
                        "submitted": p.stats.submitted,
                        "completed": p.stats.completed,
                        "rejected": p.stats.rejected,
                        "bytes_tx": p.stats.bytes_tx,
                        "bytes_rx": p.stats.bytes_rx}
                       for p in self.pairs],
        }


class AsyncRPCClient:
    """Host-side stub bound to one queue pair: submit many, reap any order.

    Shares the synchronous stub's error/stats contract (``check_reply`` +
    per-method ``MethodStats``), so whichever transport a shard endpoint
    uses, its host-side accounting looks the same.  An optional
    ``PCIeChannel`` pair models the RoP mmap-buffer copies per direction
    (byte/copy counters for the multi-host benchmarks); the channels are
    guarded by a client-local lock so several coordinator threads may
    share one stub.
    """

    def __init__(self, rop: MultiQueueRoP, qid: int, *, tx=None, rx=None):
        from .client import ClientStats           # shared accounting
        self.rop = rop
        self.qid = int(qid)
        self.tx = tx                              # host -> device channel
        self.rx = rx                              # device -> host channel
        self._stats = ClientStats()
        self._pending: dict[int, tuple[str, float]] = {}
        self._lock = witness_lock("rpcclient._lock", threading.Lock())

    @property
    def method_stats(self) -> dict:
        return self._stats.method_stats

    def stats_snapshot(self) -> dict:
        return self._stats.stats_snapshot()

    def submit(self, method: str, **kwargs) -> int:
        t0 = time.perf_counter()
        packet = serialize({"method": method, "kwargs": kwargs})
        if self.tx is not None:
            with self._lock:
                self.tx.stats.serialize_secs += time.perf_counter() - t0
                self.tx.push(packet)              # memcpy host -> mmap
                packet = self.tx.pull()           # memcpy mmap -> device
        cmd_id = self.rop.submit(self.qid, packet, method=method)
        with self._lock:
            self._pending[cmd_id] = (method, t0)
        return cmd_id

    def result(self, cmd_id: int, *, timeout: float | None = None):
        try:
            reply = self.rop.wait_completion(self.qid, cmd_id,
                                             timeout=timeout)
        except TimeoutError:
            # the ring marks the command abandoned (its completion will be
            # dropped); the host-side pending entry must go too, or
            # sustained timeouts grow it without bound
            with self._lock:
                method, t0 = self._pending.pop(cmd_id,
                                               ("?", time.perf_counter()))
            self._stats.record(method, time.perf_counter() - t0, False)
            raise
        with self._lock:
            method, t0 = self._pending.pop(cmd_id, ("?", time.perf_counter()))
            if self.rx is not None:
                self.rx.push(reply)               # memcpy device -> mmap
                reply = self.rx.pull()            # memcpy mmap -> host
        resp = deserialize(reply)
        self._stats.record(method, time.perf_counter() - t0,
                           bool(resp.get("ok")))
        return check_reply(resp, f"RPC {method}")

    def call(self, method: str, *, timeout: float | None = None, **kwargs):
        """Synchronous convenience: submit + wait."""
        return self.result(self.submit(method, **kwargs), timeout=timeout)
