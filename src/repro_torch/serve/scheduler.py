"""Admission-controlled continuous-batching scheduler.

Copy of ``repro/serve/scheduler.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

Holds a bounded pending queue of ``run`` requests and, each scheduling
round, forms ONE fused group: the head request (highest priority class,
FIFO within class) plus every queued request compatible with it — same DFG
markup, same weights fingerprint, same jit flag — up to ``max_group``.  The
group executes as a single fused super-batch through
``HolisticGNNService.run_batch`` and each request's completion callback
receives its own rows.

QoS levers:

  * **admission control / backpressure** — ``submit`` raises
    ``AdmissionError`` once ``max_pending`` requests wait; the serving
    runtime turns that into an error completion (and the multi-queue
    transport's bounded rings backpressure one level below);
  * **priority classes** — higher ``priority`` schedules strictly first;
    a group leader only coalesces with compatible requests, so a high-
    priority singleton never waits for a bulk group to assemble;
  * **deadlines** — requests whose deadline passed while queued complete
    with a ``DeadlineExceeded`` error instead of occupying the engine;
  * **telemetry** — rolling p50/p95/p99 latency, throughput, queue depth
    and group-size accounting, surfaced via the ``stats`` RPC.
"""
from __future__ import annotations

import itertools
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..concurrency import witness_condition, witness_lock
from ..rpc.queues import BackpressureError
from .batcher import fingerprint_weights


class AdmissionError(RuntimeError):
    """Pending queue is full — request rejected at admission.

    Carries a ``reason`` dict (source, queue depth, per-shard health when
    a supervisor is attached) so a client can tell "overloaded" from
    "degraded array" instead of seeing a generic full queue."""

    def __init__(self, msg: str, *, reason: dict | None = None):
        super().__init__(msg)
        self.reason = dict(reason or {})


@dataclass
class ServeRequest:
    seq: int
    dfg: str                      # markup string
    targets: object
    weights: dict
    weights_ref: str | None       # device-resident weights (put_weights)
    wkey: str
    seed: int
    jit: bool
    priority: int
    deadline: float | None        # absolute perf_counter deadline
    on_done: Callable[[dict], None]
    t_enqueue: float = field(default_factory=time.perf_counter)


class QoSTelemetry:
    """Bounded rolling latency window + lifetime counters (thread-safe)."""

    def __init__(self, window: int = 512):
        self._lock = witness_lock(
            "scheduler.qos._lock", threading.Lock())
        self._window = deque(maxlen=window)    # guarded-by: _lock
        self.completed = 0                     # guarded-by: _lock
        self.errors = 0                        # guarded-by: _lock
        self.expired = 0                       # guarded-by: _lock
        self.rejected = 0                      # guarded-by: _lock
        self.backpressured = 0                 # guarded-by: _lock
        self.last_reject_reason: dict | None = None  # guarded-by: _lock
        self.groups = 0                        # guarded-by: _lock
        self.grouped_requests = 0              # guarded-by: _lock

    def record(self, latency_s: float) -> None:
        with self._lock:
            self._window.append((time.perf_counter(), latency_s))
            self.completed += 1

    # locked mutators: the scheduler threads bump the lifetime counters
    # through these so every read in ``snapshot`` sees a consistent set
    def note_rejected(self, reason: dict | None = None) -> None:
        with self._lock:
            self.rejected += 1
            if reason is not None:
                self.last_reject_reason = dict(reason)

    def note_expired(self, n: int = 1) -> None:
        with self._lock:
            self.expired += int(n)

    def note_backpressured(self, reason: dict | None = None) -> None:
        with self._lock:
            self.backpressured += 1
            if reason is not None:
                self.last_reject_reason = dict(reason)

    def note_errors(self, n: int = 1) -> None:
        with self._lock:
            self.errors += int(n)

    def note_group(self, size: int) -> None:
        with self._lock:
            self.groups += 1
            self.grouped_requests += int(size)

    def snapshot(self, *, queue_depth: int = 0) -> dict:
        with self._lock:
            lat = np.array([l for _, l in self._window])
            now = time.perf_counter()
            span = now - self._window[0][0] if len(self._window) > 1 else 0.0
            out = {
                "completed": self.completed, "errors": self.errors,
                "expired": self.expired, "rejected": self.rejected,
                "backpressured": self.backpressured,
                "last_reject_reason": (dict(self.last_reject_reason)
                                       if self.last_reject_reason else None),
                "groups": self.groups,
                "avg_group_size": (self.grouped_requests / self.groups
                                   if self.groups else 0.0),
                "queue_depth": queue_depth,
                "window_n": len(lat),
                "throughput_rps": len(lat) / span if span > 0 else 0.0,
            }
            for p in (50, 95, 99):
                out[f"p{p}_latency_s"] = (float(np.percentile(lat, p))
                                          if len(lat) else 0.0)
            return out


class BatchScheduler:
    def __init__(self, service, *, max_group: int = 16,
                 max_pending: int = 256, coalesce: bool = True,
                 batch_window_s: float = 0.02,
                 telemetry_window: int = 512):
        self.service = service
        self.max_group = int(max_group)
        self.max_pending = int(max_pending)
        self.coalesce = coalesce
        # continuous-batching window: with fewer than max_group pending, a
        # scheduling round holds while requests are STILL ARRIVING (quiet
        # period — under closed-loop traffic one group's completions trigger
        # the next cohort's submissions a fraction of a ms apart, so an
        # age-based window would forever schedule half-groups), hard-capped
        # at batch_window_s from the oldest pending request.  Trades a few
        # ms of latency for much fuller fused batches.  Stepped mode
        # (drain/pump) forces immediate scheduling instead.
        self.batch_window_s = float(batch_window_s)
        self._quiet_s = min(0.003, self.batch_window_s / 4
                            if self.batch_window_s else 0.0)
        self.qos = QoSTelemetry(telemetry_window)
        # optional callable returning a per-shard health summary, set by
        # the serving runtime — folded into AdmissionError reasons so a
        # rejected client learns WHY the queue is full (hot array vs
        # degraded array)
        self.health_provider = None
        self._pending: list[ServeRequest] = []
        self._cond = witness_condition(
            "scheduler._cond", threading.Condition())
        self._seq = itertools.count()

    # -------------------------------------------------------------- admission
    def accepts(self, dfg) -> bool:
        """Only BatchPre-led service DFGs are batchable; everything else
        stays on the synchronous dispatch path."""
        if not isinstance(dfg, str):
            return False
        try:
            return self.service._service_program(dfg) is not None
        except Exception:  # noqa: BLE001 — malformed markup: sync path errors
            return False

    def submit(self, *, dfg, batch, weights=None, seed: int = 0,
               jit: bool = True, priority: int = 0,
               deadline_s: float | None = None,
               weights_key: str | None = None,
               weights_ref: str | None = None,
               on_done: Callable[[dict], None]) -> int:
        """Enqueue one run request; returns its sequence number.

        Raises ``AdmissionError`` when the pending queue is full — callers
        translate this into transport-level backpressure.

        ``weights_ref`` names device-resident weights (``put_weights``);
        ``weights_key``: callers that guarantee weights identity across
        requests (a deployed model version) may pass a key to skip the
        per-request content hash; requests only coalesce on equal keys.
        """
        if weights_key is not None:
            wkey = f"key:{weights_key}"
        elif weights_ref is not None and not weights:
            wkey = f"ref:{weights_ref}"
        else:
            wkey = f"{weights_ref}|{fingerprint_weights(weights)}"
        with self._cond:
            if len(self._pending) >= self.max_pending:
                reason = {"source": "admission",
                          "queue_depth": len(self._pending),
                          "max_pending": self.max_pending}
                hp = self.health_provider
                if hp is not None:
                    try:
                        health = hp()
                    except Exception:  # noqa: BLE001 — reason is best-effort
                        health = None
                    if health:
                        reason["shard_health"] = health
                self.qos.note_rejected(reason)
                raise AdmissionError(
                    f"admission queue full ({self.max_pending} pending)",
                    reason=reason)
            req = ServeRequest(
                seq=next(self._seq),
                dfg=dfg if isinstance(dfg, str) else dfg.save(),
                targets=batch, weights=dict(weights or {}),
                weights_ref=weights_ref, wkey=wkey,
                seed=int(seed),
                jit=bool(jit), priority=int(priority),
                deadline=(None if deadline_s is None
                          else time.perf_counter() + float(deadline_s)),
                on_done=on_done)
            self._pending.append(req)
            self._cond.notify_all()
            return req.seq

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    def wait_for_work(self, timeout: float | None = None) -> bool:
        with self._cond:
            if not self._pending:
                self._cond.wait(timeout)
            return bool(self._pending)

    # ------------------------------------------------------------- scheduling
    def _form_group(self, force: bool) -> list[ServeRequest]:
        """Pop one fused group (priority head + compatible followers)."""
        with self._cond:
            now = time.perf_counter()
            alive: list[ServeRequest] = []
            expired: list[ServeRequest] = []
            for r in self._pending:
                (expired if r.deadline is not None and now > r.deadline
                 else alive).append(r)
            self._pending = alive
            for r in expired:
                self.qos.note_expired()
                r.on_done({"ok": False, "error":
                           "DeadlineExceeded: request expired in queue "
                           f"(waited {now - r.t_enqueue:.3f}s)"})
            if not alive:
                return []
            if (not force and self.batch_window_s > 0
                    and len(alive) < self.max_group
                    and now - max(r.t_enqueue for r in alive) < self._quiet_s
                    and now - min(r.t_enqueue for r in alive)
                    < self.batch_window_s):
                return []                     # hold for fuller coalescing
            alive.sort(key=lambda r: (-r.priority, r.seq))
            head = alive[0]
            group = [head]
            if self.coalesce and self.accepts(head.dfg):
                for r in alive[1:]:
                    if len(group) >= self.max_group:
                        break
                    if (r.dfg == head.dfg and r.wkey == head.wkey
                            and r.jit == head.jit):
                        group.append(r)
            taken = {r.seq for r in group}
            self._pending = [r for r in alive if r.seq not in taken]
            return group

    def step(self, *, force: bool = False) -> int:
        """Schedule + execute ONE group.  Returns requests completed
        (0 while empty — or while the batching window holds, unless
        ``force``)."""
        group = self._form_group(force)
        if not group:
            return 0
        self._execute(group)
        return len(group)

    def drain(self) -> int:
        """Run scheduling rounds until the queue is empty (stepped mode;
        ignores the batching window)."""
        total = 0
        while True:
            done = self.step(force=True)
            if not done:
                return total
            total += done

    # -------------------------------------------------------------- execution
    def _execute(self, group: list[ServeRequest]) -> None:
        head = group[0]
        try:
            if self.accepts(head.dfg):
                results = self.service.run_batch(
                    head.dfg,
                    [{"targets": r.targets, "seed": r.seed} for r in group],
                    weights=head.weights, jit=head.jit,
                    weights_ref=head.weights_ref)
            else:                      # non-service DFG: solo fallback
                results = [self.service.run(head.dfg, head.targets,
                                            weights=head.weights,
                                            seed=head.seed, jit=head.jit,
                                            weights_ref=head.weights_ref)]
        except BackpressureError as e:
            # typed shed: the array's flow control (in-flight windows /
            # queue-full retry budget) refused the fused fetch — report
            # the reason, don't crash the group as a generic error
            self.qos.note_backpressured(dict(e.reason))
            resp = {"ok": False, "error": f"BackpressureError: {e}",
                    "backpressure": True, "reason": dict(e.reason)}
            self.qos.note_errors(len(group))
            for r in group:
                r.on_done(dict(resp))
            return
        except Exception as e:  # noqa: BLE001 — fault fans out to the group
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()}
            self.qos.note_errors(len(group))
            for r in group:
                r.on_done(dict(resp))
            return
        now = time.perf_counter()
        self.qos.note_group(len(group))
        for r, out in zip(group, results):
            self.qos.record(now - r.t_enqueue)
            r.on_done({"ok": True, "result": out})
