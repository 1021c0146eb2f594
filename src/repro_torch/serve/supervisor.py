"""ShardSupervisor — the autonomic runtime of the replicated CSSD array.

Copy of ``repro/serve/supervisor.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

PRs 4-5 gave the array a fault PATH (``fail_shard`` drain, streaming
``rebuild_shard``) but left the fault LOOP to an operator: someone had to
notice the ``DeviceFailedError`` burst, drain the shard, and kick the
rebuild.  The paper pitches the array as an always-on inference service
(§8), and ROADMAP open item 2 names the missing piece exactly — this
module closes the loop:

  healthy ──error──▶ suspect ──burst──▶ failed ──auto──▶ rebuilding ──▶ healthy
     ▲                  │ (decay)                                          │
     └──────────────────┴──────────────────────────────────────────────────┘

  * **detection** — two independent signals feed the state machine: the
    store reports every shard-attributed ``DeviceFailedError`` it maps
    on the serving path (``record_error`` — zero extra RPCs), and a
    monitor thread probes every endpoint's ``counters`` each
    ``probe_interval_s`` (device stats stay readable after ``fail()``,
    so a dead shard is caught even with zero serving traffic);
  * **policy, not blips** — one error marks a shard *suspect* (replica
    selection steers reads away via ``FlowControl.suspect_penalty_pages``
    until the suspicion decays after ``suspect_decay_s`` quiet seconds);
    only ``error_threshold`` errors inside ``window_s`` — or the probe
    reading the device's own failed flag — drain it;
  * **drain** — ``store.fail_shard`` (idempotent; raced operator RPCs are
    fine).  If the drain is REFUSED because a vertex class would lose its
    last replica, the shard is marked failed-undrained and no rebuild is
    attempted — that is data loss, an operator problem, not a loop to
    spin on;
  * **rebuild** — a background thread runs ``store.rebuild_shard`` with
    ``rebuild_pacing_s`` chunk pacing (serving reads keep flowing: the
    store streams under the maintenance gate, and pacing keeps recovery
    pulls from monopolising the survivor devices), retrying up to
    ``max_rebuild_attempts`` every ``rebuild_retry_s``;
  * **re-admission** — on success the shard returns to ``healthy`` and
    replica selection resumes steering load onto it.

Locking: the supervisor lock is a strict LEAF.  ``record_error`` is
called from serving threads that may hold the store's mutation lock, so
the supervisor must NEVER call back into the store while holding its own
lock — transition decisions are made under the lock, drains and rebuilds
execute outside it (guarded by per-shard draining flags + the store's
idempotent fault RPCs).

Transition hooks (``on_transition(shard, old, new, info)``) give the
telemetry layer a callback seam — the metrics-hook shape — and a bounded
event log + ``snapshot()`` feed the service ``stats`` RPC, so a client
can distinguish "overloaded" from "degraded array" by asking.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from ..concurrency import witness_lock
from ..store.blockdev import DeviceFailedError

# health states
HEALTHY = "healthy"
SUSPECT = "suspect"
FAILED = "failed"           # drained (or refused: ``drained`` False)
REBUILDING = "rebuilding"


@dataclass
class HealthPolicy:
    """Knobs of the autonomic loop (see module docstring)."""

    error_threshold: int = 3          # errors inside window_s => drain
    window_s: float = 1.0
    suspect_decay_s: float = 5.0      # quiet seconds before un-suspecting
    probe_interval_s: float = 0.05    # monitor heartbeat
    auto_rebuild: bool = True
    rebuild_pacing_s: float = 0.0     # sleep between rebuild chunk pulls
    rebuild_retry_s: float = 0.5
    max_rebuild_attempts: int = 5


class ShardSupervisor:
    """Health monitor + auto-drain/auto-rebuild loop over one array store
    (``ReplicatedGraphStore`` or ``ShardedGraphStore``).

    ``start()`` launches the monitor thread and attaches the supervisor
    as ``store.health`` (the store reports shard errors and reads the
    suspect set through that duck-typed seam).  ``stop()`` detaches and
    joins.  All public queries are safe from any thread.
    """

    def __init__(self, store, policy: HealthPolicy | None = None, *,
                 on_transition=None, max_events: int = 256):
        self.store = store
        self.policy = policy or HealthPolicy()
        self.on_transition = on_transition
        self._lock = witness_lock(             # LEAF — see module docstring
            "supervisor._lock", threading.Lock())
        n = store.n_shards
        self._state = [HEALTHY] * n
        self._drained = [False] * n
        self._errors: list[deque] = [deque(maxlen=64) for _ in range(n)]
        self._last_error = [0.0] * n
        self._first_error = [0.0] * n          # of the current incident
        self._draining = [False] * n
        self._rebuild_attempts = [0] * n
        self._next_rebuild_t = [0.0] * n
        self._rebuild_threads: dict[int, threading.Thread] = {}  # guarded-by: _lock
        self.events: deque = deque(maxlen=int(max_events))
        self.incidents: list[dict] = []        # one per completed drain
        self._hookq: deque = deque()           # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # shards already failed at attach time (operator predecessors)
        for s, failed in enumerate(getattr(store, "failed_shards",
                                           [False] * n)):
            if failed:
                self._state[s] = FAILED
                self._drained[s] = True

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ShardSupervisor":
        """Attach as ``store.health`` and launch the monitor thread
        (idempotent); returns ``self`` for chaining."""
        if self._thread is not None:
            return self
        self.store.health = self
        self._stop.clear()
        self._thread = threading.Thread(target=self._monitor,
                                        name="shard-supervisor", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Detach from the store, join the monitor and any in-flight
        rebuild threads."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        with self._lock:
            rebuilds = list(self._rebuild_threads.values())
        for th in rebuilds:
            th.join(timeout=30.0)
        if getattr(self.store, "health", None) is self:
            self.store.health = None

    def resize(self, n: int, keep: list[int] | None = None) -> None:
        """Re-dimension the per-shard state after an elastic reshard.

        Called by the store's ``_topology_changed`` hook once a grow or
        shrink commits.  On grow the new shards start ``healthy``; on
        shrink the survivors were renumbered by the store, and — since
        ``reshard`` refuses to run with any shard failed — every
        survivor was healthy or suspect at commit time, so the state
        resets to ``healthy`` (a still-flaky shard re-marks itself on
        its next error).  ``keep`` optionally lists the old ids of the
        survivors in new-id order to preserve their state instead.

        Args:
            n: the store's new shard count.
            keep: old shard ids of the survivors, in new-id order
                (shrink only); ``None`` resets shrunk state.
        """
        n = int(n)
        with self._lock:
            old_n = len(self._state)
            if n == old_n:
                return

            def remap(lst, default):
                if n > old_n:
                    return list(lst) + [default] * (n - old_n)
                if keep is not None:
                    return [lst[int(o)] for o in keep]
                return [default] * n

            self._state = remap(self._state, HEALTHY)
            self._drained = remap(self._drained, False)
            self._errors = remap(self._errors, None)
            for i, q in enumerate(self._errors):
                if q is None or (n < old_n and keep is None):
                    self._errors[i] = deque(maxlen=64)
            self._last_error = remap(self._last_error, 0.0)
            self._first_error = remap(self._first_error, 0.0)
            self._draining = remap(self._draining, False)
            self._rebuild_attempts = remap(self._rebuild_attempts, 0)
            self._next_rebuild_t = remap(self._next_rebuild_t, 0.0)
            self.events.append({"t": time.monotonic(), "shard": -1,
                                "from": f"n={old_n}", "to": f"n={n}",
                                "cause": "resize"})

    # ------------------------------------------------------------ queries
    def state_of(self, shard: int) -> str:
        """Current health state of one shard (``healthy`` / ``suspect``
        / ``failed`` / ``rebuilding``)."""
        with self._lock:
            return self._state[int(shard)]

    def states(self) -> list[str]:
        """Health state of every shard, indexed by shard id."""
        with self._lock:
            return list(self._state)

    def suspect_shards(self) -> list[int]:
        """Shards replica selection should steer away from (consumed by
        the store's ``_hist_loads`` penalty)."""
        with self._lock:
            return [s for s, st in enumerate(self._state) if st == SUSPECT]

    def snapshot(self) -> dict:
        """Point-in-time health block for the service ``stats`` RPC:
        per-shard states, suspect list, incident count + last incident,
        the 16 most recent transition events, and the active policy
        thresholds."""
        with self._lock:
            return {
                "states": list(self._state),
                "suspects": [s for s, st in enumerate(self._state)
                             if st == SUSPECT],
                "drained": list(self._drained),
                "incidents": len(self.incidents),
                "last_incident": (dict(self.incidents[-1])
                                  if self.incidents else None),
                "events": [dict(e) for e in list(self.events)[-16:]],
                "policy": {"error_threshold": self.policy.error_threshold,
                           "window_s": self.policy.window_s,
                           "auto_rebuild": self.policy.auto_rebuild},
            }

    # -------------------------------------------------- error-path signal
    def record_error(self, shard: int, exc: Exception) -> None:
        """Shard-attributed ``DeviceFailedError`` from the serving path.

        Cheap (deque append + threshold check) — called inline by reader
        threads.  One error inside a healthy window -> suspect; a burst of
        ``error_threshold`` inside ``window_s`` -> drain (outside the
        lock)."""
        s = int(shard)
        now = time.monotonic()
        drain = False
        with self._lock:
            if self._state[s] in (FAILED, REBUILDING):
                return
            q = self._errors[s]
            q.append(now)
            self._last_error[s] = now
            if self._state[s] == HEALTHY:
                self._first_error[s] = now
                self._transition_locked(s, SUSPECT,
                                        {"error": f"{type(exc).__name__}"})
            burst = sum(1 for t in q if now - t <= self.policy.window_s)
            if burst >= self.policy.error_threshold \
                    and not self._draining[s]:
                self._draining[s] = True
                drain = True
        self._fire_hooks()
        if drain:
            self._drain(s, cause="error_burst")

    # ------------------------------------------------------ monitor thread
    def _monitor(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                pass
            self._stop.wait(self.policy.probe_interval_s)

    def _tick(self) -> None:
        now = time.monotonic()
        probes = self.store.probe_shards()
        store_failed = list(getattr(self.store, "failed_shards",
                                    [False] * self.store.n_shards))
        to_drain: list[int] = []
        to_rebuild: list[int] = []
        with self._lock:
            for p in probes:
                s = int(p["shard"])
                st = self._state[s]
                dev_dead = bool(p.get("failed")) or "error" in p
                if store_failed[s]:
                    # drained behind our back (operator RPC or a finished
                    # drain): adopt, schedule rebuild
                    if st not in (FAILED, REBUILDING):
                        self._drained[s] = True
                        self._transition_locked(s, FAILED,
                                                {"cause": "observed_drained"})
                elif dev_dead and st in (HEALTHY, SUSPECT) \
                        and not self._draining[s]:
                    # the device's own failed flag is definitive — no
                    # blip policy needed, drain now
                    if st == HEALTHY:
                        self._first_error[s] = now
                    self._draining[s] = True
                    to_drain.append(s)
                elif st == SUSPECT and not self._draining[s] \
                        and now - self._last_error[s] \
                        > self.policy.suspect_decay_s:
                    self._transition_locked(s, HEALTHY, {"cause": "decay"})
            if self.policy.auto_rebuild:
                for s in range(self.store.n_shards):
                    if self._state[s] == FAILED and self._drained[s] \
                            and now >= self._next_rebuild_t[s] \
                            and self._rebuild_attempts[s] \
                            < self.policy.max_rebuild_attempts \
                            and s not in self._rebuild_threads:
                        self._transition_locked(
                            s, REBUILDING,
                            {"attempt": self._rebuild_attempts[s] + 1})
                        to_rebuild.append(s)
        self._fire_hooks()
        for s in to_drain:
            self._drain(s, cause="probe")
        for s in to_rebuild:
            th = threading.Thread(target=self._rebuild, args=(s,),
                                  name=f"shard-rebuild-{s}", daemon=True)
            # register BEFORE start: a fast rebuild could finish and pop
            # its entry before an unlocked post-start assignment ran,
            # leaving a dead thread wedged in the map (and _tick would
            # never schedule that shard again)
            with self._lock:
                self._rebuild_threads[s] = th
            th.start()

    # ------------------------------------------------------------- actions
    def _drain(self, s: int, *, cause: str) -> None:
        """Outside the supervisor lock (fail_shard takes store locks)."""
        t_det = time.monotonic()
        try:
            info = self.store.fail_shard(s)
            drained, refused = True, None
        except DeviceFailedError as e:
            # refused: the shard's class(es) would lose the last replica —
            # data loss, not degradation; no rebuild loop to spin on
            info, drained, refused = {}, False, str(e)
        except Exception as e:  # noqa: BLE001
            info, drained, refused = {}, False, f"{type(e).__name__}: {e}"
        with self._lock:
            self._draining[s] = False
            self._drained[s] = drained
            self._rebuild_attempts[s] = 0
            self._next_rebuild_t[s] = 0.0
            detect_s = max(0.0, t_det - self._first_error[s]) \
                if self._first_error[s] else 0.0
            incident = {"shard": s, "cause": cause, "drained": drained,
                        "detect_s": detect_s, "t_drained": t_det,
                        "refused": refused,
                        "degraded_classes": info.get("degraded_classes")}
            self.incidents.append(incident)
            self._transition_locked(s, FAILED, incident)
        self._fire_hooks()

    def _rebuild(self, s: int) -> None:
        pol = self.policy
        t0 = time.monotonic()
        try:
            info = self.store.rebuild_shard(s, pacing_s=pol.rebuild_pacing_s)
            ok = not info.get("rebuild_in_progress")
        except Exception as e:  # noqa: BLE001 — e.g. a survivor died
            info, ok = {"error": f"{type(e).__name__}: {e}"}, False
        deferred = bool(info.get("reshard_in_progress"))
        with self._lock:
            self._rebuild_threads.pop(s, None)
            if deferred:
                # an elastic reshard holds the maintenance plane — not a
                # failure of THIS shard, so reschedule without burning an
                # attempt (the reshard itself refuses to start while any
                # shard is failed, so this can only race its final flip)
                self._next_rebuild_t[s] = time.monotonic() \
                    + pol.rebuild_retry_s
                self._transition_locked(
                    s, FAILED, {"cause": "rebuild_deferred",
                                "reason": "reshard_in_progress"})
            elif ok:
                self._errors[s].clear()
                self._drained[s] = False
                self._rebuild_attempts[s] = 0
                if self.incidents and self.incidents[-1]["shard"] == s:
                    self.incidents[-1]["rebuild_s"] = \
                        time.monotonic() - t0
                    self.incidents[-1]["restore_s"] = \
                        time.monotonic() - self.incidents[-1]["t_drained"]
                self._transition_locked(
                    s, HEALTHY,
                    {"cause": "rebuilt",
                     "chunks": info.get("chunks"),
                     "seconds": info.get("seconds")})
            else:
                self._rebuild_attempts[s] += 1
                self._next_rebuild_t[s] = time.monotonic() \
                    + pol.rebuild_retry_s
                self._transition_locked(
                    s, FAILED,
                    {"cause": "rebuild_failed",
                     "attempt": self._rebuild_attempts[s],
                     "error": info.get("error")})
        self._fire_hooks()

    # ---------------------------------------------------------- transitions
    def _transition_locked(self, s: int, new: str, info: dict) -> None:  # requires-lock: _lock
        old = self._state[s]
        self._state[s] = new
        ev = {"t": time.monotonic(), "shard": s, "from": old, "to": new}
        ev.update({k: v for k, v in info.items()
                   if isinstance(v, (str, int, float, bool, type(None)))})
        self.events.append(ev)
        if self.on_transition is not None:
            # the hook is arbitrary telemetry code — it must never run
            # under the LEAF supervisor lock (it may acquire anything).
            # Queue it; every caller drains via _fire_hooks() after
            # releasing.
            self._hookq.append((s, old, new, dict(info)))

    def _fire_hooks(self) -> None:
        """Run queued transition hooks.  Call WITHOUT the lock held."""
        while True:
            with self._lock:
                if not self._hookq:
                    return
                s, old, new, info = self._hookq.popleft()
            hook = self.on_transition
            if hook is not None:
                try:
                    hook(s, old, new, info)
                except Exception:  # noqa: BLE001 — hooks must not break
                    pass           # the loop
