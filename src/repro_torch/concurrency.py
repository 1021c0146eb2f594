"""Machine-readable concurrency contract: the lock hierarchy + a
runtime lock-order witness.

Copy of ``repro/concurrency.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

This module is the single source of truth for the repo's lock
ordering.  Three consumers read it:

  * ``tools/analysis`` — the static lock-order / guarded-by passes
    check every acquisition in ``src/repro`` against ``LOCK_ORDER``;
  * ``docs/concurrency.md`` — the hierarchy table is generated from
    the registry (``tools/analyze.py --write-docs``; drift fails CI);
  * the **runtime witness** (below) — with ``REPRO_LOCK_WITNESS=1``
    every registered lock is wrapped at its creation site and each
    acquisition is checked against the registry rank order on the
    acquiring thread's live held-stack.

The rules the registry encodes:

  * **Ranks are ascending acquisition order**: a thread holding a lock
    of rank ``r`` may only acquire locks of rank ``> r``.  Re-entrant
    acquisition of the *same instance* is always allowed (RLocks).
  * **Leaf locks** guard tiny state; while one is held the thread may
    not acquire ANY other lock nor make a blocking call (RPC,
    ``sleep``, ``join``, ``Event.wait``).
  * **Exclusion pairs** (``NEVER_TOGETHER``) must never be held
    together in either order (the read-barrier cv vs the mutation
    lock: a draining reader may need ``_mutate``).
  * **Same-name, different-instance** nesting (two shards' stores) is
    only legal for names in ``SAME_NAME_OK`` — justified inline.

Adding a lock to the codebase without registering it here fails the
static analyzer (rule LO005), so the table cannot silently rot.
"""
from __future__ import annotations

import os
import threading
import traceback
from dataclasses import dataclass, field


# --------------------------------------------------------------- registry
@dataclass(frozen=True)
class LockSpec:
    """One registered lock/condition/semaphore attribute.

    ``sites`` binds source attributes to this spec as
    ``(module_basename, attr_name)`` pairs — the static analyzer
    resolves ``with self._mutate:`` in ``sharded.py`` through
    ``("sharded", "_mutate")``.  One attribute may alias another
    spec's lock (``_mig_cv`` shares ``_mutate``'s RLock).
    """

    name: str                 # canonical label, e.g. "sharded._mutate"
    rank: int                 # ascending = outer -> inner
    kind: str                 # "lock" | "rlock" | "condition" | "semaphore"
    sites: tuple              # ((module_basename, attr_name), ...)
    leaf: bool = False        # nothing acquired / no blocking while held
    doc: str = ""

    @property
    def reentrant(self) -> bool:
        return self.kind == "rlock"


LOCK_ORDER: tuple[LockSpec, ...] = (
    LockSpec("ingest._flush_lock", 10, "lock",
             (("ingest", "_flush_lock"),),
             doc="One firehose flush at a time (window order is the "
                 "contract); taken before the write gate."),
    LockSpec("sharded._maintenance", 20, "rlock",
             (("sharded", "_maintenance"),),
             doc="Maintenance plane: bulk ingest, rebuild stream, "
                 "reshard.  Always taken before _mutate, never after."),
    LockSpec("sharded._rd_cv", 25, "condition",
             (("sharded", "_rd_cv"),),
             doc="Reader-barrier condition guarding _rd_active/"
                 "_rd_barrier.  NEVER held together with _mutate in "
                 "either order (exclusion pair)."),
    LockSpec("sharded._mutate", 30, "rlock",
             (("sharded", "_mutate"), ("sharded", "_mig_cv")),
             doc="Coordinator mutation lock (composite cross-shard "
                 "atomicity).  _mig_cv is a Condition over this same "
                 "RLock.  Held across endpoint RPC by design on the "
                 "fan-fetch and firehose-window paths."),
    LockSpec("sharded._bp_lock", 40, "lock",
             (("sharded", "_bp_lock"),), leaf=True,
             doc="Backpressure/IO-wait counters.  LEAF: bump, release."),
    LockSpec("sharded._gossip_lock", 45, "lock",
             (("sharded", "_gossip_lock"),), leaf=True,
             doc="Gossip snapshot arrays.  LEAF: the counters RPC round "
                 "runs OUTSIDE it (snapshot in, publish out)."),
    LockSpec("ingest._lock", 50, "lock",
             (("ingest", "_lock"),), leaf=True,
             doc="Firehose submission log.  LEAF: flush pops the window "
                 "under it, applies after release."),
    LockSpec("scheduler._cond", 55, "condition",
             (("scheduler", "_cond"),),
             doc="Batch scheduler pending-queue condition.  Group "
                 "EXECUTION runs outside it; completion callbacks under "
                 "it may post to queue-pair CVs (rank 80)."),
    LockSpec("sharded._windows", 58, "semaphore",
             (("sharded", "_windows"),),
             doc="Per-shard in-flight window slots (BoundedSemaphore). "
                 "Counted, not order-checked; registered for the doc "
                 "table and so LO005 knows it is accounted for."),
    LockSpec("graphstore._lock", 60, "rlock",
             (("graphstore", "_lock"), ("endpoint", "_lock")),
             doc="Per-shard store critical section (gmap/h_chain/pages). "
                 "Re-entrant; cross-instance nesting is sanctioned for "
                 "the single-puller migration/rebuild stream."),
    LockSpec("blockdev._lock", 70, "lock",
             (("blockdev", "_lock"),),
             doc="Device allocator state (_front/_back/_free).  Grow "
                 "hooks fire AFTER release (caller holds the store "
                 "lock, which keeps relocation private)."),
    LockSpec("embcache._lock", 74, "rlock",
             (("embcache", "_lock"),),
             doc="Device-DRAM page-cache map.  Held across the backing "
                 "device read by design (the miss fill IS the critical "
                 "section)."),
    LockSpec("blockdev._busy_lock", 78, "lock",
             (("blockdev", "_busy_lock"),), leaf=True,
             doc="Busy-until command arbitration.  LEAF: compute the "
                 "deadline, release, sleep outside."),
    LockSpec("queues.cv", 80, "condition",
             (("queues", "cv"),),
             doc="One SQ/CQ pair's condition.  submit() nests the "
                 "work-signal condition inside it (80 -> 85)."),
    LockSpec("queues._work", 85, "condition",
             (("queues", "_work"),), leaf=True,
             doc="Device-side work signal across all pairs.  LEAF."),
    LockSpec("rpcclient._lock", 88, "lock",
             (("queues", "_lock"),), leaf=True,
             doc="AsyncRPCClient pending-reply map + channel guard. "
                 "LEAF: never held across a queue or channel wait."),
    LockSpec("runtime._write_lock", 90, "lock",
             (("runtime", "_write_lock"),), leaf=True,
             doc="Serving-runtime write-admission counters.  LEAF."),
    LockSpec("scheduler.qos._lock", 92, "lock",
             (("scheduler", "_lock"),), leaf=True,
             doc="QoS telemetry counters + latency window.  LEAF: all "
                 "mutation goes through QoSTelemetry's own methods."),
    LockSpec("supervisor._lock", 95, "lock",
             (("supervisor", "_lock"),), leaf=True,
             doc="Supervisor state arrays.  Strict LEAF: drains, "
                 "rebuilds and transition hooks all run outside it."),
)

RANK = {s.name: s.rank for s in LOCK_ORDER}
SPEC = {s.name: s for s in LOCK_ORDER}

# (outer, inner) pairs that violate rank order but are deliberate,
# with the justification the reviewer signed off on.  Kept EMPTY on
# purpose: the hierarchy currently has no exceptions — prefer fixing
# ranks over adding entries here.
SANCTIONED_EDGES: dict[tuple[str, str], str] = {}

# Lock names whose DIFFERENT INSTANCES may nest (same rank).  Only the
# per-shard store lock: the migration/rebuild stream has exactly one
# puller, which holds its own store's lock while reading the source
# shard's under the maintenance gate — no reverse edge can form.
SAME_NAME_OK: dict[str, str] = {
    "graphstore._lock": "single-puller migration/rebuild discipline "
                        "(dest holds its lock while pulling from src; "
                        "the maintenance gate serializes pullers)",
}

# Pairs that must never be held together in either order.
NEVER_TOGETHER: dict[frozenset, str] = {
    frozenset({"sharded._rd_cv", "sharded._mutate"}):
        "a draining reader may need _mutate; holding both inverts the "
        "quiesce protocol and deadlocks the routing flip",
}


def render_lock_table() -> str:
    """The markdown hierarchy table embedded in docs/concurrency.md
    (regenerate with ``tools/analyze.py --write-docs``; drift is a
    DOC001 finding)."""
    rows = ["| rank | lock | kind | leaf | role |",
            "|---:|---|---|:---:|---|"]
    for s in LOCK_ORDER:
        rows.append(f"| {s.rank} | `{s.name}` | {s.kind} | "
                    f"{'yes' if s.leaf else ''} | {s.doc} |")
    return "\n".join(rows) + "\n"


# ---------------------------------------------------------------- witness
WITNESS_ENV = "REPRO_LOCK_WITNESS"
_witness_on = os.environ.get(WITNESS_ENV, "") not in ("", "0")
_tls = threading.local()
_global = threading.Lock()          # guards the two lists below
violations: list[dict] = []
edges_seen: set[tuple[str, str]] = set()


def witness_enabled() -> bool:
    return _witness_on


def set_witness(on: bool) -> None:
    """Programmatic override of ``REPRO_LOCK_WITNESS`` (tests).  Only
    locks created AFTER the flip are wrapped."""
    global _witness_on
    _witness_on = bool(on)


def reset_witness() -> None:
    """Drop recorded violations/edges (test isolation)."""
    with _global:
        violations.clear()
        edges_seen.clear()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _record(kind: str, detail: str) -> None:
    frames = traceback.format_stack(limit=8)[:-2]
    with _global:
        violations.append({"kind": kind, "detail": detail,
                           "thread": threading.current_thread().name,
                           "stack": "".join(frames)})


def _check_acquire(spec: LockSpec, inst: int) -> None:
    st = _stack()
    if any(hid == inst for _, hid in st):
        return                              # re-entry on the same instance
    for held, hid in st:
        pair = (held.name, spec.name)
        if frozenset({held.name, spec.name}) in NEVER_TOGETHER:
            _record("exclusion", f"{held.name} held with {spec.name}: "
                    f"{NEVER_TOGETHER[frozenset(pair)]}")
            continue
        if held.name == spec.name:
            if spec.name not in SAME_NAME_OK:
                _record("same-name", f"two instances of {spec.name} "
                        "nested (not in SAME_NAME_OK)")
            continue
        if pair in SANCTIONED_EDGES:
            with _global:
                edges_seen.add(pair)
            continue
        if held.leaf:
            _record("leaf", f"acquired {spec.name} while holding LEAF "
                    f"{held.name}")
        elif held.rank > spec.rank:
            _record("inversion", f"acquired {spec.name} (rank "
                    f"{spec.rank}) while holding {held.name} (rank "
                    f"{held.rank})")
        with _global:
            edges_seen.add(pair)


class _WitnessBase:
    """Shared acquire/release bookkeeping for lock + condition proxies."""

    def __init__(self, spec: LockSpec, real):
        self._spec = spec
        self._real = real

    def acquire(self, *a, **kw):
        got = self._real.acquire(*a, **kw)
        if got:
            _check_acquire(self._spec, id(self._real))
            _stack().append((self._spec, id(self._real)))
        return got

    def release(self, *a, **kw):
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][1] == id(self._real):
                del st[i]
                break
        return self._real.release(*a, **kw)

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()
        return False

    # threading.Condition(wrapped_rlock) support: wait() bypasses the
    # proxy on purpose — a blocked waiter holds nothing it can deadlock
    # on, and it re-enters through _acquire_restore with its stack entry
    # still in place (same instance => re-entry is never edge-checked).
    def _release_save(self):
        return self._real._release_save()

    def _acquire_restore(self, state):
        return self._real._acquire_restore(state)

    def _is_owned(self):
        return self._real._is_owned()

    def __getattr__(self, name):
        return getattr(self._real, name)


class _WitnessCondition(_WitnessBase):
    """Condition proxy: acquisition via ``with``/acquire is witnessed;
    wait/notify delegate to the real condition (a waiting thread is
    blocked, so its stale stack entry cannot order-check anything)."""

    def wait(self, timeout=None):
        return self._real.wait(timeout)

    def wait_for(self, predicate, timeout=None):
        return self._real.wait_for(predicate, timeout)

    def notify(self, n=1):
        return self._real.notify(n)

    def notify_all(self):
        return self._real.notify_all()


def witness_lock(name: str, lock):
    """Wrap ``lock`` as registry entry ``name`` when the witness is on;
    return it untouched (zero overhead, identical type) otherwise."""
    if not _witness_on:
        return lock
    return _WitnessBase(SPEC[name], lock)


def witness_condition(name: str, cond):
    """Condition counterpart of ``witness_lock``."""
    if not _witness_on:
        return cond
    return _WitnessCondition(SPEC[name], cond)


def witness_report() -> dict:
    """Violations + distinct observed edges since the last reset."""
    with _global:
        return {"enabled": _witness_on,
                "violations": [dict(v) for v in violations],
                "edges": sorted(edges_seen)}


def assert_clean() -> dict:
    """Raise if the witness recorded any ordering violation; returns
    the report otherwise (drills call this at exit)."""
    rep = witness_report()
    if rep["violations"]:
        lines = [f"[{v['kind']}] {v['detail']} (thread {v['thread']})"
                 for v in rep["violations"]]
        raise AssertionError(
            "lock-order witness recorded %d violation(s):\n%s"
            % (len(lines), "\n".join(lines)))
    return rep
