"""Pluggable placement maps for the sharded CSSD array.

Copy of ``repro/store/placement.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

Placement answers one question: *which shard owns replica ``r`` of vid
``v``?*  The legacy answer — shard ``(v + r) % N`` — is hard-coded
modular arithmetic, which is cheap but blind to skew: a hot community
hashed onto one shard stays there forever, and growing the array means
reloading everything because every vid's owner changes.

``PlacementMap`` keeps the cheap part (the *class* of a vid is still
``v % C`` for a fixed class count ``C``) and makes the expensive part a
lookup table: an ``owner`` array of shape ``(C, R)`` mapping each
(class, role) to a shard.  That factoring has three properties the
resharding engine needs:

* **Legacy-compatible** — ``modular(N, R)`` reproduces ``(c + r) % N``
  exactly, so default arrays keep bit-identical page layouts.
* **Refinable** — ``refine(k)`` multiplies ``C`` by ``k`` without moving
  any data (class ``c`` splits into ``{c + j*C}``, all owned by the same
  shards), so a grow from 4 to 5 shards only needs ``C`` divisible by 5,
  not a full re-hash.
* **Delta-friendly** — two maps over the same ``C`` diff into an explicit
  move list (:func:`plan_moves`), which is exactly the unit of work the
  online migration streams shard-to-shard.

Planners (:func:`grow_plan`, :func:`shrink_plan`, :func:`heat_plan`)
produce target maps from the gossiped read-counter heat snapshot; the
coordinator (``ShardedGraphStore.reshard``) turns the diff into paced
page copies and atomic per-class routing flips.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = [
    "PlacementMap", "modular", "rows_of_class", "common_refine",
    "plan_moves", "grow_plan", "shrink_plan", "heat_plan", "Move",
]


def rows_of_class(n_rows: int, cls: int, n_classes: int) -> int:
    """Number of embedding rows whose vid ≡ ``cls`` (mod ``n_classes``)."""
    if n_rows <= cls:
        return 0
    return (n_rows - cls + n_classes - 1) // n_classes


@dataclass(frozen=True)
class PlacementMap:
    """Class-granular (class, role) → shard ownership table.

    Args:
        n_classes: class count ``C``; the class of vid ``v`` is ``v % C``.
        owner: int64 array of shape ``(C, R)``; ``owner[c, r]`` is the
            shard holding replica ``r`` of every vid in class ``c``.
            Shards within one row must be distinct (replicas of a class
            never share a device).
    """

    n_classes: int
    owner: np.ndarray

    def __post_init__(self):
        o = np.ascontiguousarray(np.asarray(self.owner, dtype=np.int64))
        if o.ndim != 2 or o.shape[0] != self.n_classes:
            raise ValueError(f"owner must be ({self.n_classes}, R), "
                             f"got {o.shape}")
        object.__setattr__(self, "owner", o)

    # ------------------------------------------------------------ properties
    @property
    def replication(self) -> int:
        """Replica count ``R`` (second dimension of ``owner``)."""
        return int(self.owner.shape[1])

    # ------------------------------------------------------------ validation
    def validate(self, n_shards: int) -> None:
        """Raise ``ValueError`` unless the map is total and well-formed
        for an array of ``n_shards`` devices (owners in range, replicas
        of each class on distinct shards)."""
        o = self.owner
        if o.size and (o.min() < 0 or o.max() >= n_shards):
            raise ValueError(
                f"placement owners out of range [0, {n_shards})")
        for c in range(self.n_classes):
            row = o[c]
            if len(set(int(s) for s in row)) != len(row):
                raise ValueError(
                    f"class {c}: replicas share a shard ({row.tolist()})")

    def is_modular(self, n_shards: int) -> bool:
        """True iff this map is exactly the legacy ``(c + r) % N`` layout
        (the case where page layouts stay bit-identical to the seed)."""
        if self.n_classes != n_shards:
            return False
        c = np.arange(self.n_classes, dtype=np.int64)[:, None]
        r = np.arange(self.replication, dtype=np.int64)[None, :]
        return bool(np.array_equal(self.owner, (c + r) % n_shards))

    # ------------------------------------------------------------- lookups
    def classes_of(self, shard: int) -> list[int]:
        """Sorted classes for which ``shard`` holds any replica."""
        return sorted(int(c) for c in
                      np.nonzero((self.owner == shard).any(axis=1))[0])

    def pairs_of(self, shard: int) -> list[tuple[int, int]]:
        """Canonical stripe order of ``shard``: (class, role) pairs,
        role-major then class-ascending.  This is the on-device
        embedding stripe order after a bulk load or full rebuild; at the
        default modular map it equals the legacy role-major striping."""
        out = []
        for r in range(self.replication):
            for c in np.nonzero(self.owner[:, r] == shard)[0]:
                out.append((int(c), r))
        return out

    # ----------------------------------------------------------- refinement
    def refine(self, k: int) -> "PlacementMap":
        """Split every class into ``k`` finer classes without moving data:
        class ``c`` becomes ``{c + j*C : j < k}``, same owner row.  The
        class of any vid under the fine map is consistent with the coarse
        map (``v % kC ≡ v % C (mod C)``), so existing on-device layouts
        and extents remain valid."""
        if k < 1:
            raise ValueError("refine factor must be >= 1")
        if k == 1:
            return self
        return PlacementMap(self.n_classes * k, np.tile(self.owner, (k, 1)))

    # ---------------------------------------------------------------- wire
    def to_payload(self) -> dict:
        """Wire form for RPCs (``ingest_begin(placement=...)``)."""
        return {"n_classes": int(self.n_classes), "owner": self.owner}

    @staticmethod
    def from_payload(payload: dict) -> "PlacementMap":
        """Rebuild a map from its ``to_payload`` wire form."""
        return PlacementMap(int(payload["n_classes"]),
                            np.asarray(payload["owner"], dtype=np.int64))

    def __eq__(self, other) -> bool:
        return (isinstance(other, PlacementMap)
                and self.n_classes == other.n_classes
                and np.array_equal(self.owner, other.owner))

    def __hash__(self):
        return hash((self.n_classes, self.owner.tobytes()))


def modular(n_shards: int, replication: int = 1) -> PlacementMap:
    """The legacy layout: replica ``r`` of class ``c`` on ``(c+r) % N``."""
    c = np.arange(n_shards, dtype=np.int64)[:, None]
    r = np.arange(replication, dtype=np.int64)[None, :]
    return PlacementMap(n_shards, (c + r) % n_shards)


def common_refine(a: PlacementMap, b: PlacementMap
                  ) -> tuple[PlacementMap, PlacementMap]:
    """Refine both maps to their least common class count so their owner
    tables are directly comparable (same replication required)."""
    if a.replication != b.replication:
        raise ValueError("placement maps differ in replication")
    lcm = math.lcm(a.n_classes, b.n_classes)
    return a.refine(lcm // a.n_classes), b.refine(lcm // b.n_classes)


@dataclass(frozen=True)
class Move:
    """One unit of migration work produced by :func:`plan_moves`.

    ``kind`` is ``"copy"`` (pages must ship from ``src`` to ``dst``) or
    ``"relabel"`` (``dst`` already holds the class as role ``src_role``;
    only the coordinator's extent metadata changes, no bytes move).
    """

    cls: int
    role: int
    src: int            # old owner of (cls, role)
    dst: int            # new owner of (cls, role)
    kind: str           # "copy" | "relabel"
    src_role: int = -1  # for relabel: role under which dst already holds cls


def plan_moves(old: PlacementMap, new: PlacementMap
               ) -> tuple[list[Move], dict[int, list[int]]]:
    """Diff two same-``C`` maps into (moves, drops).

    ``moves`` lists every (class, role) whose owner changes, classified
    as a real page copy or a metadata-only relabel (the new owner already
    holds the class under another role).  ``drops`` maps each shard to
    the sorted classes it no longer holds under *any* role — the pages
    it may free once the routing flip commits.
    """
    if old.n_classes != new.n_classes:
        raise ValueError("plan_moves requires equal n_classes "
                         "(use common_refine first)")
    if old.replication != new.replication:
        raise ValueError("plan_moves requires equal replication")
    moves: list[Move] = []
    drops: dict[int, list[int]] = {}
    for c in range(old.n_classes):
        o_row, n_row = old.owner[c], new.owner[c]
        o_set = set(int(s) for s in o_row)
        for r in range(old.replication):
            src, dst = int(o_row[r]), int(n_row[r])
            if src == dst:
                continue
            if dst in o_set:
                src_role = int(np.nonzero(o_row == dst)[0][0])
                moves.append(Move(c, r, src, dst, "relabel", src_role))
            else:
                moves.append(Move(c, r, src, dst, "copy"))
        for s in o_set - set(int(s) for s in n_row):
            drops.setdefault(s, []).append(c)
    for s in drops:
        drops[s].sort()
    return moves, drops


# ------------------------------------------------------------------ planners
def _refined(pmap: PlacementMap, heat: np.ndarray | None, k: int
             ) -> tuple[PlacementMap, np.ndarray]:
    """Refine a map by ``k`` and split its per-class heat to match."""
    fine = pmap.refine(k)
    if heat is None:
        h = np.ones(pmap.n_classes, dtype=np.float64)
    else:
        h = np.asarray(heat, dtype=np.float64).copy()
        if len(h) != pmap.n_classes:
            raise ValueError("heat length != n_classes")
    if h.sum() <= 0:
        h = np.ones_like(h)
    return fine, np.tile(h / k, k)


def _loads(pmap: PlacementMap, heat: np.ndarray, n_shards: int) -> np.ndarray:
    """Per-shard role-0 heat (the primary-read load proxy)."""
    out = np.zeros(n_shards, dtype=np.float64)
    np.add.at(out, pmap.owner[:, 0], heat)
    return out


def grow_plan(pmap: PlacementMap, n_old: int, n_new: int,
              heat: np.ndarray | None = None) -> PlacementMap:
    """Target map for growing the array from ``n_old`` to ``n_new`` shards.

    Refines so the class count divides evenly across ``n_new``, then
    greedily hands each new shard its fair share of role-0 classes,
    always stealing the hottest class from the currently most-loaded
    old shard.  Replica roles > 0 stay put (new shards start as
    primaries only; a later ``heat_plan`` pass can rebalance replicas).

    Returns the new :class:`PlacementMap`; diff it against the refined
    source with :func:`plan_moves`.
    """
    if n_new <= n_old:
        raise ValueError("grow_plan needs n_new > n_old")
    f = n_new // math.gcd(pmap.n_classes, n_new)
    fine, h = _refined(pmap, heat, f)
    owner = fine.owner.copy()
    loads = _loads(fine, h, n_new)
    per_new = fine.n_classes // n_new
    moved: set[int] = set()
    for s_new in range(n_old, n_new):
        for _ in range(per_new):
            # steal the hottest movable class from the most-loaded shard
            order = np.argsort(-loads[:n_old], kind="stable")
            best = None
            for donor in order:
                cand = [c for c in np.nonzero(owner[:, 0] == donor)[0]
                        if c not in moved
                        and s_new not in owner[c]]
                if cand:
                    best = max(cand, key=lambda c: (h[c], -c))
                    break
            if best is None:
                break
            moved.add(int(best))
            loads[owner[best, 0]] -= h[best]
            loads[s_new] += h[best]
            owner[best, 0] = s_new
    return PlacementMap(fine.n_classes, owner)


def shrink_plan(pmap: PlacementMap, remove: list[int], n_shards: int,
                heat: np.ndarray | None = None) -> PlacementMap:
    """Target map for draining shards ``remove`` out of an ``n_shards``
    array: every (class, role) they own is reassigned to the currently
    least-loaded survivor not already holding that class.  Shard ids are
    NOT renumbered here — the reshard engine compacts indices only after
    all copies land and the drained endpoints detach.
    """
    removed = set(int(s) for s in remove)
    survivors = [s for s in range(n_shards) if s not in removed]
    if len(survivors) < pmap.replication:
        raise ValueError("not enough survivors for replication")
    f = len(survivors) // math.gcd(pmap.n_classes, len(survivors))
    fine, h = _refined(pmap, heat, f)
    owner = fine.owner.copy()
    loads = _loads(fine, h, n_shards)
    loads[list(removed)] = np.inf        # never receive
    for c in range(fine.n_classes):
        for r in range(fine.replication):
            if int(owner[c, r]) not in removed:
                continue
            row = set(int(s) for s in owner[c])
            cand = [s for s in survivors if s not in row]
            dst = min(cand, key=lambda s: (loads[s], s))
            owner[c, r] = dst
            if r == 0:
                loads[dst] += h[c]
    return PlacementMap(fine.n_classes, owner)


def heat_plan(pmap: PlacementMap, heat: np.ndarray, live: list[int],
              refine: int = 4) -> PlacementMap:
    """Heat-weighted rebalance over the live shards.

    Refines by ``refine`` (finer classes let hot coarse classes split
    across shards), then LPT-assigns role-0 classes in descending heat
    order to the least-loaded live shard, tie-breaking toward the
    current owner so cold classes don't churn.  Replica roles > 0 keep
    their owner unless it would collide with the new primary.
    """
    if not live:
        raise ValueError("heat_plan needs at least one live shard")
    fine, h = _refined(pmap, heat, max(1, refine))
    owner = fine.owner.copy()
    live_set = set(int(s) for s in live)
    loads = {s: 0.0 for s in live_set}
    for c in np.argsort(-h, kind="stable"):
        cur = int(owner[c, 0])
        others = set(int(s) for s in owner[c, 1:])
        cand = [s for s in live_set if s not in others]
        if not cand:
            continue
        dst = min(cand, key=lambda s: (loads[s], 0 if s == cur else 1, s))
        owner[c, 0] = dst
        loads[dst] += h[c]
        # replica roles: keep unless they now collide with the primary
        for r in range(1, fine.replication):
            if int(owner[c, r]) == dst:
                row = set(int(s) for s in owner[c])
                alt = [s for s in live_set if s not in row] or \
                      [s for s in live_set if s != dst and
                       s != int(owner[c, r])]
                if cur != dst and cur not in row:
                    owner[c, r] = cur
                elif alt:
                    owner[c, r] = min(alt)
    return PlacementMap(fine.n_classes, owner)
