"""The port's own entries in the lock-order registry.

``concurrency.py`` is a verbatim copy of the reference's, so its
``LOCK_ORDER`` names only the reference's locks.  A lock that only the
port takes is declared here as a ``LockSpec`` of the same registry
(:data:`PORT_LOCK_ORDER`) and registered in ``concurrency.SPEC`` and
``RANK`` when this module is imported, so :func:`witness_lock` wraps it
under its spec and the runtime witness (``REPRO_LOCK_WITNESS=1``)
order-checks it like any other.  The static passes of
``tools/analysis`` see it when run with
``AnalysisConfig(specs=LOCK_ORDER + PORT_LOCK_ORDER)``.
"""
from __future__ import annotations

from . import concurrency as conc

PORT_LOCK_ORDER: tuple[conc.LockSpec, ...] = (
    conc.LockSpec("dfg._cache_lock", 97, "lock",
                  (("dfg", "_cache_lock"),), leaf=True,
                  doc="The DFG engine's plan cache (lookup, insert, LRU "
                      "eviction): the serving runtime's scheduler and "
                      "immediate-pool threads may run one engine at "
                      "once.  Plans are built under it; nothing else is "
                      "acquired."),
)

for _spec in PORT_LOCK_ORDER:
    conc.SPEC.setdefault(_spec.name, _spec)
    conc.RANK.setdefault(_spec.name, _spec.rank)

witness_lock = conc.witness_lock
