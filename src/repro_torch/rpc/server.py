"""CSSD-side RPC dispatcher: deserializes RoP packets, invokes service
handlers (Table 1), serializes the reply.

Copy of ``repro/rpc/server.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

Only ``type: message`` data crosses RoP, so device-side faults ship a
formatted traceback string in the error reply (debuggability of
scheduler-side failures), and per-method accounting is a bounded rolling
window (``MethodStats``) instead of an unbounded log — sustained serving
traffic must not grow device memory.  The rolling stats are surfaced to
hosts through the ``stats`` RPC (injected into the service's reply dict).
"""
from __future__ import annotations

import time
import traceback
from collections import deque
from dataclasses import dataclass, field

from .transport import serialize, deserialize

_RECENT_WINDOW = 128            # per-method rolling sample count


@dataclass
class MethodStats:
    """Bounded per-method call accounting: totals + a recent-window sample."""
    calls: int = 0
    errors: int = 0
    total_s: float = 0.0
    recent_s: deque = field(
        default_factory=lambda: deque(maxlen=_RECENT_WINDOW))

    def record(self, secs: float, ok: bool) -> None:
        self.calls += 1
        self.total_s += secs
        self.recent_s.append(secs)
        if not ok:
            self.errors += 1

    def snapshot(self) -> dict:
        rec = list(self.recent_s)
        return {"calls": self.calls, "errors": self.errors,
                "total_s": self.total_s,
                "recent_n": len(rec),
                "recent_mean_s": sum(rec) / len(rec) if rec else 0.0,
                "recent_max_s": max(rec) if rec else 0.0}


class RPCServer:
    def __init__(self, service):
        self.service = service
        self.method_stats: dict[str, MethodStats] = {}

    def handle(self, packet: bytes) -> bytes:
        req = deserialize(packet)
        return serialize(self.dispatch(req["method"], req.get("kwargs", {})))

    def dispatch(self, method: str, kwargs: dict) -> dict:
        """Invoke a handler and build the reply dict.

        Shared with the serving runtime, which routes ``run`` commands into
        the continuous batcher instead but uses this path for everything
        else (mutations, unit queries, stats).
        """
        t0 = time.perf_counter()
        fn = getattr(self.service, method, None)
        if fn is None:
            resp = {"ok": False, "error": f"no such RPC {method!r}"}
        else:
            try:
                resp = {"ok": True, "result": fn(**kwargs)}
            except Exception as e:  # noqa: BLE001 — fault surfaced to client
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()}
                # typed shedding (BackpressureError / AdmissionError)
                # carries its reason dict to the client, so callers can
                # tell overload from fault without parsing the message
                reason = getattr(e, "reason", None)
                if isinstance(reason, dict):
                    resp["reason"] = dict(reason)
        self.method_stats.setdefault(method, MethodStats()) \
            .record(time.perf_counter() - t0, resp["ok"])
        if method == "stats" and resp["ok"] and isinstance(resp["result"], dict):
            resp["result"]["rpc"] = self.stats_snapshot()
        return resp

    def stats_snapshot(self) -> dict:
        return {m: s.snapshot() for m, s in sorted(self.method_stats.items())}
