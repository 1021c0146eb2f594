"""Host-side RPC stub: serialize -> mmap copy -> doorbell -> reply.

Copy of ``repro/rpc/client.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

Both host-side stubs (this synchronous one and the multi-queue
``AsyncRPCClient``) share one error/stats contract: every reply decodes
through ``check_reply`` (typed device errors, shipped tracebacks) and
every call records into a per-method ``MethodStats`` rolling window — so
a local array endpoint and a RoP array endpoint report identically in
``stats``."""
from __future__ import annotations

import time

from .server import MethodStats
from .transport import PCIeChannel, serialize, deserialize, check_reply


class ClientStats:
    """Host-side per-method call accounting shared by every RPC stub."""

    def __init__(self):
        self.method_stats: dict[str, MethodStats] = {}

    def record(self, method: str, secs: float, ok: bool) -> None:
        self.method_stats.setdefault(method, MethodStats()) \
            .record(secs, ok)

    def stats_snapshot(self) -> dict:
        return {m: s.snapshot() for m, s in sorted(self.method_stats.items())}


class RPCClient:
    def __init__(self, server, *, tx: PCIeChannel | None = None,
                 rx: PCIeChannel | None = None):
        self.server = server
        self.tx = tx or PCIeChannel()
        self.rx = rx or PCIeChannel()
        self._stats = ClientStats()

    @property
    def method_stats(self) -> dict:
        return self._stats.method_stats

    def stats_snapshot(self) -> dict:
        return self._stats.stats_snapshot()

    def call(self, method: str, **kwargs):
        t_call = time.perf_counter()
        packet = serialize({"method": method, "kwargs": kwargs})
        self.tx.stats.serialize_secs += time.perf_counter() - t_call

        self.tx.push(packet)
        reply = self.server.handle(self.tx.pull())
        self.rx.push(reply)

        t0 = time.perf_counter()
        resp = deserialize(self.rx.pull())
        self.rx.stats.serialize_secs += time.perf_counter() - t0
        self._stats.record(method, time.perf_counter() - t_call,
                           bool(resp.get("ok")))
        return check_reply(resp, f"RPC {method}")
