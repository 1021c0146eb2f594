"""Page-granular block device — the simulated SSD under GraphStore.

Copy of ``repro/store/blockdev.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

The paper's CSSD exposes a 4 TB NVMe SSD to the FPGA through an internal
PCIe switch; GraphStore addresses it with logical page numbers (LPNs) at
4 KB flash-page granularity.  Here the device is a growable pool of 4 KB
pages backed by numpy.  Two address spaces mirror Figure 7 of the paper:

  * the *neighbor space* grows from LPN 0 upward (adjacency pages),
  * the *embedding space* grows from the top of the device downward
    (sequential embedding table, no page-level mapping needed).

The device records per-operation byte counters and timestamped I/O events
so benchmarks can reconstruct bandwidth timelines (paper Fig. 18c) and
write-amplification stats.  The event log is a bounded ring by default —
sustained serving traffic must not grow device memory (same argument as
the RPC server's rolling per-method stats); benchmarks that reconstruct
full timelines opt into an unbounded trace with ``trace_events=True``.

Two array-scale behaviours live at this layer:

  * **fault flag** — ``fail()`` marks the device dead; every subsequent
    command (read/write/alloc) raises ``DeviceFailedError``.  The
    replicated coordinator's replica selection excludes failed shards and
    its failover retry re-plans any fetch already in flight against one;
  * **busy-until command serialization** — simulated latency is arbitrated
    through a per-device ``busy_until`` deadline, so two commands issued
    concurrently against ONE device queue behind each other (a device has
    one command pipeline), while commands on different devices of an array
    still overlap.  Previously each caller slept independently, silently
    granting a single device unbounded command concurrency.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..concurrency import witness_lock

PAGE_BYTES = 4096
SLOT_DTYPE = np.int32
SLOTS_PER_PAGE = PAGE_BYTES // 4  # 1024 int32 slots

EVENTS_CAP = 4096                 # default I/O event ring size


class DeviceFailedError(RuntimeError):
    """A command was issued against a failed device."""


@dataclass
class IOEvent:
    t: float          # seconds since device creation
    kind: str         # 'read' | 'write'
    lpn: int
    nbytes: int
    tag: str          # e.g. 'graph', 'embed', 'meta'


@dataclass
class IOStats:
    read_pages: int = 0
    written_pages: int = 0
    read_bytes: int = 0
    written_bytes: int = 0
    # bounded ring: an append-only list would grow without limit under the
    # serving runtime; ``BlockDevice(trace_events=True)`` swaps in an
    # unbounded deque for benchmarks that need the full trace
    events: deque = field(default_factory=lambda: deque(maxlen=EVENTS_CAP))

    def record(self, kind: str, lpn: int, nbytes: int, tag: str, t0: float):
        if kind == "read":
            self.read_pages += 1
            self.read_bytes += nbytes
        else:
            self.written_pages += 1
            self.written_bytes += nbytes
        self.events.append(IOEvent(time.perf_counter() - t0, kind, lpn, nbytes, tag))


def sleep_us(us: float) -> None:
    """Wall-clock wait of ``us`` microseconds (simulated device time).

    Millisecond-plus waits use ``time.sleep``; sub-millisecond waits spin
    on the monotonic clock (sleep() has a multi-10µs scheduler floor that
    would swamp the simulated page latency with host noise), yielding the
    GIL at every probe (sleep(0) = sched_yield) so commands in flight on
    OTHER simulated devices — the shards of a CSSD array — burn their
    flash time concurrently instead of serializing behind the interpreter
    lock.
    """
    if us <= 0:
        return
    if us >= 1000.0:
        time.sleep(us * 1e-6)
    else:
        end = time.perf_counter() + us * 1e-6
        while time.perf_counter() < end:
            time.sleep(0)


class _LatencyAccount:
    """Deferred simulated-latency accumulator (see ``defer_latency``)."""
    __slots__ = ("us",)

    def __init__(self):
        self.us = 0.0


class _DeferCtx:
    __slots__ = ("dev", "acct")

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self) -> _LatencyAccount:
        self.acct = _LatencyAccount()
        self.dev._defer.acct = self.acct
        return self.acct

    def __exit__(self, *exc):
        self.dev._defer.acct = None
        return False


class BlockDevice:
    """Growable array of 4 KB pages with front/back allocation.

    ``write_page``/``read_page`` move whole pages (flash access granularity);
    GraphStore's layouts are designed so that mutable graph updates touch a
    single page (the paper's write-amplification argument).
    """

    def __init__(self, num_pages: int = 1 << 14, *, simulate_latency: bool = False,
                 page_read_us: float = 0.0, page_write_us: float = 0.0,
                 command_latency_us: float = 0.0, trace_events: bool = False):
        self._pages = np.zeros((num_pages, SLOTS_PER_PAGE), dtype=SLOT_DTYPE)
        self._front = 0                 # next free LPN in neighbor space
        self._back = num_pages          # one past last used LPN in embedding space
        self._free: list[int] = []      # recycled neighbor-space pages
        self._lock = witness_lock("blockdev._lock", threading.Lock())
        self._t0 = time.perf_counter()
        self.stats = IOStats()
        if trace_events:
            self.stats.events = deque()        # unbounded full trace
        self.simulate_latency = simulate_latency
        self.page_read_us = page_read_us
        self.page_write_us = page_write_us
        # fixed per-command round-trip (NVMe submission/completion + flash
        # access setup): the cost that BATCHED commands amortise — one
        # read_pages(n) pays it once, n read_page calls pay it n times.
        self.command_latency_us = command_latency_us
        # internal flash channels: a single queued multi-page command streams
        # from all channels at once; serial single-page commands cannot.
        self.channels = 8
        # write observer: called as on_write(lpn0, n_pages) for every page
        # write/free (and with the whole device span on _grow relocation) —
        # the device-DRAM page cache hooks its invalidation here.
        self.on_write = None
        # growth observer: called as on_grow(extra_pages) after ``_grow``
        # relocates the embedding space to the new device top — holders of
        # embedding-space base LPNs (GraphStore._emb_base) shift by the
        # same amount or they silently read the zeroed old location.
        self.on_grow = None
        # per-thread deferred-latency slot (see defer_latency)
        self._defer = threading.local()
        # busy-until command arbitration: one command pipeline per device
        self._busy_lock = witness_lock(
            "blockdev._busy_lock", threading.Lock())
        self._busy_until = 0.0
        self.failed = False

    # ------------------------------------------------------------------ fault
    def fail(self) -> None:
        """Fail the device: every later command raises ``DeviceFailedError``.

        The data pages are NOT cleared — a failed device's content is simply
        unreachable, exactly what a replicated array must survive.
        """
        self.failed = True

    def _check_alive(self) -> None:
        if self.failed:
            raise DeviceFailedError("command issued against a failed device")

    def defer_latency(self):
        """Context manager: accumulate this thread's simulated latency on
        this device instead of sleeping, yielding the accumulator.

        The sharded coordinator wraps each shard's fetch in this and then
        pays ONE ``sleep_us(max(per-shard totals))`` — the devices of an
        array run their commands concurrently, exactly as the flash
        channels inside one device do (whose parallelism is modelled the
        same analytic way).  Thread-local, so a mutation landing from
        another thread mid-fetch still pays its own latency inline.
        """
        return _DeferCtx(self)

    # ------------------------------------------------------------------ alloc
    @property
    def num_pages(self) -> int:
        return self._pages.shape[0]

    def _grow(self, min_extra: int) -> list:
        """Grow the page array (caller holds ``_lock``).  Returns the
        observer callbacks to fire AFTER the lock is released — arbitrary
        hook code (the page cache, the store's base-LPN shift) must not
        run under the device allocator lock."""
        old = self._pages
        extra = max(min_extra, old.shape[0])
        grown = np.zeros((old.shape[0] + extra, SLOTS_PER_PAGE), dtype=SLOT_DTYPE)
        grown[: old.shape[0]] = old
        # embedding space lives at the top: relocate it.
        back_len = old.shape[0] - self._back
        if back_len:
            grown[-back_len:] = old[self._back:]
            grown[self._back: old.shape[0]] = 0
        self._back = grown.shape[0] - back_len
        self._pages = grown
        hooks = []
        if self.on_grow is not None:           # embedding LPNs shifted up
            hooks.append((self.on_grow, (extra,)))
        if self.on_write is not None:          # embedding span relocated:
            hooks.append((self.on_write,       # every cached LPN is stale
                          (0, grown.shape[0])))
        return hooks

    @staticmethod
    def _fire(hooks: list) -> None:
        for fn, args in hooks:
            fn(*args)

    def alloc_front(self) -> int:
        """Allocate one page in the neighbor space (graph pages)."""
        self._check_alive()
        hooks: list = []
        with self._lock:
            if self._free:
                return self._free.pop()
            if self._front >= self._back:
                hooks = self._grow(1)
            lpn = self._front
            self._front += 1
        self._fire(hooks)
        return lpn

    def alloc_back(self, n: int) -> int:
        """Allocate ``n`` contiguous pages at the top (embedding space).

        Returns the first LPN of the span (ascending order within the span).
        """
        self._check_alive()
        hooks: list = []
        with self._lock:
            if self._back - n < self._front:
                hooks = self._grow(n)
            self._back -= n
            base = self._back
        self._fire(hooks)
        return base

    def free_page(self, lpn: int) -> None:
        self._check_alive()
        with self._lock:
            self._free.append(lpn)
        if self.on_write is not None:
            self.on_write(lpn, 1)

    # -------------------------------------------------------------------- i/o
    def _maybe_sleep(self, us: float):
        if self.simulate_latency and us > 0:
            acct = getattr(self._defer, "acct", None)
            if acct is not None:
                acct.us += us                 # deferred: coordinator pays
                return
            # busy-until queue model: a device executes ONE command stream.
            # The command starts when the device frees up (queueing delay)
            # and holds it for its service time; concurrent callers on this
            # device serialize, callers on other devices overlap.
            with self._busy_lock:
                now = time.perf_counter()
                start = self._busy_until if self._busy_until > now else now
                self._busy_until = start + us * 1e-6
                end = self._busy_until
            sleep_us((end - now) * 1e6)

    def write_page(self, lpn: int, data: np.ndarray, *, tag: str = "graph") -> None:
        assert data.dtype == SLOT_DTYPE and data.shape == (SLOTS_PER_PAGE,)
        self._check_alive()
        self._maybe_sleep(self.command_latency_us + self.page_write_us)
        self._pages[lpn] = data
        self.stats.record("write", lpn, PAGE_BYTES, tag, self._t0)
        if self.on_write is not None:
            self.on_write(lpn, 1)

    def write_span(self, lpn0: int, flat: np.ndarray, *, tag: str = "embed") -> None:
        """Bulk sequential write of ``flat`` (int32) starting at page lpn0.

        Stats are span-granular (one event) — per-page Python bookkeeping
        would dwarf the simulated DMA itself.
        """
        n_pages = -(-flat.size // SLOTS_PER_PAGE)
        self._check_alive()
        self._maybe_sleep(self.command_latency_us
                          + self.page_write_us * n_pages / self.channels)
        full = flat.size // SLOTS_PER_PAGE
        if full:
            self._pages[lpn0: lpn0 + full] = \
                flat[: full * SLOTS_PER_PAGE].reshape(full, SLOTS_PER_PAGE)
        rem = flat.size - full * SLOTS_PER_PAGE
        if rem:
            self._pages[lpn0 + full, :rem] = flat[full * SLOTS_PER_PAGE:]
            self._pages[lpn0 + full, rem:] = 0
        self.stats.written_pages += n_pages
        self.stats.written_bytes += n_pages * PAGE_BYTES
        self.stats.events.append(IOEvent(
            time.perf_counter() - self._t0, "write", lpn0,
            n_pages * PAGE_BYTES, tag))
        if self.on_write is not None:
            self.on_write(lpn0, n_pages)

    def read_page(self, lpn: int, *, tag: str = "graph") -> np.ndarray:
        self._check_alive()
        self._maybe_sleep(self.command_latency_us + self.page_read_us)
        self.stats.record("read", lpn, PAGE_BYTES, tag, self._t0)
        return self._pages[lpn]

    def read_pages(self, lpns, *, tag: str = "graph") -> np.ndarray:
        """Batched scattered-page read -> (len(lpns), SLOTS_PER_PAGE).

        One queued command for the whole set (NVMe queue-depth behaviour):
        the simulated latency is still per-page (``n * page_read_us``) but
        the submission overhead is paid once — this is what makes the
        near-storage batch engines (GetNeighbors/GetEmbed) fast, versus one
        ``read_page`` round-trip per page.
        """
        lpns = np.asarray(lpns, dtype=np.int64)
        self._check_alive()
        self._maybe_sleep(self.command_latency_us
                          + self.page_read_us * len(lpns) / self.channels)
        self.stats.read_pages += len(lpns)
        self.stats.read_bytes += len(lpns) * PAGE_BYTES
        self.stats.events.append(IOEvent(
            time.perf_counter() - self._t0, "read",
            int(lpns[0]) if len(lpns) else 0, len(lpns) * PAGE_BYTES, tag))
        return self._pages[lpns]

    def read_span(self, lpn0: int, n_pages: int, *, tag: str = "embed") -> np.ndarray:
        self._check_alive()
        self._maybe_sleep(self.command_latency_us
                          + self.page_read_us * n_pages / self.channels)
        self.stats.read_pages += n_pages
        self.stats.read_bytes += n_pages * PAGE_BYTES
        self.stats.events.append(IOEvent(
            time.perf_counter() - self._t0, "read", lpn0,
            n_pages * PAGE_BYTES, tag))
        return self._pages[lpn0: lpn0 + n_pages].reshape(-1)
