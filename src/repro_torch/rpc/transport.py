"""RPC-over-PCIe (RoP) transport simulation — paper §3.3, Fig. 5.

Copy of ``repro/rpc/transport.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

The paper tunnels gRPC through PCIe: the host driver exposes a pre-allocated
memory-mapped buffer; a PCIe command (opcode, buffer address, length) is
written to the FPGA's BAR ("doorbell"), and the device copies the packet out
of the mmap'd buffer into FPGA-internal memory.

We model exactly those mechanics in-process:

  * ``serialize``/``deserialize`` — the gRPC-core packet layer: a JSON
    metadata header plus zero-copy-concatenated raw ndarray payloads;
  * ``PCIeChannel`` — a pre-allocated bytearray "mmap buffer" per direction;
    ``push`` memcpy's the packet in (host->mmap), ``pull`` memcpy's it out
    (mmap->device SRAM), both sides record byte counts and copy times so the
    RoP overhead is measurable (benchmarks/fig19 uses it).

The format is self-contained (no pickle) and versioned.
"""
from __future__ import annotations

import json
import struct
import time
from dataclasses import dataclass, field

import numpy as np

_MAGIC = b"RoP1"


def _encode(obj, buffers: list[np.ndarray]):
    if isinstance(obj, np.ndarray):
        # harden the payload path: force contiguity (sliced / transposed /
        # negative-stride views) and ship the dtype as an unambiguous
        # byte-order-explicit string — ``str(dtype)`` of a native array is
        # a NAME ('float32'), of a byte-swapped one a SPEC ('>f4'), and
        # only ``dtype.str`` round-trips both through ``np.dtype(...)``.
        buffers.append(np.ascontiguousarray(obj))
        b = buffers[-1]
        # shape comes from the ORIGINAL array: ascontiguousarray promotes
        # 0-d arrays to 1-d, which would silently change the decoded rank
        return {"__nd__": len(buffers) - 1, "dtype": b.dtype.str,
                "shape": list(obj.shape)}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, dict):
        return {k: _encode(v, buffers) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v, buffers) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if hasattr(obj, "__array__"):                    # jax arrays etc.
        return _encode(np.asarray(obj), buffers)
    raise TypeError(f"unserializable type {type(obj)}")


def _decode(obj, buffers: list[np.ndarray]):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            arr = buffers[obj["__nd__"]]
            return arr.view(np.dtype(obj["dtype"])).reshape(obj["shape"])
        return {k: _decode(v, buffers) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, buffers) for v in obj]
    return obj


def serialize(obj) -> bytes:
    buffers: list[np.ndarray] = []
    meta = json.dumps(_encode(obj, buffers)).encode()
    parts: list = [_MAGIC, struct.pack("<II", len(meta), len(buffers)), meta]
    for b in buffers:
        parts.append(struct.pack("<Q", b.nbytes))
        # zero-copy handoff: join() reads straight out of the array
        # buffer — tobytes() would copy every payload twice.  memoryview
        # cannot cast zero-length shapes, so empty payloads ship as b"".
        parts.append(memoryview(b).cast("B") if b.nbytes else b"")
    return b"".join(parts)


def deserialize(data: bytes):
    assert data[:4] == _MAGIC, "bad RoP packet"
    meta_len, n_buf = struct.unpack_from("<II", data, 4)
    off = 12
    meta = json.loads(data[off: off + meta_len].decode())
    off += meta_len
    buffers = []
    for _ in range(n_buf):
        (ln,) = struct.unpack_from("<Q", data, off)
        off += 8
        buffers.append(np.frombuffer(data, dtype=np.uint8, count=ln, offset=off))
        off += ln
    return _decode(meta, buffers)


def check_reply(resp: dict, label: str = "RPC"):
    """Decode a reply dict: return the result, or raise with the
    device-side error (and its formatted traceback, when shipped).
    Shared by every host-side stub so the error contract lives here.
    The raised error carries the raw device error string as
    ``remote_error`` so callers that must re-raise a typed exception
    (e.g. ``DeviceFailedError`` for the array failover path) can map it
    without parsing the formatted message."""
    if resp.get("ok"):
        return resp.get("result")
    msg = f"{label} failed: {resp.get('error')}"
    if resp.get("traceback"):
        msg += "\n--- device traceback ---\n" + resp["traceback"]
    err = RuntimeError(msg)
    err.remote_error = str(resp.get("error") or "")
    raise err


@dataclass
class ChannelStats:
    packets: int = 0
    bytes_moved: int = 0
    copy_secs: float = 0.0
    serialize_secs: float = 0.0


@dataclass
class PCIeChannel:
    """One direction of the RoP link: mmap buffer + doorbell."""
    buf_size: int = 64 << 20
    stats: ChannelStats = field(default_factory=ChannelStats)

    def __post_init__(self):
        self._buf = bytearray(self.buf_size)          # pre-allocated mmap buffer
        self._len = 0
        self._doorbell = False

    def push(self, packet: bytes) -> None:
        """Host writes the packet into the mmap buffer + rings the doorbell."""
        if len(packet) > self.buf_size:
            self._buf = bytearray(len(packet))        # driver re-mmaps bigger buf
            self.buf_size = len(packet)
        t0 = time.perf_counter()
        self._buf[: len(packet)] = packet             # memcpy #1 (host->mmap)
        self._len = len(packet)
        self.stats.copy_secs += time.perf_counter() - t0
        self.stats.packets += 1
        self.stats.bytes_moved += len(packet)
        self._doorbell = True

    def pull(self) -> bytes:
        """Device parses the PCIe command and copies mmap->internal memory."""
        assert self._doorbell, "doorbell not rung"
        t0 = time.perf_counter()
        # bytes(memoryview) is ONE memcpy; bytes(bytearray[:n]) would cut
        # an intermediate bytearray first and copy the payload twice
        out = bytes(memoryview(self._buf)[: self._len])
        self.stats.copy_secs += time.perf_counter() - t0
        self._doorbell = False
        return out
