"""Several processes that train one mesh: the multi-host entry.

Counterpart of the reference's pod entry (``repro/launch/train.py``:
``jax.distributed.initialize()`` when ``JAX_COORDINATOR`` is set).  A
process group makes one mesh of every process's local slots
(``launch/mesh.py::make_host_mesh``, processes stacked along the data
axis, so a model row never crosses a process); every process walks the
same meshed train step (``train/trainer.py::ProcStep``), runs only its
own slots' work and meets the other end of each move between processes
in one global order.

:func:`init` reads the environment torchrun sets, or the reference's
gate:

* ``JAX_COORDINATOR`` (``host:port``): the group meets there
  (``tcp://host:port``);
* otherwise ``MASTER_ADDR`` and ``MASTER_PORT`` (torchrun's rendezvous,
  ``env://``), with ``WORLD_SIZE`` > 1;
* ``RANK`` and ``WORLD_SIZE``: this process's rank and the group's size
  (required either way);
* ``LOCAL_RANK`` (default ``RANK``): the card a CUDA process drives is
  ``LOCAL_RANK`` modulo the visible cards.

The transport is gloo: a tensor goes as a small header (dtype and
shape), then its bytes; a CUDA tensor is staged through pinned host
memory, since gloo's ``send``/``recv`` take CPU tensors (and two ranks
on one card cannot form an NCCL communicator).  A failed
``init_process_group`` raises; nothing falls back to one process.
"""
from __future__ import annotations

import datetime
import math
import os
import time

import torch
import torch.distributed as dist

# a header: the dtype's index in DTYPES, the number of dims, then the
# dims (up to 8)
HEADER = 10
DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
          torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
          torch.bool)
_current: "Group | None" = None


def requested(env=None) -> bool:
    """Whether the environment asks for a process group:
    ``JAX_COORDINATOR`` set, or ``WORLD_SIZE`` above 1."""
    env = os.environ if env is None else env
    return "JAX_COORDINATOR" in env or int(env.get("WORLD_SIZE", "1")) > 1


def settings(env=None) -> dict:
    """(init_method, rank, world_size, local_rank) that :func:`init`
    takes from ``env`` (see the module docstring); raises ``KeyError``
    naming a variable that is missing."""
    env = os.environ if env is None else env
    for name in ("RANK", "WORLD_SIZE"):
        if name not in env:
            raise KeyError(f"a process group needs {name} in the "
                           "environment (torchrun sets it)")
    coord = env.get("JAX_COORDINATOR")
    rank = int(env["RANK"])
    return {"init_method": f"tcp://{coord}" if coord else "env://",
            "rank": rank, "world_size": int(env["WORLD_SIZE"]),
            "local_rank": int(env.get("LOCAL_RANK", rank))}


class Group:
    """This process's place in the group (``rank`` of ``size``), its
    ``device`` (its card, or the CPU) and the transport between ranks.
    ``moved`` counts the bytes this process sent and received and the
    seconds spent inside ``send`` and ``recv`` (waiting for the peer
    included)."""

    def __init__(self, rank: int, size: int, device: torch.device):
        self.rank, self.size, self.device = rank, size, device
        self._staging = None
        self.moved = {"sent": 0, "received": 0, "seconds": 0.0}

    def _stage(self, nbytes: int) -> torch.Tensor:
        """A pinned host buffer of at least ``nbytes`` (grown, kept)."""
        if self._staging is None or self._staging.numel() < nbytes:
            self._staging = torch.empty(max(nbytes, 1 << 20),
                                        dtype=torch.uint8, pin_memory=True)
        return self._staging[:nbytes]

    def send(self, t: torch.Tensor, dst: int) -> None:
        """``t`` to rank ``dst``: its header, then its bytes."""
        t0 = time.perf_counter()
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"rank {self.rank} has no tensor to send to "
                            f"rank {dst}: {t!r}")
        if t.dim() > HEADER - 2:
            raise ValueError(f"a {t.dim()}-d tensor does not fit a header")
        head = torch.zeros(HEADER, dtype=torch.int64)
        head[0] = DTYPES.index(t.dtype)
        head[1] = t.dim()
        head[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
        dist.send(head, dst)
        if t.numel():
            data = t.detach().contiguous().reshape(-1).view(torch.uint8)
            if data.device.type != "cpu":
                data = self._stage(data.numel()).copy_(data)
            dist.send(data, dst)
            self.moved["sent"] += data.numel()
        self.moved["seconds"] += time.perf_counter() - t0

    def recv(self, src: int, device: torch.device,
             out: torch.Tensor | None = None) -> torch.Tensor:
        """The next tensor rank ``src`` sends this rank, on ``device``
        (copied into ``out`` where one is given)."""
        t0 = time.perf_counter()
        head = torch.empty(HEADER, dtype=torch.int64)
        dist.recv(head, src)
        dtype = DTYPES[int(head[0])]
        shape = tuple(int(n) for n in head[2:2 + int(head[1])])
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        device = torch.device(device)
        if device.type == "cpu":
            data = torch.empty(nbytes, dtype=torch.uint8)
        else:
            data = self._stage(nbytes)
        if nbytes:
            dist.recv(data, src)
        t = data.view(dtype).reshape(shape)
        t = out.copy_(t) if out is not None else t.to(device)
        self.moved["received"] += nbytes
        self.moved["seconds"] += time.perf_counter() - t0
        return t

    def broadcast(self, values: list[float], src: int) -> list[float]:
        """``values`` (a list of the same length on every rank) as rank
        ``src`` holds them, in float64."""
        t = torch.tensor(values, dtype=torch.float64)
        dist.broadcast(t, src)
        return t.tolist()

    def all_gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        dist.barrier()


def current() -> Group | None:
    """The group :func:`init` made, or None (one process)."""
    return _current


def init(device=None, *, env=None, rank: int | None = None,
         world_size: int | None = None, init_method: str | None = None,
         timeout_s: float | None = None) -> Group:
    """Join the process group (gloo) and return this process's
    :class:`Group`: ``rank``, ``world_size`` and ``init_method`` given,
    or read from ``env`` (:func:`settings`).  ``device`` ``"cpu"`` makes
    a CPU process; otherwise it drives the card ``LOCAL_RANK`` modulo the
    visible cards (``resolve_device``: raises without CUDA).  Raises
    where a group is up already, or where ``init_process_group`` fails."""
    global _current
    from ..device import resolve_device
    if _current is not None or dist.is_initialized():
        raise RuntimeError("a process group is up already in this process")
    dev = resolve_device(device)
    local = rank
    if rank is None or world_size is None or init_method is None:
        s = settings(env)
        rank = s["rank"] if rank is None else rank
        world_size = s["world_size"] if world_size is None else world_size
        init_method = init_method or s["init_method"]
        local = s["local_rank"]
    if dev.type == "cuda":
        dev = torch.device("cuda", (local or 0) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    _current = Group(rank, world_size, dev)
    return _current


def close() -> None:
    """Leave the group (destroy it); a no-op without one."""
    global _current
    if _current is None:
        return
    _current = None
    dist.destroy_process_group()
