"""Mesh construction: production meshes and host meshes of device slots.

Counterpart of ``repro/launch/mesh.py``.  The reference's mesh is a grid
of JAX devices that ``shard_map`` runs one program over; the port's is a
grid of ``torch.device`` *slots* that the SPMD engine (``core/spmd.py``)
runs its body over in one process, slot by slot in lockstep.  A slot may
repeat a device: four slots on one card are the port's counterpart of
the reference's forced host devices, and run every collective and every
slice-shaped kernel launch of a (2, 2) or (1, 4) mesh on that card.  On
a host with several cards the slots are distinct ``cuda:i`` and the
collectives become copies between cards.

``host_mesh_shape`` is the reference's pure shape-selection policy;
``make_host_mesh`` applies it to a list of slots (by default every
visible card).  Axis ``"model"`` stripes hidden/embedding dims, axis
``"data"`` stripes super-batch rows.

In a process group (``launch/procs.py``) ``make_host_mesh`` makes one
mesh of every process's pool of local slots, ordered by rank as
``jax.devices()`` orders devices by process: the processes stack along
the data axis, each process's share of the grid ``host_mesh_shape`` of
its own pool, so a model row never crosses a process.  Each slot
records its owner rank (``Mesh.ranks``); a slot of another process is
remote here, and its work runs only there (``train/sharded.py::at``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import procs

# Slots of a CPU service's ``model_parallel`` pool: the 8 host devices
# the reference's tests force (``tests/conftest.py::SPMD_HOST_DEVICES``),
# so a CPU service and the reference pick the same mesh shape.
CPU_POOL_SLOTS = 8


class Mesh:
    """A grid of ``torch.device`` slots with named axes.  ``devices`` is
    a NumPy object array (``.shape``, ``.size``, ``.flat``), as the
    reference's ``jax.sharding.Mesh.devices`` is, so ``core/spmd.py``
    reads both the same way.  ``ranks`` (the grid's shape) is each
    slot's owner process and ``group`` this process's
    ``launch/procs.py::Group``: None, every slot this process's, without
    a process group."""

    def __init__(self, devices, axis_names: tuple[str, ...], *,
                 ranks=None, group=None):
        grid = np.vectorize(torch.device, otypes=[object])(
            np.array(devices, dtype=object))
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d grid needs {grid.ndim} axis "
                             f"names, got {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.ranks = np.zeros(grid.shape, dtype=int) if ranks is None \
            else np.asarray(ranks, dtype=int).reshape(grid.shape)
        self.group = group

    def local(self, slot: int) -> bool:
        """Whether slot ``slot`` (a flat index) is this process's."""
        return self.group is None or \
            int(self.ranks.flat[slot]) == self.group.rank

    def local_slots(self) -> list[int]:
        """This process's slots, flat indices in order."""
        return [i for i in range(self.devices.size) if self.local(i)]

    @property
    def shape(self) -> dict:
        """Axis name -> width, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        shape = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names,
                                                      self.devices.shape))
        procs_ = "" if self.group is None else \
            f"; {self.group.size} processes, this one rank {self.group.rank}"
        return (f"Mesh({shape}; {sorted({str(d) for d in self.devices.flat})}"
                f"{procs_})")


def visible_cards() -> list[torch.device]:
    """Every CUDA card this process sees, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_pool(device: torch.device) -> list[torch.device]:
    """The slots ``HolisticGNNService(model_parallel=M)`` builds its mesh
    over: the visible cards for a CUDA service, ``CPU_POOL_SLOTS`` CPU
    slots for a CPU one."""
    if device.type == "cuda":
        return visible_cards()
    if device.type == "cpu":
        return [torch.device("cpu")] * CPU_POOL_SLOTS
    raise ValueError(f"no device pool for {device.type!r} services")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes over the visible cards; raises
    ``ValueError`` when fewer cards exist than the shape needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    cards = visible_cards()
    need = int(np.prod(shape))
    if len(cards) < need:
        raise ValueError(f"mesh {shape} needs {need} cards, "
                         f"{len(cards)} visible")
    grid = np.empty(need, dtype=object)
    grid[:] = cards[:need]
    return Mesh(grid.reshape(shape), axes)


def dp_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def host_mesh_shape(n: int, *, model: int | None = None) -> tuple[int, int]:
    """(data, model) shape for ``n`` devices.

    ``model=`` pins the model-axis width (it must divide ``n``).  Otherwise
    the model axis takes the largest of 4/2/1 that divides ``n`` — wide
    hidden dims benefit from model parallelism first — and the data axis
    absorbs the rest.  Deliberate odd-count handling: n=6 -> (3, 2),
    n=7 -> (7, 1), n=1 -> (1, 1); never a dropped device, never a
    non-rectangular mesh.
    """
    if n < 1:
        raise ValueError(f"need at least one device, got n={n}")
    if model is not None:
        if model < 1 or n % model != 0:
            raise ValueError(f"model={model} must divide device count {n}")
        return (n // model, model)
    for m in (4, 2, 1):
        if m <= n and n % m == 0:
            return (n // m, m)
    raise AssertionError("unreachable: 1 divides every n")


def make_host_mesh(n: int | None = None, *, model: int | None = None,
                   shape: tuple[int, int] | None = None,
                   devices=None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible card,
    or in a process group this process's card; without CUDA that raises
    ``RuntimeError``, as ``resolve_device`` does).  A slot may repeat a
    device: ``["cuda:0"] * 4`` on one card, ``["cpu"] * 8`` in the
    tests.

    ``n`` uses only the first n slots (a submesh of the pool); ``model``
    pins the model-axis width; ``shape`` bypasses the selection policy
    entirely.  Defaults to all slots with the ``host_mesh_shape`` policy.
    In a process group (``procs.current()``) ``devices`` is this
    process's pool and the mesh is every process's (see the module
    docstring): ``n`` must be None, and a ``shape`` or ``model`` whose
    model row would cross processes raises ``NotImplementedError``.
    """
    group = procs.current()
    if devices is None:
        resolve_device(None)
        devs = visible_cards() if group is None else [group.device]
    else:
        devs = [torch.device(d) for d in devices]
    if group is not None and group.size > 1:
        return _process_mesh(devs, group, n=n, model=model, shape=shape)
    if n is None:
        n = len(devs)
    if n > len(devs):
        raise ValueError(f"asked for {n} devices, only {len(devs)} exist")
    if shape is None:
        shape = host_mesh_shape(n, model=model)
    elif shape[0] * shape[1] != n:
        raise ValueError(f"shape {shape} does not cover n={n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(shape), ("data", "model"))


def _process_mesh(devs, group, *, n, model, shape) -> Mesh:
    """:func:`make_host_mesh` in a process group: every rank's pool of
    slots gathered, each rank's rows ``host_mesh_shape`` of its own pool
    (or of the model width ``shape`` or ``model`` pins), stacked along
    the data axis in rank order."""
    if group.device.type == "cuda" and any(d.type != "cuda" for d in devs):
        raise ValueError(f"a CUDA process's slots are its cards, got {devs}")
    pools = group.all_gather([str(d) for d in devs])
    sizes = [len(p) for p in pools]
    total = sum(sizes)
    if n is not None and n != total:
        raise NotImplementedError(
            f"a submesh of n={n} of a process group's {total} slots")
    if shape is not None:
        if shape[0] * shape[1] != total:
            raise ValueError(f"shape {shape} does not cover the process "
                             f"group's {total} slots")
        model = shape[1]
    if model is not None and any(s % model for s in sizes):
        raise NotImplementedError(
            f"a model row of {model} slots across processes: each process's "
            f"pool ({sizes} slots by rank) must hold whole model rows")
    widths = {host_mesh_shape(s, model=model)[1] for s in sizes}
    if len(widths) > 1:
        raise NotImplementedError(
            f"pools of {sizes} slots by rank pick model widths "
            f"{sorted(widths)}: one mesh needs one; pin it with model=")
    m = widths.pop()
    grid = np.empty(total, dtype=object)
    grid[:] = [torch.device(d) for pool in pools for d in pool]
    ranks = [r for r, s in enumerate(sizes) for _ in range(s)]
    return Mesh(grid.reshape(total // m, m), ("data", "model"), ranks=ranks,
                group=group)
