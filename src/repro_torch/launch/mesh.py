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
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

# Slots of a CPU service's ``model_parallel`` pool: the 8 host devices
# the reference's tests force (``tests/conftest.py::SPMD_HOST_DEVICES``),
# so a CPU service and the reference pick the same mesh shape.
CPU_POOL_SLOTS = 8


class Mesh:
    """A grid of ``torch.device`` slots with named axes.  ``devices`` is
    a NumPy object array (``.shape``, ``.size``, ``.flat``), as the
    reference's ``jax.sharding.Mesh.devices`` is, so ``core/spmd.py``
    reads both the same way."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        grid = np.vectorize(torch.device, otypes=[object])(
            np.array(devices, dtype=object))
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d grid needs {grid.ndim} axis "
                             f"names, got {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """Axis name -> width, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        shape = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names,
                                                      self.devices.shape))
        return f"Mesh({shape}; {sorted({str(d) for d in self.devices.flat})})"


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
    """A (data, model) mesh over ``devices`` (default: every visible card;
    without CUDA that raises ``RuntimeError``, as ``resolve_device``
    does).  A slot may repeat a device: ``["cuda:0"] * 4`` on one card,
    ``["cpu"] * 8`` in the tests.

    ``n`` uses only the first n slots (a submesh of the pool); ``model``
    pins the model-axis width; ``shape`` bypasses the selection policy
    entirely.  Defaults to all slots with the ``host_mesh_shape`` policy.
    """
    if devices is None:
        resolve_device(None)
        devs = visible_cards()
    else:
        devs = [torch.device(d) for d in devices]
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
