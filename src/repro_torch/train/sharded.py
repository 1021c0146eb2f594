"""Tensors laid out over the slots of a mesh by a PartitionSpec.

The port's stand-in for a ``jax.Array`` with a ``NamedSharding``; it has
no counterpart file in the reference.  A :class:`Layout` is a
``launch/mesh.py::Mesh`` and a resolved spec (``models/layers.PSpec``);
:func:`lay_out` splits a tensor into one block per slot, in
``mesh.devices.flat`` order, each on its slot's device, and the result,
a :class:`Laid`, holds exactly the block that the reference's
``addressable_shards`` hold on the matching device.  :func:`gather`
puts the blocks back together (the first slot of each block in slot
order is read: replicas are equal by construction), and
:func:`relayout` lays the same tensor out under another spec.

A spec entry names the mesh axes a dim is split over, major first, as
JAX reads ``P(("pod", "data"))``; dims past the spec's end are
replicated.  A dim that the entry's axes do not divide raises
``ValueError``: the reference's own specs never ask for one (``_div``
checks it, head padding makes the model dims divisible, and
``_zero1_spec`` only picks divisible dims).

Blocks that are the same slice on the same device are one tensor, so a
spec replicated over slots of one card holds one copy there; a block of
a tensor already on its slot's device is a view of it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models import layers as L


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True, eq=False)
class Layout:
    """A mesh of slots and the spec that splits a tensor over it."""
    mesh: object
    spec: L.PSpec

    def coords(self) -> list[tuple]:
        """Each slot's coordinate on the mesh, in ``devices.flat`` order."""
        return list(np.ndindex(*self.mesh.devices.shape))

    def block_slices(self, shape, coord) -> tuple:
        """The slices of a tensor of ``shape`` that slot ``coord`` holds;
        raises ``ValueError`` where the spec does not fit the shape."""
        names = self.mesh.axis_names
        size = dict(zip(names, self.mesh.devices.shape))
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec!r} has more entries than "
                             f"the shape {tuple(shape)} has dims")
        out = []
        for dim, n in enumerate(shape):
            axes = _axes(self.spec[dim]) if dim < len(self.spec) else ()
            ways, idx = 1, 0
            for a in axes:
                ways *= size[a]
                idx = idx * size[a] + coord[names.index(a)]
            if n % ways:
                raise ValueError(f"spec {self.spec!r} splits dim {dim} of "
                                 f"{tuple(shape)} {ways} ways, which does not "
                                 "divide it")
            w = n // ways
            out.append(slice(idx * w, (idx + 1) * w))
        return tuple(out)


@dataclass(eq=False)
class Laid:
    """A tensor of ``shape`` laid out by ``layout``: ``blocks[i]`` is slot
    i's block (``mesh.devices.flat`` order), on that slot's device."""
    layout: Layout
    shape: tuple
    blocks: list

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype


def _key(sl: tuple) -> tuple:
    return tuple((s.start, s.stop) for s in sl)


def lay_out(x: torch.Tensor, layout: Layout) -> Laid:
    """``x`` split into one block per slot of ``layout``'s mesh."""
    shape = tuple(x.shape)
    seen, blocks = {}, []
    for coord, dev in zip(layout.coords(), layout.mesh.devices.flat):
        sl = layout.block_slices(shape, coord)
        k = (_key(sl), str(dev))
        if k not in seen:
            seen[k] = x[sl].to(dev)
        blocks.append(seen[k])
    return Laid(layout, shape, blocks)


def gather(laid: Laid, device=None) -> torch.Tensor:
    """The whole tensor on ``device`` (default: the first slot's), from
    the first block of each slice in slot order.  A tensor replicated on
    every slot is its first block moved to ``device`` (no copy when it
    is there already)."""
    layout = laid.layout
    dev = torch.device(device) if device is not None \
        else layout.mesh.devices.flat[0]
    if all(e is None or _axes(e) == () for e in layout.spec):
        return laid.blocks[0].to(dev)
    out = torch.empty(laid.shape, dtype=laid.dtype, device=dev)
    done = set()
    for coord, block in zip(layout.coords(), laid.blocks):
        sl = layout.block_slices(laid.shape, coord)
        if _key(sl) not in done:
            done.add(_key(sl))
            out[sl].copy_(block)
    return out


def relayout(laid: Laid, layout: Layout) -> Laid:
    """The same tensor laid out by ``layout`` (``laid`` itself when the
    spec and mesh are the same)."""
    if layout.mesh is laid.layout.mesh and \
            tuple(layout.spec) == tuple(laid.layout.spec):
        return laid
    return lay_out(gather(laid), layout)


def layouts(mesh, specs):
    """A tree of :class:`Layout` over ``mesh`` for a tree of specs."""
    return L.tree_map(lambda s: Layout(mesh, s), specs)


def lay_out_tree(tree, layout_tree):
    return L.tree_map(lay_out, tree, layout_tree)


def gather_tree(tree, device=None):
    return L.tree_map(lambda a: gather(a, device), tree)


def block_tree(tree, slot: int):
    """Slot ``slot``'s block of every leaf of a tree of :class:`Laid`."""
    return L.tree_map(lambda a: a.blocks[slot], tree)
