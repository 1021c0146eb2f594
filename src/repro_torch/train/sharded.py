"""Tensors laid out over the slots of a mesh by a PartitionSpec.

The port's stand-in for a ``jax.Array`` with a ``NamedSharding``; it has
no counterpart file in the reference.  A :class:`Layout` is a
``launch/mesh.py::Mesh`` and a resolved spec (``models/layers.PSpec``);
:func:`lay_out` splits a tensor into one block per slot, in
``mesh.devices.flat`` order, each on its slot's device, and the result,
a :class:`Laid`, holds exactly the block that the reference's
``addressable_shards`` hold on the matching device.  :func:`gather`
puts the blocks back together on one slot (each slice read from that
slot's own block where it holds one, else from the first slot in slot
order that does: replicas are equal by construction), and
:func:`relayout` lays the same tensor out under another spec.

Every move of a tensor from one slot to another goes through
:func:`send`, with the two slots' indices: a block laid out from the
slot that holds the whole tensor, a slice read into a gathering slot's
tensor, and the meshed train step's own moves
(``train/trainer.py::MeshStep``), the split layers' among them: a
:class:`ModelRow` is a data row's slots on the model axis, and its
collectives, :func:`to_model_slots` (Megatron's *f*),
:func:`sum_model_slots` (*g*), :func:`from_model_slots` (an MoE's
expert outputs back to the first slot) and :func:`sum_to_model_slots`
(a reduce-scatter: the row-parallel loss's partial logits, each slot
summing its block of the vocabulary), are autograd Functions whose
forward and backward move through the row's ``send``.
:func:`redistribute` lays out a tensor held in blocks by some slots
under another spec, each slot reading its slice from the slots that
hold it (:func:`plan`).  The dry run counts the same moves from the
layouts (``launch/dryrun.py::collectives``).

A spec entry names the mesh axes a dim is split over, major first, as
JAX reads ``P(("pod", "data"))``; dims past the spec's end are
replicated.  A dim that the entry's axes do not divide raises
``ValueError``: the reference's own specs never ask for one (``_div``
checks it, head padding makes the model dims divisible, and
``_zero1_spec`` only picks divisible dims).

Blocks on one card share its memory: a tensor laid out from a slot is
viewed by the slots on its device, and one placed from the host is one
tensor for the slots that hold the same slice on one device, so a spec
replicated over slots of one card holds one copy there.

A mesh of a process group (``launch/mesh.py``, ``Mesh.ranks``) has
slots of other processes: this process holds :data:`REMOTE` in their
place, :func:`at` runs a slot's work only in the process that owns it,
and :func:`send` between two processes is the sender's ``Group.send``
and the receiver's ``Group.recv`` (``launch/procs.py``), each process
walking the same moves in the same order.  Where several slots hold a
slice, a slot reads it from a slot of its own process first.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models import layers as L


class Remote:
    """A tensor that another process holds: the block of one of its slots,
    or the result of that slot's work."""
    __slots__ = ()

    def __repr__(self) -> str:
        return "REMOTE"


REMOTE = Remote()


def owner(mesh, slot: int) -> int:
    """The rank of the process that owns slot ``slot`` (0 on a mesh of
    one process)."""
    return int(mesh.ranks.flat[slot])


def is_local(mesh, slot) -> bool:
    """Whether slot ``slot`` (None: the host) is this process's."""
    return slot is None or mesh.local(slot)


def at(mesh, slot: int, fn, *args):
    """Slot ``slot``'s work, ``fn(*args)``, where that slot is this
    process's; :data:`REMOTE` elsewhere."""
    return fn(*args) if is_local(mesh, slot) else REMOTE


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
        """The first held block's dtype (a block this process holds)."""
        for b in self.blocks:
            if isinstance(b, torch.Tensor):
                return b.dtype
        raise ValueError("no block of this tensor is held here")


def _key(sl: tuple) -> tuple:
    return tuple((s.start, s.stop) for s in sl)


def send(t: torch.Tensor, mesh, src, dst: int,
         out: torch.Tensor | None = None) -> torch.Tensor:
    """``t``, held by slot ``src`` (``None``: by no slot, as a tensor read
    from the host, which every process holds), on slot ``dst``: copied
    into ``out``, a tensor on that slot, where one is given, else ``t`` on
    the slot's device (``t`` itself, or a view, when it is there
    already).  Between processes the sender sends and gets
    :data:`REMOTE`, the receiver receives; a process that owns neither
    slot gets :data:`REMOTE`."""
    here_src, here_dst = is_local(mesh, src), is_local(mesh, dst)
    if here_src and here_dst:
        if out is not None:
            return out.copy_(t)
        return t.to(mesh.devices.flat[dst])
    if here_src:
        mesh.group.send(t, owner(mesh, dst))
    elif here_dst:
        return mesh.group.recv(owner(mesh, src), mesh.devices.flat[dst],
                               out=out)
    return REMOTE


def lay_out(x: torch.Tensor, layout: Layout, src: int | None = None, *,
            shape=None) -> Laid:
    """``x`` split into one block per slot of ``layout``'s mesh, each
    sent from slot ``src``, where ``x`` lies; with ``src`` None (``x``
    on the host or in no slot) the slots on one device that hold the
    same slice share one copy, and another process's slots get
    :data:`REMOTE`.  ``shape`` is ``x``'s, given where ``x`` is another
    process's."""
    shape = tuple(x.shape if shape is None else shape)
    mesh = layout.mesh
    seen, blocks = {}, []
    for i, (coord, dev) in enumerate(zip(layout.coords(), mesh.devices.flat)):
        sl = layout.block_slices(shape, coord)
        if src is not None:
            blocks.append(send(at(mesh, src, lambda sl=sl: x[sl]), mesh,
                               src, i))
            continue
        if not is_local(mesh, i):
            blocks.append(REMOTE)
            continue
        k = (_key(sl), str(dev))
        if k not in seen:
            seen[k] = send(x[sl], mesh, None, i)
        blocks.append(seen[k])
    return Laid(layout, shape, blocks)


def _whole(sl: tuple, shape) -> bool:
    return all(s.start == 0 and s.stop == n for s, n in zip(sl, shape))


def _nearest(mesh, dst: int, holders) -> int:
    """Of the slots ``holders`` (in slot order) that hold one slice, the
    one ``dst`` reads it from: ``dst`` itself, else the first of
    ``dst``'s process, else the first."""
    return min(holders, key=lambda i: (
        i != dst, owner(mesh, i) != owner(mesh, dst), i))


def sources(layout: Layout, shape, slot: int) -> list[tuple[int, tuple]]:
    """(slot read, slices) for each distinct block of a tensor of
    ``shape`` that :func:`gather` onto ``slot`` reads, in slot order:
    ``slot``'s own block where it holds that slice, else the first slot
    of its process that does, else the first in slot order."""
    holders, slices = {}, {}
    for i, c in enumerate(layout.coords()):
        sl = layout.block_slices(shape, c)
        holders.setdefault(_key(sl), []).append(i)
        slices[_key(sl)] = sl
    out = [(_nearest(layout.mesh, slot, h), slices[k])
           for k, h in holders.items()]
    return sorted(out, key=lambda v: v[0])


def gather(laid: Laid, slot: int = 0) -> torch.Tensor:
    """The whole tensor on slot ``slot`` (default: the first): that slot's
    own block where it is whole (a replicated spec, or axes of size 1),
    else a new tensor filled from :func:`sources` (:data:`REMOTE` where
    ``slot`` is another process's)."""
    layout = laid.layout
    mesh = layout.mesh
    if _whole(layout.block_slices(laid.shape, layout.coords()[slot]),
              laid.shape):
        return laid.blocks[slot]
    out = at(mesh, slot, lambda: torch.empty(
        laid.shape, dtype=laid.dtype, device=mesh.devices.flat[slot]))
    for i, sl in sources(layout, laid.shape, slot):
        send(laid.blocks[i], mesh, i, slot,
             out=at(mesh, slot, lambda sl=sl: out[sl]))
    return out


def relayout(laid: Laid, layout: Layout, slot: int = 0) -> Laid:
    """The same tensor laid out by ``layout`` (``laid`` itself when the
    spec and mesh are the same): gathered onto ``slot`` and laid out
    from there."""
    if layout.mesh is laid.layout.mesh and \
            tuple(layout.spec) == tuple(laid.layout.spec):
        return laid
    return lay_out(gather(laid, slot), layout, src=slot, shape=laid.shape)


def layouts(mesh, specs):
    """A tree of :class:`Layout` over ``mesh`` for a tree of specs."""
    return L.tree_map(lambda s: Layout(mesh, s), specs)


def lay_out_tree(tree, layout_tree, src: int | None = None):
    return L.tree_map(lambda x, lay: lay_out(x, lay, src), tree, layout_tree)


def gather_tree(tree, slot: int = 0):
    return L.tree_map(lambda a: gather(a, slot), tree)


def block_tree(tree, slot: int):
    """Slot ``slot``'s block of every leaf of a tree of :class:`Laid`."""
    return L.tree_map(lambda a: a.blocks[slot], tree)


# ------------------------------------------------------- the model axis
class ModelRow:
    """A data row's slots on the model axis (flat indices, model
    coordinate order; ``slots[0]``, the row's first slot, holds its
    replicated activations), with the two things a split layer asks of
    it: ``send(t, src, dst)`` moves a tensor between slots (flat
    indices), and ``run(m, fn, *args, **kwargs)`` runs model slot m's
    work, ``fn(*args, **kwargs)`` (``run_at`` any slot's, by flat
    index), by default where it is called (the dry run runs only its own
    slot's).  A split serving step's moves go through the same ``send``:
    the query heads gathered onto the slots that hold a block of a
    sequence-split cache, their ``(out, lse)`` partials to the first
    slot, each new k/v row to the slots whose blocks hold its position
    and heads, the merged heads back to the slots that hold ``wo``'s
    rows (``models/layers.py``); they run under ``no_grad``, so none
    needs a backward.  ``scatter``, ``reduce``, ``concat`` and
    ``reduce_scatter`` are the collectives (:func:`to_model_slots`,
    :func:`sum_model_slots`, :func:`from_model_slots`,
    :func:`sum_to_model_slots`)."""

    def __init__(self, slots, send, run=None):
        self.slots = tuple(slots)
        self._send = send
        self._run = run

    def send(self, t, src: int, dst: int):
        return self._send(t, src, dst)

    def send_to(self, t, m: int):
        """``t``, on the row's first slot, sent to model slot ``m``."""
        return self.send(t, self.slots[0], self.slots[m])

    def send_from(self, t, m: int):
        """``t``, on model slot ``m``, sent to the row's first slot."""
        return self.send(t, self.slots[m], self.slots[0])

    def run(self, m: int, fn, *args, **kwargs):
        return self.run_at(self.slots[m], fn, *args, **kwargs)

    def run_at(self, slot: int, fn, *args, **kwargs):
        """Slot ``slot``'s work (a flat index, in this row or not: a
        serving step's cache blocks may lie on other rows' slots)."""
        if self._run is None:
            return fn(*args, **kwargs)
        return self._run(slot, fn, *args, **kwargs)

    def scatter(self, x, dim: int | None = None, ranges=None) -> tuple:
        return to_model_slots(self, x, dim, ranges)

    def reduce(self, parts):
        return sum_model_slots(self, parts)

    def concat(self, parts, dim: int):
        return from_model_slots(self, parts, dim)

    def reduce_scatter(self, parts, ranges):
        return sum_to_model_slots(self, parts, ranges)


def data_slots(mesh, dp_axes) -> list[int]:
    """The flat index of each data shard's first slot (every non-data
    coordinate 0), in slot order."""
    other = [i for i, a in enumerate(mesh.axis_names) if a not in dp_axes]
    return [i for i, c in enumerate(np.ndindex(*mesh.devices.shape))
            if all(c[j] == 0 for j in other)]


def model_dim(spec):
    """The dim a spec splits over ``"model"``, or None."""
    for i, e in enumerate(spec):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return i
    return None


def model_rows(mesh, dp_axes) -> dict[int, list[int]]:
    """{data shard's first slot: its row's slots on the model axis}, flat
    indices in model coordinate order ([the slot] without a model
    axis): the slots of a :class:`ModelRow`."""
    firsts = data_slots(mesh, tuple(dp_axes))
    if "model" not in mesh.axis_names:
        return {i: [i] for i in firsts}
    ax = mesh.axis_names.index("model")
    shape = mesh.devices.shape
    coords = list(np.ndindex(*shape))
    return {i: [int(np.ravel_multi_index(
        coords[i][:ax] + (m,) + coords[i][ax + 1:], shape))
        for m in range(shape[ax])] for i in firsts}


def row_blocks(params, row: ModelRow):
    """A data row's view of a tree of :class:`Laid` parameters: each leaf
    a ``layers.Blocks`` of the row's blocks where its spec splits it over
    the model axis, else of its first slot's (whole) block."""
    def leaf(laid):
        dim = model_dim(laid.layout.spec)
        if dim is None:
            return L.Blocks((laid.blocks[row.slots[0]],), row)
        return L.Blocks(tuple(laid.blocks[j] for j in row.slots), row, dim)

    return L.tree_map(leaf, params)


class _ToModelSlots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, row, dim, ranges, x):
        ctx.row, ctx.dim, ctx.ranges = row, dim, ranges
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        return tuple(row.send_to(x if ranges is None else
                                 x.narrow(dim, lo, hi - lo), m)
                     for m, (lo, hi) in enumerate(
                         ranges or [(None, None)] * len(row.slots)))

    @staticmethod
    def backward(ctx, *grads):
        row = ctx.row
        if ctx.ranges is None:
            out = row.send_from(grads[0], 0)
            for m in range(1, len(grads)):
                out = out + row.send_from(grads[m], m)
            return None, None, None, out
        out = torch.zeros(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        for m, ((lo, hi), g) in enumerate(zip(ctx.ranges, grads)):
            out.narrow(ctx.dim, lo, hi - lo).add_(row.send_from(g, m))
        return None, None, None, out


class _SumModelSlots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, row, *parts):
        ctx.row = row
        out = row.send_from(parts[0], 0)
        for m in range(1, len(parts)):
            out = out + row.send_from(parts[m], m)
        return out

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(ctx.row.send_to(g, m)
                               for m in range(len(ctx.row.slots)))


class _FromModelSlots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, row, dim, *parts):
        ctx.row, ctx.dim = row, dim
        ctx.sizes = [p.shape[dim] for p in parts]
        return torch.cat([row.send_from(p, m) for m, p in enumerate(parts)],
                         dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (None, None) + tuple(
            ctx.row.send_to(s, m)
            for m, s in enumerate(torch.split(g, ctx.sizes, dim=ctx.dim)))


def _sum_arrivals(row, j: int, pieces):
    """Slot ``j``'s sum, in slot order, of ``pieces[m]`` (on model slot
    m), each added as it arrives."""
    out = None
    for m, piece in enumerate(pieces):
        x = row.send(piece, row.slots[m], row.slots[j])
        out = x if out is None else out + x
    return out


def _cat_arrivals(row, m: int, pieces):
    """Slot ``m``'s concatenation along the last dim of ``pieces[j]`` (on
    model slot j), in slot order."""
    return torch.cat([row.send(g, row.slots[j], row.slots[m])
                      for j, g in enumerate(pieces)], dim=-1)


class _SumToModelSlots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, row, ranges, *parts):
        ctx.row = row
        return tuple(row.run(j, _sum_arrivals, row, j,
                             [p[..., lo:hi] for p in parts])
                     for j, (lo, hi) in enumerate(ranges))

    @staticmethod
    def backward(ctx, *grads):
        row = ctx.row
        return (None, None) + tuple(row.run(m, _cat_arrivals, row, m, grads)
                                    for m in range(len(grads)))


def to_model_slots(row: ModelRow, x, dim: int | None = None, ranges=None):
    """``x``, on the row's first slot, on each of its model slots: whole,
    or where ``ranges`` gives each slot m an interval [lo, hi) of dim
    ``dim``, that slice (slices may overlap).  Backward sums the slots'
    gradients in slot order onto the first slot, each into its slice."""
    return _ToModelSlots.apply(row, dim, ranges, x)


def sum_model_slots(row: ModelRow, parts):
    """The sum, in slot order, of ``parts[m]`` on model slot m, on the
    row's first slot; backward sends the gradient back to each slot."""
    return _SumModelSlots.apply(row, *parts)


def from_model_slots(row: ModelRow, parts, dim: int):
    """``parts[m]``, on model slot m, concatenated along ``dim`` in slot
    order on the row's first slot (an MoE's expert outputs, each slot's
    experts); backward sends each slot its slice of the gradient."""
    return _FromModelSlots.apply(row, dim, *parts)


def sum_to_model_slots(row: ModelRow, parts, ranges):
    """A reduce-scatter: for each model slot j, the sum in slot order of
    ``parts[m]``'s slice ``ranges[j]`` = [lo, hi) of the last dim (every
    part whole there, one on each model slot m), on slot j; the ranges
    cover the dim in order.  Backward sends each slot m every slot's
    gradient slice, concatenated in slot order."""
    return _SumToModelSlots.apply(row, ranges, *parts)


def _intersect(a: tuple, b: tuple):
    out = tuple(slice(max(x.start, y.start), min(x.stop, y.stop))
                for x, y in zip(a, b))
    return out if all(s.start < s.stop for s in out) else None


def _within(piece: tuple, block: tuple) -> tuple:
    return tuple(slice(p.start - b.start, p.stop - b.start)
                 for p, b in zip(piece, block))


def plan(held, shape, layout: Layout) -> list[list[tuple]]:
    """For each slot of ``layout``'s mesh (flat order), the pieces it
    reads to hold its block of a tensor of ``shape`` that the slots in
    ``held`` hold in blocks, ``held`` a list of (slot, slices of the
    whole): (source slot, the piece's slices of the whole), one for
    each distinct held block its own block meets, read from the slot
    itself where it holds that block, else from the first of its
    process that does, else from the first in slot order."""
    mesh = layout.mesh
    holders, slices = {}, {}
    for i, sl in held:
        holders.setdefault(_key(sl), []).append(i)
        slices[_key(sl)] = sl
    out = []
    for j, c in enumerate(layout.coords()):
        want = layout.block_slices(shape, c)
        pieces = []
        for i, sl in sorted(((_nearest(mesh, j, h), slices[k])
                             for k, h in holders.items()),
                            key=lambda v: v[0]):
            piece = _intersect(sl, want)
            if piece is not None:
                pieces.append((i, piece))
        out.append(pieces)
    return out


def redistribute(blocks: dict, shape, layout: Layout, send_fn,
                 at) -> Laid:
    """A tensor of ``shape`` held in blocks, ``blocks`` {slot: (slices of
    the whole, tensor)}, laid out by ``layout``: each slot's block read
    as :func:`plan` says, a view of its own block where that holds it,
    else one piece sent, else pieces copied into a new tensor, one for
    the slots of a device that hold the same slice (each still sent its
    pieces, which are there already), as :func:`lay_out` holds one copy.
    ``send_fn(t, src, dst, out=None)`` moves (``MeshStep.send``) and
    ``at(slot, fn)`` runs a slot's part (``MeshStep.at``): the piece's
    view on its source slot, the new tensor on the reading one.  In a
    process group the slots of a device that hold one slice share a copy
    within a process: a piece of another process is sent once to it."""
    mesh = layout.mesh
    held = [(i, sl) for i, (sl, _) in sorted(blocks.items())]
    coords = layout.coords()
    built = {}

    def piece_of(i, piece):
        sl, t = blocks[i]
        return at(i, lambda: t[_within(piece, sl)])

    def one(j, pieces):
        want = layout.block_slices(shape, coords[j])
        if len(pieces) == 1 and _key(pieces[0][1]) == _key(want):
            i, piece = pieces[0]
            return send_fn(piece_of(i, piece), i, j)
        k = (_key(want), owner(mesh, j), str(mesh.devices.flat[j]))
        if k in built:
            for i, piece in pieces:
                if owner(mesh, i) == owner(mesh, j):
                    send_fn(piece_of(i, piece), i, j)
            return built[k]
        out = at(j, lambda: torch.empty(
            [s.stop - s.start for s in want], dtype=_held_dtype(blocks),
            device=mesh.devices.flat[j]))
        for i, piece in pieces:
            send_fn(piece_of(i, piece), i, j,
                    out=at(j, lambda piece=piece: out[_within(piece, want)]))
        built[k] = out
        return out

    return Laid(layout, tuple(shape),
                [one(j, p) for j, p in enumerate(plan(held, shape, layout))])


def _held_dtype(blocks: dict) -> torch.dtype:
    for _, t in blocks.values():
        if isinstance(t, torch.Tensor):
            return t.dtype
    raise ValueError("no block of this tensor is held in this process")
