"""Dry run: every (architecture x input shape) on the production mesh,
with no allocation.  Each cell's parameters, optimizer state, inputs and
caches are laid out over the mesh's slots by their specs and counted in
bytes a slot, the busiest slot's step is traced on ``meta`` tensors
through the routes and kernel argument checks the card would take, and
what it holds, computes and moves is counted.

Counterpart of ``repro/launch/dryrun.py``:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \
      [--both-meshes] [--dev] [--smoke]

The mesh is a ``launch/mesh.py::Mesh`` of ``meta`` slots, (16, 16)
``("data", "model")`` or (2, 16, 16) with ``"pod"``; ``--dev`` shrinks
it to (2, 4) / (2, 2, 4) and the shapes as the reference does.  Nothing
touches a device but ``meta``.

* **Bytes a slot** (``memory``, under the reference's
  ``memory_analysis`` key names): each leaf's block on each slot
  (``train/sharded.py::Layout.block_slices``), summed.
  ``argument_size_in_bytes`` is parameters (fp32 to train, bf16 to
  serve), optimizer state (ZeRO-1 off, as in the reference), inputs and
  caches; ``output_size_in_bytes`` is parameters and optimizer state for
  train, and the logits (B, 1, V) at the reference's logits spec plus the
  caches for decode and prefill (the reference leaves prefill's outputs
  to XLA; the port counts them as decode's, plus the encoder's output at
  the inputs' spec for an encoder-decoder); ``alias_size_in_bytes`` is
  what the reference donates: parameters and optimizer state for train,
  caches otherwise.  Each figure is the largest slot's, and
  ``memory_slots_differ`` says whether any slot holds another count.
* **The trace** (``trace_s``): slot (0, 0)'s program, the busiest slot's
  (``meta`` has no device index, so a ``meta`` mesh's slots cannot be
  told apart while a whole meshed step runs), at a data shard's batch
  (``global_batch / dp``, or the whole batch in long mode), under
  ``use_mesh`` with the cell's data axes, so an MoE's capacity is one
  shard's.  ``models/layers.py::on_card`` routes a ``meta`` tensor as a
  CUDA one, and the LM kernel wrappers run every check of their
  launch on it and return empty outputs (and decode_attention's
  scratch): a cell whose trace raises is one the card refuses.

  - train: the parts of ``train/trainer.py::make_mesh_train_step``
    (:class:`~repro_torch.train.trainer.MeshStep`) as slot 0 runs them.
    It holds its blocks of the parameters and moments and the batch
    (which the port's step takes whole on slot 0: its shard's rows are
    arguments, the other shards' rows bytes beyond them) and runs
    ``loss_and_grads`` on its shard's rows.  Where the step splits over
    the model axis (``model_split``: every architecture on a model axis
    wider than one), slot (0, 0) runs its
    own blocks' share of each split layer (its experts, MLA heads, Mamba
    channels or rows of mLSTM's C among them) and, as its row's first
    slot, the norms, residuals, replicated projections (MLA's
    down-projections, mLSTM's gates), an MoE's routing, dispatch and
    combine, the sLSTM blocks, the row-parallel loss's sum and an
    encoder-decoder's ``enc_ln``, and
    receives the other model slots' partials, columns and expert
    outputs, each a stand-in made under ``trace.paused()`` that takes
    bytes on slot 0 only when sent there (:class:`_Elsewhere`; another
    slot's work runs only for its outputs' shapes, once for each
    signature: :class:`_Paused`); the gradient sum, the norm and the layouts
    count only slot 0's blocks.  Otherwise it gathers the whole
    parameters (``sharded.gather_tree``) and runs the shard on them.  It
    then takes the other dp - 1 shards' gradients (whole, or its blocks')
    as they arrive, one leaf at a time, and sums them in slot order; then
    the global norm, its block of the gradient's and parameters' layouts
    and its ``update_with_norm``.  The other slots' work is not run:
    their results are tensors of the same shapes that count only when
    sent to slot 0 (:class:`SlotStep`).
  - prefill and decode, where the step splits over the model axis
    (:func:`model_split`): slot (0, 0)'s share of
    ``launch/serve.py::MeshServe`` (:class:`SlotServe`), its data row's
    step on its blocks of the bf16 parameters, caches and inputs laid out
    by the cell's specs: its own query heads, MLP columns, vocabulary
    block and cache blocks (an MLA decode: every block of a layer's
    compressed caches, gathered onto it for the layer), and, as its row's
    first slot, the norms, the replicated k/v projections (MLA's
    latents) and the merge of the partials, while the
    other slots' parts run under ``trace.paused()``; what they send slot
    0 takes bytes as it arrives.  A decode step writes at
    :func:`decode_offsets` (the cache's last position).  Otherwise slot
    0 holds its blocks of the bf16 parameters, caches and inputs,
    gathers the whole parameters and its shard's caches and inputs, and
    runs the step on them.

  The outputs are held to the inputs: train returns parameters and
  optimizer state of the same shapes and dtypes, decode and prefill the
  caches unchanged and logits (B/dp, 1, V), and an encoder-decoder's
  prefill its encoder's output of the frames' shape.
* **Peak bytes** (``memory.peak_bytes``, ``memory.temp_size_in_bytes``):
  the traced program's live bytes (``launch/memtrace.py::StepTrace``).
  ``temp_size_in_bytes`` is the most it holds beyond its arguments (the
  reference's meaning; the other shards' rows of a train batch count
  here), and ``peak_bytes`` is ``argument_size_in_bytes`` plus that.  ``fits`` is
  ``peak_bytes`` within the card's memory (``CARD_BYTES``);
  ``arguments_fit`` is the arguments alone within it.  A cell traced at
  a smaller shape than its own (``trace_batch``, ``trace_seq_len``)
  counts its temp bytes at that shape, so its peak is a lower bound
  (``memory.peak_is_lower_bound``): ``fits`` is False where the bound
  already passes the card, else None (not known).
* **Work** (``flops``, ``dot_flops``, ``bytes_accessed``): the same
  trace's products and bytes (see ``launch/memtrace.py``): ``flops`` the
  work slot 0's step does (flash over its visible key positions, decode
  over every cached position: ``meta`` holds no lengths); ``dot_flops``
  every product at its full shape, as ``benchmarks/hlo_analysis.py``
  counts the reference's HLO dots; ``bytes_accessed`` each op's inputs
  read and outputs written once, no fusion assumed, an upper bound on
  an eager step's HBM traffic.  ``kernel_calls`` counts the LM kernels'.
* **Transfers between slots** (``collectives``, train): every byte the
  meshed step sends from one slot to another, counted from the layouts
  and shapes in closed form (:func:`transfers`), by kind: the batch's
  rows to each data shard's first slot, the loss and gradients sent on
  to be summed, the norm, the gradient laid out onto the moments'
  blocks, and the parameters relaid where the moments' spec differs;
  a gathered step also gathers the parameters onto each data shard's
  first slot, a split one sends each split layer's activations and
  partials within each data row (an MoE's, its experts' rows of the
  dispatch buffer and their outputs: :func:`ffn_moves`; an MLA layer's,
  its latents; a Mamba or mLSTM layer's, its reshuffles of the
  projections' columns, what goes whole to every slot and its partials:
  :func:`mixer_moves`; a cross-attention's, its normed activation and,
  where ``wk``/``wv`` are replicated, the KV heads of the encoder's
  positions a slot reads), forward, backward and again in remat's
  recompute, the embedding's and loss's combines, and an
  encoder-decoder's output sent to each model slot once a step where
  the cross ``wk``/``wv`` split, and its gradient back ("encoder").  A
  split serving cell counts its step's moves the
  same way (:func:`serve_transfers`): activations, k/v slices, partial
  sums, an MoE's dispatch rows and expert outputs, and the cache rows
  by position to prefill; the same at T = 1 to decode, plus the write
  offsets, the query heads gathered onto each slot holding a block of
  a cache split by positions and their ``(out, lse)`` partials, and an
  MLA layer's compressed blocks gathered onto each model slot; the
  row-parallel logits' partials and copies; a recurrent layer's
  reshuffles, whole tensors and partials, and the copies of its states
  (mLSTM's and sLSTM's replicas on every model slot, and in long mode
  each block's on the other data rows); an encoder-decoder's encoder
  layers to prefill, its output to each model slot ("encoder", the
  copies a prefill returns) and, where the cross ``wk``/``wv`` are
  replicated, each layer's KV heads of the encoder's positions
  ("cross", every step: a decode moves no byte of the output itself).
  ``bytes_by_kind`` and ``total_bytes`` are what the busiest slot sends
  and receives.  A gathered serving cell records ``None``: nothing
  moves between slots.
* **Split** (``model_split``): whether the cell's step splits its
  compute over the model axis (:func:`model_split`): every cell on a
  model axis wider than one (``ModelAPI.model_split`` names every
  family); on a model axis of one the step runs gathered.

What has no counterpart, since there is no compiler: ``lower`` and
``compile`` (their times are replaced by ``trace_s``),
``memory_analysis``'s generated-code bytes and the HLO text.
``model_flops`` is the reference's formula.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import inspect
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from ..configs import ARCHS, SMOKES, SHAPES, shapes_for
from ..configs.base import ShapeConfig
from ..models import build, layers as L, xlstm as X
from ..train import optimizer as O
from ..train import sharded as S
from ..train.trainer import MeshStep, loss_and_grads, make_train_step
from .memtrace import StepTrace
from .mesh import Mesh, dp_axes_of
from .serve import MeshServe, cache_spans, state_replicas

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
META = torch.device("meta")
# an H100 80GB HBM3's memory, as torch.cuda.get_device_properties reads it
CARD_BYTES = 85_017_493_504


def meta_mesh(shape: tuple, axes: tuple) -> Mesh:
    """A mesh of ``meta`` slots of ``shape`` over ``axes``."""
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [META] * grid.size
    return Mesh(grid.reshape(shape), axes)


def make_mesh(*, multi_pod: bool, dev: bool) -> Mesh:
    """The production mesh, or ``--dev``'s, over ``meta`` slots."""
    if dev:
        shape = (2, 2, 4) if multi_pod else (2, 4)
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return meta_mesh(shape, axes)


def dev_shape(shape: ShapeConfig, mesh: Mesh) -> ShapeConfig:
    """``--dev``'s shape: a 32nd of the batch (at least one row a data
    shard), sequences of at most 512."""
    return dataclasses.replace(
        shape, global_batch=max(mesh.shape.get("pod", 1) * mesh.shape["data"],
                                shape.global_batch // 32),
        seq_len=min(shape.seq_len, 512))


def _is_long_mode(shape: ShapeConfig) -> bool:
    return shape.kind == "decode" and shape.global_batch == 1


def _dp_size(mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in axes]))


@dataclasses.dataclass
class Cell:
    """A cell's abstract trees on its mesh: ``trees[name]`` is (tree of
    ``meta`` tensors, tree of specs) for "params", "inputs", and "opt"
    (train) or "caches" (prefill, decode); ``outputs`` the same for what
    a serving step returns beside its caches."""
    api: object
    shape: ShapeConfig
    mesh: Mesh
    dp_axes: tuple
    trees: dict
    outputs: dict


def lower_cell(cfg, shape: ShapeConfig, mesh):
    """Returns (cell, aux): the cell's abstract trees and specs (see
    :class:`Cell`) and the reference's parameter counts."""
    dp = dp_axes_of(mesh)
    long_mode = _is_long_mode(shape)
    tp = int(mesh.shape["model"])
    active = () if long_mode else dp
    with L.use_mesh(mesh, dp_axes=active):
        api = build(cfg, tp=tp)
        abs_params = api.abstract_params(
            dtype=None if shape.kind == "train" else "bfloat16")
        trees = {"params": (abs_params, api.param_pspecs()),
                 "inputs": (api.input_specs(shape), api.input_pspecs(shape))}
        vocab_ok = cfg.vocab_size % tp == 0
        logits_spec = L.resolve_pspec((() if long_mode else L.DP, None,
                                       "model" if vocab_ok else None))
        outputs = {}
        if shape.kind == "train":
            trees["opt"] = (O.abstract_state(abs_params), O.opt_pspecs(
                api.param_defs(), dp_axes=dp, dp_size=_dp_size(mesh, dp)))
        else:
            kw = {"long_mode": long_mode} if shape.kind == "decode" else {}
            b, s = shape.global_batch, shape.seq_len
            trees["caches"] = (api.abstract_cache(b, s, **kw),
                               api.cache_pspecs(b, s, **kw))
            dt = getattr(torch, cfg.dtype)
            outputs["logits"] = (torch.empty((b, 1, cfg.vocab_size),
                                             dtype=dt, device=META),
                                 logits_spec)
            if shape.kind == "prefill" and cfg.family == "encdec":
                outputs["enc_out"] = (trees["inputs"][0]["frames"],
                                      trees["inputs"][1]["frames"])
    total, active_n = cfg.param_count()
    cell = Cell(api=api, shape=shape, mesh=mesh, dp_axes=active, trees=trees,
                outputs=outputs)
    return cell, {"params_total": total, "params_active": active_n}


def slot_bytes(tree, specs, mesh) -> np.ndarray:
    """Bytes each slot holds of ``tree`` laid out by ``specs``, in
    ``mesh.devices.flat`` order."""
    coords = list(np.ndindex(*mesh.devices.shape))
    out = np.zeros(len(coords), dtype=np.int64)
    for leaf, spec in zip(L.tree_leaves(tree), L.tree_leaves(specs)):
        lay = S.Layout(mesh, spec)
        for i, c in enumerate(coords):
            block = lay.block_slices(leaf.shape, c)
            out[i] += int(np.prod([sl.stop - sl.start for sl in block],
                                  dtype=np.int64)) * leaf.element_size()
    return out


def memory(cell: Cell) -> dict:
    """The ``memory`` record (see the module docstring)."""
    per = {k: slot_bytes(t, s, cell.mesh)
           for k, (t, s) in {**cell.trees, **cell.outputs}.items()}
    zero = np.zeros(cell.mesh.devices.size, dtype=np.int64)
    args = per["params"] + per["inputs"] + per.get("opt", zero) \
        + per.get("caches", zero)
    if cell.shape.kind == "train":
        outs = alias = per["params"] + per["opt"]
    else:
        outs = per["caches"] + sum((per[k] for k in cell.outputs), zero)
        alias = per["caches"]
    keys = {"argument_size_in_bytes": args, "output_size_in_bytes": outs,
            "alias_size_in_bytes": alias}
    rec = {k: int(v.max()) for k, v in keys.items()}
    rec["memory_slots_differ"] = any(int(v.min()) != int(v.max())
                                     for v in keys.values())
    return rec


def shard_batch(cell: Cell, shape: ShapeConfig | None = None) -> int:
    """Rows of one data shard of ``shape`` (default: the cell's): the
    trace's batch."""
    b = (shape or cell.shape).global_batch
    dp = _dp_size(cell.mesh, cell.dp_axes)
    if b % dp:
        raise ValueError(f"a batch of {b} rows does not split over {dp} "
                         "data shards")
    return b // dp


def _same(what, got, want) -> None:
    """Raise unless the trees ``got`` and ``want`` hold tensors of the
    same shapes and dtypes, leaf for leaf."""
    for (path, g), w in zip(L.tree_items(got), L.tree_leaves(want)):
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
            raise ValueError(f"{what} {'/'.join(map(str, path))}: "
                             f"{tuple(g.shape)} {g.dtype}, expected "
                             f"{tuple(w.shape)} {w.dtype}")


def _slot_laid(tree, specs, mesh):
    """(tree of ``sharded.Laid``, slot 0's blocks): ``tree`` laid out by
    ``specs`` as slot 0's program sees it: its own block of each leaf a
    ``meta`` tensor, every other slot's block one more of the same
    shape, which the trace does not hold."""
    c0 = (0,) * mesh.devices.ndim
    own = []

    def one(leaf, spec):
        lay = S.Layout(mesh, spec)
        shape = [sl.stop - sl.start for sl in lay.block_slices(leaf.shape, c0)]
        mine, other = (torch.empty(shape, dtype=leaf.dtype, device=META)
                       for _ in range(2))
        own.append(mine)
        return S.Laid(lay, tuple(leaf.shape),
                      [mine] + [other] * (mesh.devices.size - 1))

    return L.tree_map(one, tree, specs), own


def _like(tree):
    return L.tree_map(lambda t: torch.empty_like(t)
                      if isinstance(t, torch.Tensor) else t, tree)


def _signature(x):
    """A key of ``x`` that a ``meta`` step's output shapes depend on: a
    tensor's shape, dtype and whether it asks for a gradient, sequences
    item by item, a ``layers.Blocks`` (and its ``part``, which takes a
    stacked block to a layer's) by its split dim and the kinds of its
    index, anything else itself (by identity where unhashable)."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.requires_grad)
    if isinstance(x, (tuple, list)):
        return (type(x),) + tuple(_signature(a) for a in x)
    if isinstance(x, dict):
        return (dict,) + tuple((k, _signature(v)) for k, v in x.items())
    if isinstance(x, L.Blocks):      # its blocks' shapes come with them
        return (L.Blocks, x.dim, tuple(type(i) for i in x.index))
    if inspect.ismethod(x):          # ``Blocks.part``: a layer's index
        return (x.__func__, _signature(x.__self__))
    try:
        hash(x)
    except TypeError:
        return ("id", id(x))
    return x


class _Paused:
    """Other slots' work under ``trace.paused()``: counted nowhere, it
    runs only for its outputs' shapes, so a call whose function, tensor
    shapes and other arguments (:func:`_signature`) another slot's call
    had already gets stand-ins of that call's outputs, not a run (a
    split layer's tp slots run one signature: one run, not tp - 1)."""

    def __init__(self, trace: StepTrace):
        self.trace = trace
        self.seen = {}

    def __call__(self, fn, *args, **kwargs):
        key = (fn, _signature(args), _signature(kwargs))
        with self.trace.paused():
            if key not in self.seen:
                self.seen[key] = _like(fn(*args, **kwargs))
            return _like(self.seen[key])


class _Elsewhere(torch.autograd.Function):
    """Another slot's part of a split layer, as slot 0's trace sees it:
    ``fn`` runs under ``trace.paused()`` for its outputs' shapes, and
    backward gives each activation that asks for one a stand-in gradient
    made under ``trace.paused()`` too, so nothing of that slot's work
    counts on slot 0 until it is sent there.  Its parameter blocks
    (leaves) get none: their gradients, summed over the layers on that
    slot, are stand-ins too (:meth:`SlotStep.loss_and_grads`)."""

    @staticmethod
    def forward(ctx, paused, fn, kwargs, *args):
        ctx.trace = paused.trace
        ctx.like = [(a.shape, a.dtype, a.device)
                    if isinstance(a, torch.Tensor) and a.grad_fn is not None
                    else None for a in args]
        return paused(fn, *args, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        with ctx.trace.paused():
            return (None, None, None) + tuple(
                torch.empty(like[0], dtype=like[1], device=like[2])
                if like is not None and need else None
                for like, need in zip(ctx.like, ctx.needs_input_grad[3:]))


class SlotStep(MeshStep):
    """Slot 0's share of :class:`MeshStep` under ``trace``: the other data
    shards' gradients and the other slots' updates are not run; each is
    a tensor of the shape of slot 0's own, made under ``trace.paused()``
    (on another slot), that takes bytes of its own on slot 0 when it is
    sent there (the arrival buffer of ``Tensor.to`` between cards).  In a
    split step the other model slots of slot 0's row run under
    :class:`_Elsewhere`, and every other slot's part of the gradient sum,
    norm and layouts (:meth:`at`) under ``trace.paused()``."""

    def __init__(self, trace: StepTrace, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.trace = trace
        self.paused = _Paused(trace)
        self._like = {}

    def send(self, t, src: int, dst: int, out=None):
        if src == dst:
            return t if out is None else out.copy_(t)
        if dst != 0:
            with self.trace.paused():
                return torch.empty_like(t) if out is None else out
        return torch.empty_like(t) if out is None else out.copy_(t)

    def at(self, slot: int, fn, *args):
        if slot == 0:
            return fn(*args)
        with self.trace.paused():
            return fn(*args)

    def loss_and_grads(self, given, rows, objective):
        """The other model slots' parameter blocks, which no gradient
        reaches in the trace, get stand-ins made under ``trace.paused()``."""
        def absent(t):
            with self.trace.paused():
                return torch.empty_like(t)
        return loss_and_grads(self.api, given, rows, objective,
                              absent=absent if self.split else None)

    def run(self, slot: int, fn, *args, **kwargs):
        """A slot's work in a row: slot 0's traced, another's
        :class:`_Elsewhere`."""
        if slot == 0:
            return fn(*args, **kwargs)
        return _Elsewhere.apply(self.paused, fn, kwargs, *args)

    def model_row(self, i: int) -> S.ModelRow:
        return S.ModelRow(self.rows[i], self.send, self.run)

    def _elsewhere(self, what: str, i: int, run):
        """Slot 0's result of ``run``, with a stand-in kept (not held:
        slot 0's own tensors must leave when the step drops them), or on
        another slot ``i`` a stand-in of the same shapes."""
        if i == 0:
            out = run()
            with self.trace.paused():
                self._like[what] = _like(out)
            return out
        with self.trace.paused():
            return _like(self._like[what])

    def shard_grads(self, params, batch, cnt, i: int):
        return self._elsewhere("grads", i, lambda: super(
            SlotStep, self).shard_grads(params, batch, cnt, i))

    def slot_update(self, i: int, p, g, state, gnorm):
        return self._elsewhere("update", i, lambda: super(
            SlotStep, self).slot_update(i, p, g, state, gnorm))


def _train_program(cell: Cell, shape: ShapeConfig, trace: StepTrace):
    """Slot 0's share of the meshed train step (see the module
    docstring): (outputs gathered whole, state, batch)."""
    api, mesh = cell.api, cell.mesh
    params, p_own = _slot_laid(*cell.trees["params"], mesh)
    opt, o_own = _slot_laid(*cell.trees["opt"], mesh)
    batch = api.input_specs(shape)
    parts = SlotStep(trace, api, O.AdamWConfig(), mesh, dp_axes=cell.dp_axes,
                     param_specs=cell.trees["params"][1],
                     opt_specs=cell.trees["opt"][1],
                     batch_specs=api.input_pspecs(shape))
    step = make_train_step(api, parts.opt_cfg, grads_fn=parts.grads,
                           update_fn=parts.update)
    rows = {k: v[parts.b_lay[k].block_slices(v.shape, parts.coords[0])]
            for k, v in batch.items()}
    trace.hold((p_own, o_own))
    trace.hold(batch, arguments=sum(t.nbytes for t in rows.values()))
    with trace:
        new_p, new_o, metrics = step(params, opt, batch)
    out = (S.gather_tree(new_p), S.gather_tree(new_o), metrics)
    return out, (cell.trees["params"][0], cell.trees["opt"][0]), rows


class SlotServe(MeshServe):
    """Slot 0's share of :class:`~repro_torch.launch.serve.MeshServe`'s
    split step under ``trace``: slot 0's own work runs, every other
    slot's under ``trace.paused()``, and what another slot sends slot 0
    takes bytes on slot 0 as it arrives (as :class:`SlotStep`).  A
    decode step writes at ``offsets`` (global batch order), which stand
    for ``lengths``' values: a ``meta`` tensor holds none."""

    def __init__(self, trace: StepTrace, *args, offsets=(), **kwargs):
        super().__init__(*args, **kwargs)
        self.trace = trace
        self.paused = _Paused(trace)
        self.offsets = offsets

    send = SlotStep.send
    model_row = SlotStep.model_row

    def run(self, slot: int, fn, *args, **kwargs):
        """A slot's work in a row, no backward: slot 0's traced,
        another's under ``trace.paused()`` (:class:`_Paused`)."""
        if slot == 0:
            return fn(*args, **kwargs)
        return self.paused(fn, *args, **kwargs)

    def row_offsets(self, i: int, batch) -> tuple:
        lengths = batch["lengths"]
        rows = lengths.layout.block_slices(lengths.shape, self.coords[i])[0]
        return tuple(self.offsets[rows])


def decode_offsets(shape: ShapeConfig) -> tuple:
    """The write offset of every sequence a split decode step is traced
    and counted at: the cache's last position (the step that fills it)."""
    return (shape.seq_len - 1,) * shape.global_batch


def _split_serve_program(cell: Cell, shape: ShapeConfig, trace: StepTrace):
    """Slot 0's share of the split serving step (see the module
    docstring): its row's step on the cell's layouts, other slots'
    parts paused; (outputs, state, batch) as :func:`_serve_program`."""
    api, mesh = cell.api, cell.mesh
    long_mode = _is_long_mode(shape)
    b, s = shape.global_batch, shape.seq_len
    kw = {"long_mode": long_mode} if shape.kind == "decode" else {}
    with L.use_mesh(mesh, dp_axes=cell.dp_axes):
        c_specs = api.cache_pspecs(b, s, **kw)
        i_specs = api.input_pspecs(shape)
    c_tree = api.abstract_cache(b, s, **kw)
    params, p_own = _slot_laid(*cell.trees["params"], mesh)
    caches, c_own = _slot_laid(c_tree, c_specs, mesh)
    inputs, i_own = _slot_laid(api.input_specs(shape), i_specs, mesh)
    trace.hold((p_own, c_own, i_own))
    decode = shape.kind == "decode"
    serve = SlotServe(trace, api, mesh, dp_axes=dp_axes_of(mesh),
                      long_mode=long_mode,
                      offsets=decode_offsets(shape) if decode else ())
    with trace, torch.no_grad():
        out, enc = serve.row_step(0, api.decode if decode else api.prefill,
                                  params, inputs, caches, decode)
    rows = shard_batch(cell, shape)
    shard = dataclasses.replace(shape, global_batch=rows)
    v = api.cfg.vocab_size
    want = (rows, 1, v if v % serve.tp else v // serve.tp)
    for j, blk in out.items():
        if tuple(blk.shape) != want:
            raise ValueError(f"slot {j}'s logits block {tuple(blk.shape)}, "
                             f"expected {want}")
    logits = torch.empty((rows, 1, v), dtype=out[0].dtype, device=META)
    own = api.abstract_cache(rows, s, **kw)      # the shard's, as gathered
    outs = (logits, own) + ((enc[0],) if enc else ())
    return outs, (cell.trees["params"][0], own), api.input_specs(shard)


def _serve_program(cell: Cell, shape: ShapeConfig, trace: StepTrace):
    """Slot 0's serving step (see the module docstring): (outputs, state,
    batch)."""
    if model_split(cell):
        return _split_serve_program(cell, shape, trace)
    api, mesh = cell.api, cell.mesh
    b = shard_batch(cell, shape)
    kw = {"long_mode": _is_long_mode(shape)} if shape.kind == "decode" else {}
    shard = dataclasses.replace(shape, global_batch=b)
    with L.use_mesh(mesh, dp_axes=()):           # the shard's own trees
        c_specs = api.cache_pspecs(b, shape.seq_len, **kw)
        i_specs = api.input_pspecs(shard)
    c_tree = api.abstract_cache(b, shape.seq_len, **kw)
    i_tree = api.input_specs(shard)
    params, p_own = _slot_laid(*cell.trees["params"], mesh)
    caches, c_own = _slot_laid(c_tree, c_specs, mesh)
    inputs, i_own = _slot_laid(i_tree, i_specs, mesh)
    trace.hold((p_own, c_own, i_own))
    step = api.prefill if shape.kind == "prefill" else api.decode
    with trace, torch.no_grad():
        out = step(S.gather_tree(params), S.gather_tree(inputs),
                   S.gather_tree(caches))
    return out, (cell.trees["params"][0], c_tree), i_tree


def run_step(cell: Cell, shape: ShapeConfig | None = None,
             trace: StepTrace | None = None):
    """Slot 0's program of the cell's step on ``meta`` trees at one data
    shard's batch of ``shape`` (default: the cell's), under ``trace``
    where one is given: (outputs, state, batch), where outputs are what
    the step returns ((params, opt_state, metrics) to train, whole;
    (logits, caches), and the encoder's output for an encoder-decoder's
    prefill, to serve), state what it was given (params and opt_state,
    or params and caches, whole) and batch the shard's inputs."""
    shape = shape or cell.shape
    trace = StepTrace() if trace is None else trace
    shard_batch(cell, shape)
    with L.use_mesh(cell.mesh, dp_axes=cell.dp_axes):
        if shape.kind == "train":
            return _train_program(cell, shape, trace)
        return _serve_program(cell, shape, trace)


def trace_cell(cell: Cell, shape: ShapeConfig | None = None,
               trace: StepTrace | None = None) -> dict:
    """:func:`run_step`, its outputs held to its inputs (see the module
    docstring); returns the outputs' shapes.  Raises where the card's
    route refuses the cell."""
    shape = shape or cell.shape
    out, state, batch = run_step(cell, shape, trace)
    if shape.kind == "train":
        _same("parameters", out[0], state[0])
        _same("optimizer state", out[1], state[1])
        return {"loss": tuple(out[2]["loss"].shape)}
    _same("caches", out[1], state[1])
    b = batch["tokens"].shape[0]
    got = {"logits": tuple(out[0].shape)}
    want = {"logits": (b, 1, cell.api.cfg.vocab_size)}
    if "frames" in batch:
        got["enc_out"] = tuple(out[2].shape)
        want["enc_out"] = tuple(batch["frames"].shape)
    if got != want:
        raise ValueError(f"outputs {got}, expected {want}")
    return got


def step_record(memory: dict, trace: StepTrace, *,
                lower_bound: bool = False) -> dict:
    """The record's peak bytes, ``fits``, ``arguments_fit`` and work, from
    ``memory`` (:func:`memory`) and a traced program (see the module
    docstring); ``lower_bound``: the program ran at a smaller shape than
    the cell's."""
    temp = trace.peak_bytes - trace.held_bytes
    peak = memory["argument_size_in_bytes"] + temp
    fits = peak <= CARD_BYTES
    return {"memory": {**memory, "peak_bytes": peak,
                       "temp_size_in_bytes": temp,
                       "peak_is_lower_bound": lower_bound},
            "fits": None if lower_bound and fits else fits,
            "arguments_fit": memory["argument_size_in_bytes"] <= CARD_BYTES,
            "flops": trace.flops, "dot_flops": trace.dot_flops,
            "bytes_accessed": trace.bytes_accessed,
            "kernel_calls": dict(trace.kernel_calls)}


def _numel(sl) -> int:
    return int(np.prod([s.stop - s.start for s in sl], dtype=np.int64))


def ffn_moves(cfg, specs, tokens: int, e: int, tp: int) -> dict:
    """The bytes a split FFN layer (its parameters' ``specs``) on a row
    running ``tokens`` tokens in ``e``-byte activations sends each model
    slot m > 0, and receives back from it: an MLP whose spec splits
    ``d_ff``, and an MoE's shared expert, the normed activation out and
    a partial back ("activations"); an MoE whose spec splits the
    experts, the slot's experts' rows of the dispatch buffer out and
    their outputs back, E/tp x capacity x D each way ("dispatch")."""
    x = tokens * cfg.d_model * e
    out = {"activations": 0, "dispatch": 0}
    if "router" not in specs:
        if S.model_dim(specs["w_in"]) is not None:
            out["activations"] = x
        return out
    mc = cfg.moe
    if "shared" in specs and S.model_dim(specs["shared"]["w_in"]) is not None:
        out["activations"] = x
    if S.model_dim(specs["w_in"]) is not None:
        cap = max(8, int(mc.capacity_factor * tokens * mc.top_k
                         / mc.num_experts))
        out["dispatch"] = mc.num_experts // tp * cap * cfg.d_model * e
    return out


def mixer_moves(cfg, kind: str, specs, tokens: int, e: int,
                tp: int) -> dict:
    """{kind: (bytes out to model slot m, bytes back from it)}: what a
    split recurrent mixer (its parameters' ``specs``) on a row running
    ``tokens`` tokens in ``e``-byte activations moves between the row's
    first slot and each model slot m > 0 (the same for every m).  A
    Mamba layer whose spec splits ``di``: the normed activation out
    ("activations"); its ``in_proj`` columns back and its channels of
    ``x`` and ``z`` out ("reshuffle"); the whole (dt_r | B | C) out
    ("whole"); its ``x_proj`` partial and its partial output back
    ("partials").  An mLSTM layer whose spec splits ``di``: the normed
    activation out; its ``up_proj`` columns and its q and k columns back
    and its channels of ``z`` out ("reshuffle"); the whole ``u``, and
    the q, k and gates of the heads its block touches, out ("whole",
    ``xlstm.slot_rows``); its partial output back.  An sLSTM layer, or
    one whose ``di`` the spec leaves whole, runs on the first slot:
    nothing."""
    x = tokens * cfg.d_model * e
    if kind == "mamba" and S.model_dim(specs["in_proj"]) is not None:
        di = cfg.ssm.expand * cfg.d_model
        c = di // tp
        xdb = tokens * ((cfg.ssm.dt_rank or -(-cfg.d_model // 16))
                        + 2 * cfg.ssm.d_state) * e
        return {"activations": (x, 0),
                "reshuffle": (2 * tokens * c * e, tokens * 2 * c * e),
                "whole": (xdb, 0), "partials": (0, xdb + x)}
    if kind == "mlstm" and S.model_dim(specs["up_proj"]) is not None:
        di, nh = 2 * cfg.d_model, cfg.num_heads
        c = di // tp
        _, g, _, _ = X.slot_rows(di, nh, tp, 0)
        return {"activations": (x, 0),
                "reshuffle": (tokens * c * e, tokens * 4 * c * e),
                "whole": (tokens * (di + 2 * g * (di // nh) + 2 * g) * e,
                          0),
                "partials": (0, x)}
    return {}


RECURRENT = ("mamba", "mlstm", "slstm")


def sent_kv_heads(cfg, wq, wk_spec, tp: int, m: int) -> int:
    """The KV heads model slot m is sent by a split attention layer
    (``wq`` its query weight, ``wk_spec`` its ``wk``'s spec): those its
    query heads read where ``wk``/``wv`` are replicated, none where they
    are split (each slot projects its own)."""
    if S.model_dim(wk_spec) is not None:
        return 0
    hm = wq.shape[-2] // tp
    lo, hi = L._slot_kv_heads(m, hm, hm * tp // cfg.num_kv_heads)
    return hi - lo


def encoder_len(cell: Cell) -> int:
    """The encoder's positions in an encoder-decoder cell: its frames
    (train, prefill) or the encoder's output decode reads."""
    inputs = cell.api.input_specs(cell.shape)
    return inputs["frames" if "frames" in inputs else "enc_out"].shape[1]


def _encdec_layer_moves(cell: Cell, tp: int, b: int) -> list[tuple]:
    """:func:`_layer_moves` of an encoder-decoder: each encoder layer's
    attention and MLP over its frames, then each decoder layer's self-
    and cross-attention and MLP over its tokens; a cross-attention sends
    the normed activation (and where ``wk``/``wv`` are replicated the KV
    heads a slot reads, over the encoder's positions) and gets its
    partial back."""
    cfg = cell.api.cfg
    params, specs = cell.trees["params"]
    e = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    te, t = encoder_len(cell), cell.api.input_specs(cell.shape)[
        "tokens"].shape[1]
    d, hd = cfg.d_model, cfg.resolved_head_dim
    remat = cfg.remat == "full"

    def attn(m, p, sp, tq, tkv):
        return b * tq * d * e + 2 * b * tkv * sent_kv_heads(
            cfg, p["wq"], sp["wk"], tp, m) * hd * e, b * tq * d * e

    def layer(parts, mlp, tq):
        to, back = [0] * tp, [0] * tp
        x = ffn_moves(cfg, mlp, b * tq, e, tp)["activations"]
        for m in range(1, tp):
            for p, sp, tkv in parts:
                a, c = attn(m, p, sp, tq, tkv)
                to[m] += a
                back[m] += c
            to[m] += x
            back[m] += x
        return remat, to, back

    enc = layer([(params["enc"]["attn"], specs["enc"]["attn"], te)],
                specs["enc"]["mlp"], te)
    dec = layer([(params["dec"][k], specs["dec"][k], tkv)
                 for k, tkv in (("self", t), ("cross", te))],
                specs["dec"]["mlp"], t)
    return [enc] * cfg.enc_layers + [dec] * cfg.num_layers


def _layer_moves(cell: Cell, tp: int, b: int) -> list[tuple]:
    """A split step's layers, in order, each (under remat, bytes its
    forward sends from the row's first slot to model slot m, and from
    slot m back, for m in 1 .. tp-1): its backward sends the same bytes
    the other way, and a recompute its forward's again.  A GQA layer
    sends the normed activation (and the KV heads a slot reads where
    ``wk``/``wv`` are replicated), an MLA layer its latents ``cq``,
    ``ckv`` and ``k_rope``; each gets its partial output back; a
    recurrent mixer moves what :func:`mixer_moves` counts; an
    encoder-decoder's layers, :func:`_encdec_layer_moves`."""
    cfg = cell.api.cfg
    if cfg.family == "encdec":
        return _encdec_layer_moves(cell, tp, b)
    params, specs = cell.trees["params"]
    t, d = cell.shape.seq_len, cfg.d_model
    e = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    x = b * t * d * e
    hd = cfg.resolved_head_dim

    def layer(blk, blk_specs, kind):
        to, back = [0] * tp, [0] * tp
        ffn = ffn_moves(cfg, blk_specs["ffn"], b * t, e, tp) \
            if "ffn" in blk_specs else {"dispatch": 0, "activations": 0}
        mix = mixer_moves(cfg, kind, blk_specs["mixer"], b * t, e, tp)
        for m in range(1, tp):
            if kind in RECURRENT:
                to[m] += sum(a for a, _ in mix.values())
                back[m] += sum(a for _, a in mix.values())
            elif cfg.mla is not None:
                back[m] += x
                ml = cfg.mla
                to[m] += b * t * (ml.q_lora_rank + ml.kv_lora_rank
                                  + ml.qk_rope_head_dim) * e
            else:
                back[m] += x
                to[m] += x + 2 * b * t * sent_kv_heads(
                    cfg, blk["mixer"]["wq"], blk_specs["mixer"]["wk"], tp,
                    m) * hd * e
            to[m] += ffn["dispatch"] + ffn["activations"]
            back[m] += ffn["dispatch"] + ffn["activations"]
        return to, back

    out = []
    remat = cfg.remat == "full"
    for per in range(cfg.n_periods):
        for blk, blk_specs, kind in zip(params["stack"], specs["stack"],
                                        cfg.period_pattern):
            out.append((remat, *layer(blk, blk_specs, kind)))
    for blk, blk_specs, kind in zip(params["rem"], specs["rem"],
                                    cfg.remainder_kinds):
        out.append((False, *layer(blk, blk_specs, kind)))
    return out


def _vocab_rows(cfg, specs) -> bool:
    """Whether a split step's logits' weight is split by vocabulary rows
    (else along ``d_model``: the row-parallel fallback)."""
    w = specs["embed"]["tokens" if cfg.tie_embeddings else "head"]
    return L.vocab_rows(S.model_dim(w), cfg.tie_embeddings)


def _split_moves(cell: Cell, parts: MeshStep, out) -> None:
    """The moves within each data row of a split step (see
    :func:`transfers`), added to ``out``."""
    cfg = cell.api.cfg
    batch = cell.api.input_specs(cell.shape)
    b = shard_batch(cell)
    tt = batch["tokens"].shape[1]
    ck = min(cfg.loss_chunk, tt)
    while tt % ck:
        ck -= 1
    e = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    xt = b * tt * cfg.d_model * e
    f32 = 4
    rows = _vocab_rows(cfg, cell.trees["params"][1])
    enc = 0                       # the encoder's output, sent once a step
    if cfg.family == "encdec" and S.model_dim(
            cell.trees["params"][1]["dec"]["cross"]["wk"]) is not None:
        enc = b * encoder_len(cell) * cfg.d_model * e
    for i in parts.slots:
        row = parts.rows[i]
        tp = len(row)
        layers = _layer_moves(cell, tp, b)
        for m in range(1, tp * bool(enc)):
            out["encoder"][row[0], row[m]] += enc
            out["encoder"][row[m], row[0]] += enc
        xs = xt if rows else xt // tp         # x, or its d_model columns
        if not rows:          # each slot's block of every slot's partial
            for c, (lo, hi) in enumerate(L.vocab_blocks(cfg.vocab_size,
                                                        tp)):
                for a in range(tp):
                    if a != c:
                        out["loss"][row[a], row[c]] += b * tt * (hi - lo) \
                            * f32
                        out["loss"][row[c], row[a]] += b * tt * (hi - lo) \
                            * f32
        for m in range(1, tp):
            h, s = row[0], row[m]
            out["embed"][h, s] += b * tt * batch["tokens"].element_size() \
                + xs
            out["embed"][s, h] += xs
            out["loss"][h, s] += xs + b * tt * (
                3 * f32 + batch["labels"].element_size())
            out["loss"][s, h] += xs + b * tt * 3 * f32
            for remat, to, back in layers:
                out["forward"][h, s] += to[m]
                out["forward"][s, h] += back[m]
                out["backward"][s, h] += to[m]
                out["backward"][h, s] += back[m]
                if remat:
                    out["recompute"][h, s] += to[m]
                    out["recompute"][s, h] += back[m]


def transfers(cell: Cell) -> dict:
    """{kind: {(from slot, to slot): bytes}}: what one step of the
    meshed train step (``MeshStep``, one micro-batch) sends between
    slots, from the layouts alone, in ``mesh.devices.flat`` indices: the
    batch's rows and the count of its labels from slot 0 to each other
    data shard's first slot ("batch"); the loss, cross-entropy and aux
    (all but an encoder-decoder) of each to slot 0, and its gradients
    ("grads"); the norm from slot 0 to every slot ("norm"); the gradient
    laid out onto the moments' blocks ("scatter"); and, where the
    moments' spec differs from the parameters', the parameters laid out
    by the moments' spec ("relayout") and back ("layback").

    A gathered step (``MeshStep.split`` false) also gathers each block
    ``sharded.sources`` reads into the parameters on each data shard's
    first slot ("gather"), sends each shard's whole gradient to slot 0,
    lays the gradient out from slot 0, and relays the parameters through
    slot 0.  A split step gathers nothing: within each data row, the
    split layers' forward sends (the normed activation to each model
    slot, the KV heads each slot reads where ``wk``/``wv`` are
    replicated, an MLA layer's latents, an MoE's experts' rows of the
    dispatch buffer, a Mamba or mLSTM layer's moves
    (:func:`mixer_moves`), the partials and expert outputs back to the
    first slot: "forward"), their backward's ("backward"), the forward's again
    where remat recomputes a period ("recompute"), an encoder-decoder's
    output to each model slot and its gradient back, once a step, where
    the cross ``wk``/``wv`` split ("encoder"), the embedding's
    tokens, partials (row-parallel: columns) and their gradient
    ("embed"), and the loss's normed chunks, maxima, labels and sums
    (row-parallel: the chunks' columns and fp32 partial logits, each
    way: "loss"); each split leaf's gradient is sent block by block to
    the first row's slot of that block, the replicated leaves' whole to
    slot 0, each of the first row's other slots sends slot 0 its part of
    the norm, and every layout reads each slot's block from the slots
    that hold it (``sharded.plan``)."""
    mesh, api = cell.mesh, cell.api
    coords = list(np.ndindex(*mesh.devices.shape))
    with L.use_mesh(mesh, dp_axes=cell.dp_axes):
        b_specs = api.input_pspecs(cell.shape)
    parts = MeshStep(api, O.AdamWConfig(), mesh, dp_axes=cell.dp_axes,
                     param_specs=cell.trees["params"][1],
                     opt_specs=cell.trees["opt"][1], batch_specs=b_specs)
    slots = parts.slots
    out = collections.defaultdict(collections.Counter)
    f32 = 4
    batch = api.input_specs(cell.shape)
    scalars = 2 if api.cfg.family == "encdec" else 3
    for i in slots[1:]:
        for k, v in batch.items():
            sl = S.Layout(mesh, b_specs[k]).block_slices(v.shape, coords[i])
            out["batch"][0, i] += _numel(sl) * v.element_size()
        out["batch"][0, i] += f32
        out["grads"][i, 0] += scalars * f32
    for i in range(1, len(coords)):
        out["norm"][0, i] += f32

    def gather_onto(kind, leaf, lay, dst):
        for j, sl in S.sources(lay, leaf.shape, dst):
            if j != dst:
                out[kind][j, dst] += _numel(sl) * leaf.element_size()

    def lay_out_from(kind, leaf, lay, src):
        for i, c in enumerate(coords):
            if i != src:
                out[kind][src, i] += _numel(lay.block_slices(
                    leaf.shape, c)) * leaf.element_size()

    def read(kind, leaf, held, lay):
        for j, pieces in enumerate(S.plan(held, leaf.shape, lay)):
            for i, piece in pieces:
                if i != j:
                    out[kind][i, j] += _numel(piece) * leaf.element_size()

    params, p_specs = cell.trees["params"]
    m_specs = cell.trees["opt"][1]["m"]
    if parts.split:
        _split_moves(cell, parts, out)
        first = parts.rows[slots[0]]
    for leaf, ps, ms in zip(L.tree_leaves(params), L.tree_leaves(p_specs),
                            L.tree_leaves(m_specs)):
        p_lay, m_lay = S.Layout(mesh, ps), S.Layout(mesh, ms)
        if not parts.split:
            for d in slots:
                gather_onto("gather", leaf, p_lay, d)
            for i in slots[1:]:
                out["grads"][i, 0] += leaf.numel() * leaf.element_size()
            lay_out_from("scatter", leaf, m_lay, 0)
            if tuple(ps) != tuple(ms):
                gather_onto("relayout", leaf, p_lay, 0)
                lay_out_from("relayout", leaf, m_lay, 0)
                gather_onto("layback", leaf, m_lay, 0)
                lay_out_from("layback", leaf, p_lay, 0)
            continue
        held = first if S.model_dim(ps) is not None else first[:1]
        for i in slots[1:]:
            for m, dst in enumerate(held):
                src = parts.rows[i][m]
                out["grads"][src, dst] += _numel(p_lay.block_slices(
                    leaf.shape, coords[dst])) * leaf.element_size()
        read("scatter", leaf, [(j, p_lay.block_slices(leaf.shape, coords[j]))
                               for j in held], m_lay)
        if tuple(ps) != tuple(ms):
            every = range(len(coords))
            read("relayout", leaf, [(j, p_lay.block_slices(
                leaf.shape, coords[j])) for j in every], m_lay)
            read("layback", leaf, [(j, m_lay.block_slices(
                leaf.shape, coords[j])) for j in every], p_lay)
    if parts.split:
        for j in first[1:]:
            out["norm"][j, 0] += f32
    return {k: dict(v) for k, v in out.items()}


def _layers(cell: Cell, geometry):
    """Each layer of the cell in order: (its parameters' specs, its kind,
    its caches, their specs and their :class:`serve.Geometry`, from
    ``geometry``)."""
    cfg = cell.api.cfg
    _, p_specs = cell.trees["params"]
    c_tree, c_specs = cell.trees["caches"]
    if cfg.family == "encdec":     # the decoder's: self-attention's caches
        dec = p_specs["dec"]
        for _ in range(cfg.num_layers):
            yield ({"mixer": dec["self"], "ffn": dec["mlp"],
                    "cross": dec["cross"]}, "attn", c_tree["self"],
                   c_specs["self"], geometry["self"])
        return
    for per in range(cfg.n_periods):
        for pos, kind in enumerate(cfg.period_pattern):
            yield (p_specs["stack"][pos], kind, c_tree["stack"][pos],
                   c_specs["stack"][pos], geometry["stack"][pos])
    for pos, kind in enumerate(cfg.remainder_kinds):
        yield (p_specs["rem"][pos], kind, c_tree["rem"][pos],
               c_specs["rem"][pos], geometry["rem"][pos])


def _state_moves(out, mesh, coords, row, kind, split, caches, specs,
                 geometry) -> None:
    """A recurrent layer's cache moves in a split serving step (see
    :func:`serve_transfers`), added to ``out`` under "state": a Mamba
    layer split by channels, each model slot's block to its replicas
    outside the row (long mode); an mLSTM layer split by rows of C,
    each slot's rows of C and the n and m of the heads no earlier slot
    computed to the row's first slot, then, as for a layer run whole on
    the first slot (sLSTM, or a ``di`` the spec leaves whole), each leaf
    whole from the first slot to every other model slot, and each model
    slot's to its replicas outside the row."""
    h, tp = row[0], len(row)

    def layer_bytes(key, j):
        sl = S.Layout(mesh, specs[key]).block_slices(caches[key].shape,
                                                     coords[j])
        return _numel(sl[geometry[key].lead:]) * caches[key].element_size()

    reps = {key: state_replicas(S.Layout(mesh, specs[key]),
                                caches[key].shape, coords, row)
            for key in caches}

    def to_replicas(key, m):
        for r in reps[key][m]:
            out["state"][row[m], r] += layer_bytes(key, row[m])

    if kind == "mamba" and split:
        for key in caches:
            for m in range(tp):
                to_replicas(key, m)
        return
    if kind == "mlstm" and split:
        c = caches["C"]
        lead = geometry["C"].lead
        sl = S.Layout(mesh, specs["C"]).block_slices(c.shape, coords[h])
        b = sl[lead].stop - sl[lead].start
        nh, hd = c.shape[lead + 1], c.shape[lead + 2]
        done = 0
        for m in range(1, tp + 1):
            h0, g, _, r = X.slot_rows(nh * hd, nh, tp, m - 1)
            new = h0 + g - max(done, h0)
            done = max(done, h0 + g)
            if m - 1 == 0:
                continue
            out["state"][row[m - 1], h] += b * g * r * hd * 4
            if new > 0:
                out["state"][row[m - 1], h] += b * new * (hd + 1) * 4
    for key in caches:
        to_replicas(key, 0)
        for m in range(1, tp):
            out["state"][h, row[m]] += layer_bytes(key, h)
            to_replicas(key, m)


def _mla_cache_moves(out, row, spans, size, *, b, t, wide, decode, offs,
                     off_bytes) -> None:
    """An MLA layer's cache moves in a split serving step (see
    :func:`serve_transfers`), added to ``out``: the compressed rows from
    the row's first slot ``h`` to the slots whose blocks hold their
    positions ("cache", ``wide`` bytes a row of ``ckv`` and ``krope``
    together); to decode also the write offsets to each model slot
    ("positions") and every block of the layer to each model slot that
    does not hold it ("latent")."""
    h = row[0]
    if not decode:
        for j, _, (lo, hi) in L.write_plan(spans, [(0, 1)], rows=t):
            if j != h:
                out["cache"][h, j] += b * (hi - lo) * wide
        return
    pos = [min(max(o, 0), size[0] - 1) for o in offs]
    for j, _, got in L.write_plan(spans, [(0, 1)], pos=pos):
        if j != h:
            out["cache"][h, j] += len(got) * wide
    readers = L.CacheBlocks((None,) * len(spans), spans, size,
                            S.ModelRow(row, None)).readers()
    for j in row:
        if j != h:
            out["positions"][h, j] += off_bytes
        for i, ((p0, p1), _) in readers:
            if i != j:
                out["latent"][i, j] += b * (p1 - p0) * wide


def serve_transfers(cell: Cell) -> dict:
    """{kind: {(from slot, to slot): bytes}}: what one split serving step
    (``MeshServe``, prefill or one decode step at
    :func:`decode_offsets`) sends between slots, from the layouts alone,
    within each running data row (every row; in long mode the first,
    whose sequence's blocks lie on every row's slots): the tokens to
    each model slot and their embedding rows (or, where the vocabulary
    does not divide the model degree, their ``d_model`` columns) back
    ("embed"); the normed activation to each model slot before each split
    GQA attention, MLP (an MoE's shared expert) and the logits (its
    columns to the row-parallel logits), an MLA layer's latents (``cq``,
    and to prefill ``ckv`` and ``k_rope``: "activations") and each slot's
    partial output back ("partials"); an MoE's experts' rows of the
    dispatch buffer to each slot ("dispatch") and their outputs back
    ("combine"); to prefill where ``wk``/``wv`` are replicated, the KV
    heads each slot reads ("kv"); the new k/v (or compressed) rows from
    the slot that made them to each slot whose block holds their
    position and heads (``layers.write_plan``, "cache"); to decode, the
    write offsets to each slot that ropes or reads ("positions"), over a
    GQA cache split by positions, the query heads gathered onto each
    reading slot (``layers.query_plan``, "query"), its (out, lse)
    partials to the first slot and the merged heads out to each model
    slot ("merge"), and an MLA layer's compressed blocks to each model
    slot that does not hold them ("latent"); the row-parallel logits'
    partials to the first slot and the whole logits back out to each
    model slot, and in long mode the other rows' logits blocks
    ("logits"); a Mamba or mLSTM layer's moves by :func:`mixer_moves`'
    kinds ("activations", "reshuffle", "whole", "partials") and its
    states' copies (:func:`_state_moves`, "state"); an encoder-decoder's
    encoder layers to prefill ("activations", "partials", "kv"), its
    output to each model slot ("encoder"), and each decoder layer's
    cross-attention: its normed activation and partial, and where
    ``wk``/``wv`` are replicated the KV heads of the encoder's positions
    each slot reads ("cross")."""
    api, mesh, shape = cell.api, cell.mesh, cell.shape
    cfg = api.cfg
    long_mode = _is_long_mode(shape)
    serve = MeshServe(api, mesh, dp_axes=dp_axes_of(mesh),
                      long_mode=long_mode)
    coords = serve.coords
    e = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    f32 = 4
    inputs = api.input_specs(shape)
    tok = inputs["tokens"]
    decode = shape.kind == "decode"
    b = shape.global_batch if long_mode else shard_batch(cell)
    tt = tok.shape[1]
    t = 1 if decode else shape.seq_len
    d, hd, kvh = cfg.d_model, cfg.resolved_head_dim, cfg.num_kv_heads
    v = cfg.vocab_size
    x = b * t * d * e
    rows = _vocab_rows(cfg, cell.trees["params"][1])
    mla = cfg.mla is not None
    off_bytes = b * inputs["lengths"].element_size() if decode else 0
    out = collections.defaultdict(collections.Counter)
    encdec = cfg.family == "encdec"
    te = encoder_len(cell) if encdec else 0
    for i in serve.running:
        row = serve.rows[i]
        tp, h = len(row), row[0]
        dm = d if rows else d // tp       # the embedding's and logits' width
        hm = L.padded_heads(cfg.num_heads, kvh, tp) // tp
        for m in range(1, tp):
            out["embed"][h, row[m]] += b * tt * tok.element_size()
            out["embed"][row[m], h] += b * tt * dm * e
            out["activations"][h, row[m]] += b * dm * e     # the logits
            if not rows:
                out["logits"][row[m], h] += b * v * e
                out["logits"][h, row[m]] += b * v * e
            if encdec and not decode:     # the encoder, and its output
                enc_p, enc_s = cell.trees["params"][0]["enc"], \
                    cell.trees["params"][1]["enc"]
                xe = b * te * d * e
                out["activations"][h, row[m]] += 2 * xe * cfg.enc_layers
                out["partials"][row[m], h] += 2 * xe * cfg.enc_layers
                n = sent_kv_heads(cfg, enc_p["attn"]["wq"],
                                  enc_s["attn"]["wk"], tp, m)
                if n:
                    out["kv"][h, row[m]] += 2 * b * te * n * hd * e \
                        * cfg.enc_layers
                out["encoder"][h, row[m]] += xe
        for specs, kind, c_tree, c_specs, geom in _layers(cell,
                                                         serve.geometry):
            ffn = ffn_moves(cfg, specs["ffn"], b * t, e, tp) \
                if "ffn" in specs else {"dispatch": 0, "activations": 0}
            if kind in RECURRENT:
                mix = mixer_moves(cfg, kind, specs["mixer"], b * t, e, tp)
                for m in range(1, tp):
                    for k, (to, back) in mix.items():
                        if to:
                            out[k][h, row[m]] += to
                        if back:
                            out[k][row[m], h] += back
                    if ffn["activations"]:
                        out["activations"][h, row[m]] += ffn["activations"]
                        out["partials"][row[m], h] += ffn["activations"]
                    if ffn["dispatch"]:
                        out["dispatch"][h, row[m]] += ffn["dispatch"]
                        out["combine"][row[m], h] += ffn["dispatch"]
                _state_moves(out, mesh, coords, row, kind, bool(mix),
                             c_tree, c_specs, geom)
                continue
            key = "k" if cfg.mla is None else "ckv"
            leaf, c_spec = c_tree[key], c_specs[key]
            act = x
            if mla:
                ml = cfg.mla
                act = b * t * (ml.q_lora_rank + (0 if decode else (
                    ml.kv_lora_rank + ml.qk_rope_head_dim))) * e
            for m in range(1, tp):
                out["activations"][h, row[m]] += act + ffn["activations"]
                out["partials"][row[m], h] += x + ffn["activations"]
                if ffn["dispatch"]:
                    out["dispatch"][h, row[m]] += ffn["dispatch"]
                    out["combine"][row[m], h] += ffn["dispatch"]
                if "cross" in specs:      # its normed activation, partial
                    out["activations"][h, row[m]] += x
                    out["partials"][row[m], h] += x
                    if S.model_dim(specs["cross"]["wk"]) is None:
                        lo, hi = L._slot_kv_heads(m, hm, hm * tp // kvh)
                        out["cross"][h, row[m]] += 2 * b * te * (hi - lo) \
                            * hd * e
            spans, size = cache_spans(S.Layout(mesh, c_spec), leaf.shape,
                                      coords, i, lead=geom[key].lead,
                                      heads=not mla)
            if mla:
                _mla_cache_moves(out, row, spans, size, b=b, t=t,
                                 wide=(ml.kv_lora_rank
                                       + ml.qk_rope_head_dim) * e,
                                 decode=decode,
                                 offs=decode_offsets(shape)[:b],
                                 off_bytes=off_bytes)
                continue
            split_kv = S.model_dim(specs["mixer"]["wk"]) is not None
            gp = hm * tp // kvh
            kvm = kvh // tp if split_kv else kvh
            heads = [(m * kvm, (m + 1) * kvm) for m in range(tp)] \
                if split_kv else [(0, kvh)]
            makers = row if split_kv else [h]
            cap = size[0]
            if not decode:
                if not split_kv:
                    for m in range(1, tp):
                        lo, hi = L._slot_kv_heads(m, hm, gp)
                        out["kv"][h, row[m]] += 2 * b * t * (hi - lo) * hd * e
                n = min(t, cap) if kind == "local" else t
                for j, k, (lo, hi) in L.write_plan(spans, heads, rows=n):
                    if makers[k] != j:
                        out["cache"][makers[k], j] += 2 * b * (hi - lo) \
                            * kvm * hd * e
                continue
            offs = decode_offsets(shape)[:b]
            pos = [o % cap if kind == "local" else min(max(o, 0), cap - 1)
                   for o in offs]
            for j, k, got in L.write_plan(spans, heads, pos=pos):
                if makers[k] != j:
                    out["cache"][makers[k], j] += 2 * len(got) * kvm * hd * e
            readers = L.CacheBlocks((None,) * len(spans), spans, size,
                                    S.ModelRow(row, None)).readers()
            for j in sorted(set(row) | {j for j, _ in readers}):
                if j != h:
                    out["positions"][h, j] += off_bytes
            if all(sp[0] == (0, cap) for _, sp in readers):
                continue
            for j, (_, hs) in readers:
                for m, lo, hi in L.query_plan(hs, hm, gp, tp):
                    if row[m] != j:
                        out["query"][row[m], j] += b * (hi - lo) * hd * e
                nq = (hs[1] - hs[0]) * gp
                if j != h:
                    out["merge"][j, h] += b * nq * (hd + 1) * f32
            for m in range(1, tp):
                out["merge"][h, row[m]] += b * hm * hd * e
    if long_mode:
        lay = S.Layout(mesh, serve.logits_spec)
        lshape = (b, 1, v)
        first = serve.rows[serve.running[0]]
        for j, c in enumerate(coords):
            if j not in first:
                sl = lay.block_slices(lshape, c)
                src = next(r for r in first if S._key(lay.block_slices(
                    lshape, coords[r])) == S._key(sl))
                out["logits"][src, j] += _numel(sl) * e
    return {k: dict(v) for k, v in out.items()}


def model_split(cell: Cell) -> bool:
    """Whether the cell's step splits its compute over the model axis:
    a cell of an architecture that ``ModelAPI.model_split`` names, on a
    model axis wider than one (a train step, or a serving step:
    ``MeshServe``)."""
    return cell.mesh.shape["model"] > 1 and cell.api.model_split()


def collectives(cell: Cell) -> dict | None:
    """The ``collectives`` record of a train cell or a split serving cell
    (None for a gathered serving cell, which moves nothing between
    slots): of :func:`transfers` (:func:`serve_transfers`), the bytes
    the busiest slot sends and receives, by kind (``bytes_by_kind``) and
    in all (``total_bytes``), which slot that is (``slot``, a flat
    index), and every slot's bytes sent summed (``mesh_total_bytes``)."""
    if cell.shape.kind != "train" and not model_split(cell):
        return None
    moves = transfers(cell) if cell.shape.kind == "train" \
        else serve_transfers(cell)
    zero = np.zeros(cell.mesh.devices.size, dtype=np.int64)
    per = {k: zero.copy() for k in moves}
    for k, m in moves.items():
        for (src, dst), b in m.items():
            per[k][src] += b
            per[k][dst] += b
    total = sum(per.values(), zero)
    slot = int(np.argmax(total))
    return {"bytes_by_kind": {k: int(v[slot]) for k, v in per.items()},
            "total_bytes": int(total[slot]), "slot": slot,
            "mesh_total_bytes": int(sum(sum(m.values())
                                        for m in moves.values()))}


def analyze(cell: Cell, *, chips: int, aux) -> dict:
    """The cell's record before its trace: ``aux``, ``memory``,
    ``model_flops``, ``collectives`` and ``chips``."""
    shape = cell.shape
    out = dict(aux)
    out["memory"] = memory(cell)
    # MODEL_FLOPS: 6*N_active*D train; 2*N_active*D forward-only
    n_act = aux["params_active"]
    if shape.kind == "train":
        out["model_flops"] = 6.0 * n_act * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        out["model_flops"] = 2.0 * n_act * shape.global_batch * shape.seq_len
    else:
        out["model_flops"] = 2.0 * n_act * shape.global_batch
    out["collectives"] = collectives(cell)
    out["model_split"] = model_split(cell)
    out["chips"] = chips
    return out


def analyze_cell(cfg, shape: ShapeConfig, mesh, *,
                 trace_shape: ShapeConfig | None = None) -> tuple[Cell, dict]:
    """(cell, record) of ``cfg`` at ``shape`` on ``mesh``: bytes a slot,
    transfers, and slot 0's program traced at ``trace_shape`` (default:
    ``shape``)."""
    t0 = time.perf_counter()
    cell, aux = lower_cell(cfg, shape, mesh)
    rec = analyze(cell, chips=int(mesh.devices.size), aux=aux)
    t_lower = time.perf_counter() - t0
    trace_shape = trace_shape or shape
    trace = StepTrace()
    t0 = time.perf_counter()
    rec["trace_outputs"] = trace_cell(cell, trace_shape, trace)
    t_trace = time.perf_counter() - t0
    smaller = (trace_shape.global_batch, trace_shape.seq_len) != \
        (shape.global_batch, shape.seq_len)
    rec.update(step_record(rec["memory"], trace, lower_bound=smaller))
    rec.update(mesh=dict(mesh.shape), lower_s=round(t_lower, 2),
               trace_s=round(t_trace, 2), seq_len=shape.seq_len,
               global_batch=shape.global_batch, kind=shape.kind,
               trace_batch=shard_batch(cell, trace_shape),
               trace_seq_len=trace_shape.seq_len)
    return cell, rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, dev: bool,
             smoke: bool = False, out_dir: str | None = None,
             trace_shape: ShapeConfig | None = None) -> dict:
    """One cell: its record (:func:`analyze_cell`), printed and written
    under ``out_dir``."""
    cfg = (SMOKES if smoke else ARCHS)[arch]
    mesh = make_mesh(multi_pod=multi_pod, dev=dev)
    shape = SHAPES[shape_name]
    if dev:
        shape = dev_shape(shape, mesh)
    _, rec = analyze_cell(cfg, shape, mesh, trace_shape=trace_shape)
    rec.update(arch=arch, shape=shape_name, multi_pod=multi_pod, dev=dev)
    print(json.dumps({k: rec[k] for k in
                      ("arch", "shape", "multi_pod", "chips", "model_flops",
                       "dot_flops", "fits", "trace_s")}, indent=None))
    print(f"  memory a slot: {rec['memory']}")
    if rec["collectives"] is not None:
        print(f"  collectives: {rec['collectives']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        base = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
        with open(os.path.join(out_dir, base + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def cells(arch: str | None, shape: str | None, every: bool) -> list:
    """(arch, shape) pairs: ``--all``'s ``ARCHS x shapes_for``, or one."""
    if every:
        return [(a, s.name) for a in ARCHS for s in shapes_for(a)]
    if not (arch and shape):
        raise SystemExit("--arch/--shape or --all")
    return [(arch, shape)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--dev", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    args = ap.parse_args(argv)

    todo = cells(args.arch, args.shape, args.all)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in todo:
        for mp in meshes:
            try:
                run_cell(arch, shape, multi_pod=mp, dev=args.dev,
                         smoke=args.smoke, out_dir=args.out)
            except Exception as e:  # noqa: BLE001 - a failed cell is a finding
                traceback.print_exc()
                failures.append((arch, shape, mp, f"{type(e).__name__}: {e}"))
    if failures:
        print(f"\nFAILED {len(failures)} cells:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print(f"\nALL {len(todo) * len(meshes)} dry-run cells traced OK")


if __name__ == "__main__":
    main()
