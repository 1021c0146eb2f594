"""Fault-tolerant trainer: the train step (gradient accumulation, remat
through the model's ``cfg.remat``), training on a mesh of slots with
ZeRO-1, async checkpointing with deterministic resume, straggler
detection, and failure recovery (replay from the last committed step).

Counterpart of ``repro/train/trainer.py``.  The reference's step is
``jax.value_and_grad`` under ``jit``; here it is the loss, then
``torch.autograd.grad`` with respect to every parameter leaf, run
eagerly.  A leaf the loss does not reach gets no gradient (``None``):
the step raises naming it rather than let the optimizer skip it, so a
path that cuts the graph (a kernel without a backward) cannot train
silently.

``Trainer(mesh=..., dp_axes=..., zero1=...)`` lays the parameters out
over the mesh's slots by ``api.param_pspecs()`` and the optimizer state
by ``opt_pspecs`` (``train/sharded.py``), each slot holding the block
the reference's ``NamedSharding`` puts on the matching device.  Each
data shard's batch rows run on its data row of slots, in one of two
ways (:class:`MeshStep`):

* split, where ``api.model_split()`` (every architecture: GQA
  attention, MLA, Mamba, mLSTM or sLSTM and the gated MLP, an MoE or no
  FFN in every layer, and seamless's encoder-decoder) and the model axis
  is wider than one: the row's model slots compute as the reference's
  GSPMD step does, each on its own blocks of the parameters (its query heads,
  MLP columns or experts, Mamba channels or rows of mLSTM's C and
  vocabulary block, or its ``d_model`` columns of an embedding whose
  vocabulary the model degree does not divide; see
  ``models/layers.py``, ``mamba.py``, ``xlstm.py``, ``encdec.py``:
  the encoder's output sent to each model slot once a step), the partials
  summed (the expert outputs and projections' columns concatenated) in
  slot order on the row's first slot, which holds the replicated
  activations and runs the norms, MLA's down-projections, the MoE's
  routing, mLSTM's gates and the sLSTM blocks.  Nothing is gathered:
  each split leaf's gradient is summed per block over the data rows onto the first row's slot of that block,
  each replicated leaf's onto slot 0, and the norm is the slot-order
  sum of each slot's blocks' squares;
* gathered, on a model axis of one: the whole
  parameters are gathered onto the row's first slot, which runs the
  shard's rows through the normal kernels, and the shards' whole
  gradients are summed in slot order on slot 0.

Each shard's loss is weighted so that the shards sum to the reference's
global loss: the cross-entropy by the shard's share of the labels that
count, an MoE's aux at 1/dp (the reference's ``pmean``); the MoE's
capacity is the shard's own, as under the reference's ``shard_map``.
The gradient, clipped by its global norm, is laid out onto the moments'
blocks from the slots that hold it, and each slot runs the AdamW
arithmetic on its block; under ZeRO-1 the updated parameter slices are
then brought back over the data axes into the parameters' layout (the
gathered step through slot 0, the split one slot to slot).

On a mesh of a process group (``launch/mesh.py``, the multi-host entry
``launch/procs.py``) each process runs :class:`ProcStep`: the same
parts, each slot's work only in the process that owns it (``at``), each
move between processes a send met by a receive, the metrics slot 0's
broadcast from its process; every process lays out only its own slots'
blocks, builds the global batch and keeps its rows, and the checkpoint
is written by slot 0's process.

A step's three parts run under ``torch.profiler`` ranges named
``train_step.forward``, ``train_step.backward`` and
``train_step.optimizer``, so a profiler window splits its time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from ..device import resolve_device
from ..models import layers as L
from ..models.api import ModelAPI
from . import optimizer as O
from . import sharded as S
from .checkpoint import Checkpointer


def loss_and_grads(api: ModelAPI, params, batch, objective=None, *,
                   absent=None):
    """(loss, metrics, grads): ``api.train_loss`` and the gradient of the
    loss with respect to every leaf of ``params`` (a tuple of one for
    each block of a ``layers.Blocks`` leaf); raises ``RuntimeError``
    naming the leaves the loss does not reach, or, where ``absent`` is
    given, takes ``absent(tensor)`` as their gradient (the dry run's
    other slots).  ``objective(loss, metrics)``, where given, is the
    scalar returned and differentiated in place of the loss."""
    items = L.tree_items(params)
    fresh = lambda t: t.detach().requires_grad_(True)  # noqa: E731
    given = [dataclasses.replace(p, blocks=tuple(map(fresh, p.blocks)))
             if isinstance(p, L.Blocks) else fresh(p) for _, p in items]
    leaves = [t for p in given
              for t in (p.blocks if isinstance(p, L.Blocks) else (p,))]
    with torch.enable_grad():
        with record_function("train_step.forward"):
            loss, metrics = api.train_loss(L.tree_unflatten(params, given),
                                           batch)
            if objective is not None:
                loss = objective(loss, metrics)
        with record_function("train_step.backward"):
            grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    if absent is not None:
        grads = iter([absent(t) if g is None else g
                      for t, g in zip(leaves, grads)])
    grads = [tuple(next(grads) for _ in p.blocks)
             if isinstance(p, L.Blocks) else next(grads) for p in given]
    missing = ["/".join(map(str, path)) for (path, _), g in zip(items, grads)
               if any(x is None for x in (g if isinstance(g, tuple)
                                          else (g,)))]
    if missing:
        raise RuntimeError(f"no gradient reaches {len(missing)} parameter "
                           f"leaves: {missing}")
    detach = lambda t: t.detach() if isinstance(t, torch.Tensor) else t  # noqa: E731
    return (loss.detach(), {k: detach(v) for k, v in metrics.items()},
            L.tree_unflatten(params, grads))


def _here(slot, fn, *args):
    return fn(*args)


def _blockwise(fn, at=_here):
    """``fn`` on tensors (slot 0's work), and on the held blocks of a
    ``sharded.Laid``, block by block, each its slot's work (the split
    step's gradients)."""
    def apply(a, *rest):
        if isinstance(a, S.Laid):
            return S.Laid(a.layout, a.shape, [
                None if x is None else at(k, fn, x, *(r.blocks[k]
                                                      for r in rest))
                for k, x in enumerate(a.blocks)])
        return at(0, fn, a, *rest)
    return apply


def make_train_step(api: ModelAPI, opt_cfg: O.AdamWConfig, *,
                    grad_accum: int = 1, grads_fn=None, update_fn=None,
                    at=_here):
    """(params, opt_state, batch) -> (params, opt_state, metrics).
    ``grads_fn(params, batch)`` and ``update_fn(params, grads, state)``
    replace ``loss_and_grads`` and ``apply_updates`` (the meshed step's
    parts), and ``at(slot, fn, *args)`` runs the accumulation's
    arithmetic on a slot (``MeshStep.at``); the accumulation over
    micro-batches is the same."""
    grads_fn = grads_fn or functools.partial(loss_and_grads, api)
    update_fn = update_fn or functools.partial(O.apply_updates, opt_cfg)
    zeros = _blockwise(lambda a: torch.zeros(
        a.shape, dtype=torch.float32, device=a.device), at)
    add = _blockwise(torch.add, at)
    mean = _blockwise(lambda g: g / grad_accum, at)

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, metrics, grads = grads_fn(params, batch)
        else:
            # micro-batches of consecutive rows, summed in order from zero
            # in fp32, as the reference's scan
            gsum = lsum = None
            for i in range(grad_accum):
                mb = {k: v.reshape((grad_accum, -1) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                loss_i, _, g = grads_fn(params, mb)
                if gsum is None:
                    gsum = L.tree_map(zeros, g)
                    lsum = zeros(loss_i)
                gsum = L.tree_map(add, gsum, g)
                lsum = add(lsum, loss_i)
            grads = L.tree_map(mean, gsum)
            loss = mean(lsum)
            metrics = {}
        with record_function("train_step.optimizer"):
            params, opt_state, om = update_fn(params, grads, opt_state)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return step


class MeshStep:
    """The parts of the train step on ``mesh`` (see the module docstring
    and :func:`make_mesh_train_step`), each one slot's program: a data
    shard's gradients on its row of slots, their sum, one slot's AdamW
    on its blocks.  ``split`` says whether the row's model slots split
    the compute.  Every move between slots goes through :meth:`send`,
    and every slot's part of a step through :meth:`at` (or its row's
    ``run``).  The dry run (``launch/dryrun.py``) runs slot 0's share of
    the same parts."""

    def __init__(self, api: ModelAPI, opt_cfg: O.AdamWConfig, mesh, *,
                 dp_axes=("data",), param_specs, opt_specs, batch_specs):
        self.api = api
        self.opt_cfg = opt_cfg
        self.mesh = mesh
        self.slots = S.data_slots(mesh, tuple(dp_axes))
        self.coords = list(np.ndindex(*mesh.devices.shape))
        self.p_lay = S.layouts(mesh, param_specs)
        self.m_lay = S.layouts(mesh, opt_specs["m"])
        self.step_lay = S.Layout(mesh, opt_specs["step"])
        self.b_lay = S.layouts(mesh, batch_specs)
        tp = int(mesh.shape.get("model", 1))
        self.split = tp > 1 and api.model_split()
        self.rows = S.model_rows(mesh, dp_axes)
        self.home = mesh.local_slots()[0]   # where the batch lies

    def send(self, t, src: int, dst: int, out=None):
        return S.send(t, self.mesh, src, dst, out=out)

    def at(self, slot: int, fn, *args):
        """Slot ``slot``'s part of a step: ``fn(*args)`` (``sharded.at``:
        :data:`sharded.REMOTE` where the slot is another process's)."""
        return S.at(self.mesh, slot, fn, *args)

    def model_row(self, i: int) -> S.ModelRow:
        """Data shard ``i``'s (its first slot's flat index) row of model
        slots."""
        return S.ModelRow(self.rows[i], self.send)

    def shard_grads(self, params, batch, cnt, i: int):
        """Data shard ``i``'s (its first slot's flat index) part on its
        row: (loss, xent weighted, aux or None, gradients).  Its rows of
        the batch, which lies on slot ``home``, run on the row's blocks
        (split) or on the whole parameters gathered onto slot ``i``; the
        cross-entropy is weighted by the shard's share of the labels that
        count (``cnt`` in all), an MoE's aux by 1/dp.  A split leaf's
        gradient is a tuple of its blocks' on the row's slots."""
        rows = {k: self.send(v[self.b_lay[k].block_slices(
            v.shape, self.coords[i])], self.home, i)
            for k, v in batch.items()}
        w = (rows["labels"] >= 0).sum().float() / self.send(cnt, self.home, i)
        dp = len(self.slots)

        def objective(_, m):
            out = m["xent"] * w
            return out + (0.01 / dp) * m["aux"] if "aux" in m else out

        given = S.row_blocks(params, self.model_row(i)) if self.split \
            else S.gather_tree(params, i)
        l_d, m_d, g_d = self.loss_and_grads(given, rows, objective)
        return l_d, m_d["xent"] * w, m_d.get("aux"), g_d

    def loss_and_grads(self, given, rows, objective):
        return loss_and_grads(self.api, given, rows, objective)

    def _sum_blocks(self, acc, params, g_d, i: int):
        """Data row ``i``'s block gradients added, block by block in slot
        order, onto the first row's slot of each block: a tree of
        ``sharded.Laid`` holding only those blocks."""
        first, mine = self.rows[self.slots[0]], self.rows[i]

        def leaf(laid, g, a=None):
            blocks = [None] * self.mesh.devices.size
            for m, gm in enumerate(g):
                dst = first[m]
                gm = self.send(gm, mine[m], dst)
                blocks[dst] = gm if a is None else \
                    self.at(dst, torch.add, a.blocks[dst], gm)
            return S.Laid(laid.layout, laid.shape, blocks)

        if acc is None:
            return L.tree_map(leaf, params, g_d)
        return L.tree_map(leaf, params, g_d, acc)

    def grads(self, params, batch):
        """One micro-batch: each data shard's part, summed over the shards
        in slot order: on slot 0 whole (gathered), or block by block on
        the first row's slots (split)."""
        cnt = (batch["labels"] >= 0).sum().float()
        dp = len(self.slots)
        loss = xent = aux = grads = None
        for i in self.slots:
            l_d, x_d, a_d, g_d = self.shard_grads(params, batch, cnt, i)
            x_d = self.send(x_d, i, 0)
            if a_d is not None:
                a_d = self.at(0, lambda a: a / dp, self.send(a_d, i, 0))
            first = loss is None
            if first:
                loss, xent, aux = self.send(l_d, i, 0), x_d, a_d
            else:
                loss = self.at(0, torch.add, loss, self.send(l_d, i, 0))
                xent = self.at(0, torch.add, xent, x_d)
                aux = None if aux is None else self.at(0, torch.add, aux, a_d)
            if self.split:
                grads = self._sum_blocks(grads, params, g_d, i)
            elif first:
                grads = L.tree_map(lambda g: self.send(g, i, 0), g_d)
            else:
                grads = L.tree_map(lambda a, g: self.at(
                    0, torch.add, a, self.send(g, i, 0)), grads, g_d)
        metrics = {"xent": xent} if aux is None else {"xent": xent,
                                                      "aux": aux}
        return loss, metrics, grads

    def norm(self, grads):
        """The gradient's global norm on slot 0: of the whole gradient
        there (gathered), or the square root of the slot-order sum of each
        holding slot's sum of its blocks' squares (split), where a
        replicated leaf's one block counts once."""
        if not self.split:
            return self.at(0, O.global_norm, grads)
        held = {}
        for laid in L.tree_leaves(grads):
            for j, b in enumerate(laid.blocks):
                if b is not None:
                    held.setdefault(j, []).append(b)

        def sq(bs):
            return sum(torch.sum(torch.square(b.float())) for b in bs)

        total = None
        for j in sorted(held):
            part = self.send(self.at(j, sq, held[j]), j, 0)
            total = part if total is None else self.at(0, torch.add, total,
                                                       part)
        return self.at(0, torch.sqrt, total)

    def regroup(self, laid: S.Laid, layout: S.Layout) -> S.Laid:
        """``laid`` (whose absent blocks are None) laid out by ``layout``:
        ``sharded.relayout`` through slot 0 (gathered), or each slot's
        block read from the slots that hold it (split)."""
        if not self.split:
            return S.relayout(laid, layout)
        if layout.mesh is laid.layout.mesh and all(
                b is not None for b in laid.blocks) and \
                tuple(layout.spec) == tuple(laid.layout.spec):
            return laid
        coords = laid.layout.coords()
        held = {j: (laid.layout.block_slices(laid.shape, coords[j]), b)
                for j, b in enumerate(laid.blocks) if b is not None}
        return S.redistribute(held, laid.shape, layout, self.send, self.at)

    def slot_update(self, i: int, p, g, state, gnorm):
        """Slot ``i``'s AdamW on its moment blocks, with the matching
        blocks of the parameters ``p`` and gradient ``g`` (both laid out
        like the moments) and the whole gradient's norm."""
        st = {"step": state["step"].blocks[i],
              "m": S.block_tree(state["m"], i),
              "v": S.block_tree(state["v"], i)}
        return O.update_with_norm(self.opt_cfg, S.block_tree(p, i),
                                  S.block_tree(g, i), st,
                                  self.send(gnorm, 0, i))

    def update(self, params, grads, state):
        """Each slot's :meth:`slot_update`, the gradient laid out onto the
        moments' blocks (from slot 0, or from the slots that hold it);
        parameters back into their layout."""
        gnorm = self.norm(grads)
        if self.split:
            g = L.tree_map(self.regroup, grads, self.m_lay)
        else:
            g = L.tree_map(lambda x, lay, ref: S.lay_out(
                x, lay, src=0, shape=ref.shape), grads, self.m_lay, params)
        p = L.tree_map(self.regroup, params, self.m_lay)
        new_p, new_m, new_v, new_step = [], [], [], []
        for i in range(self.mesh.devices.size):
            np_i, ns_i, om = self.slot_update(i, p, g, state, gnorm)
            new_p.append(np_i)
            new_m.append(ns_i["m"])
            new_v.append(ns_i["v"])
            new_step.append(ns_i["step"])
            if i == 0:
                lr = om["lr"]        # every slot's: the schedule at its step

        def laid(trees, lay_tree):
            leaves = [L.tree_leaves(t) for t in trees]
            return L.tree_unflatten(lay_tree, [
                S.Laid(lay, tuple(ref.shape), [slot[j] for slot in leaves])
                for j, (lay, ref) in enumerate(zip(
                    L.tree_leaves(lay_tree), L.tree_leaves(params)))])

        params = L.tree_map(self.regroup, laid(new_p, self.m_lay), self.p_lay)
        state = {"step": S.Laid(self.step_lay, (), new_step),
                 "m": laid(new_m, self.m_lay), "v": laid(new_v, self.m_lay)}
        return params, state, {"grad_norm": gnorm, "lr": lr}

    def publish(self, metrics: dict) -> dict:
        """The step's metrics as every process reports them: slot 0's."""
        return metrics


def _remote_like(x):
    """``x``'s structure with :data:`sharded.REMOTE` for each tensor."""
    if isinstance(x, torch.Tensor):
        return S.REMOTE
    if isinstance(x, dict):
        return {k: _remote_like(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_remote_like(v) for v in x)
    return x


class ProcStep(MeshStep):
    """:class:`MeshStep` on a mesh of a process group
    (``launch/mesh.py``; each process runs this on its own slots).
    Every process walks the same parts in the same order: each runs its
    own data rows' :meth:`shard_grads` (all of them first, which touch
    no other process's slot) and its own slots' :meth:`slot_update`,
    holds :data:`sharded.REMOTE` for another process's, and meets the
    other end of each move (:meth:`send`, ``sharded.send``) as the
    sender or the receiver.  The sums keep slot order on the slots that
    own them, so every block, loss and norm is the single-process step's
    bit for bit; the metrics are slot 0's, broadcast from its
    process."""

    def grads(self, params, batch):
        self._mine = None
        try:
            return super().grads(params, batch)
        finally:
            self._mine = None

    def shard_grads(self, params, batch, cnt, i: int):
        if self._mine is None:
            self._mine = {j: super(ProcStep, self).shard_grads(
                params, batch, cnt, j)
                for j in self.slots if S.is_local(self.mesh, j)}
            self._theirs = _remote_like(next(iter(self._mine.values())))
        return self._mine.pop(i) if i in self._mine else self._theirs

    def slot_update(self, i: int, p, g, state, gnorm):
        if S.is_local(self.mesh, i):
            return super().slot_update(i, p, g, state, gnorm)
        self.send(gnorm, 0, i)
        theirs = L.tree_map(lambda _: S.REMOTE, self.m_lay)
        return theirs, {"step": S.REMOTE, "m": theirs, "v": theirs}, \
            {"lr": S.REMOTE}

    def publish(self, metrics: dict) -> dict:
        keys = list(metrics)
        here = S.is_local(self.mesh, 0)
        values = self.mesh.group.broadcast(
            [float(metrics[k]) if here else 0.0 for k in keys],
            S.owner(self.mesh, 0))
        return dict(zip(keys, values))


def make_mesh_train_step(api: ModelAPI, opt_cfg: O.AdamWConfig, mesh, *,
                         dp_axes=("data",), param_specs, opt_specs,
                         batch_specs, grad_accum: int = 1):
    """The train step on ``mesh``: (params, opt_state, batch) ->
    (params, opt_state, metrics), where params and opt_state are trees
    of ``sharded.Laid`` laid out by ``param_specs`` and ``opt_specs``,
    and batch holds whole tensors on slot 0, split by ``batch_specs``
    (see the module docstring and :class:`MeshStep`).  Raises
    ``ValueError`` when the batch's rows do not split into
    ``grad_accum`` micro-batches of whole data shards."""
    kind = MeshStep if mesh.group is None else ProcStep
    parts = kind(api, opt_cfg, mesh, dp_axes=dp_axes,
                 param_specs=param_specs, opt_specs=opt_specs,
                 batch_specs=batch_specs)
    dp = len(parts.slots)
    step = make_train_step(api, opt_cfg, grad_accum=grad_accum,
                           grads_fn=parts.grads, update_fn=parts.update,
                           at=parts.at)

    def checked(params, opt_state, batch):
        b = batch["labels"].shape[0]
        if b % (grad_accum * dp):
            raise ValueError(f"a global batch of {b} rows does not split "
                             f"into {grad_accum} micro-batches over {dp} "
                             "data shards")
        params, opt_state, metrics = step(params, opt_state, batch)
        return params, opt_state, parts.publish(metrics)

    return checked


@dataclass
class StragglerMonitor:
    """Per-step deadline policy: EMA of step time; steps slower than
    ``factor``x EMA are flagged.  At pod scale the supervisor maps flags to
    a host and triggers re-slicing; single-process we record + expose."""
    factor: float = 3.0
    ema: float | None = None
    alpha: float = 0.2
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        if slow:
            self.flagged.append((step, dt))
        return slow


class Trainer:
    """The reference's ``Trainer``, plus ``device``: where an unmeshed
    trainer runs (default: the card).  A meshed one runs on its mesh's
    slots, and takes no ``device``; ``zero1`` without a mesh is ignored,
    as in the reference."""

    def __init__(self, api: ModelAPI, shape, *, mesh=None, dp_axes=("data",),
                 opt_cfg: O.AdamWConfig | None = None, grad_accum: int = 1,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 zero1: bool = False, seed: int = 0, device=None):
        if mesh is not None and device is not None:
            raise ValueError("a meshed Trainer runs on its mesh's slots; "
                             "pass no device")
        self.api = api
        self.shape = shape
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes)
        # a meshed trainer's batch lies on its process's first slot
        self.device = mesh.devices.flat[mesh.local_slots()[0]] \
            if mesh is not None else resolve_device(device)
        self.opt_cfg = opt_cfg or O.AdamWConfig()
        self.grad_accum = grad_accum
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.monitor = StragglerMonitor()
        self.seed = seed
        self.metrics_log: list[dict] = []
        self.layouts = None
        if mesh is None:
            self.step_fn = make_train_step(api, self.opt_cfg,
                                           grad_accum=grad_accum)
            return
        with L.use_mesh(mesh, self.dp_axes):
            pspecs = api.param_pspecs()
            ospecs = O.opt_pspecs(api.param_defs(), zero1=zero1,
                                  dp_axes=self.dp_axes,
                                  dp_size=int(np.prod(
                                      [mesh.shape[a] for a in self.dp_axes])))
            bspecs = api.input_pspecs(shape)
        self.layouts = {"params": S.layouts(mesh, pspecs),
                        "opt": S.layouts(mesh, ospecs)}
        self.step_fn = make_mesh_train_step(
            api, self.opt_cfg, mesh, dp_axes=self.dp_axes,
            param_specs=pspecs, opt_specs=ospecs, batch_specs=bspecs,
            grad_accum=grad_accum)

    # ------------------------------------------------------------ lifecycle
    def init_or_restore(self):
        """(params, opt_state, step): the latest checkpoint, or seed-made
        parameters and a zero state; laid out over the mesh's slots when
        the trainer has one."""
        if self.ckpt and self.ckpt.latest_step() is not None:
            defs = self.api.param_defs()
            like = {"params": defs,
                    "opt": {"step": 0, "m": defs, "v": defs}}
            tree, step = self.ckpt.restore(like, device=self.device,
                                           layouts=self.layouts)
            return tree["params"], tree["opt"], step
        params = self.api.init_params(self.seed, self.device)
        opt_state = O.init_state(params)
        if self.layouts is not None:
            params = S.lay_out_tree(params, self.layouts["params"])
            opt_state = S.lay_out_tree(opt_state, self.layouts["opt"])
        return params, opt_state, 0

    def run(self, num_steps: int, *, pipeline=None, fault_hook=None):
        from ..data.pipeline import Pipeline
        params, opt_state, start = self.init_or_restore()
        # every process builds the global batch (host 0 of 1), as the
        # reference's Trainer asks for one host's worth of it
        pipe = pipeline or Pipeline(self.api.cfg, self.shape, seed=self.seed,
                                    start_step=start, host_index=0,
                                    host_count=1)
        ctx = L.use_mesh(self.mesh, self.dp_axes) if self.mesh is not None \
            else contextlib.nullcontext()
        with ctx, contextlib.closing(pipe):
            step = start
            while step < start + num_steps:
                t0 = time.perf_counter()
                ds, batch = pipe.next()
                if ds != step:
                    raise RuntimeError(f"pipeline desync {ds} != {step}")
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in batch.items()}
                if fault_hook is not None and fault_hook(step):
                    # simulated node failure: deterministic replay from ckpt
                    raise RuntimeError(f"injected fault at step {step}")
                params, opt_state, m = self.step_fn(params, opt_state, batch)
                m = {k: float(v) for k, v in m.items()}
                dt = time.perf_counter() - t0
                slow = self.monitor.observe(step, dt)
                m.update(step=step, dt=dt, straggler=slow)
                self.metrics_log.append(m)
                step += 1
                if self.ckpt and (step % self.ckpt_every == 0):
                    self.save(step, params, opt_state)
            if self.ckpt:
                self.save(step, params, opt_state, blocking=True)
        return params, opt_state, step

    def save(self, step: int, params, opt_state, *, blocking=False):
        """A checkpoint of ``step``: leaves gathered onto slot 0 and
        written by the process that owns it; in a process group the
        others wait at a barrier for a blocking one."""
        group = self.mesh.group if self.mesh is not None else None
        self.ckpt.save(step, {"params": params, "opt": opt_state},
                       blocking=blocking, write=group is None or
                       self.mesh.local(0))
        if blocking and group is not None:
            group.barrier()
