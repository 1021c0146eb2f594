"""Fault-tolerant trainer on one device: the train step (gradient
accumulation, remat through the model's ``cfg.remat``), async
checkpointing with deterministic resume, straggler detection, and
failure recovery (replay from the last committed step).

Counterpart of ``repro/train/trainer.py``.  The reference's step is
``jax.value_and_grad`` under ``jit``; here it is the loss, then
``torch.autograd.grad`` with respect to every parameter leaf, run
eagerly.  A leaf the loss does not reach gets no gradient (``None``):
the step raises naming it rather than let the optimizer skip it, so a
path that cuts the graph (a kernel without a backward) cannot train
silently.  ``Trainer(mesh=...)`` and ``zero1=True`` raise
``NotImplementedError`` naming ROADMAP.md's "Training on a mesh".

A step's three parts run under ``torch.profiler`` ranges named
``train_step.forward``, ``train_step.backward`` and
``train_step.optimizer``, so a profiler window splits its time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function

from ..device import resolve_device
from ..models import layers as L
from ..models.api import ModelAPI
from . import optimizer as O
from .checkpoint import Checkpointer

MESH_ITEM = "Training on a mesh"


def mesh_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: see ROADMAP.md, "
                               f"'{MESH_ITEM}'")


def loss_and_grads(api: ModelAPI, params, batch):
    """(loss, metrics, grads): ``api.train_loss`` and the gradient of the
    loss with respect to every leaf of ``params``; raises
    ``RuntimeError`` naming the leaves the loss does not reach."""
    items = L.tree_items(params)
    leaves = [p.detach().requires_grad_(True) for _, p in items]
    with torch.enable_grad():
        with record_function("train_step.forward"):
            loss, metrics = api.train_loss(L.tree_unflatten(params, leaves),
                                           batch)
        with record_function("train_step.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    missing = ["/".join(map(str, path))
               for (path, _), g in zip(items, grads) if g is None]
    if missing:
        raise RuntimeError(f"no gradient reaches {len(missing)} parameter "
                           f"leaves: {missing}")
    detach = lambda t: t.detach() if isinstance(t, torch.Tensor) else t  # noqa: E731
    return (loss.detach(), {k: detach(v) for k, v in metrics.items()},
            L.tree_unflatten(params, list(grads)))


def make_train_step(api: ModelAPI, opt_cfg: O.AdamWConfig, *,
                    grad_accum: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, metrics, grads = loss_and_grads(api, params, batch)
        else:
            # micro-batches of consecutive rows, summed in order from zero
            # in fp32, as the reference's scan
            gsum = L.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=L.tree_leaves(params)[0].device)
            for i in range(grad_accum):
                mb = {k: v.reshape((grad_accum, -1) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                loss_i, _, g = loss_and_grads(api, params, mb)
                gsum = L.tree_map(torch.add, gsum, g)
                lsum = lsum + loss_i
            grads = L.tree_map(lambda g: g / grad_accum, gsum)
            loss = lsum / grad_accum
            metrics = {}
        with record_function("train_step.optimizer"):
            params, opt_state, om = O.apply_updates(opt_cfg, params, grads,
                                                    opt_state)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return step


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
    def __init__(self, api: ModelAPI, shape, *, mesh=None,
                 opt_cfg: O.AdamWConfig | None = None, grad_accum: int = 1,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 zero1: bool = False, seed: int = 0, device=None):
        if mesh is not None:
            raise mesh_not_ported("Trainer(mesh=...)")
        if zero1:
            raise mesh_not_ported("ZeRO-1 (zero1=True)")
        self.api = api
        self.shape = shape
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or O.AdamWConfig()
        self.grad_accum = grad_accum
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.monitor = StragglerMonitor()
        self.seed = seed
        self.metrics_log: list[dict] = []
        self.step_fn = make_train_step(api, self.opt_cfg,
                                       grad_accum=grad_accum)

    # ------------------------------------------------------------ lifecycle
    def init_or_restore(self):
        if self.ckpt and self.ckpt.latest_step() is not None:
            defs = self.api.param_defs()
            like = {"params": defs,
                    "opt": {"step": 0, "m": defs, "v": defs}}
            tree, step = self.ckpt.restore(like, device=self.device)
            return tree["params"], tree["opt"], step
        params = self.api.init_params(self.seed, self.device)
        return params, O.init_state(params), 0

    def run(self, num_steps: int, *, pipeline=None, fault_hook=None):
        from ..data.pipeline import Pipeline
        params, opt_state, start = self.init_or_restore()
        pipe = pipeline or Pipeline(self.api.cfg, self.shape, seed=self.seed,
                                    start_step=start, host_count=1)
        try:
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
                    self.ckpt.save(step, {"params": params, "opt": opt_state})
            if self.ckpt:
                self.ckpt.save(step, {"params": params, "opt": opt_state},
                               blocking=True)
        finally:
            pipe.close()
        return params, opt_state, step
