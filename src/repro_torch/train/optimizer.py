"""AdamW on tensors (no optimizer library) with ZeRO-1 optimizer-state
specs, and the int8 error-feedback gradient compressor.

Counterpart of ``repro/train/optimizer.py``: the same configuration,
schedule and update, with the reference's order of operations, so one
step matches it at 1e-6.  The optimizer state mirrors the parameter tree
(``step``, a 0-d int32 tensor, and the moments ``m`` and ``v``).
``apply_updates`` is functional, as the reference's: it returns new
parameter and state trees and leaves its arguments as they were.

``opt_pspecs`` derives the state's PartitionSpecs from the parameter
ParamDefs; with ``zero1=True`` the moments also split their largest
replicated, dp-divisible dim over the data axes (ZeRO-1: each data slot
owns a slice of the moments).  A meshed step updates each slot's block
with :func:`update_with_norm`, the arithmetic of ``apply_updates`` given
the full gradient's norm.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models import layers as L


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10000


def schedule(c: AdamWConfig, step):
    """Linear warmup, then cosine decay to 10 % of ``c.lr``: an fp32
    tensor of ``step``'s shape (a Python int gives a 0-d one)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(c.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - c.warmup_steps)
                       / max(c.decay_steps - c.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return c.lr * warm * (0.1 + 0.9 * cos)


def init_state(params):
    leaf = L.tree_leaves(params)[0]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
        "m": L.tree_map(torch.zeros_like, params),
        "v": L.tree_map(torch.zeros_like, params),
    }


def abstract_state(abstract_params):
    """The state's stand-ins on the ``meta`` device."""
    zero = L.tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                            device="meta"), abstract_params)
    return {"step": torch.empty((), dtype=torch.int32, device="meta"),
            "m": zero, "v": zero}


def _zero1_spec(pdef_spec, shape, dp_axes, dp_size: int) -> L.PSpec:
    """Add dp sharding on the largest unsharded, divisible dim (ZeRO-1)."""
    entries = list(pdef_spec) + [None] * (len(shape) - len(pdef_spec))
    best, best_dim = -1, -1
    for i, (e, s) in enumerate(zip(entries, shape)):
        if e is None and dp_size > 0 and s % dp_size == 0 and s > best:
            best, best_dim = s, i
    if best_dim >= 0:
        entries[best_dim] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return L.PSpec(*entries)


def opt_pspecs(param_defs, *, zero1: bool = False, dp_axes=("data",),
               dp_size: int = 1):
    base = L.pspec_tree(param_defs)
    if not zero1:
        mom = base
    else:
        mom = L.tree_map(lambda d: _zero1_spec(L.resolve_pspec(d.pspec),
                                               d.shape, tuple(dp_axes),
                                               dp_size), param_defs)
    return {"step": L.PSpec(), "m": mom, "v": mom}


def global_norm(tree):
    """sqrt of the sum over leaves (in leaf order) of each leaf's sum of
    squares in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in L.tree_leaves(tree)))


@torch.no_grad()
def apply_updates(c: AdamWConfig, params, grads, state):
    """One AdamW step with global-norm clipping: (params, state, {"grad_norm",
    "lr"})."""
    return update_with_norm(c, params, grads, state, global_norm(grads))


@torch.no_grad()
def update_with_norm(c: AdamWConfig, params, grads, state, gnorm):
    """``apply_updates`` with the gradient's global norm given: the same
    arithmetic element by element, so trees of blocks of the parameters,
    gradient and moments update as the whole trees would."""
    step = state["step"] + 1
    lr = schedule(c, step)
    scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1c = 1 - c.b1 ** step.float()
    b2c = 1 - c.b2 ** step.float()

    new_m = L.tree_map(
        lambda g, m: c.b1 * m + (1 - c.b1) * g.float() * scale,
        grads, state["m"])
    new_v = L.tree_map(
        lambda g, v: c.b2 * v + (1 - c.b2) * torch.square(g.float() * scale),
        grads, state["v"])
    new_params = L.tree_map(
        lambda p, m, v: (p - lr * (m / b1c / (torch.sqrt(v / b2c) + c.eps)
                                   + c.weight_decay * p)).to(p.dtype),
        params, new_m, new_v)
    new_state = {"step": step, "m": new_m, "v": new_v}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------- int8 EF compression
def compress_int8(g, err):
    """Error-feedback int8 quantization: returns (q, scale, new_err)."""
    gf = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gf - deq


def decompress_int8(q, scale):
    return q.float() * scale
