"""Distributed-optimization collectives: the int8 error-feedback
compressed mean of gradients over a mesh axis.

Counterpart of ``repro/train/collectives.py``.  The reference runs the
collective under ``shard_map``, one program per device; the port runs it
over the slots of its mesh (``launch/mesh.py``) in one process, as
``core/spmd.py`` runs ``psum``: each slot's gradients and error are a
tree on the slot's device, and every group of slots along ``axis`` (the
slots that share their other coordinates) reduces together.

Wire format as in the reference: each slot quantizes ``g + err`` to int8
against a scale shared by its group (the max over the group's slots of
max |g + err|, over 127); the int8 payloads are summed in int32 in slot
order; the mean and each slot's new error land on the slot's device.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..models import layers as L


def _groups(mesh, axis: str) -> list[list[int]]:
    """Flat (row-major) slot indices of each group along ``axis``."""
    shape = mesh.devices.shape
    ax = list(mesh.axis_names).index(axis)
    flat = np.arange(mesh.devices.size).reshape(shape)
    rest = [range(n) if i != ax else [slice(None)]
            for i, n in enumerate(shape)]
    return [flat[idx].tolist() for idx in itertools.product(*rest)]


def _one(gs, es, devices):
    """One leaf over a group: per-slot gradients ``gs`` and errors ``es``
    -> per-slot (mean, new error), each on its slot's device."""
    gf = [g.float() + e for g, e in zip(gs, es)]
    gmax = torch.stack([torch.max(torch.abs(x)).to(devices[0])
                        for x in gf]).max()
    scale = torch.clamp(gmax, min=1e-12) / 127.0
    qs = [torch.clamp(torch.round(x / scale.to(x.device)), -127,
                      127).to(torch.int8) for x in gf]
    acc = qs[0].to(devices[0], torch.int32)
    for q in qs[1:]:                                 # int32, in slot order
        acc = acc + q.to(devices[0], torch.int32)
    mean = acc.float() * scale / float(len(qs))
    outs = []
    for x, q, dev in zip(gf, qs, devices):
        s = scale.to(dev)
        outs.append((mean.to(dev), x - q.float() * s))
    return outs


def compressed_psum_mean(mesh, axis: str = "data"):
    """Returns f(local_grads, errs) -> (means, new_errs) with an int8
    wire: ``local_grads`` and ``errs`` are lists with one tree a slot of
    ``mesh.devices.flat``, and so are the results."""
    devices = list(mesh.devices.flat)
    groups = _groups(mesh, axis)

    def f(grads, errs):
        if len(grads) != len(devices) or len(errs) != len(devices):
            raise ValueError(f"{len(grads)} gradient and {len(errs)} error "
                             f"trees for {len(devices)} slots")
        keys = [k for k, _ in L.tree_items(grads[0])]
        g_leaves = [L.tree_leaves(g) for g in grads]
        e_leaves = [L.tree_leaves(e) for e in errs]
        means = [[None] * len(keys) for _ in devices]
        new_errs = [[None] * len(keys) for _ in devices]
        for group in groups:
            devs = [devices[s] for s in group]
            for j in range(len(keys)):
                outs = _one([g_leaves[s][j].to(devices[s]) for s in group],
                            [e_leaves[s][j].to(devices[s]) for s in group],
                            devs)
                for s, (mean, err) in zip(group, outs):
                    means[s][j], new_errs[s][j] = mean, err
        return ([L.tree_unflatten(grads[0], m) for m in means],
                [L.tree_unflatten(grads[0], e) for e in new_errs])

    return f
