"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --steps 20 --smoke --ckpt /tmp/ckpt

Counterpart of ``repro/launch/train.py``, with its flags, plus
``--device`` (default: the card; ``--device cpu`` runs the plain
versions), ``--layers`` and ``--dtype`` (the configuration cut to that
depth, or in that dtype) and ``--report PATH`` (the metrics of every
step, the kernels' launch counts, in a process group what the transport
moved (``procs.Group.moved``) and, on a mesh, the sha256 of each of this
process's slots' blocks of the final parameters and optimizer state, as
JSON; in a process group each rank writes ``PATH.<rank>``).
``--mesh`` trains on a (data, model) mesh over the device's pool of
slots (``launch/mesh.py::device_pool``:
the visible cards, or 8 CPU slots with ``--device cpu``, as the
reference's 8 forced host devices), at tp = the model axis' width;
``--zero1`` splits the moments over the data axes.

The multi-host entry: with ``JAX_COORDINATOR`` (the reference's gate)
or ``WORLD_SIZE`` > 1 in the environment, ``main`` joins a process group
(``launch/procs.py``, which says what it reads: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, torchrun's ``MASTER_ADDR`` and
``MASTER_PORT`` or ``JAX_COORDINATOR``'s ``host:port``) and trains one
mesh of every process's pool (its card, ``LOCAL_RANK`` modulo the
visible cards, or 8 CPU slots), stacked along the data axis; it needs
``--mesh``.  Rank 0 prints; the group is left at exit.  For example,
two processes on one host's CPU::

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --smoke --device cpu --mesh --batch 4 --steps 3

Fault tolerance: kill and restart resumes from the last committed
checkpoint and replays the deterministic data stream.
"""
from __future__ import annotations

import argparse
import hashlib
import json

import torch

from .. import kernels
from ..configs import ARCHS, SMOKES
from ..configs.base import ShapeConfig
from ..device import resolve_device
from ..models import build, layers as L
from ..train import AdamWConfig, Trainer
from . import procs
from .mesh import device_pool, dp_axes_of, make_host_mesh


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--mesh", action="store_true",
                    help="use a (data, model) mesh over local devices")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the configuration to this many layers")
    ap.add_argument("--dtype", default=None,
                    help="the configuration's dtype (e.g. float32)")
    ap.add_argument("--report", default=None,
                    help="write each step's metrics and the launch counts "
                         "as JSON here (PATH.<rank> in a process group)")
    return ap.parse_args(argv)


def make_trainer(args, group=None) -> Trainer:
    """The Trainer ``main`` runs for parsed ``args``; in a process group
    ``group`` (``launch/procs.py``) its mesh spans every process's pool."""
    cfg = (SMOKES if args.smoke else ARCHS)[args.arch]
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    if args.dtype is not None:
        cfg = cfg.replace(dtype=args.dtype)
    shape = ShapeConfig("cli", "train", seq_len=args.seq,
                        global_batch=args.batch)
    if group is not None and not args.mesh:
        raise ValueError("a process group trains one mesh: pass --mesh")
    mesh = None
    if args.mesh:
        dev = resolve_device(args.device) if group is None else group.device
        mesh = make_host_mesh(devices=[dev] if group is not None and
                              dev.type == "cuda" else device_pool(dev))
    return Trainer(build(cfg, tp=(mesh.shape["model"] if mesh else 1)),
                   shape, mesh=mesh,
                   dp_axes=dp_axes_of(mesh) if mesh else ("data",),
                   opt_cfg=AdamWConfig(lr=args.lr),
                   grad_accum=args.grad_accum, ckpt_dir=args.ckpt,
                   ckpt_every=args.ckpt_every, zero1=args.zero1,
                   device=None if mesh else args.device)


def report(path: str, tr: Trainer, params, opt, step: int, group) -> None:
    """``--report``'s JSON (see the module docstring)."""
    mesh = tr.mesh
    out = {"rank": group.rank if group else 0,
           "processes": group.size if group else 1,
           "mesh": list(mesh.devices.shape) if mesh is not None else None,
           "ranks": mesh.ranks.tolist() if mesh is not None else None,
           "step": step, "metrics": tr.metrics_log,
           "launches": kernels.launch_counts(),
           "moved": group.moved if group else None}
    if mesh is not None:
        leaves = L.tree_leaves(params) + L.tree_leaves(opt)
        out["slots"] = {str(i): [_sha(a.blocks[i]) for a in leaves]
                        for i in mesh.local_slots()}
    with open(path, "w") as f:
        json.dump(out, f)


def _sha(t) -> str:
    data = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
    return hashlib.sha256(data.numpy().tobytes()).hexdigest()


def main(argv=None):
    args = parse_args(argv)
    # the multi-host entry (JAX_COORDINATOR, or torchrun's WORLD_SIZE)
    group = procs.init(args.device) if procs.requested() else None
    try:
        tr = make_trainer(args, group)
        params, opt, step = tr.run(args.steps)
        last = tr.metrics_log[-1] if tr.metrics_log else {}
        if group is None or group.rank == 0:
            print(f"finished at step {step}: loss={last.get('loss'):.4f} "
                  f"grad_norm={last.get('grad_norm'):.3f} "
                  f"stragglers={len(tr.monitor.flagged)}")
        if args.report:
            report(args.report if group is None
                   else f"{args.report}.{group.rank}", tr, params, opt,
                   step, group)
        return tr
    finally:
        if group is not None:
            procs.close()


if __name__ == "__main__":
    main()
