"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --steps 20 --smoke --ckpt /tmp/ckpt

Counterpart of ``repro/launch/train.py``, with its flags, plus
``--device`` (default: the card; ``--device cpu`` runs the plain
versions).  ``--mesh`` trains on a (data, model) mesh over the device's
pool of slots (``launch/mesh.py::device_pool``: the visible cards, or
8 CPU slots with ``--device cpu``, as the reference's 8 forced host
devices), at tp = the model axis' width; ``--zero1`` splits the
moments over the data axes.  The reference's multi-host entry is not
ported: with ``JAX_COORDINATOR`` set, ``main`` raises
``NotImplementedError`` (the port runs one process).  Fault
tolerance: kill and restart resumes from the last committed checkpoint
and replays the deterministic data stream.
"""
from __future__ import annotations

import argparse
import os

from ..configs import ARCHS, SMOKES
from ..configs.base import ShapeConfig
from ..device import resolve_device
from ..models import build
from ..train import AdamWConfig, Trainer
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
    return ap.parse_args(argv)


def make_trainer(args) -> Trainer:
    """The Trainer ``main`` runs for parsed ``args``."""
    cfg = (SMOKES if args.smoke else ARCHS)[args.arch]
    shape = ShapeConfig("cli", "train", seq_len=args.seq,
                        global_batch=args.batch)
    mesh = make_host_mesh(devices=device_pool(resolve_device(args.device))) \
        if args.mesh else None
    return Trainer(build(cfg, tp=(mesh.shape["model"] if mesh else 1)),
                   shape, mesh=mesh,
                   dp_axes=dp_axes_of(mesh) if mesh else ("data",),
                   opt_cfg=AdamWConfig(lr=args.lr),
                   grad_accum=args.grad_accum, ckpt_dir=args.ckpt,
                   ckpt_every=args.ckpt_every, zero1=args.zero1,
                   device=None if mesh else args.device)


def main(argv=None):
    args = parse_args(argv)
    if "JAX_COORDINATOR" in os.environ:        # the reference's pod entry
        raise NotImplementedError(
            "the multi-host entry (JAX_COORDINATOR) is not ported: the "
            "port trains in one process, over the slots of one host")
    tr = make_trainer(args)
    _, _, step = tr.run(args.steps)
    last = tr.metrics_log[-1] if tr.metrics_log else {}
    print(f"finished at step {step}: loss={last.get('loss'):.4f} "
          f"grad_norm={last.get('grad_norm'):.3f} "
          f"stragglers={len(tr.monitor.flagged)}")
    return tr


if __name__ == "__main__":
    main()
