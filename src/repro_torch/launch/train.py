"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --steps 20 --smoke --ckpt /tmp/ckpt

Counterpart of ``repro/launch/train.py``, with its flags, plus
``--device`` (default: the card; ``--device cpu`` runs the plain
versions).  It trains on one device: ``--mesh`` and ``--zero1`` raise
``NotImplementedError`` naming ROADMAP.md's "Training on a mesh".  Fault
tolerance: kill and restart resumes from the last committed checkpoint
and replays the deterministic data stream.
"""
from __future__ import annotations

import argparse

from ..configs import ARCHS, SMOKES
from ..configs.base import ShapeConfig
from ..models import build
from ..train import AdamWConfig, Trainer
from ..train.trainer import mesh_not_ported


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
    if args.mesh:
        raise mesh_not_ported("--mesh")
    if args.zero1:
        raise mesh_not_ported("--zero1")
    cfg = (SMOKES if args.smoke else ARCHS)[args.arch]
    shape = ShapeConfig("cli", "train", seq_len=args.seq,
                        global_batch=args.batch)
    return Trainer(build(cfg, tp=1), shape, opt_cfg=AdamWConfig(lr=args.lr),
                   grad_accum=args.grad_accum, ckpt_dir=args.ckpt,
                   ckpt_every=args.ckpt_every, device=args.device)


def main(argv=None):
    args = parse_args(argv)
    tr = make_trainer(args)
    _, _, step = tr.run(args.steps)
    last = tr.metrics_log[-1] if tr.metrics_log else {}
    print(f"finished at step {step}: loss={last.get('loss'):.4f} "
          f"grad_norm={last.get('grad_norm'):.3f} "
          f"stragglers={len(tr.monitor.flagged)}")
    return tr


if __name__ == "__main__":
    main()
