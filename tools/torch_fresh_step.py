#!/usr/bin/env python3
"""What a fresh process pays before its training steps settle:
``chip_smoke.py``'s phase 18 starts each rank as a new process, whose
first step reads far above the rest.  This times, in a new process:
the CUDA context (the first tensor on the card), the port's first
rmsnorm launch (its kernel library loaded), the first cuBLAS product,
a pinned 1 GiB host buffer (the transport's staging, ``launch/procs.py``)
and its first copy from the card, then phase 10's cut (llama3.2-3b at
its widths, 2 layers, fp32, batch 4 x seq 512) at (1, 2) on one card,
3 steps of ``Trainer(mesh=...)``, alone: no process group, no other
process on the card.

Run from the repository root on a machine with an H100, once a
process (each run is its own fresh process):

    PYTHONPATH=src python tools/torch_fresh_step.py

It prints each first cost in seconds and each step's ms, with the
card's name and power limit.
"""
from __future__ import annotations

import subprocess
import time

import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build
from repro_torch.train import Trainer

GIB = 1 << 30


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    first = {"context": timed(lambda: torch.ones(1, device="cuda"))}
    x = torch.randn(512, 3072, device="cuda")
    w = torch.ones(3072, device="cuda")
    first["rmsnorm"] = timed(lambda: ops.rmsnorm(x, w))
    a = torch.randn(3072, 3072, device="cuda")
    first["matmul"] = timed(lambda: a @ a)
    pinned = []
    first["pinned_1gib"] = timed(lambda: pinned.append(
        torch.empty(GIB, dtype=torch.uint8, pin_memory=True)))
    src = torch.empty(GIB, dtype=torch.uint8, device="cuda")
    first["copy_1gib"] = timed(lambda: pinned[0].copy_(src))
    cfg = ARCHS["llama3.2-3b"].replace(num_layers=2, dtype="float32")
    tr = Trainer(build(cfg, tp=2), ShapeConfig("fresh", "train", 512, 4),
                 mesh=make_host_mesh(shape=(1, 2), devices=["cuda:0"] * 2))
    tr.run(3)
    steps = [round(m["dt"] * 1e3, 3) for m in tr.metrics_log]
    print(f"fresh process: first costs (s) "
          f"{ {k: round(v, 4) for k, v in first.items()} }; (1, 2) train "
          f"step ms {steps}  [{card}]")


if __name__ == "__main__":
    main()
