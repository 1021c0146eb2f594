#!/usr/bin/env python3
"""Peak card memory and step time of ``chip_smoke.py``'s phase 10 runs:
llama3.2-3b at its widths, 2 layers in fp32, batch 4 x seq 512, 3 steps
of ``Trainer(mesh=...)`` on (data, model) meshes of slots on one card,
ZeRO-1 where data > 1.

Run from the repository root on a machine with an H100, against the
package that ``PYTHONPATH`` names (this checkout's, or another commit's
unpacked beside it, to compare the two on one card):

    PYTHONPATH=src python tools/torch_mesh_train_peak.py [1x1 1x2 2x1 2x2]

For each mesh (all four when none is named) it prints
``torch.cuda.max_memory_allocated`` over the run above what was
allocated before it (after ``reset_peak_memory_stats``), the step ms
(median of steps 2 and 3) and whether the package's step split the
compute over the model axis, with the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build
from repro_torch.train import Trainer

ARCH, LAYERS, BATCH, SEQ, STEPS = "llama3.2-3b", 2, 4, 512, 3
SLOT = "cuda:0"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def run(mesh_shape) -> tuple[int, float, bool]:
    """(peak bytes above the start, median step ms, split) of one run."""
    cfg = ARCHS[ARCH].replace(num_layers=LAYERS, dtype="float32")
    shape = ShapeConfig("mesh", "train", SEQ, BATCH)
    d, m = mesh_shape
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_host_mesh(shape=mesh_shape, devices=[SLOT] * (d * m))
    api = build(cfg, tp=m)
    tr = Trainer(api, shape, mesh=mesh, zero1=d > 1)
    tr.run(STEPS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    split = m > 1 and getattr(api, "model_split", lambda: False)()
    dt = float(np.median([x["dt"] for x in tr.metrics_log[1:]]))
    del tr
    torch.cuda.empty_cache()
    return peak, dt * 1e3, split


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_mesh_train_peak: no CUDA device", file=sys.stderr)
        return 1
    meshes = [tuple(map(int, a.split("x"))) for a in argv] or \
        [(1, 1), (1, 2), (2, 1), (2, 2)]
    name = card()
    for mesh_shape in meshes:
        t0 = time.perf_counter()
        peak, ms, split = run(mesh_shape)
        print(f"mesh train peak {mesh_shape[0]}x{mesh_shape[1]}: "
              f"max_memory_allocated {peak} bytes ({peak / 2**30:.3f} GiB) "
              f"above the start, step ms {ms:.3f} (median of steps 2-"
              f"{STEPS}), split {split}, {time.perf_counter() - t0:.1f} s "
              f"[{name}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
