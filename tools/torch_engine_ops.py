#!/usr/bin/env python3
"""The GNN engine's time on the card, by model and by operation.

Run from the repository root on a machine with an H100:

    PYTHONPATH=src python tools/torch_engine_ops.py [--groups 20]

Builds the main-path cell of ``chip_smoke.py`` (the "physics" graph,
GCN/GIN/NGCF at [420, 128, 64], fanouts [10, 10], one group of 32
requests x 16 targets under Hetero) and prints, for each model, the
engine's time ("plan walk to sync": the planned path ``run_batch``
takes, host clock, ending in a synchronize) over ``--groups`` groups,
median and best, then each operation's time on the eager path, which
synchronises after every node (summed over a pass, median over the
groups).  ``chip_smoke.py`` reads the engine's time over five groups;
this reads it over more, and splits it.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_engine_ops: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import gnn
    from repro_torch.core.service import HolisticGNNService, make_service_dfg
    from repro_torch.kernels.ops import program_config
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=20)
    groups = ap.parse_args(argv).groups
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    edges, emb = cs.make_graph()
    svc = HolisticGNNService(h_threshold=64, pad_to=64, device=cs.DEVICE)
    svc.update_graph(edges, emb)
    program_config(svc.xbuilder, "hetero")
    rng = np.random.default_rng(1)
    reqs = [{"targets": rng.integers(0, cs.N_VERTICES, cs.TARGETS).tolist(),
             "seed": 100 + i} for i in range(cs.GROUP)]
    for model in cs.MODELS:
        dfg, weights = cs.model_setup(gnn, make_service_dfg, model)
        for _ in range(3):                            # warm: plans, allocator
            svc.run_batch(dfg, reqs, weights=weights)
        engine, per_op = [], {}
        for _ in range(groups):
            svc.run_batch(dfg, reqs, weights=weights)
            engine.append(sum(t for op, _, t in svc.engine.timings
                              if op == "__dfg_jit__") * 1e3)
        for _ in range(groups):
            svc.run_batch(dfg, reqs, weights=weights, jit=False)
            summed = {}
            for op, _, t in svc.engine.timings:
                summed[op] = summed.get(op, 0.0) + t * 1e3
            for op, ms in summed.items():
                per_op.setdefault(op, []).append(ms)
        ops = ", ".join(f"{op} {statistics.median(v):.4f}"
                        for op, v in per_op.items())
        print(f"{model}: engine {statistics.median(engine):.4f} ms median, "
              f"{min(engine):.4f} best of {groups} groups; eager, ms a pass "
              f"by operation: {ops}  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
