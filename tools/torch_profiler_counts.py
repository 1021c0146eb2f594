#!/usr/bin/env python3
"""torch.profiler's recorded kernel launches against the port's launch
counters, on one xlstm-125m training step (batch 8 x seq 128, remat
"full": the forward's rmsnorm launches, then the recompute's inside the
backward) and one paged-LM prefill (llama3.2-3b, 2 layers), each in
windows opened as ``chip_smoke.py`` opens them before its marker burst:
``profile(activities=[CUDA], acc_events=True)`` around the call and a
synchronize.

Run from the repository root on a machine with an H100:

    PYTHONPATH=src python tools/torch_profiler_counts.py \
        [--windows 2] [--calls train,prefill]

For each call it prints, window by window, the launches each kernel's
wrapper counted, those the profiler recorded under the kernel's name
(``chip_smoke.COUNT_SYMBOLS``), the number of kernels recorded and the
positions of rmsnorm's among them in start order, with the card's name
and power limit and the environment's ``TEARDOWN_CUPTI`` (whether Kineto
tears CUPTI down after each window).
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import kernels
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import synth_batch
from repro_torch.launch.serve import PagedLM
from repro_torch.models import build
from repro_torch.store.pagedkv import PagePool
from repro_torch.train import make_train_step, optimizer as O

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import COUNT_SYMBOLS  # noqa: E402

DEVICE = "cuda"
SYMBOLS = {k: COUNT_SYMBOLS[k]
           for k in ("rmsnorm", "flash_attention", "decode_attention")}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def window(fn) -> tuple[dict, dict, int, list]:
    """(counted, recorded, kernels recorded, rmsnorm's positions among
    them in start order) of one call."""
    before = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) \
            as prof:
        fn()
        torch.cuda.synchronize()
    counted = {k: v - before[k] for k, v in kernels.launch_counts().items()
               if k in SYMBOLS}
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    recorded = {k: sum(1 for e in events if re.search(s, e.name))
                for k, s in SYMBOLS.items()}
    ordered = sorted(events, key=lambda e: e.time_range.start)
    where = [i for i, e in enumerate(ordered)
             if re.search(SYMBOLS["rmsnorm"], e.name)]
    return counted, recorded, len(ordered), where


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--calls", default="train,prefill")
    args = ap.parse_args()
    print(card())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')}")
    cfg = ARCHS["xlstm-125m"]
    api = build(cfg)
    params = api.init_params(0, DEVICE)
    opt = O.init_state(params)
    shape = ShapeConfig("t", "train", 128, 8)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in synth_batch(cfg, shape, 0).items()}
    step = make_train_step(api, O.AdamWConfig())
    step(params, opt, batch)
    torch.cuda.synchronize()

    lm_cfg = ARCHS["llama3.2-3b"].replace(num_layers=2)
    lm_params = build(lm_cfg).init_params(0, DEVICE)
    pool = PagePool(num_pages=64, page_size=16, num_layers=2,
                    num_kv_heads=lm_cfg.num_kv_heads,
                    head_dim=lm_cfg.resolved_head_dim, device=DEVICE)
    lm = PagedLM(lm_cfg, lm_params, pool)
    seq = lm.mgr.add_sequence(0, list(range(500)))
    lm.prefill_logits(seq)
    torch.cuda.synchronize()

    calls = {"train": ("xlstm-125m train step",
                       lambda: step(params, opt, batch)),
             "prefill": ("llama3.2-3b prefill (2 layers)",
                         lambda: lm.prefill_logits(seq))}
    for what, fn in (calls[c] for c in args.calls.split(",")):
        for attempt in range(args.windows):
            counted, recorded, n, where = window(fn)
            print(f"{what}, window {attempt + 1}: counted {counted}, "
                  f"recorded {recorded}, {n} kernels recorded, rmsnorm at "
                  f"{where}")

if __name__ == "__main__":
    main()
