#!/usr/bin/env python3
"""How many logits positions phase 13's route gate keeps at each prompt
length.

Run from the repository root on a machine with an H100:

    PYTHONPATH=src python tools/torch_moe_axis_prompts.py \
        [--prompts 32 64 256]

For each prompt length (the cache holds it, ``chip_smoke.py``'s 8
decode steps and 8 positions more), it runs ``chip_smoke.py``'s phase 13
serving runs (``moe_serve``: phi3.5-moe at its published widths, 2
layers, through ``MeshServe`` at (1, 2) and (1, 16), and llama4-scout, 1
layer, at (1, 16); batch ``MOE_SERVE_BATCH``) and prints their lines,
each gate's reading and how many positions the routes leave it.  A gate
that would fail the smoke run is printed (``GATE FAILED``) and the run
goes on.  A flip of one route in the prompt, in a layer whose output
reaches later positions, leaves every later position of that sequence
out, so the share kept falls with the prompt's length.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_moe_axis_prompts: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops, ref
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompts", type=int, nargs="+", default=[32, 64, 256])
    prompts = ap.parse_args(argv).prompts
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    _build.library()
    gate = cs.compare_routed

    def reported(*args, **kwargs):
        try:
            return gate(*args, **kwargs)
        except AssertionError as e:
            print(f"GATE FAILED {e}")

    cs.compare_routed = reported
    cs.dense_rows = lambda *a, **k: []          # no kernel timing here
    names = cs.LM_KERNELS + ("decode_attention_partial",)
    plain = {"rmsnorm": ref.rmsnorm_ref,
             "flash_attention": ref.attention_ref,
             "decode_attention": ref.decode_attention_ref,
             "decode_attention_partial": ref.decode_attention_partial_ref}
    originals = {n: getattr(ops, n) for n in names}
    for prompt in prompts:
        cs.MOE_SERVE_PROMPT = prompt
        cs.MOE_SERVE_SEQ = prompt + cs.MOE_SERVE_STEPS + 8
        print(f"==== prompt {prompt}, cache {cs.MOE_SERVE_SEQ}, batch "
              f"{cs.MOE_SERVE_BATCH}, {cs.MOE_SERVE_STEPS} steps")
        for arch, layers, meshes in cs.MOE_SERVE:
            cs.moe_serve(torch, card, arch, layers, meshes, originals, plain)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
