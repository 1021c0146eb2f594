#!/usr/bin/env python3
"""Where phi3.5-moe's routes part between two attention arithmetics.

Run from the repository root on a machine with an H100:

    PYTHONPATH=src python tools/torch_moe_route_flips.py [--seeds 0 1]

Builds phi3.5-moe-42b-a6.6b as ``chip_smoke.py``'s dense phase does (its
published widths, 2 layers, batch 2, a 256-token prompt and 8 decode
steps, teacher-forced) from parameter seed s and token seed s + 1 (s = 0
is ``chip_smoke.py``'s run), and runs it with the prefill's attention
computed four ways, every other kernel the port's own:

* ``kernel``: the port's bf16 flash_attention (P rounded to bf16 in its
  key tiles, as it feeds the tensor cores);
* ``sdpa``: ``scaled_dot_product_attention`` on its flash backend, a
  second implementation that also rounds P to bf16 (in its own tiles);
* ``plain16``: ``kernels/ref.py::attention_ref`` on the bf16 operands
  (P = exp(s - max) over the whole row, rounded to bf16 once);
* ``plain32``: the same on fp32 copies, rounded to bf16 once at the end
  (P not rounded).

For each pair it prints how many of the 18 logits positions the route
gate of ``chip_smoke.py`` (``agreeing_positions``) would keep, how many
of the first MoE layer's tokens were routed otherwise, and by what router
margin: the smaller of the gaps between the first and second and the
second and third largest router probabilities in the second run of the
pair, beside the same margin's quantiles over all of that layer's tokens.
It also prints the share of the first attention call's bf16 outputs that
differ between the two runs, and their largest difference.  Last, the
comparison ``chip_smoke.py`` gates (every kernel against every plain
version) with each of the two plain attentions.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"


@contextlib.contextmanager
def routed(torch):
    """Each MoE call's router probabilities (B*T, E) and kept routes (B,
    T, k), as ``chip_smoke.routes_recorded`` records the routes."""
    from repro_torch.models import layers as L
    probs, calls = [], []

    def wrapped(xl, router, *, cfg):
        bl, t, d = xl.shape
        probs.append(torch.softmax(xl.reshape(bl * t, d).float()
                                   @ router.float(), dim=-1))
        return inner(xl, router, cfg=cfg)

    with cs.routes_recorded(torch) as recorded:
        inner = L._moe_dispatch         # the recorder of the routes
        L._moe_dispatch = wrapped
        try:
            yield probs, calls
        finally:
            L._moe_dispatch = inner
            calls.extend(recorded)


def first_output(torch, fn, kept):
    """``fn`` with its first call's output kept in ``kept``."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not kept:
            kept.append(out.detach().clone())
        return out
    return wrapped


def main(argv: list[str]) -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_moe_route_flips: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops, ref
    from repro_torch.models import build, layers as L
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    seeds = ap.parse_args(argv).seeds
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)

    def sdpa(q, k, v, *, causal=True, window=0):
        assert window <= 0 or window >= q.shape[2], window
        rep = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    def plain32(q, k, v, *, causal=True, window=0):
        return ref.attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal, window=window).to(q.dtype)

    attention = {"kernel": ops.flash_attention, "sdpa": sdpa,
                 "plain16": ref.attention_ref, "plain32": plain32}
    plain = {"rmsnorm": ref.rmsnorm_ref,
             "decode_attention": ref.decode_attention_ref}
    cfg = ARCHS[ARCH].replace(num_layers=cs.FAMILY_LAYERS)
    api = build(cfg)
    reach = cs.moe_reach(cfg)
    k_top = cfg.moe.top_k
    for seed in seeds:
        params = api.init_params(seed, cs.DEVICE)
        rng = np.random.default_rng(seed + 1)
        inp = {"tokens": torch.tensor(rng.integers(
            0, cfg.vocab_size, (cs.FAMILY_BATCH,
                                cs.FAMILY_PROMPT + cs.FAMILY_STEPS)),
            dtype=torch.int32, device=cs.DEVICE)}

        def run(fns):
            kept = []
            fns = dict(fns)
            fns["flash_attention"] = first_output(
                torch, fns["flash_attention"], kept)
            with cs.wrappers_as(ops, fns), routed(torch) as (probs, calls):
                logits = cs.dense_generate(
                    torch, api, params, inp, cs.FAMILY_PROMPT,
                    cs.FAMILY_STEPS, cs.FAMILY_SEQ)[0]
            return {"logits": torch.stack(logits, 1), "probs": probs,
                    "calls": calls, "attn": kept[0]}

        run({"flash_attention": ops.flash_attention})        # warm
        runs = {name: run({"flash_attention": fn})
                for name, fn in attention.items()}
        for a, b in (("kernel", "plain32"), ("kernel", "plain16"),
                     ("sdpa", "plain32"), ("sdpa", "plain16"),
                     ("kernel", "sdpa"), ("plain16", "plain32")):
            ra, rb = runs[a], runs[b]
            gated, strict = cs.agreeing_positions(
                torch, ra["calls"], rb["calls"], reach,
                cs.FAMILY_PROMPT - 1, ra["logits"].shape[1])
            # the first MoE layer's prefill tokens
            ka, kb = ra["calls"][0], rb["calls"][0]
            flipped = (ka != kb).any(dim=-1).reshape(-1)
            top = torch.sort(rb["probs"][0], dim=-1, descending=True).values
            margin = torch.minimum(top[:, 0] - top[:, 1],
                                   top[:, 1] - top[:, k_top])
            # a top-k that differs, against a token dropped past an
            # expert's capacity in one run only
            chosen = [torch.sort(L._top_k(r["probs"][0], k_top)[1],
                                 -1).values for r in (ra, rb)]
            set_differs = (chosen[0] != chosen[1]).any(-1)
            q = torch.quantile(margin, torch.tensor(
                [0.01, 0.1, 0.5], device=margin.device))
            differ = (ra["attn"] != rb["attn"]).float().mean()
            diff = (ra["attn"].float() - rb["attn"].float()).abs().max()
            print(f"seed {seed} {a} vs {b}: gated {int(gated.sum())} of "
                  f"{gated.numel()} positions ({int(strict.sum())} with no "
                  f"differing route before them in any layer); first MoE "
                  f"layer: {int(flipped.sum())} of {flipped.numel()} prompt "
                  f"tokens routed otherwise ({int(set_differs.sum())} by "
                  f"the router's top {k_top}, the rest by a capacity drop), "
                  f"their margins "
                  f"{sorted(round(float(x), 6) for x in margin[flipped])}"
                  f" (of those with another top {k_top}: "
                  f"{sorted(round(float(x), 6) for x in margin[set_differs])}"
                  f"); "
                  f"all tokens' margin 1 % / 10 % / 50 %: "
                  f"{[round(float(x), 6) for x in q]}; first attention "
                  f"output: {100 * float(differ):.2f} % of bf16 elements "
                  f"differ, max abs diff {float(diff):.4g}  [{card}]")
        # chip_smoke.py's comparison: every kernel against every plain
        # version, with each plain attention
        for name in ("plain16", "plain32"):
            rp = run({**plain, "flash_attention": attention[name]})
            gated, strict = cs.agreeing_positions(
                torch, runs["kernel"]["calls"], rp["calls"], reach,
                cs.FAMILY_PROMPT - 1, rp["logits"].shape[1])
            print(f"seed {seed} kernels vs plain versions with {name}: "
                  f"gated {int(gated.sum())} of {gated.numel()} positions "
                  f"({int(strict.sum())} with no differing route before "
                  f"them in any layer)  [{card}]")
        del params, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
