#!/usr/bin/env python3
"""What a dry-run cell holds at its traced peak: the op that reached it,
the live storages by size, and the port's call stack there.

Run from the repository root, on the CPU (the trace is on ``meta``
slots; nothing touches a card):

    PYTHONPATH=src python tools/torch_dryrun_peak.py --arch llama3.2-3b \
        [--shape train_4k] [--multi-pod] [--dev] [--smoke]

It runs ``launch/dryrun.py::analyze_cell`` on the cell's production
mesh (``--dev``'s with ``--dev``) with ``launch/memtrace.py::StepTrace``
watched: each time the live bytes pass their peak so far, it notes the
aten op that allocated, the storages then live (counts by size, those
of 50 MB or more) and the frames of ``src/repro_torch`` on the stack.
Prints the record's peak, arguments, ``fits`` and ``model_split``, then
what it noted at the peak.
"""
from __future__ import annotations

import argparse
import collections
import traceback

from repro_torch.configs import ARCHS, SHAPES, SMOKES
from repro_torch.launch import dryrun as D
from repro_torch.launch import memtrace as MT

BIG = 50e6                      # storages listed at the peak, bytes


def watch() -> dict:
    """Patch ``StepTrace`` to note the state at each new peak; returns
    the dict it writes into."""
    seen = {"op": None, "peak": 0}
    add, dispatch = MT.StepTrace._add, MT.StepTrace.__torch_dispatch__

    def dispatch_noted(self, func, types, args=(), kwargs=None):
        seen["op"] = str(func)
        return dispatch(self, func, types, args, kwargs)

    def add_noted(self, t):
        n = add(self, t)
        if self.peak_bytes > seen["peak"]:
            sizes = [v[0] for v in self._live.values() if v[0] >= BIG]
            seen.update(
                peak=self.peak_bytes, at=seen["op"],
                storages=sorted(collections.Counter(
                    round(s / 1e9, 3) for s in sizes).items(), reverse=True),
                stack=[f"{f.filename.split('src/')[-1]}:{f.lineno} {f.name}"
                       for f in traceback.extract_stack()[:-1]
                       if "repro_torch" in f.filename])
        return n

    MT.StepTrace._add = add_noted
    MT.StepTrace.__torch_dispatch__ = dispatch_noted
    return seen


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dev", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    cfg = (SMOKES if args.smoke else ARCHS)[args.arch]
    mesh = D.make_mesh(multi_pod=args.multi_pod, dev=args.dev)
    shape = SHAPES[args.shape]
    if args.dev:
        shape = D.dev_shape(shape, mesh)
    seen = watch()
    _, rec = D.analyze_cell(cfg, shape, mesh)
    m = rec["memory"]
    print(f"{args.arch} {args.shape} {dict(mesh.shape)}: peak "
          f"{m['peak_bytes'] / 1e9:.3f} GB a slot (arguments "
          f"{m['argument_size_in_bytes'] / 1e9:.3f}, temp "
          f"{m['temp_size_in_bytes'] / 1e9:.3f}), fits {rec['fits']}, "
          f"model_split {rec['model_split']}, traced in {rec['trace_s']} s")
    print(f"  at the peak: {seen['at']}")
    print(f"  live storages of {BIG / 1e6:.0f} MB or more (GB, count): "
          f"{seen['storages']}")
    print("  stack: " + " <- ".join(reversed(seen["stack"])))


if __name__ == "__main__":
    main()
