"""Dry run: every (architecture x input shape) on the production mesh,
with no allocation.  Each cell's parameters, optimizer state, inputs and
caches are laid out over the mesh's slots by their specs and counted in
bytes a slot, and the cell's step is traced on ``meta`` tensors through
the routes and kernel argument checks the card would take.

Counterpart of ``repro/launch/dryrun.py``:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \
      [--both-meshes] [--dev] [--smoke]

The mesh is a ``launch/mesh.py::Mesh`` of ``meta`` slots, (16, 16)
``("data", "model")`` or (2, 16, 16) with ``"pod"``; ``--dev`` shrinks
it to (2, 4) / (2, 2, 4) and the shapes as the reference does.  Nothing
touches a device but ``meta``.

* **Bytes a slot** (``memory``, under the reference's
  ``memory_analysis`` key names): each leaf's block on each slot
  (``train/sharded.py::Layout.block_slices``), summed.
  ``argument_size_in_bytes`` is parameters (fp32 to train, bf16 to
  serve), optimizer state (ZeRO-1 off, as in the reference), inputs and
  caches; ``output_size_in_bytes`` is parameters and optimizer state for
  train, and the logits (B, 1, V) at the reference's logits spec plus the
  caches for decode and prefill (the reference leaves prefill's outputs
  to XLA; the port counts them as decode's, plus the encoder's output at
  the inputs' spec for an encoder-decoder); ``alias_size_in_bytes`` is
  what the reference donates: parameters and optimizer state for train,
  caches otherwise.  Each figure is the largest slot's, and
  ``memory_slots_differ`` says whether any slot holds another count.
* **The trace** (``trace_s``): the step on ``meta`` trees, at one data
  shard's batch (``global_batch / dp``, or the whole batch in long mode),
  the shape the card's kernels see, since a meshed port step runs each
  data shard's rows on whole gathered parameters
  (``train/trainer.py::make_mesh_train_step``).  It runs under
  ``use_mesh`` with the cell's data axes, as a meshed step does, so an
  MoE's capacity is one shard's.  ``models/layers.py::on_card`` routes a
  ``meta`` tensor as a CUDA one, and the three LM kernel wrappers run
  every check of their launch on it and return empty outputs: a cell
  whose trace raises is one the card refuses.  The outputs are held to
  the inputs: train returns parameters and optimizer state of the same
  shapes and dtypes, decode and prefill the caches unchanged and logits
  (B/dp, 1, V), and an encoder-decoder's prefill its encoder's output
  of the frames' shape.

What has no counterpart, since there is no compiler and the port's
meshes gather parameters where GSPMD splits them: ``lower`` and
``compile`` (their times are replaced by ``trace_s``),
``memory_analysis``'s temp and generated-code bytes, ``cost_analysis``,
the loop-expanded HLO flops and bytes, and the collective schedule.
``model_flops`` is the reference's formula.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from ..configs import ARCHS, SMOKES, SHAPES, shapes_for
from ..configs.base import ShapeConfig
from ..models import build, layers as L
from ..train import optimizer as O
from ..train import sharded as S
from ..train.trainer import make_train_step
from .mesh import Mesh, dp_axes_of

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
META = torch.device("meta")


def make_mesh(*, multi_pod: bool, dev: bool) -> Mesh:
    """The production mesh, or ``--dev``'s, over ``meta`` slots."""
    if dev:
        shape = (2, 2, 4) if multi_pod else (2, 4)
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [META] * grid.size
    return Mesh(grid.reshape(shape), axes)


def dev_shape(shape: ShapeConfig, mesh: Mesh) -> ShapeConfig:
    """``--dev``'s shape: a 32nd of the batch (at least one row a data
    shard), sequences of at most 512."""
    return dataclasses.replace(
        shape, global_batch=max(mesh.shape.get("pod", 1) * mesh.shape["data"],
                                shape.global_batch // 32),
        seq_len=min(shape.seq_len, 512))


def _is_long_mode(shape: ShapeConfig) -> bool:
    return shape.kind == "decode" and shape.global_batch == 1


def _dp_size(mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in axes]))


@dataclasses.dataclass
class Cell:
    """A cell's abstract trees on its mesh: ``trees[name]`` is (tree of
    ``meta`` tensors, tree of specs) for "params", "inputs", and "opt"
    (train) or "caches" (prefill, decode); ``outputs`` the same for what
    a serving step returns beside its caches."""
    api: object
    shape: ShapeConfig
    mesh: Mesh
    dp_axes: tuple
    trees: dict
    outputs: dict


def lower_cell(cfg, shape: ShapeConfig, mesh):
    """Returns (cell, aux): the cell's abstract trees and specs (see
    :class:`Cell`) and the reference's parameter counts."""
    dp = dp_axes_of(mesh)
    long_mode = _is_long_mode(shape)
    tp = int(mesh.shape["model"])
    active = () if long_mode else dp
    with L.use_mesh(mesh, dp_axes=active):
        api = build(cfg, tp=tp)
        abs_params = api.abstract_params(
            dtype=None if shape.kind == "train" else "bfloat16")
        trees = {"params": (abs_params, api.param_pspecs()),
                 "inputs": (api.input_specs(shape), api.input_pspecs(shape))}
        vocab_ok = cfg.vocab_size % tp == 0
        logits_spec = L.resolve_pspec((() if long_mode else L.DP, None,
                                       "model" if vocab_ok else None))
        outputs = {}
        if shape.kind == "train":
            trees["opt"] = (O.abstract_state(abs_params), O.opt_pspecs(
                api.param_defs(), dp_axes=dp, dp_size=_dp_size(mesh, dp)))
        else:
            kw = {"long_mode": long_mode} if shape.kind == "decode" else {}
            b, s = shape.global_batch, shape.seq_len
            trees["caches"] = (api.abstract_cache(b, s, **kw),
                               api.cache_pspecs(b, s, **kw))
            dt = getattr(torch, cfg.dtype)
            outputs["logits"] = (torch.empty((b, 1, cfg.vocab_size),
                                             dtype=dt, device=META),
                                 logits_spec)
            if shape.kind == "prefill" and cfg.family == "encdec":
                outputs["enc_out"] = (trees["inputs"][0]["frames"],
                                      trees["inputs"][1]["frames"])
    total, active_n = cfg.param_count()
    cell = Cell(api=api, shape=shape, mesh=mesh, dp_axes=active, trees=trees,
                outputs=outputs)
    return cell, {"params_total": total, "params_active": active_n}


def slot_bytes(tree, specs, mesh) -> np.ndarray:
    """Bytes each slot holds of ``tree`` laid out by ``specs``, in
    ``mesh.devices.flat`` order."""
    coords = list(np.ndindex(*mesh.devices.shape))
    out = np.zeros(len(coords), dtype=np.int64)
    for leaf, spec in zip(L.tree_leaves(tree), L.tree_leaves(specs)):
        lay = S.Layout(mesh, spec)
        for i, c in enumerate(coords):
            block = lay.block_slices(leaf.shape, c)
            out[i] += int(np.prod([sl.stop - sl.start for sl in block],
                                  dtype=np.int64)) * leaf.element_size()
    return out


def memory(cell: Cell) -> dict:
    """The ``memory`` record (see the module docstring)."""
    per = {k: slot_bytes(t, s, cell.mesh)
           for k, (t, s) in {**cell.trees, **cell.outputs}.items()}
    zero = np.zeros(cell.mesh.devices.size, dtype=np.int64)
    args = per["params"] + per["inputs"] + per.get("opt", zero) \
        + per.get("caches", zero)
    if cell.shape.kind == "train":
        outs = alias = per["params"] + per["opt"]
    else:
        outs = per["caches"] + sum((per[k] for k in cell.outputs), zero)
        alias = per["caches"]
    keys = {"argument_size_in_bytes": args, "output_size_in_bytes": outs,
            "alias_size_in_bytes": alias}
    rec = {k: int(v.max()) for k, v in keys.items()}
    rec["memory_slots_differ"] = any(int(v.min()) != int(v.max())
                                     for v in keys.values())
    return rec


def shard_batch(cell: Cell, shape: ShapeConfig | None = None) -> int:
    """Rows of one data shard of ``shape`` (default: the cell's): the
    trace's batch."""
    b = (shape or cell.shape).global_batch
    dp = _dp_size(cell.mesh, cell.dp_axes)
    if b % dp:
        raise ValueError(f"a batch of {b} rows does not split over {dp} "
                         "data shards")
    return b // dp


def _same(what, got, want) -> None:
    """Raise unless the trees ``got`` and ``want`` hold tensors of the
    same shapes and dtypes, leaf for leaf."""
    for (path, g), w in zip(L.tree_items(got), L.tree_leaves(want)):
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
            raise ValueError(f"{what} {'/'.join(map(str, path))}: "
                             f"{tuple(g.shape)} {g.dtype}, expected "
                             f"{tuple(w.shape)} {w.dtype}")


def run_step(cell: Cell, shape: ShapeConfig | None = None):
    """The cell's step on ``meta`` trees at one data shard's batch of
    ``shape`` (default: the cell's): (outputs, state, batch), where
    outputs are what the step returns ((params, opt_state, metrics) to
    train; (logits, caches), and the encoder's output for an
    encoder-decoder's prefill, to serve) and state what it was given
    (params and opt_state, or params and caches)."""
    shape = shape or cell.shape
    api = cell.api
    b = shard_batch(cell, shape)
    params = cell.trees["params"][0]
    batch = api.input_specs(dataclasses.replace(shape, global_batch=b))
    with L.use_mesh(cell.mesh, dp_axes=cell.dp_axes):
        if shape.kind == "train":
            opt = cell.trees["opt"][0]
            out = make_train_step(api, O.AdamWConfig())(params, opt, batch)
            return out, (params, opt), batch
        kw = {"long_mode": _is_long_mode(shape)} \
            if shape.kind == "decode" else {}
        caches = api.abstract_cache(b, shape.seq_len, **kw)
        with torch.no_grad():
            step = api.prefill if shape.kind == "prefill" else api.decode
            return step(params, batch, caches), (params, caches), batch


def trace_cell(cell: Cell, shape: ShapeConfig | None = None) -> dict:
    """:func:`run_step`, its outputs held to its inputs (see the module
    docstring); returns the outputs' shapes.  Raises where the card's
    route refuses the cell."""
    shape = shape or cell.shape
    out, state, batch = run_step(cell, shape)
    if shape.kind == "train":
        _same("parameters", out[0], state[0])
        _same("optimizer state", out[1], state[1])
        return {"loss": tuple(out[2]["loss"].shape)}
    _same("caches", out[1], state[1])
    b = batch["tokens"].shape[0]
    got = {"logits": tuple(out[0].shape)}
    want = {"logits": (b, 1, cell.api.cfg.vocab_size)}
    if "frames" in batch:
        got["enc_out"] = tuple(out[2].shape)
        want["enc_out"] = tuple(batch["frames"].shape)
    if got != want:
        raise ValueError(f"outputs {got}, expected {want}")
    return got


def analyze(cell: Cell, *, chips: int, aux) -> dict:
    """The cell's record: ``aux``, ``memory``, ``model_flops`` and
    ``chips``."""
    shape = cell.shape
    out = dict(aux)
    out["memory"] = memory(cell)
    # MODEL_FLOPS: 6*N_active*D train; 2*N_active*D forward-only
    n_act = aux["params_active"]
    if shape.kind == "train":
        out["model_flops"] = 6.0 * n_act * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        out["model_flops"] = 2.0 * n_act * shape.global_batch * shape.seq_len
    else:
        out["model_flops"] = 2.0 * n_act * shape.global_batch
    out["chips"] = chips
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, dev: bool,
             smoke: bool = False, out_dir: str | None = None,
             trace_shape: ShapeConfig | None = None) -> dict:
    """One cell: its record, printed and written under ``out_dir``.
    ``trace_shape`` traces the step at another shape than the one the
    bytes are counted at (default: the same)."""
    cfg = (SMOKES if smoke else ARCHS)[arch]
    mesh = make_mesh(multi_pod=multi_pod, dev=dev)
    shape = SHAPES[shape_name]
    if dev:
        shape = dev_shape(shape, mesh)
    chips = int(mesh.devices.size)
    t0 = time.perf_counter()
    cell, aux = lower_cell(cfg, shape, mesh)
    rec = analyze(cell, chips=chips, aux=aux)
    t_lower = time.perf_counter() - t0
    trace_shape = trace_shape or shape
    t0 = time.perf_counter()
    rec["trace_outputs"] = trace_cell(cell, trace_shape)
    t_trace = time.perf_counter() - t0
    rec.update(arch=arch, shape=shape_name, multi_pod=multi_pod,
               mesh=dict(mesh.shape), lower_s=round(t_lower, 2),
               trace_s=round(t_trace, 2), dev=dev, seq_len=shape.seq_len,
               global_batch=shape.global_batch, kind=shape.kind,
               trace_batch=shard_batch(cell, trace_shape),
               trace_seq_len=trace_shape.seq_len)
    print(json.dumps({k: rec[k] for k in
                      ("arch", "shape", "multi_pod", "chips", "model_flops",
                       "trace_s")}, indent=None))
    print(f"  memory a slot: {rec['memory']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        base = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
        with open(os.path.join(out_dir, base + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def cells(arch: str | None, shape: str | None, every: bool) -> list:
    """(arch, shape) pairs: ``--all``'s ``ARCHS x shapes_for``, or one."""
    if every:
        return [(a, s.name) for a in ARCHS for s in shapes_for(a)]
    if not (arch and shape):
        raise SystemExit("--arch/--shape or --all")
    return [(arch, shape)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--dev", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    args = ap.parse_args(argv)

    todo = cells(args.arch, args.shape, args.all)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in todo:
        for mp in meshes:
            try:
                run_cell(arch, shape, multi_pod=mp, dev=args.dev,
                         smoke=args.smoke, out_dir=args.out)
            except Exception as e:  # noqa: BLE001 - a failed cell is a finding
                traceback.print_exc()
                failures.append((arch, shape, mp, f"{type(e).__name__}: {e}"))
    if failures:
        print(f"\nFAILED {len(failures)} cells:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print(f"\nALL {len(todo) * len(meshes)} dry-run cells traced OK")


if __name__ == "__main__":
    main()
