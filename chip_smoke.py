#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package ``repro``.
Phases, each uncaught, so any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``); build the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` and print the seconds;
2. the quickstart flow over RPC: ``update_graph``, ``program_config(...,
   "hetero")``, a 2-layer GCN ``run`` that must go through AggCombine on
   the vector device and launch the agg_combine kernel;
3. the main path at full width: the "physics" graph (12,000 vertices,
   90,000 zipf(1.35) edges, 420 features), GCN/GIN/NGCF at [420, 128, 64]
   with fanouts [10, 10], one ``run_batch`` of 32 requests x 16 targets
   each under Hetero, with every launch count zeroed just before and read
   just after; then group time, Hetero against an Octa (Shell-only)
   service at 2e-5, and fused against serial ``run`` bit for bit;
4. every kernel against its plain version on the arguments the main path
   gave it (recorded in phase 3), with kernel, plain and library times
   and the least time the card could take (``bound_ms``);
5. a ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` last.

Without CUDA, or without the repository beside it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the repo's "physics" workload (benchmarks/common.py), regenerated inline
N_VERTICES, N_EDGES, FEAT, ZIPF_A = 12_000, 90_000, 420, 1.35
DIMS = [FEAT, 128, 64]                # benchmarks/fig16_pure_inference.py
FANOUTS = [10, 10]
GROUP, TARGETS = 32, 16
MODELS = ("gcn", "gin", "ngcf")
GROUP_REPEATS = 5
DEVICE = "cuda"

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM and fp32 FMA
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

TOL = {"agg_combine": 2e-5, "spmm": 1e-5, "gemm": 1e-5, "sddmm": 1e-5}
TOL_BF16 = 2e-2
SERVICE_TOL = 2e-5
KERNEL_SOURCES = {
    "agg_combine": ("src/repro_torch/kernels/csrc/agg_combine.cu",
                    "src/repro/kernels/agg_combine.py:95"),
    "spmm": ("src/repro_torch/kernels/csrc/spmm.cu",
             "src/repro/kernels/spmm.py:56"),
    "gemm": ("src/repro_torch/kernels/csrc/gemm.cu",
             "src/repro/kernels/gemm.py:63"),
    "sddmm": ("src/repro_torch/kernels/csrc/sddmm.cu",
              "src/repro/kernels/sddmm.py:49"),
}


def make_graph(seed: int = 0):
    """Power-law edges (zipf sources, uniform destinations) and Gaussian
    embeddings, the recipe of ``benchmarks/common.py::make_workload``."""
    rng = np.random.default_rng(seed)
    src = rng.zipf(ZIPF_A, N_EDGES) % N_VERTICES
    dst = rng.integers(0, N_VERTICES, N_EDGES)
    edges = np.stack([dst, src], axis=1).astype(np.int64)
    emb = rng.standard_normal((N_VERTICES, FEAT)).astype(np.float32)
    return edges, emb


def model_setup(gnn, make_service_dfg, model: str):
    params = gnn.init_params(model, DIMS, seed=0, device=DEVICE)
    weights = {k: v for k, v in gnn.dfg_feeds(model, params, None, []).items()
               if k != "H"}
    return make_service_dfg(model, len(DIMS) - 1, FANOUTS).save(), weights


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gathered_rows(torch, nbr, mask, prefix: int = 0) -> int:
    """Distinct rows of h that unmasked slots (and a destination prefix)
    need: what this call's data must read, each row once."""
    rows = nbr[mask != 0].long()
    if prefix:
        rows = torch.cat([rows, torch.arange(prefix, device=nbr.device)])
    return int(torch.unique(rows).numel())


def call_cost(torch, name: str, args) -> tuple[float, float]:
    """(bytes, fp32 flops) the function needs for this call: each input
    read once, each output written once."""
    if name == "gemm":
        a, b = args
        m, k = a.shape
        n = b.shape[1]
        return (m * k + k * n + m * n) * a.element_size(), 2.0 * m * n * k
    h, nbr, mask = args[:3]
    f = h.shape[1]
    d, k = nbr.shape
    nnz = int((mask != 0).sum())
    ell = nbr.numel() * 4 + mask.numel() * 4
    if name == "spmm":
        return gathered_rows(torch, nbr, mask) * f * 4 + ell + d * f * 4, \
            2.0 * nnz * f
    if name == "sddmm":
        return (gathered_rows(torch, nbr, mask, prefix=d) * f * 4 + ell
                + d * k * f * 4), 2.0 * nnz * f
    w = args[3]
    o = w.shape[1]
    return (gathered_rows(torch, nbr, mask) * f * 4 + ell + f * o * 4 + o * 4
            + d * o * 4), 2.0 * nnz * f + 2.0 * d * f * o


def device_busy(torch, fn) -> tuple[float, float]:
    """(device-busy ms, wall ms) of one call of ``fn`` under torch.profiler:
    the summed time of every kernel and copy the card ran, against the
    host clock around the call (which the profiler slows somewhat)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / 1e3, wall * 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 2
    from repro_torch import kernels   # fails without the repository beside us
    from repro_torch.core import gnn
    from repro_torch.core.service import HolisticGNNService, make_service_dfg
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.ops import program_config
    from repro_torch.rpc import RPCClient, RPCServer

    # ------------------------------------------------ 1. card, build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.build_dir().name})")
    for line in (_build.build_dir() / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    # ------------------------------------------------ 2. quickstart over RPC
    rng = np.random.default_rng(0)
    qs_edges = np.stack([rng.integers(0, 1000, 8000),
                         rng.zipf(1.4, 8000) % 1000], 1).astype(np.int64)
    qs_emb = rng.standard_normal((1000, 64)).astype(np.float32)
    qs = HolisticGNNService(h_threshold=32, pad_to=32, device=DEVICE)
    client = RPCClient(RPCServer(qs))
    client.call("update_graph", edge_array=qs_edges, embeddings=qs_emb)
    program_config(qs.xbuilder, "hetero")
    qs_params = gnn.init_params("gcn", [64, 32, 16], seed=1, device="cpu")
    qs_weights = {k: v.numpy() for k, v in
                  gnn.dfg_feeds("gcn", qs_params, None, []).items()
                  if k != "H"}
    before = kernels.launch_counts()["agg_combine"]
    out = client.call("run", dfg=make_service_dfg("gcn", 2, [10, 10]).save(),
                      batch=[1, 2, 3, 4], weights=qs_weights)["Result"]
    assert qs.engine.trace.count(("AggCombine", "vector")) == 2, \
        qs.engine.trace
    assert kernels.launch_counts()["agg_combine"] > before
    assert out.shape[1] == 16 and np.isfinite(out).all()
    print(f"quickstart: Result {out[:4].shape} via "
          f"{sorted({d for _, d in qs.engine.trace})}")

    # ------------------------------------------------ 3. main path, full width
    edges, emb = make_graph()
    svc = HolisticGNNService(h_threshold=64, pad_to=64, device=DEVICE)
    svc.update_graph(edges, emb)
    program_config(svc.xbuilder, "hetero")
    octa = HolisticGNNService(h_threshold=64, pad_to=64, device=DEVICE)
    octa.update_graph(edges, emb)
    program_config(octa.xbuilder, "octa")
    req_rng = np.random.default_rng(1)
    reqs = [{"targets": req_rng.integers(0, N_VERTICES, TARGETS).tolist(),
             "seed": 100 + i} for i in range(GROUP)]
    setups = {m: model_setup(gnn, make_service_dfg, m) for m in MODELS}
    for m in MODELS:                                   # warm: plans, allocator
        svc.run_batch(setups[m][0], reqs, weights=setups[m][1])
    torch.cuda.synchronize()

    # record what each kernel wrapper gets on the main path, to replay it
    recorded = {name: [] for name in kernels.KERNELS}
    originals = {name: getattr(ops, name) for name in kernels.KERNELS}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            recorded[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    for name, fn in originals.items():
        setattr(ops, name, recorder(name, fn))
    try:
        kernels.reset_launch_counts()
        fused = {m: svc.run_batch(setups[m][0], reqs, weights=setups[m][1])
                 for m in MODELS}
        launches = kernels.launch_counts()
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)
    print(f"main path launches: {launches}")
    assert all(launches[k] > 0 for k in kernels.KERNELS), launches
    print(f"group: {GROUP} requests x {TARGETS} targets, fanouts {FANOUTS}; "
          f"H rows {recorded['agg_combine'][0][0][0].shape[0]}, layer dst "
          f"rows {[a[0][1].shape[0] for a in recorded['agg_combine']]}")

    for m in MODELS:
        dfg, weights = setups[m]
        for res, r in zip(fused[m], reqs):
            assert res["Result"].shape == (TARGETS, DIMS[-1])
            assert np.isfinite(res["Result"]).all()
        times, engine = [], []
        for _ in range(GROUP_REPEATS):
            t0 = time.perf_counter()
            svc.run_batch(dfg, reqs, weights=weights)
            times.append(time.perf_counter() - t0)
            engine.append(sum(t for op, _, t in svc.engine.timings
                              if op == "__dfg_jit__"))
        best = min(times)
        print(f"{m}: run_batch group {best * 1e3:.3f} ms best of "
              f"{GROUP_REPEATS} (median {np.median(times) * 1e3:.3f} ms), "
              f"{GROUP / best:.1f} requests/s; engine (plan walk to sync) "
              f"median {np.median(engine) * 1e3:.3f} ms, the rest is host "
              f"sampling, padding and copies  [{card}]")
        busy, wall = device_busy(
            torch, lambda: svc.run_batch(dfg, reqs, weights=weights))
        print(f"{m}: under torch.profiler the card was busy {busy:.3f} ms of "
              f"a {wall:.3f} ms group ({100 * busy / wall:.2f} %)  [{card}]")
        shell = octa.run_batch(dfg, reqs, weights=weights)
        err = max(float(np.abs(a["Result"] - b["Result"]).max())
                  for a, b in zip(fused[m], shell))
        for a, b in zip(fused[m], shell):
            np.testing.assert_allclose(a["Result"], b["Result"],
                                       rtol=SERVICE_TOL, atol=SERVICE_TOL)
        for res, r in zip(fused[m], reqs):
            serial = svc.run(dfg, r["targets"], weights=weights,
                             seed=r["seed"])["Result"][:TARGETS]
            np.testing.assert_array_equal(serial, res["Result"])
        print(f"{m}: hetero vs octa max abs err {err:.3g} (tol {SERVICE_TOL});"
              f" fused == serial bitwise for {GROUP} requests")

    # ------------------------------------------------ 4. kernels vs plain
    plain = {
        "agg_combine": lambda h, n, k, w, b, mode="mean":
            ref.agg_combine_ref(h, n, k, w, b, mode=mode),
        "spmm": lambda h, n, k, mode="mean": ref.spmm_ref(h, n, k, mode=mode),
        "gemm": lambda a, b: ref.gemm_ref(a, b).to(a.dtype),
        "sddmm": ref.sddmm_ref,
    }

    def library(name, args, kwargs):
        if name == "gemm":
            a, b = args
            return lambda: torch.matmul(a, b)
        if name == "spmm":
            h, nbr, mask = args
            per_slot = mask                  # mean: fold 1/deg into the weights
            if kwargs.get("mode", "mean") == "mean":
                per_slot = mask / torch.clamp(mask.sum(1), min=1.0)[:, None]
            idx = nbr.long()
            return lambda: torch.nn.functional.embedding_bag(
                idx, h, per_sample_weights=per_slot, mode="sum")
        return None

    rows = []
    for name in kernels.KERNELS:
        fn = originals[name]
        tol = TOL[name]
        ms = plain_ms = bound_ms = 0.0
        lib_ms = 0.0 if name in ("gemm", "spmm") else None
        max_err, by_bytes, by_ops = 0.0, 0.0, 0.0
        for args, kwargs in recorded[name]:
            got = fn(*args, **kwargs)
            want = plain[name](*args, **kwargs)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max()) \
                if got.numel() else 0.0
            assert torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol), (name, err)
            max_err = max(max_err, err)
            ms += time_ms(torch, lambda: fn(*args, **kwargs))
            plain_ms += time_ms(torch, lambda: plain[name](*args, **kwargs),
                                reps=5)
            lib = library(name, args, kwargs)
            if lib is not None:
                lib_ms += time_ms(torch, lib)
            nbytes, flops = call_cost(torch, name, args)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / FP32_FLOP_PER_S * 1e3
            bound_ms += max(t_bytes, t_ops)
            if t_bytes >= t_ops:
                by_bytes += t_bytes
            else:
                by_ops += t_ops
        src, replaces = KERNEL_SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                     "library_ms": lib_ms})
        print(f"{name}: {len(recorded[name])} calls, max abs err {max_err:.3g} "
              f"(tol {tol}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"bound {bound_ms:.4f} ms  [{card}]")

    # agg_combine_partial and bf16 gemm on main-path arguments
    (h, nbr, mask, w, _b), kw = recorded["agg_combine"][0]
    got = kernels.agg_combine_partial(h, nbr, mask, w, **kw)
    want = ref.agg_combine_ref(h, nbr, mask, w, None, **kw)
    assert torch.allclose(got, want, rtol=TOL["agg_combine"],
                          atol=TOL["agg_combine"])
    print(f"agg_combine_partial: max abs err "
          f"{float((got - want).abs().max()):.3g}")
    (a, b), _ = recorded["gemm"][0]
    a16, b16 = a.bfloat16(), b.bfloat16()
    got = kernels.gemm(a16, b16).float()
    want = ref.gemm_ref(a16, b16).bfloat16().float()
    assert torch.allclose(got, want, rtol=TOL_BF16, atol=TOL_BF16)
    print(f"gemm bf16 {tuple(a.shape)}@{tuple(b.shape)}: max abs err "
          f"{float((got - want).abs().max()):.3g} (tol {TOL_BF16})")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")

    # ------------------------------------------------ 5. result lines
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
