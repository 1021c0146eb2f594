#!/usr/bin/env python3
"""Time other tile shapes of the port's gemm and flash_attention kernels
on the card, at the main path's shapes, beside the library call.

Run from the repository root on a machine with an H100:

    PYTHONPATH=src python tools/torch_kernel_tiles.py

It compiles ``src/repro_torch/kernels/csrc/{gemm,flash_attention}.cu``
once more into a scratch library under ``build/kernel_tiles/``, with one
extra C entry per tile shape (the kernels' own ``launch_tile`` templates,
nothing else changed), checks each against the plain version, and prints
device ms a launch under torch.profiler:

* gemm at the four GNN main-path shapes (3072x420 and 3072x128 by 128,
  512x128 by 64, 512x64 by 64), one line per (wide, narrow) tile pair,
  with the pass total (4, 1, 4, 1 calls) beside ``torch.matmul``'s;
* flash_attention at llama3.2-3b's prefill (1 x 24 heads over 8 x 500 x
  128, causal, model layout), one line per (BQ, TR, SPLIT), beside
  ``scaled_dot_product_attention`` on repeated KV heads.

A tuning aid for whoever changes the tiles: the port itself runs only the
shapes its launch functions pick.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build, ref  # noqa: E402

OUT = os.path.join(ROOT, "build", "kernel_tiles")
GEMM_SHAPES = [(3072, 420, 128, 4), (3072, 128, 128, 1), (512, 128, 64, 4),
               (512, 64, 64, 1)]            # (M, K, N, calls a pass)
# (wide tile for N > 64, narrow tile): BM, BN, TM, TN, BK, STAGES
GEMM_TILES = {
    "24x64/6x4 + 32x32/2x4 (the port's)": ((24, 64, 6, 4, 16, 3),
                                           (32, 32, 2, 4, 32, 3)),
    "32x64/8x4 + 32x32/4x4": ((32, 64, 8, 4, 16, 3), (32, 32, 4, 4, 16, 3)),
    "32x64/8x4, BK 32, 4 stages": ((32, 64, 8, 4, 32, 4),
                                   (32, 32, 4, 4, 32, 4)),
    "32x64/4x4 + 32x32/2x4": ((32, 64, 4, 4, 16, 4), (32, 32, 2, 4, 16, 4)),
    "32x32/4x4 + 16x32/2x4": ((32, 32, 4, 4, 16, 4), (16, 32, 2, 4, 16, 4)),
    "16x64/8x4 + 16x32/4x4": ((16, 64, 8, 4, 16, 3), (16, 32, 4, 4, 16, 3)),
    "64x64/8x4 (96 blocks)": ((64, 64, 8, 4, 16, 3), (32, 32, 4, 4, 16, 4)),
}
FLASH_TILES = {                             # BQ, TR, SPLIT at D = 128
    "32 rows, 4 a thread, 2 parts (the port's)": (32, 4, 2),
    "32 rows, 4 a thread, 1 part": (32, 4, 1),
    "32 rows, 2 a thread, 1 part": (32, 2, 1),
    "16 rows, 2 a thread, 1 part": (16, 2, 1),
}


def build() -> ctypes.CDLL:
    csrc = str(_build.CSRC)
    lines = [f'#include "{csrc}/gemm.cu"']
    for i, (wide, narrow) in enumerate(GEMM_TILES.values()):
        w, n = ",".join(map(str, wide)), ",".join(map(str, narrow))
        lines.append(
            f'extern "C" int tile_gemm_{i}(const void* a, const void* b, '
            f'void* c, int m, int k, int n, void* st) {{ auto s = '
            f'static_cast<cudaStream_t>(st); return n > 64 ? '
            f'launch_tile<float,{w}>(a, b, c, m, k, n, s) : '
            f'launch_tile<float,{n}>(a, b, c, m, k, n, s); }}')
    flash = [f'#include "{csrc}/flash_attention.cu"']
    for i, cfg in enumerate(FLASH_TILES.values()):
        flash.append(
            f'extern "C" int tile_flash_{i}(const float* q, const float* k, '
            f'const float* v, float* o, int b, int hq, int hkv, int t, int s,'
            f' int causal, float scale, const int64_t* st, void* stream) {{ '
            f'Strides a{{st[0], st[1], st[2]}}, b_{{st[3], st[4], st[5]}}, '
            f'c{{st[6], st[7], st[8]}}, d{{st[9], st[10], st[11]}}; return '
            f'launch_tile<128,{",".join(map(str, cfg))}>(q, k, v, o, b, hq, '
            f'hkv, t, s, causal, scale, a, b_, c, d, '
            f'static_cast<cudaStream_t>(stream)); }}')
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    cmds, objs = [], []
    for name, text in (("tiles_gemm", lines), ("tiles_flash", flash)):
        src = os.path.join(OUT, name + ".cu")
        with open(src, "w") as f:
            f.write("\n".join(text) + "\n")
        objs.append(os.path.join(OUT, name + ".o"))
        cmds.append([nvcc, *_build.NVCC_FLAGS, "-I", csrc, "-c", src, "-o",
                     objs[-1]])
    _build._run_all(cmds)
    lib = os.path.join(OUT, "libtiles.so")
    _build._run_all([[nvcc, "-shared", *objs, "-o", lib]])
    return ctypes.CDLL(lib)


def device_ms(fn, reps: int = 30) -> float:
    """Mean device time of one call (torch.profiler), after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_tiles: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    lib = build()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    ins = [(torch.randn(m, k, device="cuda", generator=gen),
            torch.randn(k, n, device="cuda", generator=gen) * 0.1)
           for m, k, n, _ in GEMM_SHAPES]
    rows = list(GEMM_TILES.items()) + [("torch.matmul", None)]
    for i, (name, _) in enumerate(rows):
        fn = None if name == "torch.matmul" else getattr(lib, f"tile_gemm_{i}")
        if fn is not None:
            fn.argtypes, fn.restype = [P, P, P, I, I, I, P], I
        per, total = [], 0.0
        for (a, b), (m, k, n, calls) in zip(ins, GEMM_SHAPES):
            out = torch.empty(m, n, device="cuda")
            if fn is None:
                call = lambda: torch.matmul(a, b)           # noqa: E731
            else:
                call = lambda: fn(a.data_ptr(), b.data_ptr(),  # noqa: E731
                                  out.data_ptr(), m, k, n, stream)
                assert call() == 0
                torch.cuda.synchronize()
                torch.testing.assert_close(out, ref.gemm_ref(a, b),
                                           rtol=1e-5, atol=1e-5)
            ms = device_ms(call)
            per.append(ms)
            total += calls * ms
        print(f"gemm {name}: pass {total:.4f} ms; ms a launch "
              f"{[round(x, 5) for x in per]}  [{card}]")
    q = torch.randn(1, 500, 24, 128, device="cuda",
                    generator=gen).permute(0, 2, 1, 3)
    k = torch.randn(1, 500, 8, 128, device="cuda",
                    generator=gen).permute(0, 2, 1, 3)
    v = torch.randn(1, 500, 8, 128, device="cuda",
                    generator=gen).permute(0, 2, 1, 3)
    want = ref.attention_ref(q, k, v)
    kr, vr = k.repeat_interleave(3, 1), v.repeat_interleave(3, 1)
    rows = list(FLASH_TILES) + ["scaled_dot_product_attention"]
    for i, name in enumerate(rows):
        out = torch.empty_like(q)
        if name == "scaled_dot_product_attention":
            call = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731,E501
                q, kr, vr, is_causal=True)
        else:
            fn = getattr(lib, f"tile_flash_{i}")
            fn.argtypes = [P, P, P, P, I, I, I, I, I, I, F, P, P]
            fn.restype = I
            st = torch.tensor([x for t in (q, k, v, out) for x in t.stride()[:3]],
                              dtype=torch.int64)
            call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),  # noqa: E731,E501
                              out.data_ptr(), 1, 24, 8, 500, 500, 1,
                              128 ** -0.5, st.data_ptr(), stream)
            assert call() == 0
            torch.cuda.synchronize()
            torch.testing.assert_close(out, want, rtol=3e-5, atol=3e-5)
        print(f"flash {name}: {device_ms(call):.5f} ms a launch  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
