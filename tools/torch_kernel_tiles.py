#!/usr/bin/env python3
"""Time other tile shapes of the port's kernels on the card, at the main
path's shapes, beside the library call.

Run from the repository root on a machine with an H100:

    PYTHONPATH=src python tools/torch_kernel_tiles.py [gemm] [flash] \
        [decode] [rmsnorm] [agg] [sddmm] [spmm]

(all seven when none is named).  For gemm, flash, agg, sddmm and spmm
it compiles ``src/repro_torch/kernels/csrc/{gemm,flash_attention,
agg_combine,sddmm,spmm}.cu`` once more into a scratch library under
``build/kernel_tiles/``, with one extra C entry per tile shape (the
kernels' own ``launch_tile`` and ``launch`` templates, nothing else
changed); decode and rmsnorm call the port's library with other values
of a launch argument.  Each
is checked against the plain version and timed in device ms a launch
under torch.profiler:

* gemm at the four GNN main-path shapes (3072x420 and 3072x128 by 128,
  512x128 by 64, 512x64 by 64), one line per (wide, narrow) tile pair,
  with the pass total (4, 1, 4, 1 calls) beside ``torch.matmul``'s;
* flash_attention at llama3.2-3b's prefill (1 x 24 heads over 8 x 500 x
  128, causal, model layout), one line per (BQ, TR, SPLIT), beside
  ``scaled_dot_product_attention`` on repeated KV heads; then the bf16
  tensor-core kernel at gemma3-12b's causal prefill (4 x 16 heads over 8
  x 1536 x 256) and llama3.2-3b's training shape (4 x 24 over 8 x 512 x
  128), one line per (keys a tile, consumer warpgroups, stages), beside
  SDPA and the operations bound;
* decode_attention at llama3.2-3b's decode step (batch 4, 516 positions,
  24 heads over 8, D 128, 16-slot pages), cold (each launch on another
  of 28 layers' pools) and warm, split and combine kernels apart, one
  line per pages-a-split (the C entry's argument), beside the plain
  version and the bound;
* decode_attention's partial entry at the split serving step's (1,16)
  blocks (gemma3-12b's 128 global and 64 ring positions, phi3.5-moe's 3,
  jamba's 8; bf16), one line per (positions a split, one launch as a
  cluster or the split and combine kernels), in device ms a launch on
  CUDA events (back to back behind a spin, each launch on another copy
  of the pools), beside SDPA over the dense cache under a length mask
  (which writes no lse) and the bound;
* rmsnorm at the 500 x 3072 prefill rows and the 4 x 3072 decode rows,
  fp32 and bf16, one line per threads-a-row (the C entry's argument),
  beside ``F.rms_norm`` and the bound;
* agg_combine at the GNN main path's two layers (N 16384, F 420, D 3072,
  K 10, O 128 and N 3072, F 128, D 512, K 10, O 64), one line per tile
  shape (rows, columns, rows a consumer thread, k a stage, stages,
  producer warps), beside the port's unfused spmm then gemm kernels and
  the bound;
* sddmm at the same two layers, one line per warps (destination rows) a
  block, beside the bound;
* spmm at the same two layers, warm and cold (each launch on another
  copy of h, past the L2), held bit for bit: the register path by floats
  a thread, gathers in flight a thread (SLOTS) and threads a block, and
  a bulk-copy path (``SPMM_BULK`` below: TMA copies of whole rows into
  shared memory on mbarriers) by warps (rows in flight) a block, beside
  ``embedding_bag`` and the bound.

A tuning aid for whoever changes the tiles: the port itself runs only the
shapes its launch functions pick.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import kernels  # noqa: E402
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
DECODE_PAGES_PER_SPLIT = (1, 2, 4, 8)
DECODE_LAYERS, DECODE_ROUNDS = 28, 3
# decode_attention_partial at the split serving step's (1,16) blocks, bf16:
# (label, B, Hq, Hkv, D, ps, positions a block, all of them seen)
PARTIAL_SHAPES = [("gemma3-12b global", 4, 16, 8, 256, 16, 128),
                  ("gemma3-12b ring", 4, 16, 8, 256, 16, 64),
                  ("phi3.5-moe", 8, 32, 8, 128, 1, 3),
                  ("jamba", 8, 32, 8, 128, 8, 8)]
PARTIAL_SPLITS = (8, 16, 32, 64)           # positions a split
PARTIAL_LAUNCHES = 200                     # timed launches a variant
SPIN_CYCLES_PER_US = 2000                  # the H100's 1.98 GHz, rounded up
RMSNORM_THREADS = (96, 128, 192, 256, 384)  # 8, 6, 4, 3, 2 vectors
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
# GNN main-path layers: (N, F, D, K, O)
GNN_LAYERS = [(16384, 420, 3072, 10, 128), (3072, 128, 512, 10, 64)]
# agg_combine tile shapes by O > 64: the port's first, then 8 producer
# warps, 32 and 16 rows (96 and 192 blocks), 12 rows
AGG_CANDIDATES = {
    True: [(24, 128, 3, 16, 3, 12), (24, 128, 3, 16, 3, 8),
           (32, 128, 4, 16, 3, 12), (16, 128, 2, 16, 3, 12),
           (12, 128, 3, 16, 3, 8)],
    False: [(8, 64, 1, 32, 3, 8), (4, 64, 1, 32, 3, 4),
            (16, 64, 2, 32, 3, 8), (2, 64, 1, 32, 3, 4)]}
SDDMM_WARPS = (4, 8, 16)                   # the port's first
# spmm's register path: (floats a thread, SLOTS, threads a block), the
# port's SLOTS and threads (csrc/spmm.cu's kSlots, kThreads) first; the
# bulk-copy path: warps a block
SPMM_PORT = (5, 128)
SPMM_CANDIDATES = [(4, 5, 128), (2, 5, 128), (1, 5, 128), (4, 5, 256),
                   (4, 5, 64), (4, 10, 256), (4, 10, 128), (4, 10, 64),
                   (4, 8, 128), (4, 6, 128), (4, 4, 128), (4, 3, 128),
                   (4, 2, 128), (2, 10, 128), (1, 10, 128)]
SPMM_BULK_WARPS = (1, 2, 4)
L2_BYTES = 50 * 2**20                      # the H100's L2
# spmm by TMA bulk copies, a sweep variant beside spmm.cu's register path.
# A warp owns a destination row at a time (rows strided over the grid),
# with two stages of K x F floats in shared memory: lane j starts the copy
# of slot j's row (F * 4 bytes) on the stage's mbarrier, and the warp
# sums the stage in slot order, lanes over float4 columns, while the next
# row's copies land in the other stage.  Same arithmetic as the
# register path (products and sums rounded on their own, in slot order).
# Takes F % 4 == 0, h 16-byte aligned and K <= 32 only.
SPMM_BULK = r'''
namespace bulk {
using namespace repro_torch;
template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
spmm_bulk_kernel(const float* __restrict__ h, const int* __restrict__ nbr,
                 const float* __restrict__ mask, float* __restrict__ out,
                 int n, int f, int d, int k, int mean) {
  extern __shared__ __align__(128) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int stage = k * f;
  float* buf = smem + static_cast<size_t>(warp) * 2 * stage;
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(WARPS) * 2 * stage) + 2 * warp;
  if (lane == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    fence_mbar_init();
  }
  __syncthreads();
  const int stride = gridDim.x * WARPS, first = blockIdx.x * WARPS + warp;
  auto issue = [&](int row, int s) {          // the whole warp
    const int64_t src = lane < k ? gather_row(
        nbr[static_cast<int64_t>(row) * k + lane], n) : -1;
    const unsigned live = __ballot_sync(~0u, src >= 0);
    if (lane == 0) mbar_expect_tx(bar + s, __popc(live) * f * 4);
    if (src >= 0)
      bulk_copy(buf + s * stage + lane * f, h + src * f, f * 4, bar + s);
  };
  if (first < d) issue(first, 0);
  if (first + stride < d) issue(first + stride, 1);
  int i = 0;
  for (int row = first; row < d; row += stride, ++i) {
    const int s = i & 1;
    const int64_t base = static_cast<int64_t>(row) * k;
    const int idx = lane < k ? nbr[base + lane] : 0;
    const float m = lane < k ? mask[base + lane] : 0.f;
    float deg = 0.f;
    for (int j = 0; j < k; ++j) deg = __fadd_rn(deg, __shfl_sync(~0u, m, j));
    const float div = fmaxf(deg, 1.f);
    mbar_wait(bar + s, (i >> 1) & 1);
    const float* st = buf + s * stage;
    for (int c0 = 0; c0 < f; c0 += 128) {
      const int c = c0 + lane * 4;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < k; ++j) {
        const bool ok = gather_row(__shfl_sync(~0u, idx, j), n) >= 0;
        const float mj = __shfl_sync(~0u, m, j);
        const float4 v = ok && c < f ? load4(st + j * f + c)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
        a[0] = __fadd_rn(a[0], __fmul_rn(v.x, mj));
        a[1] = __fadd_rn(a[1], __fmul_rn(v.y, mj));
        a[2] = __fadd_rn(a[2], __fmul_rn(v.z, mj));
        a[3] = __fadd_rn(a[3], __fmul_rn(v.w, mj));
      }
      if (mean)
        for (int e = 0; e < 4; ++e) a[e] = __fdiv_rn(a[e], div);
      if (c < f)
        store4(out + static_cast<int64_t>(row) * f + c,
               make_float4(a[0], a[1], a[2], a[3]));
    }
    __syncwarp();
    if (row + 2 * stride < d) issue(row + 2 * stride, s);
  }
}

template <int WARPS>
int launch_bulk(const void* h, const void* nbr, const void* mask, void* out,
                int n, int f, int d, int k, int mean, cudaStream_t st) {
  if (f % 4 != 0 || k > 32 || reinterpret_cast<uintptr_t>(h) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = spmm_bulk_kernel<WARPS>;
  const size_t smem = sizeof(float) * WARPS * 2 * static_cast<size_t>(k) * f
                      + 16 * WARPS;
  int rc = allow_shared(kernel, smem);
  if (rc != 0) return rc;
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32,
                                                smem);
  const int want = (d + WARPS - 1) / WARPS;
  const int blocks = want < per_sm * sms ? want : per_sm * sms;
  kernel<<<blocks, WARPS * 32, smem, st>>>(
      static_cast<const float*>(h), static_cast<const int*>(nbr),
      static_cast<const float*>(mask), static_cast<float*>(out), n, f, d, k,
      mean);
  return launch_status();
}
}  // namespace bulk
'''
FP32_FLOP_PER_S = 67e12                    # H100 SXM data sheet
FLASH_TILES = {                             # BQ, TR, SPLIT at D = 128
    "32 rows, 4 a thread, 2 parts (the port's)": (32, 4, 2),
    "32 rows, 4 a thread, 1 part": (32, 4, 1),
    "32 rows, 2 a thread, 1 part": (32, 2, 1),
    "16 rows, 2 a thread, 1 part": (16, 2, 1),
}
# the bf16 tensor-core kernel: (B, Hq, Hkv, T, D) of gemma3-12b's causal
# prefill and llama3.2-3b's training step, and at each D the tiles to
# time, (BN keys a tile, NC consumer warpgroups of 64 rows, ST stages)
FLASH_BF16_SHAPES = {256: (4, 16, 8, 1536), 128: (4, 24, 8, 512)}
FLASH_BF16_TILES = {
    256: {"BN 64, 2 consumer warpgroups, 2 stages (the port's)": (64, 2, 2),
          "BN 64, 1 consumer warpgroup, 2 stages": (64, 1, 2),
          "BN 64, 1 consumer warpgroup, 3 stages": (64, 1, 3),
          "BN 32, 2 consumer warpgroups, 3 stages": (32, 2, 3),
          "BN 128, 1 consumer warpgroup, 1 stage": (128, 1, 1)},
    128: {"BN 128, 2 consumer warpgroups, 2 stages (the port's)": (128, 2, 2),
          "BN 128, 2 consumer warpgroups, 3 stages": (128, 2, 3),
          "BN 64, 2 consumer warpgroups, 2 stages": (64, 2, 2),
          "BN 64, 2 consumer warpgroups, 4 stages": (64, 2, 4),
          "BN 128, 1 consumer warpgroup, 2 stages": (128, 1, 2)},
}
BF16_FLOP_PER_S = 989e12                   # H100 SXM data sheet


def build(which: set) -> ctypes.CDLL:
    csrc = str(_build.CSRC)
    agg = [f'#include "{csrc}/agg_combine.cu"']
    for i, shape in enumerate(c for cs in AGG_CANDIDATES.values()
                              for c in cs):
        agg.append(
            f'extern "C" int tile_agg_{i}(const void* h, const void* nbr, '
            f'const void* mask, const void* w, const void* b, void* out, '
            f'int n, int f, int d, int k, int o, void* st) {{ return '
            f'launch<{",".join(map(str, shape))}>(h, nbr, mask, w, b, out, n, '
            f'f, d, k, o, 1, 1, static_cast<cudaStream_t>(st)); }}')
    sddmm = [f'#include "{csrc}/sddmm.cu"']
    for warps in SDDMM_WARPS:
        sddmm.append(
            f'extern "C" int tile_sddmm_{warps}(const void* h, const void* '
            f'nbr, const void* mask, void* out, int n, int f, int d, int k, '
            f'void* st) {{ return launch<{warps}>(h, nbr, mask, out, n, f, d, '
            f'k, static_cast<cudaStream_t>(st)); }}')
    spmm = [f'#include "{csrc}/spmm.cu"', SPMM_BULK]
    for width, slots, threads in SPMM_CANDIDATES:
        spmm.append(
            f'extern "C" int tile_spmm_{width}_{slots}_{threads}(const void* '
            f'h, const void* nbr, const void* mask, void* out, int n, int f, '
            f'int d, int k, int mean, void* st) {{ return launch<{width},'
            f'{slots},{threads}>(h, nbr, mask, out, n, f, d, k, mean, '
            f'static_cast<cudaStream_t>(st)); }}')
    for warps in SPMM_BULK_WARPS:
        spmm.append(
            f'extern "C" int tile_spmm_bulk_{warps}(const void* h, '
            f'const void* nbr, const void* mask, void* out, int n, int f, '
            f'int d, int k, int mean, void* st) {{ return '
            f'bulk::launch_bulk<{warps}>(h, nbr, mask, out, n, f, d, k, '
            f'mean, static_cast<cudaStream_t>(st)); }}')
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
            f'const Args a{{q, k, v, o, b, hq, hkv, t, s, causal, 0, scale, '
            f'{{st[0], st[1], st[2]}}, {{st[3], st[4], st[5]}}, '
            f'{{st[6], st[7], st[8]}}, {{st[9], st[10], st[11]}}, '
            f'static_cast<cudaStream_t>(stream)}}; return '
            f'launch_tile<128,{",".join(map(str, cfg))}>(a); }}')
    for d, tiles in FLASH_BF16_TILES.items():
        for i, cfg in enumerate(tiles.values()):
            flash.append(
                f'extern "C" int tile_flash_bf16_{d}_{i}(const void* q, '
                f'const void* k, const void* v, void* o, int b, int hq, '
                f'int hkv, int t, int s, int causal, float scale, '
                f'const int64_t* st, void* stream) {{ const Args a{{q, k, v, '
                f'o, b, hq, hkv, t, s, causal, 0, scale, {{st[0], st[1], '
                f'st[2]}}, {{st[3], st[4], st[5]}}, {{st[6], st[7], st[8]}}, '
                f'{{st[9], st[10], st[11]}}, static_cast<cudaStream_t>('
                f'stream)}}; return launch_wgmma<{d},'
                f'{",".join(map(str, cfg))}>(a); }}')
    os.makedirs(OUT, exist_ok=True)
    _build.write_generated(OUT)            # agg_combine.cu's tile table
    nvcc = _build._nvcc()
    cmds, objs = [], []
    units = (("gemm", lines), ("flash", flash), ("agg", agg),
             ("sddmm", sddmm), ("spmm", spmm))
    for name, text in ((f"tiles_{u}", t) for u, t in units if u in which):
        src = os.path.join(OUT, name + ".cu")
        with open(src, "w") as f:
            f.write("\n".join(text) + "\n")
        objs.append(os.path.join(OUT, name + ".o"))
        cmds.append([nvcc, *_build.NVCC_FLAGS, "-I", csrc, "-I", OUT, "-c",
                     src, "-o", objs[-1]])
    logs = _build._run_all(cmds)
    with open(os.path.join(OUT, "build.log"), "w") as f:
        f.write("\n".join(logs))
    lib = os.path.join(OUT, "libtiles.so")
    _build._run_all([[nvcc, "-shared", *objs, "-o", lib]])
    return ctypes.CDLL(lib)


def device_ms(fn, reps: int = 30) -> float:
    """Mean device time of one call (torch.profiler), after a warm-up."""
    return sum(device_ms_by_kernel(fn, reps).values())


def device_ms_by_kernel(fn, reps: int = 30) -> dict[str, float]:
    """Mean device time of one call by kernel name (torch.profiler).  The
    profiler now and then records no device time for a run; every ``fn``
    here launches work on the card, so such a run is taken again (up to
    three times)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {e.key: e.self_device_time_total / 1e3 / reps
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA}
        if sum(by.values()) > 0:
            break
    return by


def sweep_decode(card: str) -> None:
    """decode_attention by pages a split (the C entry's argument), cold and
    warm, at the decode step of llama3.2-3b."""
    from repro_torch.kernels.decode_attention import pages_per_split
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, hq, hkv, d, ps, n = 4, 24, 8, 128, 16, 516
    pp = -(-n // ps)
    shape = (DECODE_LAYERS, b * pp + 2, ps, hkv, d)
    kb = torch.randn(shape, device="cuda", generator=gen)
    vb = torch.randn(shape, device="cuda", generator=gen)
    perm = torch.randperm(b * pp + 2, device="cuda", generator=gen)
    pt = perm[: b * pp].view(b, pp).to(torch.int32)
    lengths = torch.full((b,), n, dtype=torch.int32, device="cuda")
    q = torch.randn(b, hq, d, device="cuda", generator=gen)
    out = torch.empty_like(q)
    bound = (2 * b * n * hkv * d + 2 * q.numel() + pt.numel() + b) * 4 \
        / HBM_BYTES_PER_S * 1e3

    def timed(fn):
        """(cold ms, warm ms, {kernel: cold ms}) a launch."""
        by = device_ms_by_kernel(
            lambda: [fn(li) for li in range(DECODE_LAYERS)],
            reps=DECODE_ROUNDS)
        by = {("split" if "split" in k else "combine" if "combine" in k
               else k): v / DECODE_LAYERS for k, v in by.items()}
        return sum(by.values()), device_ms(lambda: fn(0)), by

    want = ref.decode_attention_ref(q, kb[0], vb[0], pt, lengths)
    for pps in DECODE_PAGES_PER_SPLIT:
        ws = torch.empty(b * hq * -(-pp // pps) * (d + 2), device="cuda")

        def kernel(li):
            return lib.repro_decode_attention_f32(
                q.data_ptr(), kb[li].data_ptr(), vb[li].data_ptr(),
                pt.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                ws.data_ptr(), b, hkv, hq // hkv, d, b * pp + 2, ps, pp, pps,
                d ** -0.5, stream)
        assert kernel(0) == 0
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=3e-5, atol=3e-5)
        cold, warm, by = timed(kernel)
        mark = " (the port's)" if pps == pages_per_split(ps, d) else ""
        print(f"decode_attention {pps} pages a split{mark}: cold "
              f"{cold:.5f} ms a launch (split {by.get('split', 0):.5f}, "
              f"combine {by.get('combine', 0):.5f}), warm {warm:.5f}, bound "
              f"{bound:.5f} ({100 * bound / cold:.1f} % cold)  [{card}]")
    cold, warm, _ = timed(lambda li: ref.decode_attention_ref(
        q, kb[li], vb[li], pt, lengths))
    print(f"decode_attention plain: cold {cold:.5f} ms a launch, warm "
          f"{warm:.5f}  [{card}]")


def events_ms(calls, launches: int = PARTIAL_LAUNCHES) -> float:
    """Device ms a launch of ``launches`` calls taken in turn from
    ``calls``, on CUDA events, issued behind a spin long enough to cover
    the host's issue, so the launches reach the card back to back."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(launches * 100 * SPIN_CYCLES_PER_US)
    start.record()
    for i in range(launches):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def sweep_partial(card: str) -> None:
    """decode_attention_partial by positions a split and path, at the
    split serving step's blocks."""
    from repro_torch.kernels.decode_attention import (CLUSTER_SPLITS,
                                                      partial_pages_per_split)
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    one = torch.zeros(1, device="cuda")
    print(f"decode_attention_partial: a one-element fill, the floor of a "
          f"launch back to back, {events_ms([lambda: one.fill_(1.0)]):.5f} "
          f"ms  [{card}]")
    for label, b, hq, hkv, d, ps, n in PARTIAL_SHAPES:
        pp = n // ps
        copies = max(2, -(-8 * L2_BYTES // (4 * b * n * hkv * d)))
        copies = min(copies, DECODE_LAYERS)
        pools = [tuple(torch.randn(b * pp, ps, hkv, d, device="cuda",
                                   generator=gen).to(bf16) for _ in range(2))
                 for _ in range(copies)]
        pt = torch.arange(b * pp, device="cuda",
                          dtype=torch.int32).view(b, pp)
        lengths = torch.full((b,), n, dtype=torch.int32, device="cuda")
        q = torch.randn(b, hq, d, device="cuda", generator=gen).to(bf16)
        out = torch.empty(b, hq, d, device="cuda")
        lse = torch.empty(b, hq, device="cuda")
        bound = ((2 * b * n * hkv * d + q.numel()) * 2
                 + (q.numel() + b * hq + pt.numel() + b) * 4) \
            / HBM_BYTES_PER_S * 1e3
        want = ref.decode_attention_partial_ref(q, *pools[0], pt, lengths)
        port = partial_pages_per_split(ps, d, 2) * ps
        for pps in sorted({max(1, sl // ps) for sl in PARTIAL_SPLITS}):
            n_split = -(-pp // pps)
            for cluster in (1, 0):
                if cluster and n_split > 16:
                    continue
                ws = torch.empty(b * hq * n_split * (d + 2), device="cuda")

                def kernel(kp, vp, pps=pps, cluster=cluster, ws=ws):
                    return lib.repro_decode_attention_partial_bf16(
                        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                        pt.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                        lse.data_ptr(), ws.data_ptr(), b, hkv, hq // hkv, d,
                        b * pp, ps, pp, pps, cluster, d ** -0.5, stream)
                assert kernel(*pools[0]) == 0
                torch.cuda.synchronize()
                torch.testing.assert_close(out, want[0], rtol=3e-5,
                                           atol=3e-5)
                torch.testing.assert_close(lse, want[1], rtol=3e-5,
                                           atol=3e-5)
                calls = [lambda p=p: kernel(*p) for p in pools]
                ms = events_ms(calls)
                port_path = cluster == (n_split <= CLUSTER_SPLITS)
                mark = ""
                if pps * ps == port and port_path:
                    by = device_ms_by_kernel(lambda: [c() for c in calls], 3)
                    mark = (f" (the port's; kernels' own time a launch "
                            f"{sum(by.values()) / len(calls):.5f} under "
                            f"torch.profiler)")
                path = (f"one launch, clusters of {n_split}" if cluster
                        else "split + combine")
                print(f"decode_attention_partial {label} (B {b}, {hq}/{hkv}"
                      f" heads, D {d}, {n} positions): {pps * ps} positions"
                      f" a split, {path}{mark}: {ms:.5f} ms a launch, bound "
                      f"{bound:.5f} ({100 * bound / ms:.1f} %)  [{card}]")
        rep = hq // hkv
        sdpa = []
        for kp, vp in pools:
            k, v = (p.view(b, -1, hkv, d).permute(0, 2, 1, 3)
                    .repeat_interleave(rep, 1) for p in (kp, vp))
            mask = (torch.arange(n, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            sdpa.append(lambda k=k, v=v, mask=mask:
                        torch.nn.functional.scaled_dot_product_attention(
                            q[:, :, None, :], k, v, attn_mask=mask))
        print(f"decode_attention_partial {label}: SDPA with a length mask "
              f"{events_ms(sdpa):.5f} ms a launch  [{card}]")


def sweep_rmsnorm(card: str) -> None:
    """rmsnorm by threads a row at the LM's prefill and decode rows."""
    from repro_torch.kernels.rmsnorm import threads_per_row
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    f = 3072
    w = torch.randn(f, device="cuda", generator=gen)
    for dtype, entry in ((torch.float32, lib.repro_rmsnorm_f32),
                         (torch.bfloat16, lib.repro_rmsnorm_bf16)):
        name = str(dtype).replace("torch.", "")
        for rows in (500, 4):
            x = torch.randn(rows, f, device="cuda", generator=gen).to(dtype)
            out = torch.empty_like(x)
            want = ref.rmsnorm_ref(x, w)
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            bound = (2 * x.numel() * x.element_size() + f * 4) \
                / HBM_BYTES_PER_S * 1e3
            for tpr in RMSNORM_THREADS:
                call = lambda: entry(  # noqa: E731
                    x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, f,
                    1e-6, tpr, stream)
                assert call() == 0
                torch.cuda.synchronize()
                torch.testing.assert_close(out.float(), want.float(),
                                           rtol=tol, atol=tol)
                ms = device_ms(call)
                mark = (" (the port's)" if tpr == threads_per_row(f, rows)
                        else "")
                print(f"rmsnorm ({rows}x{f}) {name} {tpr} threads a row"
                      f"{mark}: {ms:.5f} ms a launch, bound {bound:.5f} "
                      f"({100 * bound / ms:.1f} %)  [{card}]")
            wd = w.to(dtype)
            ms = device_ms(lambda: torch.nn.functional.rms_norm(
                x, (f,), wd, 1e-6))
            print(f"rmsnorm ({rows}x{f}) {name} F.rms_norm: {ms:.5f} ms a "
                  f"launch  [{card}]")


def gnn_inputs(gen, n, f, d, k):
    """h, and nbr and mask laid out as the sampler pads them: about a
    third of the slots masked, a masked slot pointing at row 0."""
    h = torch.randn(n, f, device="cuda", generator=gen)
    nbr = torch.randint(0, n, (d, k), device="cuda", generator=gen,
                        dtype=torch.int32)
    mask = (torch.rand(d, k, device="cuda", generator=gen) < 0.7).float()
    return h, torch.where(mask > 0, nbr, 0), mask


def gnn_bytes(h, nbr, mask, prefix: int = 0) -> int:
    """Bytes of the distinct h rows the unmasked slots (and a destination
    prefix) need, plus nbr and mask: each read once."""
    rows = nbr[mask != 0].long()
    if prefix:
        rows = torch.cat([rows, torch.arange(prefix, device="cuda")])
    return (int(torch.unique(rows).numel()) * h.shape[1] + 2 * nbr.numel()) \
        * 4


def sweep_agg(card: str, lib: ctypes.CDLL) -> None:
    """agg_combine by tile shape at the main path's layers, from the
    scratch build."""
    from repro_torch.kernels.agg_combine import (TILES, agg_tile, smem_bytes,
                                                 threads)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    entry = 0
    for n, f, d, k, o in GNN_LAYERS:
        h, nbr, mask = gnn_inputs(gen, n, f, d, k)
        w = torch.randn(f, o, device="cuda", generator=gen) * 0.1
        b = torch.randn(o, device="cuda", generator=gen) * 0.1
        out = torch.empty(d, o, device="cuda")
        want = ref.agg_combine_ref(h, nbr, mask, w, b)
        t_bytes = (gnn_bytes(h, nbr, mask) + (f * o + o + d * o) * 4) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * (int((mask != 0).sum()) * f + d * f * o) \
            / FP32_FLOP_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        shape = f"N {n}, F {f}, D {d}, K {k}, O {o}"
        for tile in AGG_CANDIDATES[o > 64]:
            fn = getattr(lib, f"tile_agg_{entry}")
            entry += 1
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
                [ctypes.c_void_p]
            call = lambda: fn(  # noqa: E731
                h.data_ptr(), nbr.data_ptr(), mask.data_ptr(), w.data_ptr(),
                b.data_ptr(), out.data_ptr(), n, f, d, k, o, stream)
            assert call() == 0
            torch.cuda.synchronize()
            torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
            ms = device_ms(call)
            rows, cols, tm, bk, stages, warps = tile
            mark = " (the port's)" if tile == TILES[agg_tile(f, o)] else ""
            print(f"agg_combine ({shape}) {rows}x{cols} tile, {tm}x4 a "
                  f"thread, {stages} stages of {bk}, {warps} producer warps, "
                  f"{threads(tile)} threads, {-(-d // rows)} blocks, "
                  f"{smem_bytes(tile, f)} B shared{mark}: {ms:.5f} "
                  f"ms a launch, bound {bound:.5f} ({100 * bound / ms:.1f} "
                  f"%)  [{card}]")
        ms = device_ms(lambda: kernels.gemm(kernels.spmm(h, nbr, mask), w))
        print(f"agg_combine ({shape}) unfused spmm + gemm: {ms:.5f} ms  "
              f"[{card}]")


def sweep_sddmm(card: str, lib: ctypes.CDLL) -> None:
    """sddmm by warps (destination rows) a block at the main path's
    layers, from the scratch build."""
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, f, d, k, _ in GNN_LAYERS:
        h, nbr, mask = gnn_inputs(gen, n, f, d, k)
        out = torch.empty(d, k, f, device="cuda")
        want = ref.sddmm_ref(h, nbr, mask)
        bound = (gnn_bytes(h, nbr, mask, prefix=d) + out.numel() * 4) \
            / HBM_BYTES_PER_S * 1e3
        shape = f"N {n}, F {f}, D {d}, K {k}"
        for warps in SDDMM_WARPS:
            fn = getattr(lib, f"tile_sddmm_{warps}")
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
                [ctypes.c_void_p]
            call = lambda: fn(  # noqa: E731
                h.data_ptr(), nbr.data_ptr(), mask.data_ptr(), out.data_ptr(),
                n, f, d, k, stream)
            assert call() == 0
            torch.cuda.synchronize()
            assert torch.equal(out, want)
            ms = device_ms(call)
            mark = " (the port's)" if warps == SDDMM_WARPS[0] else ""
            print(f"sddmm ({shape}) {warps} warps a block, a warp a row"
                  f"{mark}: {ms:.5f} ms a launch, bound {bound:.5f} "
                  f"({100 * bound / ms:.1f} %)  [{card}]")


def sweep_spmm(card: str, lib: ctypes.CDLL) -> None:
    """spmm's register path by (floats a thread, SLOTS, threads a block)
    and its bulk-copy path by warps a block, at the main path's layers,
    from the scratch build: mean mode warm, and cold with each launch on
    another copy of h; every variant held bit for bit in both modes."""
    from repro_torch.kernels.spmm import spmm_width
    with open(os.path.join(OUT, "build.log")) as log:
        entry = ""
        for line in log:
            if "Compiling entry function" in line:
                m = re.search(r"\d+(spmm[a-z_]*_kernel)I(.*?)EEv", line)
                args = m and re.sub(r"Li(\d+)E", r"\1,", m[2]).strip(",")
                entry = m and f"{m[1]}<{args}>"
            elif entry and ("registers" in line or "spill" in line):
                print(f"  {entry}: {line.strip()}")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    variants = [(f"tile_spmm_{w}_{s}_{t}", (w, s, t),
                 f"{w} floats a thread, {s} slots in flight, {t} threads a "
                 "block") for w, s, t in SPMM_CANDIDATES]
    variants += [(f"tile_spmm_bulk_{w}", None, f"bulk copies, {w} warps (rows"
                  " in flight x 2) a block") for w in SPMM_BULK_WARPS]
    for n, f, d, k, _ in GNN_LAYERS:
        h, nbr, mask = gnn_inputs(gen, n, f, d, k)
        copies = [h.clone() for _ in range(
            max(2, -(-2 * L2_BYTES // (h.numel() * 4))))]
        out = torch.empty(d, f, device="cuda")
        want = {m: ref.spmm_ref(h, nbr, mask, mode="mean" if m else "sum")
                for m in (0, 1)}
        bound = (gnn_bytes(h, nbr, mask) + out.numel() * 4) \
            / HBM_BYTES_PER_S * 1e3
        shape = f"N {n}, F {f}, D {d}, K {k}"
        port = (spmm_width(f, d), *SPMM_PORT)
        for name, tile, what in variants:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
                [ctypes.c_void_p]
            call = lambda x, m=1: fn(  # noqa: E731
                x.data_ptr(), nbr.data_ptr(), mask.data_ptr(), out.data_ptr(),
                n, f, d, k, m, stream)
            for m in (0, 1):
                assert call(h, m) == 0
                torch.cuda.synchronize()
                assert torch.equal(out, want[m]), (name, m)
            warm = device_ms(lambda: call(h))
            cold = device_ms(lambda: [call(c) for c in copies],
                             reps=3) / len(copies)
            mark = " (the port's)" if tile == port else ""
            print(f"spmm ({shape}) {what}{mark}: warm {warm:.5f} ms a "
                  f"launch, cold {cold:.5f}, bound {bound:.5f} "
                  f"({100 * bound / warm:.1f} % warm, {100 * bound / cold:.1f}"
                  f" % cold)  [{card}]")
        per_slot = mask / torch.clamp(mask.sum(1), min=1.0)[:, None]
        idx = nbr.long()
        ms = device_ms(lambda: torch.nn.functional.embedding_bag(
            idx, h, per_sample_weights=per_slot, mode="sum"))
        print(f"spmm ({shape}) embedding_bag (mean): {ms:.5f} ms a launch "
              f"warm  [{card}]")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_tiles: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    which = set(argv) or {"gemm", "flash", "decode", "rmsnorm", "agg",
                          "sddmm", "spmm"}
    if "decode" in which:
        sweep_partial(card)
        sweep_decode(card)
    if "rmsnorm" in which:
        sweep_rmsnorm(card)
    if which & {"gemm", "flash", "agg", "sddmm", "spmm"}:
        lib = build(which)
        if "spmm" in which:
            sweep_spmm(card, lib)
        if "sddmm" in which:
            sweep_sddmm(card, lib)
        if "agg" in which:
            sweep_agg(card, lib)
        if which & {"gemm", "flash"}:
            sweep_gemm_flash(card, which, lib)
    return 0


def sweep_gemm_flash(card: str, which: set, lib: ctypes.CDLL) -> None:
    """gemm and flash_attention by tile shape, from the scratch build."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    ins = [(torch.randn(m, k, device="cuda", generator=gen),
            torch.randn(k, n, device="cuda", generator=gen) * 0.1)
           for m, k, n, _ in GEMM_SHAPES]
    rows = list(GEMM_TILES.items()) + [("torch.matmul", None)]
    for i, (name, _) in enumerate(rows if "gemm" in which else []):
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
    for i, name in enumerate(rows if "flash" in which else []):
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
    if "flash" in which:
        sweep_flash_bf16(card, lib)


def sweep_flash_bf16(card: str, lib: ctypes.CDLL) -> None:
    """The bf16 tensor-core flash kernel by tile (keys a tile, consumer
    warpgroups, stages) at gemma3-12b's causal prefill (D 256) and
    llama3.2-3b's training shape (D 128), model layout, each held to the
    plain version at 2e-2, beside SDPA on repeated KV heads and the
    operations bound."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d, (b, hq, hkv, t) in FLASH_BF16_SHAPES.items():
        q, k, v = (torch.randn(b, t, h, d, device="cuda", generator=gen,
                               dtype=torch.bfloat16).permute(0, 2, 1, 3)
                   for h in (hq, hkv, hkv))
        want = ref.attention_ref(q, k, v)
        kr, vr = k.repeat_interleave(hq // hkv, 1), \
            v.repeat_interleave(hq // hkv, 1)
        bound = 4.0 * b * hq * t * (t + 1) / 2 * d / BF16_FLOP_PER_S * 1e3
        rows = list(FLASH_BF16_TILES[d]) + ["scaled_dot_product_attention"]
        for i, name in enumerate(rows):
            out = torch.empty_like(q)
            if name == "scaled_dot_product_attention":
                call = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731,E501
                    q, kr, vr, is_causal=True)
            else:
                fn = getattr(lib, f"tile_flash_bf16_{d}_{i}")
                fn.argtypes = [P, P, P, P, I, I, I, I, I, I, F, P, P]
                fn.restype = I
                st = torch.tensor([x for a in (q, k, v, out)
                                   for x in a.stride()[:3]], dtype=torch.int64)
                call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),  # noqa: E731,E501
                                  out.data_ptr(), b, hq, hkv, t, t, 1,
                                  d ** -0.5, st.data_ptr(), stream)
                assert call() == 0
                torch.cuda.synchronize()
                torch.testing.assert_close(out.float(), want.float(),
                                           rtol=2e-2, atol=2e-2)
            ms = device_ms(call)
            print(f"flash bf16 D {d} ({b} x {hq} over {hkv} x {t}, causal) "
                  f"{name}: {ms:.5f} ms a launch, bound {bound:.5f} "
                  f"({100 * bound / ms:.1f} %)  [{card}]")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
