// Causal, full or sliding-window attention with an online softmax, for
// sm_90a, on fp32 or bf16 q/k/v (the output in q's type):
// o[b,h,i,:] = softmax_j(q[b,h,i,:] . k[b,h/G,j,:] / sqrt(D)) @ v[b,h/G,:,:],
// with key j visible to query i when j < S, (not causal or j <= i) and
// (window <= 0 or i - j < window).
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel.  The TPU grid
// walked key tiles in order and carried (m, l, acc) in VMEM scratch from
// one grid step to the next; blocks have no order, so one block owns one
// (batch*head, query tile) and loops over the key tiles itself, up to
// the diagonal when causal, with the running state in registers.  GQA is
// by index (head h reads KV head h / G, G need not be a power of two):
// no repeated copy of K and V.  Ragged tails are masked, never padded.
// Two kernels, one for each type:
//
// fp32 (flash_kernel, below): FMA arithmetic.  Bound at prefill shapes:
// operations (4*T*S*D/2 flops per head against 67 TFLOP/s of fp32 FMA; no
// TF32, since the reference holds attention to 3e-5).  In practice the
// limit is the SM's shared-memory port, 128 bytes a clock: a warp's
// 16-byte shared load costs it 4 clocks whether or not lanes share
// addresses, against one clock for a warp's FMA on each of the 4
// schedulers.  What the design does about both:
//
//  * The critical path.  A launch lasts as long as its slowest SM, so
//    query tiles are 32 rows (T = 500 over 24 heads: 384 blocks, the
//    heaviest 32 x 500 keys) and, when causal, the grid's slow axis walks
//    the tiles from the last (heaviest) to the first, so the heaviest
//    blocks start first and the light ones fill in behind.  A block is
//    two parts of 4 warps that take alternate key tiles, each with its
//    own buffers, barrier and (m, l, acc), combined once at the end: the
//    heaviest tile takes half as long as one 4-warp block would, which
//    would otherwise share its SM for its whole life and end last.
//  * QK^T without re-reads (see Flash below): each lane keeps a 1/16
//    slice of its rows' q in registers and reads only the K values it
//    multiplies; a butterfly of shuffles sums the 16 slices.  Per 16 keys
//    and 4 rows: 32 shared loads and 60 shuffles for 512 FMAs, where
//    16-byte fragments of q and K cost 80 loads.
//  * PV register-tiled: 4 rows x 8 dims a thread (D = 128), P and V read
//    as 16-byte fragments: 12 loads for 128 FMAs.  A row's probabilities
//    are written and read by the same 16 lanes: a __syncwarp, no block
//    barrier.  Row max: shuffles over those lanes; row sum: each lane's
//    share, added once at the end.
//  * Loads overlap compute: each part double-buffers its K/V tiles of 32
//    keys, fed by cp.async along the contiguous head dim, one barrier of
//    its own a tile; whole tiles of 16-byte aligned rows take an
//    unchecked 16-byte copy, the ragged tail and unaligned rows a checked
//    one (load_tile).  Shared memory per part: 4*(4*32*(D+4) + BQ*36)
//    bytes, 144 KB a block at D = 128 (one an SM, 8 warps); at D = 256 a
//    block is one part of 16 query rows (135 KB), so its registers and
//    buffers fit.
//  * A window: key tiles wholly below the window of the block's first
//    query row are skipped, as tiles past the diagonal are when causal,
//    so a block walks about window / 32 tiles whatever its position.
//
// Every product is an fp32 FMA, in an order fixed by D and the key index,
// and expf is the precise one.
//
// bf16 (flash_wgmma_kernel, further down): Hopper's tensor cores.  See
// the notes above it.
//
// q, k, v and o are addressed through (batch, head, seq) strides with the
// head dim contiguous, so the model's (B, T, H, D) activations are read
// and written in place; the arithmetic does not depend on the strides.
#include "common.cuh"

#include <cuda.h>      // CUtensorMap and its enums (types only)
#include <dlfcn.h>

#include <cstring>
#include <type_traits>

namespace {

using repro_torch::kNegInf;
using repro_torch::load4;
using repro_torch::load_f32;

struct Strides {
  int64_t b, h, t;
};

constexpr int kTX = 16;         // lanes of a row group (half a warp)
constexpr int kBK = 32;         // keys a tile: two groups of kTX

// A block owns BQ query rows; each of its SPLIT parts has (BQ / TR) row
// groups of kTX lanes, lane tx of group ty owning rows ty + (BQ/TR) i (TR
// of them), and takes every SPLIT-th key tile.
//  * QK^T: lane tx keeps d-slice [tx D/16, (tx+1) D/16) of its rows' q in
//    registers.  For each group of 16 keys it forms 16 partial dots over
//    its slice, the one for key k in slot k ^ tx, and a 4-step butterfly
//    over the 16 lanes (add slot s + w of lane tx ^ w into slot s, w = 8,
//    4, 2, 1) leaves lane tx the whole score of key tx in slot 0.  Every
//    K value a lane reads is one it uses: no lane re-reads what its
//    neighbours read, and q never goes through shared memory.
//  * PV: lane tx owns output dims 4 (tx + 16 g) .. + 3 and reads P (the
//    row's probabilities, via shared memory) and V as 16-byte fragments.
// K, V and P tiles are fp32; a part's buffers take kPartBytes.
template <int D, int BQ, int TR, int SPLIT>
struct Flash {
  static constexpr int kTY = BQ / TR;
  static constexpr int kPartThreads = kTY * kTX;      // one part's threads
  static constexpr int kThreads = SPLIT * kPartThreads;
  static constexpr int kSlice = D / kTX;              // q/k elements a lane
  static constexpr int kVec = 4;                      // elements a cp.async
  static constexpr int kPad = 4;
  static constexpr int kLd = D + kPad, kLdP = kBK + 4;   // padded rows
  static constexpr int kGroups = D / 4;               // 4-element groups
  static constexpr int kGpt = (kGroups + kTX - 1) / kTX;
  static constexpr size_t kPartBytes =      // a part's K, V x 2 and P
      sizeof(float) * 4 * kBK * kLd + sizeof(float) * BQ * kLdP;
  // what a part-1 thread hands to its part-0 twin (acc, m, l), written
  // over part 1's buffers, which grow to hold it where they are smaller
  static constexpr int kXch = TR * (kGpt * 4 + 2);
  static constexpr size_t kXchBytes = sizeof(float) * kXch * kPartThreads;
  static constexpr size_t kSmem =
      kPartBytes + (SPLIT == 1 ? 0
                    : kXchBytes > kPartBytes ? kXchBytes : kPartBytes);
};

// N consecutive elements of shared memory as fp32, 16, 8 or 4 bytes a load
template <int N>
__device__ __forceinline__ void load_slice(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = load4(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}
template <int D, int BQ, int TR, int SPLIT>
__global__ void __launch_bounds__((Flash<D, BQ, TR, SPLIT>::kThreads))
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int hq,
             int group, int t, int s, int causal, int window, float scale,
             Strides qs_, Strides ks_, Strides vs_, Strides os_) {
  using F = Flash<D, BQ, TR, SPLIT>;
  constexpr int kLd = F::kLd, kLdP = F::kLdP, kTY = F::kTY;
  constexpr int kSlice = F::kSlice, kGroups = F::kGroups, kGpt = F::kGpt;
  constexpr int kCols = kBK / kTX;
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq, kvh = h / group;
  // causal: the last query tile walks the most keys, so it goes first
  // (harmless with a window, where the tiles past it walk about as many)
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  // part p of the block takes key tiles p, p + SPLIT, ...: its own rows'
  // (m, l, acc) over its share of the keys, combined at the end.  A part
  // loads its own tiles and syncs on its own barrier, so the parts run as
  // freely as two blocks would.
  const int tid = threadIdx.x, part = tid / F::kPartThreads;
  const int ptid = tid % F::kPartThreads;
  const int tx = tid % kTX, ty = ptid / kTX;
  // [2][kBK][kLd] each
  float* ks = reinterpret_cast<float*>(smem + part * F::kPartBytes);
  float* vs = ks + 2 * kBK * kLd;
  float* ps = reinterpret_cast<float*>(vs + 2 * kBK * kLd);  // [BQ][kLdP]
  auto part_sync = [&]() {
    if constexpr (SPLIT == 1) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;" :: "r"(1 + part),
                   "n"(F::kPartThreads) : "memory");
    }
  };
  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* kb = k + b * ks_.b + kvh * ks_.h;
  const float* vb = v + b * vs_.b + kvh * vs_.h;

  // causal: no key after the tile's last query row is visible; a window:
  // none before the first row's window
  const int kend = causal ? min(s, min(q0 + BQ, t)) : s;
  const int tiles = (kend + kBK - 1) / kBK;
  const int tile0 = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  // whole tiles of aligned rows take the unchecked copy (uniform)
  const bool k_full = repro_torch::rows_aligned<float, F::kVec>(kb, ks_.t);
  const bool v_full = repro_torch::rows_aligned<float, F::kVec>(vb, vs_.t);
  auto load_rows = [&](float* dst, const float* src, int64_t ld, int rows,
                       bool aligned) {
    if (aligned && rows >= kBK) {
      repro_torch::load_tile_full<float, kBK, D, kLd, F::kPartThreads,
                                  F::kVec>(dst, src, ld, ptid);
    } else {
      repro_torch::load_tile<float, kBK, D, kLd, F::kPartThreads, F::kVec>(
          dst, src, ld, rows, D, ptid);
    }
  };
  auto first_key = [&](int n) { return (tile0 + n * SPLIT + part) * kBK; };
  auto load_kv = [&](int n) {       // the part's n-th tile, into buffer n&1
    const int k0 = first_key(n);
    load_rows(ks + (n & 1) * kBK * kLd, kb + k0 * ks_.t, ks_.t, s - k0,
              k_full);
    load_rows(vs + (n & 1) * kBK * kLd, vb + k0 * vs_.t, vs_.t, s - k0,
              v_full);
  };
  const int span = tiles - tile0;
  const int mine = span > part ? (span - part + SPLIT - 1) / SPLIT : 0;
  if (mine > 0) load_kv(0);
  repro_torch::cp_async_commit();

  // this lane's slice of its rows' q, zero past the last query
  float qr[TR][kSlice];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ty + kTY * i;
#pragma unroll
    for (int d = 0; d < kSlice; ++d)
      qr[i][d] = r < t ? load_f32(qb[r * qs_.t + tx * kSlice + d]) : 0.f;
  }

  float m[TR], l[TR], acc[TR][kGpt * 4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kGpt * 4; ++e) acc[i][e] = 0.f;
  }

  for (int n = 0; n < mine; ++n) {
    repro_torch::cp_async_wait<0>();   // K and V of tile n have landed
    part_sync();                       // ... and tile n-1 is done with
    if (n + 1 < mine) load_kv(n + 1);
    repro_torch::cp_async_commit();
    const int k0 = first_key(n);
    const float* kt = ks + (n & 1) * kBK * kLd;
    const float* vt = vs + (n & 1) * kBK * kLd;

    float sc[TR][kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float dots[TR][kTX];
#pragma unroll
      for (int slot = 0; slot < kTX; ++slot) {
        float kf[kSlice];
        load_slice(kt + (kTX * c + (slot ^ tx)) * kLd + tx * kSlice, kf);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < kSlice; ++d) dot = fmaf(qr[i][d], kf[d], dot);
          dots[i][slot] = dot;
        }
      }
#pragma unroll
      for (int step = 1; step < kTX; step *= 2) {
        const int w = kTX / 2 / step;      // 8, 4, 2, 1
#pragma unroll
        for (int slot = 0; slot < w; ++slot)
#pragma unroll
          for (int i = 0; i < TR; ++i)
            dots[i][slot] += __shfl_xor_sync(0xffffffffu, dots[i][slot + w], w);
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) sc[i][c] = dots[i][0];
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = ty + kTY * i;
      // the keys the row may see, from its position (not held in
      // registers across the loop: at D = 128 they would spill)
      const int r = q0 + row;
      const int hi = causal ? min(s - 1, r) : s - 1;
      const int lo = window > 0 ? r - window + 1 : 0;
      bool vis[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = k0 + tx + kTX * c;
        vis[c] = j <= hi && j >= lo;
        sc[i][c] = vis[c] ? sc[i][c] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][c]);
      }
      const float m_new = fmaxf(m[i], repro_torch::warp_max(mx, kTX));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = vis[c] ? expf(sc[i][c] - m_new) : 0.f;
        ps[row * kLdP + tx + kTX * c] = p;
        sum += p;
      }
      // m is the same on the row's lanes, so each lane keeps its own
      // share of the row sum and they are added once, at the end
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kGpt * 4; ++e) acc[i][e] *= alpha;
    }
    __syncwarp();            // a row's probabilities: its own 16 lanes

#pragma unroll
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = load4(ps + (ty + kTY * i) * kLdP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < kGpt; ++g) {
          if (kGroups % kTX != 0 && tx + kTX * g >= kGroups) continue;
          const float4 vv = load4(vt + (c + cc) * kLd + 4 * (tx + kTX * g));
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                          : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * g] = fmaf(p, vv.x, acc[i][4 * g]);
            acc[i][4 * g + 1] = fmaf(p, vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, vv.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }
  repro_torch::cp_async_wait<0>();

  if constexpr (SPLIT == 2) {
    // part 1 hands its state to part 0 through its own buffers
    __syncthreads();
    float* xch = reinterpret_cast<float*>(smem + F::kPartBytes) +
                 ptid * F::kXch;
    if (part == 1) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int e = 0; e < kGpt * 4; ++e) xch[i * kGpt * 4 + e] = acc[i][e];
        xch[TR * kGpt * 4 + 2 * i] = m[i];
        xch[TR * kGpt * 4 + 2 * i + 1] = l[i];
      }
    }
    __syncthreads();
    if (part == 1) return;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float m1 = xch[TR * kGpt * 4 + 2 * i];
      const float m_new = fmaxf(m[i], m1);
      const float a0 = expf(m[i] - m_new), a1 = expf(m1 - m_new);
      l[i] = a0 * l[i] + a1 * xch[TR * kGpt * 4 + 2 * i + 1];
#pragma unroll
      for (int e = 0; e < kGpt * 4; ++e)
        acc[i][e] = a0 * acc[i][e] + a1 * xch[i * kGpt * 4 + e];
    }
  }

  float* ob = o + b * os_.b + h * os_.h;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    // every lane adds its row's shares, before any lane leaves the loop
    const float denom = fmaxf(repro_torch::warp_sum(l[i], kTX), 1e-30f);
    const int r = q0 + ty + kTY * i;
    if (r >= t) continue;
#pragma unroll
    for (int g = 0; g < kGpt; ++g) {
      if (kGroups % kTX != 0 && tx + kTX * g >= kGroups) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        repro_torch::store_as(ob + r * os_.t + 4 * (tx + kTX * g) + e,
                              acc[i][4 * g + e] / denom);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int b, hq, hkv, t, s, causal, window;
  float scale;
  Strides qs, ks, vs, os;
  cudaStream_t stream;
};

template <int D, int BQ, int TR, int SPLIT>
int launch_tile(const Args& a) {
  using F = Flash<D, BQ, TR, SPLIT>;
  auto kernel = flash_kernel<D, BQ, TR, SPLIT>;
  const int rc = repro_torch::allow_shared(kernel, F::kSmem);
  if (rc != 0) return rc;
  const dim3 grid(a.b * a.hq, (a.t + BQ - 1) / BQ);
  kernel<<<grid, F::kThreads, F::kSmem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.hq,
      a.hq / a.hkv, a.t, a.s, a.causal, a.window, a.scale, a.qs, a.ks, a.vs,
      a.os);
  return repro_torch::launch_status();
}

// 32 query rows a block, 4 a thread, in two parts that split the keys; at
// D = 256, 16 rows, 2 a thread, one part, so the q slice, the partial dots
// and the output stay in registers and the buffers in shared memory.
template <int D>
int launch(const Args& a) {
  if constexpr (D > 128) {
    return launch_tile<D, 16, 2, 1>(a);
  } else {
    return launch_tile<D, 32, 4, 2>(a);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor cores.  Bound at prefill shapes: operations, 4*T*S*D/2
// flops per head over the visible pairs against 989 TFLOP/s of bf16
// tensor-core products, which only wgmma reaches.  The design:
//
//  * Products.  A block owns 64 * NC query rows: NC consumer warpgroups of
//    64 rows each, and one producer warpgroup.  S = Q K^T is
//    wgmma.m64nBNk16 with Q (64 x D, the warpgroup's own) and the K tile
//    (BN x D) both read from shared memory through descriptors, D / 16
//    products a tile.  The online softmax runs on S's accumulator
//    fragments in registers: a thread holds two rows (r and r + 8) and
//    BN / 4 keys of each, so a row's max and sum take two shuffles within
//    its group of 4 lanes.  P is rounded to bf16 in registers, where the
//    accumulator layout of S is already the A-operand layout of the next
//    product: O += P V is wgmma.m64nDk16 with A from registers and the V
//    tile read MN-major (the transpose bit), BN / 16 products a tile.
//  * Loads.  K and V tiles go through a ring of ST stages in shared
//    memory, in the swizzled layout (16-byte chunks XOR the row within
//    each 8-row group of min(2 D, 128)-byte rows, D / 64 column blocks at
//    D > 64) that the descriptors name.  One producer thread fills it
//    with TMA (a tensor map over the strided (B, Hkv, S, D) view, rows
//    past S zero-filled) and the ring's handoff runs on mbarriers: full
//    (the bytes landed), empty (each consumer warp is done with the
//    stage).  Rows not aligned to 16 bytes, which TMA refuses, take a
//    checked copy by the producer warpgroup's 128 threads into the same
//    layout.  Q is loaded once by its warpgroup, 16 bytes a thread where
//    rows are aligned, else element by element, every load in flight at
//    once: a block walks only about a dozen tiles at gemma3's shape, so
//    its start and end weigh (a Q load one chunk at a time, or a division
//    per output element, each cost a measurable share of the launch).
//  * Within a warpgroup the steps run in turn (S, softmax, P V); the two
//    warpgroups of a block overlap each other.  FA3's turn-taking and its
//    issue of the next tile's S beside P V measured slower here (the
//    latter made ptxas serialise every product).
//  * The output goes through the warpgroup's spent Q tile, so that the
//    global stores are 16 bytes a thread along the rows.
//  * Registers.  A consumer thread holds O (D / 2 fp32), S (BN / 2) and P
//    (BN / 4 words): at D = 256, BN = 64: 128 + 32 + 16.  With two
//    consumer warpgroups the producer gives up its registers (setmaxnreg
//    down to 40, the consumers up to 232).
//  * Work skipped and ordered as in the fp32 kernel: key tiles past the
//    diagonal (causal) or wholly below the window are never loaded; a
//    warpgroup skips the tiles its own rows cannot see; only tiles that
//    cross the diagonal, the window's edge or the end of S are masked;
//    causal launches start the heaviest query tiles first.
//
// Numerics: scores are exact bf16 products summed in fp32; the softmax is
// fp32 (ex2.approx of scores scaled by log2(e) / sqrt(D)); P is rounded to
// bf16 before P V, the only rounding the fp32 kernel does not make (a
// TPU's matrix unit multiplies in bf16 at its default precision too); l
// is summed from the fp32 p; O accumulates in fp32 and rounds once.

using bf16 = __nv_bfloat16;

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);
#include "wgmma.inc"   // _build.wgmma_inc(): the specialisations, N 16-256

// 2^x by the SFU (ex2.approx, relative error about 2^-22, results below
// 2^-126 flushed to zero), for the softmax's exponentials.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from touching registers a product reads or writes
// asynchronously before the product has been waited for.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma's shared-memory matrix descriptor: the start address, the leading
// and stride byte offsets (16-byte units) and the swizzle (1: 128 bytes,
// 2: 64, 3: 32).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swz) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32 |
         static_cast<uint64_t>(swz) << 62;
}

template <int R>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Named barrier `id` of `count` threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// One box of a 4-d tensor map into shared memory, counted on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(repro_torch::smem_addr(dst)),
         "l"(reinterpret_cast<uint64_t>(map)),
         "r"(repro_torch::smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

// Tiles of ROWS x D bf16 in shared memory, as TMA writes them under the
// swizzle of kSw-byte rows and wgmma reads them: D / kAtom column blocks
// of ROWS rows x kSw bytes, and in each 8 x 128-byte (64-byte: 4 x 128,
// 32-byte: 2 x 128) group the 16-byte chunk index XOR the bits of the
// byte offset above 128.  Tiles start on 1024-byte boundaries.
template <int D>
struct Swz {
  static constexpr int kAtom = D < 64 ? D : 64;     // elements a row
  static constexpr int kSw = 2 * kAtom;             // bytes a row
  static constexpr uint32_t kMode = kSw == 128 ? 1 : kSw == 64 ? 2 : 3;
  __device__ static __forceinline__ uint32_t at(int r, int c, int rows) {
    const uint32_t lin = (c / kAtom) * rows * kSw + r * kSw + (c % kAtom) * 2;
    return lin ^ (((lin >> 7) & (kSw / 16 - 1)) << 4);
  }
};

template <int D, int BN, int NC, int ST>
struct Wg {
  static constexpr int kRows = 64 * NC;             // query rows a block
  static constexpr int kThreads = 128 * (NC + 1);   // + the producer
  static constexpr int kQBytes = 64 * D * 2;        // a warpgroup's Q
  static constexpr int kTileBytes = BN * D * 2;     // a K or V tile
  static constexpr size_t kSmem =                   // + 1024 to align
      1024 + NC * kQBytes + 2 * ST * kTileBytes + 2 * ST * sizeof(uint64_t);
  static_assert(kSmem <= 232448, "a block's shared memory");
  static_assert(BN % 16 == 0 && BN <= 256 && D % 16 == 0, "wgmma shapes");
};

// The warpgroup's 64 query rows from r0 into the swizzled Q tile, zero
// past the last query.
template <int D>
__device__ __forceinline__ void load_q(unsigned char* dst, const bf16* src,
                                       int64_t ld, int r0, int t, int tid) {
  const bool aligned = repro_torch::rows_aligned<bf16, 8>(src, ld);
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
#pragma unroll                 // every load in flight at once
  for (int i = tid; i < 64 * D / 8; i += 128) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    union { uint4 u; unsigned short e[8]; } x;
    x.u = make_uint4(0, 0, 0, 0);
    if (r0 + r < t) {
      const int64_t at = (r0 + r) * ld + c;
      if (aligned) {
        x.u = *reinterpret_cast<const uint4*>(src + at);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x.e[e] = s16[at + e];
      }
    }
    *reinterpret_cast<uint4*>(dst + Swz<D>::at(r, c, 64)) = x.u;
  }
}

// A K or V tile of BN rows (valid of them exist) by the producer
// warpgroup's 128 threads, element by element, into the layout TMA gives.
template <int D, int BN>
__device__ __forceinline__ void load_tile_checked(unsigned char* dst,
                                                  const bf16* src, int64_t ld,
                                                  int valid, int tid) {
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
#pragma unroll 1
  for (int i = tid; i < BN * D; i += 128) {
    const int r = i / D, c = i % D;
    *reinterpret_cast<unsigned short*>(dst + Swz<D>::at(r, c, BN)) =
        r < valid ? s16[r * ld + c] : static_cast<unsigned short>(0);
  }
}

template <int D, int BN, int NC, int ST>
__global__ void __launch_bounds__((Wg<D, BN, NC, ST>::kThreads), 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int hq,
                   int group, int t, int s, int causal, int window,
                   float scale, int tma, Strides qs_, Strides ks_,
                   Strides vs_, Strides os_) {
  using W = Wg<D, BN, NC, ST>;
  using Z = Swz<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (1024 - repro_torch::smem_addr(smem_raw) % 1024) % 1024;
  unsigned char* qsm = smem;                            // [NC][64 x D]
  unsigned char* ksm = qsm + NC * W::kQBytes;           // [ST][BN x D]
  unsigned char* vsm = ksm + ST * W::kTileBytes;        // [ST][BN x D]
  uint64_t* full = reinterpret_cast<uint64_t*>(vsm + ST * W::kTileBytes);
  uint64_t* empty = full + ST;

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq, kvh = h / group;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * W::kRows;
  // causal: no key after the block's last query row is visible; a window:
  // none before its first row's window
  const int kend = causal ? min(s, min(q0 + W::kRows, t)) : s;
  const int tile0 = window > 0 ? max(0, q0 - window + 1) / BN : 0;
  const int ntiles = max(0, (kend + BN - 1) / BN - tile0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      repro_torch::mbar_init(&full[i], tma ? 1 : 128);
      repro_torch::mbar_init(&empty[i], 4 * NC);
    }
    repro_torch::fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == NC) {
    // ------------------------------------------------ producer
    if constexpr (NC > 1) regs_down<40>();
    for (int n = 0; n < ntiles; ++n) {
      if (tma && tid != 0) break;
      const int st = n % ST, k0 = (tile0 + n) * BN;
      repro_torch::mbar_wait(&empty[st], ((n / ST) & 1) ^ 1);
      unsigned char* kt = ksm + st * W::kTileBytes;
      unsigned char* vt = vsm + st * W::kTileBytes;
      if (tma) {
        repro_torch::mbar_expect_tx(&full[st], 2 * W::kTileBytes);
#pragma unroll
        for (int c = 0; c < D / Z::kAtom; ++c) {
          tma_load(kt + c * BN * Z::kSw, &kmap, &full[st], c * Z::kAtom, k0,
                   kvh, b);
          tma_load(vt + c * BN * Z::kSw, &vmap, &full[st], c * Z::kAtom, k0,
                   kvh, b);
        }
      } else {
        load_tile_checked<D, BN>(kt, k + b * ks_.b + kvh * ks_.h + k0 * ks_.t,
                                 ks_.t, s - k0, tid);
        load_tile_checked<D, BN>(vt, v + b * vs_.b + kvh * vs_.h + k0 * vs_.t,
                                 vs_.t, s - k0, tid);
        fence_proxy_async();            // generic writes, read by wgmma
        repro_torch::mbar_arrive(&full[st]);
      }
    }
  } else {
    // ------------------------------------------------ consumers
    if constexpr (NC > 1) regs_up<232>();
    const int warp = tid / 32, lane = tid % 32;
    const int wr0 = q0 + 64 * wg;                  // the warpgroup's rows
    const int last = min(wr0 + 63, t - 1);         // ... its last query
    const int r_lo = wr0 + 16 * warp + lane / 4;   // this thread's: r_lo, +8
    unsigned char* qw = qsm + wg * W::kQBytes;
    load_q<D>(qw, q + b * qs_.b + h * qs_.h, qs_.t, wr0, t, tid);
    fence_proxy_async();                           // read by wgmma
    named_sync(1 + wg, 128);

    const float sl = scale * 1.4426950408889634f;  // to log2 units
    const uint32_t qaddr = repro_torch::smem_addr(qw);
    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int n = 0; n < ntiles; ++n) {
      const int st = n % ST, k0 = (tile0 + n) * BN;
      repro_torch::mbar_wait(&full[st], (n / ST) & 1);
      // does any of the warpgroup's rows see a key of the tile?
      const bool live = wr0 <= last && (!causal || k0 <= last) &&
                        (window <= 0 || k0 + BN - 1 > wr0 - window);
      if (live) {
        float sacc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
        const uint32_t kaddr = repro_torch::smem_addr(ksm + st * W::kTileBytes);
        hold(sacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int blk = 16 * kk / Z::kAtom, off = 16 * kk % Z::kAtom * 2;
          wgmma_ss<BN>(sacc,
                       smem_desc(qaddr + blk * 64 * Z::kSw + off, 16,
                                 8 * Z::kSw, Z::kMode),
                       smem_desc(kaddr + blk * BN * Z::kSw + off, 16,
                                 8 * Z::kSw, Z::kMode), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        hold(sacc);

        // a key of s[i]: k0 + 8 (i / 4) + 2 (lane % 4) + i % 2, of row
        // r_lo + 8 ((i / 2) % 2); mask only tiles that cross the end of S,
        // the diagonal of the first row or the window of the last
        const bool edge = k0 + BN > s || (causal && k0 + BN - 1 > wr0) ||
                          (window > 0 && k0 <= last - window);
        if (edge) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            const int j = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
            const int r = r_lo + 8 * ((i / 2) % 2);
            const bool vis = j < s && (!causal || j <= r) &&
                             (window <= 0 || r - j < window);
            if (!vis) sacc[i] = -INFINITY;
          }
        }
        float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          mt[(i / 2) % 2] = fmaxf(mt[(i / 2) % 2], sacc[i]);
        float mb[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
          const float m_new = fmaxf(m[r], mt[r] * sl);
          mb[r] = m_new == -INFINITY ? 0.f : m_new;   // a row with nothing
          alpha[r] = fast_exp2(m[r] - mb[r]);
          m[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int r = (i / 2) % 2;
          sacc[i] = fast_exp2(fmaf(sacc[i], sl, -mb[r]));
          rs[r] += sacc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i / 2) % 2];
        // P as bf16 A fragments: 16 keys a product, rows r_lo and r_lo + 8
        uint32_t pf[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 p2 = __floats2bfloat162_rn(
                sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1]);
            pf[kk][e] = *reinterpret_cast<const uint32_t*>(&p2);
          }

        const uint32_t vaddr = repro_torch::smem_addr(vsm + st * W::kTileBytes);
        hold(oacc);
        hold(pf);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<D>(oacc, pf[kk],
                      smem_desc(vaddr + kk * 16 * Z::kSw, BN * Z::kSw,
                                8 * Z::kSw, Z::kMode), 1);
        wgmma_commit();
        wgmma_wait_all();
        hold(oacc);
        hold(pf);
      }
      __syncwarp();          // each consumer warp is done with the stage
      if (lane == 0) repro_torch::mbar_arrive(&empty[st]);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    bf16* ob = o + b * os_.b + h * os_.h;
    if (repro_torch::rows_aligned<bf16, 8>(ob, os_.t)) {
      // through the warpgroup's spent Q tile (same swizzle: no bank
      // conflicts), then 16 bytes a thread along the output rows
      named_sync(1 + wg, 128);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(
              qw + Z::at(r_lo - wr0 + 8 * r, 8 * j + 2 * (lane % 4), 64)) =
              __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv[r],
                                    oacc[4 * j + 2 * r + 1] * inv[r]);
      named_sync(1 + wg, 128);
#pragma unroll
      for (int i = tid; i < 64 * D / 8; i += 128) {
        const int row = i / (D / 8), c = (i % (D / 8)) * 8;
        if (wr0 + row < t)
          *reinterpret_cast<uint4*>(ob + (wr0 + row) * os_.t + c) =
              *reinterpret_cast<const uint4*>(qw + Z::at(row, c, 64));
      }
    } else {
      const bool pairs = repro_torch::rows_aligned<bf16, 2>(ob, os_.t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r_lo + 8 * r;
        if (row >= t) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float x = oacc[4 * j + 2 * r] * inv[r];
          const float y = oacc[4 * j + 2 * r + 1] * inv[r];
          bf16* p = ob + row * os_.t + 8 * j + 2 * (lane % 4);
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(p) =
                __floats2bfloat162_rn(x, y);
          } else {
            p[0] = __float2bfloat16(x);
            p[1] = __float2bfloat16(y);
          }
        }
      }
    }
  }
}

// The driver's tensor-map encoder, looked up in the loaded driver, so the
// library links no libcuda; null where there is none.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(
                                          dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Whether TMA can read k or v (B, Hkv, S, D) with these strides: a 16-byte
// aligned base and strides of whole 16-byte units, over the dims longer
// than 1; the rows then start 16-byte aligned too.
bool tma_reads(const void* p, const Strides& st, int b, int hkv, int s,
               int d) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (s <= 1 || (st.t % 8 == 0 && st.t >= d)) &&
         (hkv <= 1 || (st.h % 8 == 0 && st.h > 0)) &&
         (b <= 1 || (st.b % 8 == 0 && st.b > 0));
}

// A tensor map over k or v as (B, Hkv, S, D) through its strides (a dim
// of length 1 gets a packed stride, never used), read in boxes of kAtom
// columns x BN rows under the swizzle the kernel's descriptors name, rows
// past S read as zeros.
template <int D, int BN>
int encode_kv(CUtensorMap* map, const void* base, const Strides& st,
              const Args& a) {
  using Z = Swz<D>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr)
    return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t row = 2ull * D, head = row * a.s, batch = head * a.hkv;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(a.s),
                              static_cast<cuuint64_t>(a.hkv),
                              static_cast<cuuint64_t>(a.b)};
  const cuuint64_t strides[3] = {a.s > 1 ? 2ull * st.t : row,
                                 a.hkv > 1 ? 2ull * st.h : head,
                                 a.b > 1 ? 2ull * st.b : batch};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Z::kAtom),
                             static_cast<cuuint32_t>(BN), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = Z::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : Z::kSw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D, int BN, int NC, int ST>
int launch_wgmma(const Args& a) {
  using W = Wg<D, BN, NC, ST>;
  auto kernel = flash_wgmma_kernel<D, BN, NC, ST>;
  CUtensorMap kmap, vmap;
  std::memset(&kmap, 0, sizeof kmap);
  std::memset(&vmap, 0, sizeof vmap);
  const int tma = a.s > 0 && tma_reads(a.k, a.ks, a.b, a.hkv, a.s, D) &&
                  tma_reads(a.v, a.vs, a.b, a.hkv, a.s, D);
  int rc = 0;
  if (tma) {
    rc = encode_kv<D, BN>(&kmap, a.k, a.ks, a);
    if (rc == 0) rc = encode_kv<D, BN>(&vmap, a.v, a.vs, a);
    if (rc != 0) return rc;
  }
  rc = repro_torch::allow_shared(kernel, W::kSmem);
  if (rc != 0) return rc;
  const dim3 grid(a.b * a.hq, (a.t + W::kRows - 1) / W::kRows);
  kernel<<<grid, W::kThreads, W::kSmem, a.stream>>>(
      kmap, vmap, static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.hq,
      a.hq / a.hkv, a.t, a.s, a.causal, a.window, a.scale, tma, a.qs, a.ks,
      a.vs, a.os);
  return repro_torch::launch_status();
}

// 128 query rows a block (two consumer warpgroups) and two stages; keys a
// tile 128, at D = 256 64 (O alone takes 128 registers a thread, and the
// ring's two stages of K and V 128 KB).
template <typename T, int D>
int launch_typed(const Args& a) {
  if constexpr (std::is_same<T, float>::value) {
    return launch<D>(a);
  } else if constexpr (D > 128) {
    return launch_wgmma<D, 64, 2, 2>(a);
  } else {
    return launch_wgmma<D, 128, 2, 2>(a);
  }
}

template <typename T>
int dispatch(int d, const Args& a) {
  switch (d) {
    case 16: return launch_typed<T, 16>(a);
    case 32: return launch_typed<T, 32>(a);
    case 64: return launch_typed<T, 64>(a);
    case 128: return launch_typed<T, 128>(a);
    case 256: return launch_typed<T, 256>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Head dims with a compiled kernel; any other D is refused (error code 1,
// cudaErrorInvalidValue) and the wrapper checks the set first.  window <=
// 0 means no window.
#define REPRO_FLASH_ENTRY(NAME, T)                                           \
  extern "C" int NAME(                                                      \
      const void* q, const void* k, const void* v, void* o, int b, int hq,  \
      int hkv, int t, int s, int d, int causal, int window, float scale,    \
      int64_t qsb, int64_t qsh, int64_t qst, int64_t ksb, int64_t ksh,      \
      int64_t kst, int64_t vsb, int64_t vsh, int64_t vst, int64_t osb,      \
      int64_t osh, int64_t ost, void* stream) {                             \
    const Args a{q, k, v, o, b, hq, hkv, t, s, causal, window, scale,       \
                 {qsb, qsh, qst}, {ksb, ksh, kst}, {vsb, vsh, vst},         \
                 {osb, osh, ost}, static_cast<cudaStream_t>(stream)};       \
    return dispatch<T>(d, a);                                               \
  }

REPRO_FLASH_ENTRY(repro_flash_attention_f32, float)
REPRO_FLASH_ENTRY(repro_flash_attention_bf16, __nv_bfloat16)
