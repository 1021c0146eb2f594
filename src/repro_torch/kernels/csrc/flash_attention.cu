// Causal, full or sliding-window attention with an online softmax, for
// sm_90a, on fp32 or bf16 q/k/v (fp32 arithmetic, the output in q's type):
// o[b,h,i,:] = softmax_j(q[b,h,i,:] . k[b,h/G,j,:] / sqrt(D)) @ v[b,h/G,:,:],
// with key j visible to query i when j < S, (not causal or j <= i) and
// (window <= 0 or i - j < window).
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel.  The TPU grid
// walked key tiles in order and carried (m, l, acc) in VMEM scratch from
// one grid step to the next; blocks have no order, so one block owns one
// (batch*head, 32-query tile) and loops over the key tiles itself, up to
// the diagonal when causal, with the running state in registers.  GQA is
// by index (head h reads KV head h / G, G need not be a power of two):
// no repeated copy of K and V.  Ragged tails are masked, never padded.
//
// Bound at prefill shapes: operations (4*T*S*D/2 flops per head against
// 67 TFLOP/s of fp32 FMA; no TF32, since the reference holds attention to
// 3e-5).  In practice the limit is the SM's shared-memory port, 128 bytes
// a clock: a warp's 16-byte shared load costs it 4 clocks whether or not
// lanes share addresses, against one clock for a warp's FMA on each of
// the 4 schedulers.  What the design does about both:
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
//    one (load_tile).  Shared memory per part in fp32: 4*(4*32*(D+4) +
//    BQ*36) bytes, 144 KB a block at D = 128 (one an SM, 8 warps); at
//    D = 256 a block is one part of 16 query rows (135 KB), so its
//    registers and buffers fit.  bf16 tiles take about half.
//
//  * bf16 (the dense LM path's activations and caches): K and V tiles
//    stay bf16 in shared memory, half the bytes, copied 8 elements a
//    16-byte cp.async; each shared load widens to fp32 in registers and
//    the arithmetic below is the fp32 one; q widens as it is loaded, and
//    the output rounds once, to nearest.  Rows are padded by 16 elements
//    (8 at D = 256), from a count of the QK^T loads' bank conflicts.
//  * A window: key tiles wholly below the window of the block's first
//    query row are skipped, as tiles past the diagonal are when causal,
//    so a block walks about window / 32 tiles whatever its position.
//
// Every product is an fp32 FMA, in an order fixed by D and the key index,
// and expf is the precise one.  q, k, v and o are addressed through
// (batch, head, seq) strides with the head dim contiguous, so the model's
// (B, T, H, D) activations are read and written in place; the arithmetic
// does not depend on the strides.
#include "common.cuh"

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
//    row's probabilities, via shared memory) and V as 16-byte fragments
//    (8 bytes of bf16).
// K and V tiles are of T, P is fp32; a part's buffers take kPartBytes.
template <typename T, int D, int BQ, int TR, int SPLIT>
struct Flash {
  static constexpr int kTY = BQ / TR;
  static constexpr int kPartThreads = kTY * kTX;      // one part's threads
  static constexpr int kThreads = SPLIT * kPartThreads;
  static constexpr int kSlice = D / kTX;              // q/k elements a lane
  static constexpr int kVec = 16 / sizeof(T);         // elements a cp.async
  static constexpr int kPad = sizeof(T) == 4 ? 4 : D == 256 ? 8 : 16;
  static constexpr int kLd = D + kPad, kLdP = kBK + 4;   // padded rows
  static constexpr int kGroups = D / 4;               // 4-element groups
  static constexpr int kGpt = (kGroups + kTX - 1) / kTX;
  static constexpr size_t kPartBytes =      // a part's K, V x 2 and P
      sizeof(T) * 4 * kBK * kLd + sizeof(float) * BQ * kLdP;
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
template <int N>
__device__ __forceinline__ void load_slice(const __nv_bfloat16* p,
                                           float (&out)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      // a bf16 is the high half of its fp32: widen by placing the bits
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[i + 2 * j] = __uint_as_float(w[j] << 16);
        out[i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = load4(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __bfloat162float(p[i]);
  }
}

template <typename T, int D, int BQ, int TR, int SPLIT>
__global__ void __launch_bounds__((Flash<T, D, BQ, TR, SPLIT>::kThreads))
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int hq, int group,
             int t, int s, int causal, int window, float scale, Strides qs_,
             Strides ks_, Strides vs_, Strides os_) {
  using F = Flash<T, D, BQ, TR, SPLIT>;
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
  T* ks = reinterpret_cast<T*>(smem + part * F::kPartBytes);  // [2][kBK][kLd]
  T* vs = ks + 2 * kBK * kLd;                                // [2][kBK][kLd]
  float* ps = reinterpret_cast<float*>(vs + 2 * kBK * kLd);  // [BQ][kLdP]
  auto part_sync = [&]() {
    if constexpr (SPLIT == 1) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;" :: "r"(1 + part),
                   "n"(F::kPartThreads) : "memory");
    }
  };
  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + kvh * ks_.h;
  const T* vb = v + b * vs_.b + kvh * vs_.h;

  // causal: no key after the tile's last query row is visible; a window:
  // none before the first row's window
  const int kend = causal ? min(s, min(q0 + BQ, t)) : s;
  const int tiles = (kend + kBK - 1) / kBK;
  const int tile0 = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  // whole tiles of aligned rows take the unchecked copy (uniform)
  const bool k_full = repro_torch::rows_aligned<T, F::kVec>(kb, ks_.t);
  const bool v_full = repro_torch::rows_aligned<T, F::kVec>(vb, vs_.t);
  auto load_rows = [&](T* dst, const T* src, int64_t ld, int rows,
                       bool aligned) {
    if (aligned && rows >= kBK) {
      repro_torch::load_tile_full<T, kBK, D, kLd, F::kPartThreads, F::kVec>(
          dst, src, ld, ptid);
    } else {
      repro_torch::load_tile<T, kBK, D, kLd, F::kPartThreads, F::kVec>(
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
    const T* kt = ks + (n & 1) * kBK * kLd;
    const T* vt = vs + (n & 1) * kBK * kLd;

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

  T* ob = o + b * os_.b + h * os_.h;
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

template <typename T, int D, int BQ, int TR, int SPLIT>
int launch_tile(const Args& a) {
  using F = Flash<T, D, BQ, TR, SPLIT>;
  auto kernel = flash_kernel<T, D, BQ, TR, SPLIT>;
  const int rc = repro_torch::allow_shared(kernel, F::kSmem);
  if (rc != 0) return rc;
  const dim3 grid(a.b * a.hq, (a.t + BQ - 1) / BQ);
  kernel<<<grid, F::kThreads, F::kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.hq, a.hq / a.hkv,
      a.t, a.s, a.causal, a.window, a.scale, a.qs, a.ks, a.vs, a.os);
  return repro_torch::launch_status();
}

// 32 query rows a block, 4 a thread, in two parts that split the keys; at
// D = 256, 16 rows, 2 a thread, one part, so the q slice, the partial dots
// and the output stay in registers and the buffers in shared memory.
template <typename T, int D>
int launch(const Args& a) {
  if constexpr (D > 128) {
    return launch_tile<T, D, 16, 2, 1>(a);
  } else {
    return launch_tile<T, D, 32, 4, 2>(a);
  }
}

template <typename T>
int dispatch(int d, const Args& a) {
  switch (d) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    case 256: return launch<T, 256>(a);
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
