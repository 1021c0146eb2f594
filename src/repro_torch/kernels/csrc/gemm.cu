// Blocked GEMM for sm_90a: c (M,N) = a (M,K) @ b (K,N), fp32 accumulate,
// output in a's type (fp32 or bf16).
//
// Replaces repro/kernels/gemm.py::_gemm_kernel.  Bound: operations at the
// service's shapes (2*M*N*K fp32 FMAs; TF32 would miss the reference's
// 1e-5).  The service's products are small (3072 x 128 outputs, about
// 3,000 an SM), so what limits a kernel on the FMA pipes is one warp's
// chain of dependent work and the SM's shared-memory port (128 bytes a
// clock: a warp's 16-byte shared load costs 4 clocks).  The design:
//
//  * Tiles that fill the card, chosen from N alone: 24x64 outputs a block
//    above N = 64 (3072 x 128 gives 256 blocks for 132 SMs, so no SM
//    holds more than two), 6x4 a thread, 64 threads; 32x32 at and below
//    N = 64, 2x4 a thread, 128 threads, so the 512-row calls get 32
//    blocks of 4 warps.  Measured on the H100, 24x64 beat 32x64 (8x4 a
//    thread: each warp's chain is a third longer) and 16x64 or 32x32
//    (4x4 a thread: more shared loads per FMA).
//  * A and B tiles in shared memory row-major as they lie in global
//    memory, rows padded by 4 elements.  Per 4 steps of k a thread reads
//    each of its A rows and B rows as one 16-byte (bf16: 8-byte) load:
//    10 loads for 96 FMAs at 6x4.  A thread's rows are interleaved
//    (ty, ty + 4, ...), so the two rows a warp reads at once fall in
//    different banks.
//  * Three shared-memory stages fed by cp.async: the tile two steps
//    ahead loads while this one computes, one __syncthreads a step.
//    Whole tiles of aligned rows take an unchecked 16-byte copy
//    (load_tile_full); ragged edges and unaligned rows (a row slice of
//    an odd-K matrix, bf16 rows at K = 420) a checked one, element by
//    element where 16 bytes do not fit (load_tile).
//
// bf16 tiles stay bf16 in shared memory and widen to fp32 on the fragment
// load; the sum rounds once on the store.  Every output element is one
// chain of fused multiply-adds over k = 0..K-1 in order (out-of-range k
// adds an exact 0*0), no split over K and no atomics, and the tile shape
// never depends on M: a row's result is the same bits whatever rows ride
// with it, which keeps fused batches bit-identical to serial runs.
#include "common.cuh"

namespace {

using repro_torch::load4;
using repro_torch::store_as;

// BMxBN outputs a block, TMxTN a thread, BK k a stage, STAGES stages.
template <typename T, int BM, int BN, int TM, int TN, int BK, int STAGES>
struct Tile {
  static constexpr int kRowsY = BM / TM;               // thread rows
  static constexpr int kThreads = kRowsY * (BN / TN);
  static constexpr int kLdA = BK + 4, kLdB = BN + 4;   // padded rows
  static constexpr int kStageElems = BM * kLdA + BK * kLdB;
  static constexpr size_t kSmem = sizeof(T) * STAGES * kStageElems;
};

template <typename T, int BM, int BN, int TM, int TN, int BK, int STAGES>
__global__ void __launch_bounds__(
    (Tile<T, BM, BN, TM, TN, BK, STAGES>::kThreads))
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            T* __restrict__ c, int m, int k, int n) {
  using G = Tile<T, BM, BN, TM, TN, BK, STAGES>;
  static_assert(TN == 4 && BK % 4 == 0, "4-wide fragments");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const T* a0 = a + static_cast<int64_t>(row0) * k;
  const T* b0 = b + col0;
  const int tiles = (k + BK - 1) / BK;
  // whole, aligned tiles take the unchecked copy (uniform over the block)
  const bool a_full = row0 + BM <= m && repro_torch::rows_aligned(a, k);
  const bool b_full = col0 + BN <= n && repro_torch::rows_aligned(b, n);

  auto load = [&](int t) {
    T* as = smem + (t % STAGES) * G::kStageElems;
    T* bs = as + BM * G::kLdA;
    const int k0 = t * BK;
    const T* at = a0 + k0;
    const T* bt = b0 + static_cast<int64_t>(k0) * n;
    if (a_full && k0 + BK <= k) {
      repro_torch::load_tile_full<T, BM, BK, G::kLdA, G::kThreads>(
          as, at, k, tid);
    } else {
      repro_torch::load_tile<T, BM, BK, G::kLdA, G::kThreads>(
          as, at, k, m - row0, k - k0, tid);
    }
    if (b_full && k0 + BK <= k) {
      repro_torch::load_tile_full<T, BK, BN, G::kLdB, G::kThreads>(
          bs, bt, n, tid);
    } else {
      repro_torch::load_tile<T, BK, BN, G::kLdB, G::kThreads>(
          bs, bt, n, k - k0, n - col0, tid);
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) load(t);
    repro_torch::cp_async_commit();   // empty groups keep the count even
  }

  float acc[TM][TN] = {};
  for (int t = 0; t < tiles; ++t) {
    repro_torch::cp_async_wait<STAGES - 2>();    // tile t has landed
    __syncthreads();          // ... for every thread; tile t-1 is read
    if (t + STAGES - 1 < tiles) load(t + STAGES - 1);
    repro_torch::cp_async_commit();
    const T* as = smem + (t % STAGES) * G::kStageElems;
    const T* bs = as + BM * G::kLdA;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 av[TM], bv[4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = load4(as + (ty + i * G::kRowsY) * G::kLdA + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        bv[kk] = load4(bs + (kq + kk) * G::kLdB + tx * TN);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                        : kk == 2 ? av[i].z : av[i].w;
          acc[i][0] = fmaf(x, bv[kk].x, acc[i][0]);
          acc[i][1] = fmaf(x, bv[kk].y, acc[i][1]);
          acc[i][2] = fmaf(x, bv[kk].z, acc[i][2]);
          acc[i][3] = fmaf(x, bv[kk].w, acc[i][3]);
        }
      }
    }
  }
  repro_torch::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * G::kRowsY;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx * TN + j;
      if (col < n) store_as(&c[static_cast<int64_t>(r) * n + col], acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int TM, int TN, int BK, int STAGES>
int launch_tile(const void* a, const void* b, void* c, int m, int k, int n,
                cudaStream_t stream) {
  using G = Tile<T, BM, BN, TM, TN, BK, STAGES>;
  auto kernel = gemm_kernel<T, BM, BN, TM, TN, BK, STAGES>;
  const int rc = repro_torch::allow_shared(kernel, G::kSmem);
  if (rc != 0) return rc;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, k, n);
  return repro_torch::launch_status();
}

// The tile from N alone (see the note at the top).
template <typename T>
int launch(const void* a, const void* b, void* c, int m, int k, int n,
           void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return n > 64 ? launch_tile<T, 24, 64, 6, 4, 16, 3>(a, b, c, m, k, n, st)
                : launch_tile<T, 32, 32, 2, 4, 32, 3>(a, b, c, m, k, n, st);
}

}  // namespace

extern "C" int repro_gemm_f32(const void* a, const void* b, void* c, int m,
                              int k, int n, void* stream) {
  return launch<float>(a, b, c, m, k, n, stream);
}

extern "C" int repro_gemm_bf16(const void* a, const void* b, void* c, int m,
                               int k, int n, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, m, k, n, stream);
}
