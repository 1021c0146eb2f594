// Blocked GEMM for sm_90a: c (M,N) = a (M,K) @ b (K,N), fp32 accumulate,
// output in a's type (fp32 or bf16).
//
// Replaces repro/kernels/gemm.py::_gemm_kernel.  A shared-memory-tiled
// product on the fp32 FMA pipes: each block of 256 threads owns a 64x64
// output tile and walks K in steps of 16, staging a 64x16 tile of A and a
// 16x64 tile of B in shared memory; each thread keeps a 4x4 block of sums
// in registers.  No TF32: the reference holds fp32 to 1e-5.  bf16 inputs
// convert to fp32 on load and round once on the store.  Every output
// element is one chain of fused multiply-adds over k = 0..K-1 in order,
// and the tile shape is fixed, so a row's result never depends on M.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256

__device__ __forceinline__ float load_f32(float x) { return x; }
__device__ __forceinline__ float load_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            T* __restrict__ c, int m, int k, int n) {
  __shared__ float as[kBK][kBM];   // A tile, k-major
  __shared__ float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  float acc[kTM][kTN] = {};

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k)
          ? load_f32(a[static_cast<int64_t>(gr) * k + gk]) : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, cc = i % kBN;
      const int gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n)
          ? load_f32(b[static_cast<int64_t>(gk) * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = col0 + tx * kTN + j;
      if (col < n) store_as(&c[static_cast<int64_t>(r) * n + col], acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int m, int k, int n,
           void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, k, n);
  return repro_torch::launch_status();
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
