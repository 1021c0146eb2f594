// RMSNorm for sm_90a: out[r,:] = x[r,:] * rsqrt(mean(x[r,:]^2) + eps) * w,
// computed in fp32 and stored in x's type (fp32 or bf16); w is fp32.
//
// Replaces repro/kernels/rmsnorm.py::_rmsnorm_kernel.  The TPU kernel held
// a (256, F) slab of rows in VMEM; here one block of 256 threads owns one
// row.  Each thread sums the squares of its strided share of the row, a
// warp-shuffle and shared-memory reduction gives the row's mean, and a
// second pass over the row (from L1/L2, the row is at most a few KB)
// scales and stores it.  Bound: bytes (each element is read once and
// written once for three flops), so the row is read with neighbouring
// threads on neighbouring elements.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int f, float eps) {
  __shared__ float partial[kWarps];
  __shared__ float inv_rms;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * f;
  T* orow = out + row * f;
  float ss = 0.f;
  for (int i = threadIdx.x; i < f; i += kThreads) {
    const float v = repro_torch::load_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = repro_torch::warp_sum(ss);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kWarps ? partial[threadIdx.x] : 0.f;
    v = repro_torch::warp_sum(v);
    if (threadIdx.x == 0) inv_rms = 1.f / sqrtf(v / f + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int i = threadIdx.x; i < f; i += kThreads)
    repro_torch::store_as(&orow[i], repro_torch::load_f32(xr[i]) * r * w[i]);
}

template <typename T>
int launch(const void* x, const void* w, void* out, int rows, int f,
           float eps, void* stream) {
  rmsnorm_kernel<T><<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), f, eps);
  return repro_torch::launch_status();
}

}  // namespace

extern "C" int repro_rmsnorm_f32(const void* x, const void* w, void* out,
                                 int rows, int f, float eps, void* stream) {
  return launch<float>(x, w, out, rows, f, eps, stream);
}

extern "C" int repro_rmsnorm_bf16(const void* x, const void* w, void* out,
                                  int rows, int f, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, rows, f, eps, stream);
}
