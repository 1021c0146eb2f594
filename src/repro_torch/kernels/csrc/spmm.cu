// ELL/page-format SpMM for sm_90a: out[i,:] = sum_k mask[i,k] * h[nbr[i,k],:]
// (divided by max(sum_k mask[i,k], 1) in mean mode).
//
// Replaces repro/kernels/spmm.py::_spmm_kernel.  One block of 128 threads
// owns one destination row and one 128-feature slice; neighbouring threads
// read neighbouring features of the same gathered row, so every gathered
// row is read as coalesced segments and the row's indices and mask come
// from L1 as broadcasts.  Slots run in order and each product and sum is
// rounded on its own (no fused multiply-add), which is exactly what
// spmm_ref computes: the kernel matches it bit for bit, and a row's result
// never depends on how many rows the launch has.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
spmm_kernel(const float* __restrict__ h, const int* __restrict__ nbr,
            const float* __restrict__ mask, float* __restrict__ out,
            int n, int f, int k, int mean) {
  const int64_t row = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= f) return;
  const int* nrow = nbr + row * k;
  const float* mrow = mask + row * k;
  float acc = 0.f;
  float deg = 0.f;
  for (int j = 0; j < k; ++j) {
    const int64_t src = repro_torch::gather_row(nrow[j], n);
    const float m = mrow[j];
    const float v = src >= 0 ? h[src * f + col] : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(v, m));
    deg = __fadd_rn(deg, m);
  }
  if (mean) acc = acc / fmaxf(deg, 1.f);
  out[row * f + col] = acc;
}

}  // namespace

extern "C" int repro_spmm_f32(const void* h, const void* nbr,
                              const void* mask, void* out, int n, int f,
                              int d, int k, int mean, void* stream) {
  const dim3 grid(d, (f + kThreads - 1) / kThreads);
  spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const int*>(nbr),
      static_cast<const float*>(mask), static_cast<float*>(out), n, f, k,
      mean);
  return repro_torch::launch_status();
}
