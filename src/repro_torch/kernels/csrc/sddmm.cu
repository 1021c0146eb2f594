// SDDMM for sm_90a, the NGCF similarity term:
//   out[i,k,:] = h[nbr[i,k],:] * h[i,:] * mask[i,k]      shape (D,K,F), D <= N
//
// Replaces repro/kernels/sddmm.py::_sddmm_kernel.  An elementwise
// gather-product: one block of 128 threads owns one (row, slot) pair and
// one 128-feature slice, so the gathered row, the destination row and the
// (D,K,F) output are all read or written as coalesced segments.  The
// products are rounded in the order sddmm_ref takes them, (g * d) * m, with
// no fused multiply-add, so the kernel matches it bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const float* __restrict__ h, const int* __restrict__ nbr,
             const float* __restrict__ mask, float* __restrict__ out,
             int n, int f, int k) {
  const int64_t e = blockIdx.x;            // row * k + slot
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= f) return;
  const int64_t row = e / k;
  const int64_t src = repro_torch::gather_row(nbr[e], n);
  const float g = src >= 0 ? h[src * f + col] : 0.f;
  out[e * f + col] = __fmul_rn(__fmul_rn(g, h[row * f + col]), mask[e]);
}

}  // namespace

extern "C" int repro_sddmm_f32(const void* h, const void* nbr,
                               const void* mask, void* out, int n, int f,
                               int d, int k, void* stream) {
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(d) * k),
                  (f + kThreads - 1) / kThreads);
  sddmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const int*>(nbr),
      static_cast<const float*>(mask), static_cast<float*>(out), n, f, k);
  return repro_torch::launch_status();
}
