// Fused aggregate-combine for sm_90a, one GCN layer per launch:
//   out (D,O) = relu(mean_k(mask * h[nbr]) @ w + b)     (epilogue on)
//   out (D,O) = mean_k(mask * h[nbr]) @ w               (epilogue off)
//
// Replaces repro/kernels/agg_combine.py::_agg_combine_kernel.  Each block
// owns BD destination rows.  It first gathers and masks the K neighbour
// rows of h and reduces them in fp32 into shared memory (BD x F floats),
// so the aggregate never goes to device memory.  It then loops over the
// output tiles of w inside the block: each thread owns one output column
// of the tile and keeps BD sums in registers, reading w coalesced from L2
// and the aggregate as shared-memory broadcasts.  The TPU kernel reused
// the aggregate across output tiles because its grid ran in order; blocks
// have no order, so here the reuse is the in-block loop.  BD depends on F
// alone (16 rows at F=420 use 27 KB), ragged F and O edges are masked
// in the kernel, and every sum runs in a fixed order (aggregation as in
// spmm.cu, then one fused multiply-add chain over F), so a row's result
// never depends on how many rows the launch has.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSmemBudget = 96 * 1024;        // bytes of aggregate per block
constexpr int kDefaultSmem = 48 * 1024;       // above this, opt in

template <int BD>
__global__ void __launch_bounds__(kThreads)
agg_combine_kernel(const float* __restrict__ h, const int* __restrict__ nbr,
                   const float* __restrict__ mask, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out,
                   int n, int f, int d, int k, int o, int mean, int epilogue) {
  extern __shared__ float agg[];               // BD x F
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BD;

  for (int idx = threadIdx.x; idx < BD * f; idx += kThreads) {
    const int r = idx / f, col = idx - r * f;
    const int64_t row = row0 + r;
    float acc = 0.f;
    if (row < d) {
      const int* nrow = nbr + row * k;
      const float* mrow = mask + row * k;
      float deg = 0.f;
      for (int j = 0; j < k; ++j) {
        const int64_t src = repro_torch::gather_row(nrow[j], n);
        const float m = mrow[j];
        const float v = src >= 0 ? h[src * f + col] : 0.f;
        acc = __fadd_rn(acc, __fmul_rn(v, m));
        deg = __fadd_rn(deg, m);
      }
      if (mean) acc = acc / fmaxf(deg, 1.f);
    }
    agg[idx] = acc;
  }
  __syncthreads();

  for (int o0 = 0; o0 < o; o0 += kThreads) {
    const int col = o0 + threadIdx.x;
    if (col >= o) break;
    float z[BD];
#pragma unroll
    for (int r = 0; r < BD; ++r) z[r] = 0.f;
    for (int c = 0; c < f; ++c) {
      const float wv = w[static_cast<int64_t>(c) * o + col];
#pragma unroll
      for (int r = 0; r < BD; ++r) z[r] = fmaf(agg[r * f + c], wv, z[r]);
    }
    const float bias = epilogue ? b[col] : 0.f;
#pragma unroll
    for (int r = 0; r < BD; ++r) {
      const int64_t row = row0 + r;
      if (row >= d) break;
      out[row * o + col] = epilogue ? fmaxf(__fadd_rn(z[r], bias), 0.f) : z[r];
    }
  }
}

template <int BD>
int launch(const void* h, const void* nbr, const void* mask, const void* w,
           const void* b, void* out, int n, int f, int d, int k, int o,
           int mean, int epilogue, cudaStream_t stream) {
  const int smem = BD * f * static_cast<int>(sizeof(float));
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        agg_combine_kernel<BD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((d + BD - 1) / BD);
  agg_combine_kernel<BD><<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(h), static_cast<const int*>(nbr),
      static_cast<const float*>(mask), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), n, f, d, k, o,
      mean, epilogue);
  return repro_torch::launch_status();
}

}  // namespace

// Rows per block for a feature width: the largest of 16, 8, 4, 2, 1 whose
// aggregate fits the shared-memory budget; 0 when not even one row fits.
extern "C" int repro_agg_combine_rows(int f) {
  for (int bd = 16; bd >= 1; bd /= 2)
    if (static_cast<int64_t>(bd) * f * sizeof(float) <= kSmemBudget) return bd;
  return 0;
}

extern "C" int repro_agg_combine_f32(const void* h, const void* nbr,
                                     const void* mask, const void* w,
                                     const void* b, void* out, int n, int f,
                                     int d, int k, int o, int mean,
                                     int epilogue, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (repro_agg_combine_rows(f)) {
    case 16: return launch<16>(h, nbr, mask, w, b, out, n, f, d, k, o, mean, epilogue, s);
    case 8:  return launch<8>(h, nbr, mask, w, b, out, n, f, d, k, o, mean, epilogue, s);
    case 4:  return launch<4>(h, nbr, mask, w, b, out, n, f, d, k, o, mean, epilogue, s);
    case 2:  return launch<2>(h, nbr, mask, w, b, out, n, f, d, k, o, mean, epilogue, s);
    case 1:  return launch<1>(h, nbr, mask, w, b, out, n, f, d, k, o, mean, epilogue, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
