// RMSNorm for sm_90a: out[r,:] = x[r,:] * rsqrt(mean(x[r,:]^2) + eps) * w,
// computed in fp32 and stored in x's type (fp32 or bf16); w is fp32.
//
// Replaces repro/kernels/rmsnorm.py::_rmsnorm_kernel.  The TPU kernel held
// a (256, F) slab of rows in VMEM.  Bound: bytes (each element is read
// once and written once for three flops).  Here TPR threads own a row
// (whole warps, or a power-of-two share of one for short rows; the
// caller picks TPR from F) and hold it in registers: thread t takes the
// 4-element chunks t, t + TPR, ... (at most kMaxChunks), read once as
// 16-byte vectors (8-byte for bf16) beside the same chunks of w, so x is
// read once and there is one trip to memory before the reduction.
// The sum of squares is taken in one fixed order (the thread's chunks in
// order, a warp shuffle butterfly, then the row's warps in order through
// shared memory, one barrier) and the scaled row is stored from
// registers.  A row whose pointer or F is not aligned to the vector size
// takes element loads and stores into the same registers, so its bits
// are the same.
#include "common.cuh"

namespace {

constexpr int kMaxChunks = 8;      // 4-element chunks a thread holds
constexpr int kMaxThreads = 512;

template <typename T>
__device__ __forceinline__ bool vec_aligned(const T* p, int f) {
  return f % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// Four elements of a row from global memory as fp32: one vector load, or
// element loads (zeros past f) for an unaligned or ragged chunk.
template <typename T>
__device__ __forceinline__ float4 load_chunk(const T* p, bool vec, int left) {
  if (vec) return repro_torch::load4(p);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = e < left ? repro_torch::load_f32(p[e]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* p, float4 o, bool vec,
                                            int left) {
  if (vec) {
    repro_torch::store4(p, o);
    return;
  }
  const float v[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < left) repro_torch::store_as(&p[e], v[e]);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int rows, int f, int tpr, float eps) {
  __shared__ float partial[kMaxThreads / 32];
  const int t = threadIdx.x % tpr;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / tpr) +
                      threadIdx.x / tpr;
  const bool live = row < rows;
  const int chunks = (f + 3) / 4;
  const T* xr = x + row * f;
  T* orow = out + row * f;
  const bool xvec = vec_aligned(xr, f), ovec = vec_aligned(orow, f);
  const bool wvec = vec_aligned(w, f);

  float4 v[kMaxChunks], wv[kMaxChunks];          // x and w, loaded together
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int c = t + j * tpr;
    const bool in = live && c < chunks;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    v[j] = in ? load_chunk(xr + 4 * c, xvec, f - 4 * c) : zero;
    wv[j] = in ? load_chunk(w + 4 * c, wvec, f - 4 * c) : zero;
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    ss = fmaf(v[j].x, v[j].x, ss);
    ss = fmaf(v[j].y, v[j].y, ss);
    ss = fmaf(v[j].z, v[j].z, ss);
    ss = fmaf(v[j].w, v[j].w, ss);
  }
  if (tpr <= 32) {                                // the row is in one warp
    ss = repro_torch::warp_sum(ss, tpr);
  } else {
    ss = repro_torch::warp_sum(ss);
    if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
    __syncthreads();
    const int w0 = (threadIdx.x / tpr) * (tpr / 32);
    ss = 0.f;
    for (int k = 0; k < tpr / 32; ++k) ss += partial[w0 + k];
  }
  const float r = 1.f / sqrtf(ss / f + eps);
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int c = t + j * tpr;
    if (!live || c >= chunks) break;
    const float4 o = make_float4(v[j].x * r * wv[j].x, v[j].y * r * wv[j].y,
                                 v[j].z * r * wv[j].z, v[j].w * r * wv[j].w);
    store_chunk(orow + 4 * c, o, ovec, f - 4 * c);
  }
}

// TPR threads a row: a power of two up to 32, or whole warps up to 512,
// with TPR * kMaxChunks * 4 >= f.  Blocks of whole rows, as many as make
// 128 threads when a row has fewer.
template <typename T>
int launch(const void* x, const void* w, void* out, int rows, int f,
           float eps, int tpr, void* stream) {
  const bool ok = tpr >= 1 && tpr <= kMaxThreads &&
                  (tpr <= 32 ? 32 % tpr == 0 : tpr % 32 == 0) &&
                  static_cast<int64_t>(tpr) * kMaxChunks * 4 >= f;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = tpr >= 128 ? 1 : 128 / tpr;
  const int threads = per_block * tpr;
  rmsnorm_kernel<T><<<(rows + per_block - 1) / per_block, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), rows, f, tpr, eps);
  return repro_torch::launch_status();
}

}  // namespace

extern "C" int repro_rmsnorm_f32(const void* x, const void* w, void* out,
                                 int rows, int f, float eps, int tpr,
                                 void* stream) {
  return launch<float>(x, w, out, rows, f, eps, tpr, stream);
}

extern "C" int repro_rmsnorm_bf16(const void* x, const void* w, void* out,
                                  int rows, int f, float eps, int tpr,
                                  void* stream) {
  return launch<__nv_bfloat16>(x, w, out, rows, f, eps, tpr, stream);
}
