// Shared helpers of the port's CUDA kernels.
//
// Every entry point is a plain C function: device pointers, int sizes and
// the caller's CUDA stream in, cudaGetLastError() out.  The Python
// wrappers (repro_torch/kernels/*.py) check types, shapes and devices
// before they call, allocate every output, and raise on a non-zero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace repro_torch {

// Index of a gathered row, or -1 when it lies outside h: an out-of-range
// neighbour index reads as a zero row instead of touching memory outside
// the table.  The sampler never emits one.
__device__ __forceinline__ int64_t gather_row(int idx, int n) {
  return (idx >= 0 && idx < n) ? static_cast<int64_t>(idx) : -1;
}

// fp32 or bf16 storage, fp32 arithmetic: widen on load, round once on store.
__device__ __forceinline__ float load_f32(float x) { return x; }
__device__ __forceinline__ float load_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Sum and max over the lanes of a warp (every lane gets the result), or
// over the `width` lanes of an aligned group of them.
__device__ __forceinline__ float warp_sum(float v, int width = 32) {
  for (int o = width / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v, int width = 32) {
  for (int o = width / 2; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The score of a masked key, as in the reference kernels.
constexpr float kNegInf = -1e30f;

// Opt a kernel in to more than 48 KB of dynamic shared memory; returns a
// CUDA error code (0 when nothing had to be set).
template <typename Kernel>
inline int allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace repro_torch
