// Shared helpers of the port's CUDA kernels.
//
// Every entry point is a plain C function: device pointers, int sizes and
// the caller's CUDA stream in, cudaGetLastError() out.  The Python
// wrappers (repro_torch/kernels/*.py) check types, shapes and devices
// before they call, allocate every output, and raise on a non-zero code.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace repro_torch {

// Index of a gathered row, or -1 when it lies outside h: an out-of-range
// neighbour index reads as a zero row instead of touching memory outside
// the table.  The sampler never emits one.
__device__ __forceinline__ int64_t gather_row(int idx, int n) {
  return (idx >= 0 && idx < n) ? static_cast<int64_t>(idx) : -1;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace repro_torch
