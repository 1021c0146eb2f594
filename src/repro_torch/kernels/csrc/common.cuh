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
// over the `width` lanes (a power of two) of an aligned group of them.
// Unrolled and branch-free (a step past the width is taken and its result
// dropped), so that the butterflies of independent values interleave.
__device__ __forceinline__ float warp_sum(float v, int width = 32) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    const float t = __shfl_xor_sync(0xffffffffu, v, o);
    v = o < width ? v + t : v;
  }
  return v;
}
__device__ __forceinline__ float warp_max(float v, int width = 32) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    const float t = __shfl_xor_sync(0xffffffffu, v, o);
    v = o < width ? fmaxf(v, t) : v;
  }
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

// Four consecutive elements (shared or global memory) as fp32 in one load
// (16 bytes of fp32, 8 of bf16); p must be aligned to that size.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The inverse of load4: four fp32 values stored as 4 consecutive elements
// (16 bytes of fp32, 8 of bf16 rounded to nearest); p aligned to that.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Asynchronous global -> shared copies (cp.async): BYTES of 4, 8 or 16,
// both addresses aligned to BYTES.  A thread's copies since its last
// commit form one group; cp_async_wait<N>() returns once at most N of its
// groups are still in flight (a __syncthreads() then shows every
// thread's copies to the block).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(src), "n"(BYTES) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Bulk copies by the Tensor Memory Accelerator, completed on an mbarrier
// in shared memory.  One thread initialises the barrier for one arrival
// (mbar_init, then fence_mbar_init and a __syncthreads()); one thread
// arrives announcing the bytes the phase waits for (mbar_expect_tx), any
// thread starts copies that count against them (bulk_copy: BYTES a
// multiple of 16, both addresses 16-byte aligned) without waiting, and
// mbar_wait returns once the phase of the given parity is complete, that
// is, every byte has landed.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                  "r"(smem_addr(bar)) : "memory");
}
// A plain arrival (release: this thread's earlier writes are seen by the
// threads that wait on the phase).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void zero_as(float* p) { *p = 0.f; }
__device__ __forceinline__ void zero_as(__nv_bfloat16* p) {
  *p = __float2bfloat16(0.f);
}
// One element: fp32 as a 4-byte cp.async, bf16 (2 bytes, below the
// smallest cp.async) as a plain load and store.
__device__ __forceinline__ void copy_elem(float* dst, const float* src) {
  cp_async<4>(dst, src);
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src) {
  *dst = *src;
}

// Whether every row of a matrix at p with a row stride of ld elements
// starts on a VEC-element boundary (by default 4: 16 bytes of fp32, 8 of
// bf16), so that load_tile_full may copy it: decided from the pointer and
// the stride.
template <typename T, int VEC = 4>
__device__ __forceinline__ bool rows_aligned(const T* p, int64_t ld) {
  return reinterpret_cast<uintptr_t>(p) % (VEC * sizeof(T)) == 0 &&
         ld % VEC == 0;
}

// Start the copy of a ROWS x COLS tile of T that lies wholly inside the
// matrix, rows aligned (rows_aligned<T, VEC>): one cp.async per VEC
// elements (4 by default; at most 16 bytes) and no checks.  dst has a row
// stride of LDS elements, src one of ld.
template <typename T, int ROWS, int COLS, int LDS, int THREADS, int VEC = 4>
__device__ __forceinline__ void load_tile_full(T* dst, const T* src,
                                               int64_t ld, int tid) {
  static_assert(COLS % VEC == 0 && LDS % VEC == 0, "tiles in chunks of VEC");
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  static_assert(kBytes <= 16, "a cp.async moves at most 16 bytes");
  constexpr int kPerRow = COLS / VEC, kChunks = ROWS * kPerRow;
#pragma unroll
  for (int it = 0; it < (kChunks + THREADS - 1) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    if (kChunks % THREADS != 0 && i >= kChunks) break;
    const int r = i / kPerRow, c = (i % kPerRow) * VEC;
    cp_async<kBytes>(dst + r * LDS + c, src + r * ld + c);
  }
}

// Start the copy of a ROWS x COLS tile of T into shared memory (row stride
// LDS elements) from global memory at src (row stride ld elements), of
// which the first rows_valid rows and cols_valid columns exist; the rest
// of the tile is zeroed.  VEC elements (4 by default) go in one cp.async
// wherever the source address is aligned to their size, so the copy width
// follows the pointer and the row stride, never the number of rows;
// ragged and unaligned chunks go element by element.  The bits that land
// are the same either way, and the same as load_tile_full's.
template <typename T, int ROWS, int COLS, int LDS, int THREADS, int VEC = 4>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t ld,
                                          int rows_valid, int cols_valid,
                                          int tid) {
  static_assert(COLS % VEC == 0 && LDS % VEC == 0, "tiles in chunks of VEC");
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  static_assert(kBytes <= 16, "a cp.async moves at most 16 bytes");
  constexpr int kPerRow = COLS / VEC, kChunks = ROWS * kPerRow;
#pragma unroll
  for (int it = 0; it < (kChunks + THREADS - 1) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    if (kChunks % THREADS != 0 && i >= kChunks) break;
    const int r = i / kPerRow, c = (i % kPerRow) * VEC;
    T* d = dst + r * LDS + c;
    const T* s = src + r * ld + c;
    if (r < rows_valid && c + VEC <= cols_valid &&
        reinterpret_cast<uintptr_t>(s) % kBytes == 0) {
      cp_async<kBytes>(d, s);
      continue;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (r < rows_valid && c + e < cols_valid) copy_elem(d + e, s + e);
      else zero_as(d + e);
    }
  }
}

}  // namespace repro_torch
