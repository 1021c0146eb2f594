// ELL/page-format SpMM for sm_90a: out[i,:] = sum_k mask[i,k] * h[nbr[i,k],:]
// (divided by max(sum_k mask[i,k], 1) in mean mode).
//
// Replaces repro/kernels/spmm.py::_spmm_kernel.  Bound on the H100: bytes
// (K gathered rows of h for every output row, 2K flops an element, far
// under the fp32 ridge), so the kernel's job is to keep enough gathers in
// flight and to spend no lane, load or index read it does not need:
//
//  * A thread owns one vector of V consecutive floats of one output row
//    (V = 4, 2 or 1: the wrapper picks it from F and D, narrowed to what
//    h's alignment allows; 2 where float4s would leave the card mostly
//    idle, so that twice the threads have their gathers in flight), and
//    the threads are laid flat over (row, vector), kThreads a block: a
//    row's F / V vectors run on into the next row's, so whole warps are
//    busy whatever F is (F = 420 is 105 float4s a row; no slice of a row
//    runs a partly empty warp).
//  * A thread reads its row's indices and masks SLOTS slots at a time
//    (broadcasts from L1: a warp's lanes share one or two rows' slots) and
//    issues all SLOTS gathers, one V-float load each, before it sums them;
//    then the next SLOTS.  Five slots a round (two rounds at the sampler's
//    K = 10) take 40 registers, so an SM holds 48 warps; all ten at once
//    take 72 registers and 28 warps, about the same gathers in flight
//    with fewer warps to cover the index loads and sums, and are 8-13 %
//    slower at the 3,072-row layer (tools/torch_kernel_tiles.py spmm).
//  * The sum runs in slot order with each product and sum rounded on its
//    own (no fused multiply-add), and mean mode divides once with IEEE
//    rounding: exactly what spmm_ref computes, so the kernel matches it
//    bit for bit at every V and block size, and a row's result never
//    depends on the rows launched with it.  Masked slots are multiplied,
//    never skipped (the sampler points them at row 0, which stays in L1),
//    and an index outside [0, N) reads as a zero row.
//  * The output goes out as one V-float store a thread.
#include "common.cuh"

namespace {

constexpr int kSlots = 5;              // gathers a thread issues before summing
constexpr int kThreads = 128;          // threads a block

// V consecutive floats of one thread.
template <int V>
struct Vec {
  float x[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load_vec(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 t = repro_torch::load4(p);
    r.x[0] = t.x; r.x[1] = t.y; r.x[2] = t.z; r.x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r.x[0] = t.x; r.x[1] = t.y;
  } else {
    r.x[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const Vec<V>& v) {
  if constexpr (V == 4) {
    repro_torch::store4(p, make_float4(v.x[0], v.x[1], v.x[2], v.x[3]));
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v.x[0], v.x[1]);
  } else {
    *p = v.x[0];
  }
}

// items = D * (F / V) vectors, one a thread.
template <int V, int SLOTS, int THREADS>
__global__ void __launch_bounds__(THREADS)
spmm_kernel(const float* __restrict__ h, const int* __restrict__ nbr,
            const float* __restrict__ mask, float* __restrict__ out,
            int n, int f, int64_t items, int k, int mean) {
  const int64_t item =
      static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (item >= items) return;
  const int units = f / V;
  const int64_t row = item / units;
  const int col = static_cast<int>(item - row * units) * V;
  const int* nrow = nbr + row * k;
  const float* mrow = mask + row * k;
  Vec<V> acc = {};
  float deg = 0.f;
  for (int j0 = 0; j0 < k; j0 += SLOTS) {
    Vec<V> v[SLOTS];
    float m[SLOTS];
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      const bool live = j0 + u < k;
      const int64_t src =
          live ? repro_torch::gather_row(nrow[j0 + u], n) : -1;
      m[u] = live ? mrow[j0 + u] : 0.f;
      v[u] = src >= 0 ? load_vec<V>(h + src * f + col) : Vec<V>{};
    }
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      if (j0 + u >= k) break;
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc.x[e] = __fadd_rn(acc.x[e], __fmul_rn(v[u].x[e], m[u]));
      deg = __fadd_rn(deg, m[u]);
    }
  }
  if (mean) {
    const float div = fmaxf(deg, 1.f);
#pragma unroll
    for (int e = 0; e < V; ++e) acc.x[e] = __fdiv_rn(acc.x[e], div);
  }
  store_vec<V>(out + row * f + col, acc);
}

template <int V, int SLOTS, int THREADS>
int launch(const void* h, const void* nbr, const void* mask, void* out,
           int n, int f, int d, int k, int mean, cudaStream_t s) {
  if (f % V != 0 || reinterpret_cast<uintptr_t>(h) % (4 * V) != 0 ||
      reinterpret_cast<uintptr_t>(out) % (4 * V) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t items = static_cast<int64_t>(d) * (f / V);
  if (items == 0) return 0;
  const auto blocks = static_cast<unsigned>((items + THREADS - 1) / THREADS);
  spmm_kernel<V, SLOTS, THREADS><<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(h), static_cast<const int*>(nbr),
      static_cast<const float*>(mask), static_cast<float*>(out), n, f, items,
      k, mean);
  return repro_torch::launch_status();
}

}  // namespace

// width: floats a thread (4, 2 or 1; F a multiple of it, h and out aligned
// to it), picked by kernels/spmm.py::spmm_width.  Anything else returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int repro_spmm_f32(const void* h, const void* nbr,
                              const void* mask, void* out, int n, int f,
                              int d, int k, int mean, int width,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 4:
      return launch<4, kSlots, kThreads>(h, nbr, mask, out, n, f, d, k, mean,
                                         s);
    case 2:
      return launch<2, kSlots, kThreads>(h, nbr, mask, out, n, f, d, k, mean,
                                         s);
    case 1:
      return launch<1, kSlots, kThreads>(h, nbr, mask, out, n, f, d, k, mean,
                                         s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
