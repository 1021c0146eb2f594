// SDDMM for sm_90a, the NGCF similarity term:
//   out[i,k,:] = h[nbr[i,k],:] * h[i,:] * mask[i,k]      shape (D,K,F), D <= N
//
// Replaces repro/kernels/sddmm.py::_sddmm_kernel.  Bound on the H100:
// bytes, and of those mostly the (D,K,F) output, written once (K times
// the gathered input).  The design:
//
//  * One warp a destination row, kWarps warps a block (768 blocks at the
//    3,072-row GNN layer; tools/torch_kernel_tiles.py times other counts).
//    The warp holds h[i] in registers as float4s, read once: up to
//    kChunks a lane, so wider rows go in column passes of 128 float4s and
//    the registers stay bounded.
//  * Each slot's index and mask are read once a warp, one slot a lane, and
//    shuffled; two slots at a time are gathered, so a lane keeps up to
//    2 x kChunks 16-byte loads in flight.
//  * The output goes out with streaming stores (st.global.cs): written once
//    and never read here, it should not evict the h rows the gathers want
//    to find in L2.
//  * Where F % 4 != 0 or h or out is not 16-byte aligned, lanes own single
//    floats with the same arithmetic.
//
// The products are rounded in the order sddmm_ref takes them, (g * d) * m,
// with no fused multiply-add, so the kernel matches it bit for bit; every
// element is computed on its own, so the warp layout never changes a bit.
#include "common.cuh"

namespace {

constexpr int kChunks = 4;             // column vectors a lane holds
constexpr int kWarps = 4;              // warps (destination rows) a block
constexpr unsigned kFull = 0xffffffffu;

template <int V>
struct Frag {
  float x[V];
};

template <int V>
__device__ __forceinline__ Frag<V> load_frag(const float* p) {
  Frag<V> r;
  if constexpr (V == 4) {
    const float4 t = repro_torch::load4(p);
    r.x[0] = t.x; r.x[1] = t.y; r.x[2] = t.z; r.x[3] = t.w;
  } else {
    r.x[0] = *p;
  }
  return r;
}

// (g * d) * m, each product rounded, stored past L2's keep-set.
template <int V>
__device__ __forceinline__ void store_product(float* p, const Frag<V>& g,
                                              const Frag<V>& dv, float m) {
  float x[V];
#pragma unroll
  for (int e = 0; e < V; ++e) x[e] = __fmul_rn(__fmul_rn(g.x[e], dv.x[e]), m);
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else {
    __stcs(p, x[0]);
  }
}

template <int V, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
sddmm_kernel(const float* __restrict__ h, const int* __restrict__ nbr,
             const float* __restrict__ mask, float* __restrict__ out,
             int n, int f, int d, int k) {
  const int lane = threadIdx.x % 32;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= d) return;                          // uniform in the warp
  const int units = f / V;                       // V = 4: F % 4 == 0
  const float* hd = h + row * f;
  for (int c0 = 0; c0 < units; c0 += 32 * kChunks) {
    Frag<V> dv[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = c0 + j * 32 + lane;
      dv[j] = c < units ? load_frag<V>(hd + c * V) : Frag<V>{};
    }
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int cnt = min(32, k - j0);
      const int idx = lane < cnt ? nbr[row * k + j0 + lane] : 0;
      const float m = lane < cnt ? mask[row * k + j0 + lane] : 0.f;
      for (int u = 0; u < cnt; u += 2) {
        const bool two = u + 1 < cnt;
        const int64_t src0 =
            repro_torch::gather_row(__shfl_sync(kFull, idx, u), n);
        const int64_t src1 =
            repro_torch::gather_row(__shfl_sync(kFull, idx, (u + 1) & 31), n);
        const float m0 = __shfl_sync(kFull, m, u);
        const float m1 = __shfl_sync(kFull, m, (u + 1) & 31);
        Frag<V> g0[kChunks], g1[kChunks];
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int c = c0 + j * 32 + lane;
          g0[j] = c < units && src0 >= 0 ? load_frag<V>(h + src0 * f + c * V)
                                         : Frag<V>{};
          g1[j] = c < units && two && src1 >= 0
                      ? load_frag<V>(h + src1 * f + c * V) : Frag<V>{};
        }
        float* o0 = out + (row * k + j0 + u) * f;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int c = c0 + j * 32 + lane;
          if (c >= units) continue;
          store_product<V>(o0 + c * V, g0[j], dv[j], m0);
          if (two) store_product<V>(o0 + f + c * V, g1[j], dv[j], m1);
        }
      }
    }
  }
}

template <int WARPS>
int launch(const void* h, const void* nbr, const void* mask, void* out,
           int n, int f, int d, int k, cudaStream_t s) {
  const auto blocks =
      static_cast<unsigned>((static_cast<int64_t>(d) + WARPS - 1) / WARPS);
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kernel = vec ? sddmm_kernel<4, WARPS> : sddmm_kernel<1, WARPS>;
  kernel<<<blocks, WARPS * 32, 0, s>>>(
      static_cast<const float*>(h), static_cast<const int*>(nbr),
      static_cast<const float*>(mask), static_cast<float*>(out), n, f, d, k);
  return repro_torch::launch_status();
}

}  // namespace

extern "C" int repro_sddmm_f32(const void* h, const void* nbr,
                               const void* mask, void* out, int n, int f,
                               int d, int k, void* stream) {
  return launch<kWarps>(h, nbr, mask, out, n, f, d, k,
                        static_cast<cudaStream_t>(stream));
}
