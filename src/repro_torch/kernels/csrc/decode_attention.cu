// Paged single-token attention, fp32, for sm_90a (one decode step):
// out[b,h,:] = softmax_j(q[b,h,:] . K[b,j,h/G,:] / sqrt(D)) @ V[b,:,h/G,:]
// over the positions j < lengths[b], where position j of sequence b lives
// in slot j % ps of physical page page_table[b, j / ps] of the
// (P, ps, Hkv, D) pools.
//
// Replaces repro/kernels/decode_attention.py::_decode_kernel.  The TPU
// kernel scalar-prefetched the page table so that its BlockSpec fetched
// page pt[b, p] while the previous one was in use, and carried (m, l, acc)
// across the sequential page axis of its grid.  Here one block owns one
// (batch, KV head) and its G query heads (G need not be a power of two)
// and walks that sequence's pages itself with an online softmax: it reads
// the page id, stages the page's K and V rows for its KV head in shared
// memory, scores them (one warp per (head, slot) pair, shuffle-reduced
// over D), updates the running max and sum, and accumulates P @ V.
// Pages at or past the sequence's end are never read, and slots past the
// end of the last page are masked, so the page table's padding (page 0,
// possibly another sequence's live page) is harmless.  Bound: bytes (the
// sequence's K and V rows are read once for 4*G*D flops per position);
// with B*Hkv blocks (32 at batch 4) most SMs idle, so splitting a
// sequence's pages over blocks is the next step.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ kp,
              const float* __restrict__ vp, const int* __restrict__ pt,
              const int* __restrict__ lengths, float* __restrict__ out,
              int n_pool, int ps, int hkv, int group, int d, int pp,
              float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [G][D]
  float* acc = qs + group * d;      // [G][D]
  float* ks = acc + group * d;      // [ps][D]
  float* vs = ks + ps * d;          // [ps][D]
  float* sc = vs + ps * d;          // [G][ps] scores, then probabilities
  float* m = sc + group * ps;       // [G]
  float* l = m + group;             // [G]
  float* alpha = l + group;         // [G]

  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gd = group * d;
  const int64_t qoff = (static_cast<int64_t>(b) * hkv + h) * gd;
  for (int i = tid; i < gd; i += kThreads) {
    qs[i] = q[qoff + i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m[g] = repro_torch::kNegInf;
    l[g] = 0.f;
  }

  const int len = lengths[b];
  const int n_pages = len > 0 ? min((len + ps - 1) / ps, pp) : 0;
  const int64_t slot_stride = static_cast<int64_t>(hkv) * d;
  for (int p = 0; p < n_pages; ++p) {
    const int page = pt[static_cast<int64_t>(b) * pp + p];
    const int valid = (page >= 0 && page < n_pool) ? min(ps, len - p * ps) : 0;
    const int64_t base = (static_cast<int64_t>(page) * ps) * slot_stride + h * d;
    __syncthreads();              // the previous page's readers are done
    for (int i = tid; i < ps * d; i += kThreads) {
      const int slot = i / d, dd = i % d;
      const bool in = slot < valid;
      ks[i] = in ? kp[base + slot * slot_stride + dd] : 0.f;
      vs[i] = in ? vp[base + slot * slot_stride + dd] : 0.f;
    }
    __syncthreads();
    for (int e = warp; e < group * ps; e += kWarps) {
      const int g = e / ps, slot = e % ps;
      float dot = 0.f;
      for (int dd = lane; dd < d; dd += 32)
        dot = fmaf(qs[g * d + dd], ks[slot * d + dd], dot);
      dot = repro_torch::warp_sum(dot);
      if (lane == 0) sc[e] = slot < valid ? dot * scale : repro_torch::kNegInf;
    }
    __syncthreads();
    for (int g = tid; g < group; g += kThreads) {
      float mx = repro_torch::kNegInf;
      for (int slot = 0; slot < ps; ++slot) mx = fmaxf(mx, sc[g * ps + slot]);
      const float m_new = fmaxf(m[g], mx);
      float sum = 0.f;
      for (int slot = 0; slot < ps; ++slot) {
        const float e = slot < valid ? expf(sc[g * ps + slot] - m_new) : 0.f;
        sc[g * ps + slot] = e;
        sum += e;
      }
      alpha[g] = expf(m[g] - m_new);
      l[g] = alpha[g] * l[g] + sum;
      m[g] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < gd; i += kThreads) {
      const int g = i / d, dd = i % d;
      float a = acc[i] * alpha[g];
      for (int slot = 0; slot < valid; ++slot)
        a = fmaf(sc[g * ps + slot], vs[slot * d + dd], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < gd; i += kThreads)
    out[qoff + i] = acc[i] / fmaxf(l[i / d], 1e-30f);
}

}  // namespace

extern "C" int repro_decode_attention_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, int b, int hkv,
    int group, int d, int n_pool, int ps, int pp, float scale,
    void* stream) {
  const size_t bytes =
      sizeof(float) * (2 * group * d + 2 * ps * d + group * ps + 3 * group);
  const int rc = repro_torch::allow_shared(decode_kernel, bytes);
  if (rc != 0) return rc;
  decode_kernel<<<b * hkv, kThreads, bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<float*>(out), n_pool, ps,
      hkv, group, d, pp, scale);
  return repro_torch::launch_status();
}
