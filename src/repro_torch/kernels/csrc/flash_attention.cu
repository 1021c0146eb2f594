// Causal or full attention with an online softmax, fp32, for sm_90a:
// o[b,h,i,:] = softmax_j(q[b,h,i,:] . k[b,h/G,j,:] / sqrt(D)) @ v[b,h/G,:,:],
// with key j visible to query i when j < S and (not causal or j <= i).
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel.  The TPU grid
// walked key tiles in order and carried (m, l, acc) in VMEM scratch from
// one grid step to the next; blocks have no order, so one block owns one
// (batch*head, 64-query tile) and loops over the key tiles itself, up to
// the diagonal when causal, with the running state in registers.  GQA is
// by index (head h reads KV head h / G, G need not be a power of two):
// no repeated copy of K and V.  Ragged tails are masked, never padded.
//
// Layout: 256 threads as 16 x 16; thread (ty, tx) owns query rows
// 4*ty..4*ty+3, the score columns 2*tx, 2*tx+1 of each 32-key tile, and
// the output dims tx, tx+16, ... .  Q and the K/V tile sit in shared
// memory (rows padded by one float so the score loop is free of bank
// conflicts); the probabilities go through shared memory to the PV
// product.  The row max and sum are shuffles over the 16 lanes that share
// ty.  Every product is an fp32 FMA: no TF32, since the reference holds
// attention to 3e-5.  Bound at prefill shapes: operations (4*T*S*D/2
// flops per head against 67 TFLOP/s of fp32 FMA).
//
// q, k, v and o are addressed through (batch, head, seq) strides with the
// head dim contiguous, so the model's (B, T, H, D) activations are read
// and written in place.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // keys per tile
constexpr int kTX = 16;          // threads across a row
constexpr int kRows = kBQ / 16;  // query rows per thread (4)
constexpr int kCols = kBK / kTX; // score columns per thread (2)
constexpr int kThreads = 256;

struct Strides {
  int64_t b, h, t;
};

template <int D>
constexpr size_t shared_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int hq,
             int group, int t, int s, int causal, float scale, Strides qs_,
             Strides ks_, Strides vs_, Strides os_) {
  constexpr int kLd = D + 1;
  constexpr int kDims = D / kTX;  // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [kBQ][kLd]
  float* ks = qs + kBQ * kLd;       // [kBK][kLd]
  float* vs = ks + kBK * kLd;       // [kBK][D]
  float* ps = vs + kBK * D;         // [kBQ][kBK + 1]

  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq, kvh = h / group;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* kb = k + b * ks_.b + kvh * ks_.h;
  const float* vb = v + b * vs_.b + kvh * vs_.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[r * kLd + d] = q0 + r < t ? qb[(q0 + r) * qs_.t + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = repro_torch::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[i][j] = 0.f;
  }

  // causal: no key after the tile's last query row is visible
  const int kend = causal ? min(s, min(q0 + kBQ, t)) : s;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();              // Q stored; the last tile's readers done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const bool in = k0 + c < s;
      ks[c * kLd + d] = in ? kb[(k0 + c) * ks_.t + d] : 0.f;
      vs[c * D + d] = in ? vb[(k0 + c) * vs_.t + d] : 0.f;
    }
    __syncthreads();

    float sc[kRows][kCols] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx * kCols + j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty * kRows + i;
      bool vis[kCols];
      float mx = repro_torch::kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx * kCols + j;
        vis[j] = kp < s && (!causal || kp <= q0 + row);
        sc[i][j] = vis[j] ? sc[i][j] * scale : repro_torch::kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], repro_torch::warp_max(mx, kTX));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = vis[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[row * (kBK + 1) + tx * kCols + j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + repro_torch::warp_sum(sum, kTX);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[kDims];
#pragma unroll
      for (int j = 0; j < kDims; ++j) vv[j] = vs[c * D + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(ty * kRows + i) * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  float* ob = o + b * os_.b + h * os_.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * kRows + i;
    if (r >= t) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDims; ++j) ob[r * os_.t + tx + kTX * j] = acc[i][j] / denom;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int b,
           int hq, int hkv, int t, int s, int causal, float scale,
           const Strides& qs, const Strides& ks, const Strides& vs,
           const Strides& os, cudaStream_t stream) {
  constexpr size_t bytes = shared_bytes<D>();
  const int rc = repro_torch::allow_shared(flash_kernel<D>, bytes);
  if (rc != 0) return rc;
  const dim3 grid((t + kBQ - 1) / kBQ, b * hq);
  flash_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, hq, hq / hkv, t, s, causal, scale, qs, ks, vs, os);
  return repro_torch::launch_status();
}

}  // namespace

// Head dims with a compiled kernel; any other D is refused (error code 1,
// cudaErrorInvalidValue) and the wrapper checks the set first.
extern "C" int repro_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int b, int hq,
    int hkv, int t, int s, int d, int causal, float scale, int64_t qsb,
    int64_t qsh, int64_t qst, int64_t ksb, int64_t ksh, int64_t kst,
    int64_t vsb, int64_t vsh, int64_t vst, int64_t osb, int64_t osh,
    int64_t ost, void* stream) {
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst},
      os{osb, osh, ost};
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(qp, kp, vp, op, b, hq, hkv, t, s, causal, scale, qs, ks, vs, os, st);
    case 32: return launch<32>(qp, kp, vp, op, b, hq, hkv, t, s, causal, scale, qs, ks, vs, os, st);
    case 64: return launch<64>(qp, kp, vp, op, b, hq, hkv, t, s, causal, scale, qs, ks, vs, os, st);
    case 128: return launch<128>(qp, kp, vp, op, b, hq, hkv, t, s, causal, scale, qs, ks, vs, os, st);
    case 256: return launch<256>(qp, kp, vp, op, b, hq, hkv, t, s, causal, scale, qs, ks, vs, os, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
