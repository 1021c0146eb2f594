// Paged single-token attention, for sm_90a (one decode step), on fp32 or
// bf16 q and pages (fp32 arithmetic, the output in q's type):
// out[b,h,:] = softmax_j(q[b,h,:] . K[b,j,h/G,:] / sqrt(D)) @ V[b,:,h/G,:]
// over the positions j < lengths[b], where position j of sequence b lives
// in slot j % ps of physical page page_table[b, j / ps] of the
// (P, ps, Hkv, D) pools.
//
// Replaces repro/kernels/decode_attention.py::_decode_kernel.  The TPU
// kernel scalar-prefetched the page table so that its BlockSpec fetched
// page pt[b, p] while the previous one was in use, and carried (m, l, acc)
// across the sequential page axis of its grid.  Bound: bytes (each of
// the sequence's K and V rows is read once for 4*G*D flops a position),
// so the card needs megabytes of loads in flight; one block per
// (batch, KV head) walking its pages gives 32 blocks at batch 4 and
// leaves the kernel latency-bound.  So the sequence's pages are split
// over blocks (flash-decoding), in two kernels launched together:
//
// * decode_split_kernel, grid (B*Hkv*ceil(G/GT), n_split): a block owns
//   split s of a sequence, positions [s*SL, (s+1)*SL) with SL = pps*ps,
//   for one KV head and up to GT of its query heads.  It reads the
//   sequence's length on the device and exits if the split lies past the
//   end; else it loads the split's page ids and its heads' q (coalesced,
//   into shared memory, then into registers), then starts
//   the copy of all its K rows and then all its V rows into shared
//   memory: one TMA bulk copy a row, counted on an mbarrier for K and one
//   for V, where every row is 16-byte aligned (4-byte cp.async where not,
//   the same bits landing).  No thread waits on a copy it starts, and
//   the scores run as soon as K is in, while V is still landing.  Scores:
//   LPS lanes a key slot, each holding up to 16 floats of every head's q
//   in registers, shuffle-reduced within the group, without branches;
//   softmax: one warp a head; P @ V: threads over (slot group, 4
//   columns), summed over the groups in a fixed order.  It writes
//   (m, l, acc[D]) for each head to the workspace.
// * decode_combine_kernel, one block a (batch, query head): reads the
//   sequence's length and every used split's (m, l) at once, then merges
//   the splits in split order and writes acc / l (zeros for a sequence
//   with no position, as the TPU kernel's flush gives).
//
// The partial entries (repro_decode_attention_partial_*) compute, for a
// slot's block of a sequence-split cache, what a merge across slots needs:
// acc / l in fp32 (not rounded to q's type) and lse = m + log(l), the
// log-sum-exp of the scaled scores; a sequence with no position gives
// zeros and -inf.  A slot holds a short block (3 to 128 positions on the
// split serving step), where two launches of a few microseconds each, and
// the 32 to 64 blocks that 64-position splits give, leave the card idle.
// So the wrapper gives the partial its own, shorter split (16 positions)
// and, where a sequence's splits number at most a cluster's blocks, runs
// them in ONE launch:
//
// * decode_cluster_kernel, the same grid, cluster (1, n_split, 1), at
//   most 8 splits: the splits of one (sequence, KV head, head chunk) are
//   one thread-block cluster.  Each block runs the split kernel's body and
//   writes its (m, l, acc[D]) for each head through distributed shared
//   memory straight into slot s of block 0's shared memory (a block past
//   the sequence's end takes part with m = -inf and l = 0); after one
//   cluster barrier the other blocks exit and block 0 merges the used
//   splits with the combine kernel's arithmetic in its order: the max,
//   exp(m_s - mx), the fmaf chains over s in split order, a / max(l,
//   1e-30), lse = mx + log(l).  No workspace, no second kernel, and the
//   same bits as the two kernels.  At these sizes every step is latency
//   (one warp a scheduler, each step waiting on the last), so q is read
//   once by the block, coalesced, while the length and the page ids are
//   in flight; pages of a power-of-two size take shifts; and the split's
//   final sums and the merge keep four outputs a thread in flight.
//
// Where a call has more splits than a cluster holds (long blocks in long
// mode), the partial runs the split and combine kernels at its split.
//
// Split boundaries sit at multiples of SL, which depends on the pools'
// ps, D and element size only, and the merge order is fixed: a
// sequence's output bits do not depend on the batch it rides in, on the
// page table's padded width, or on the path.  Pages past the sequence's
// end are never read; a page id outside the pool masks its slots.
//
// bf16 pools (the dense LM path's caches, viewed as pages) stay bf16 in
// shared memory: a row is D * 2 bytes, a bulk copy where that is a
// multiple of 16 (D % 8 == 0), rows padded to 8 elements; q widens to
// fp32 as it is loaded into registers, each K and V load widens 4
// elements, and the combine rounds the output once, to nearest.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneChunks = 4;     // 4-element chunks of q a lane holds a head
constexpr int kMaxCluster = 8;     // splits a cluster: the portable limit

// Positions of sequence b that the page table can hold.
__device__ __forceinline__ int visible(const int* lengths, int b, int cap) {
  return min(max(lengths[b], 0), cap);
}

// Elements of a shared-memory row of T: D rounded up to 16 bytes.
template <typename T>
__host__ __device__ __forceinline__ int row_elems(int d) {
  constexpr int v = 16 / sizeof(T);
  return (d + v - 1) / v * v;
}

// Bytes of shared memory below the V rows: the split's K rows, which the
// fp32 P @ V partials of every slot group reuse once the scores are taken.
template <typename T>
__host__ __device__ __forceinline__ int k_region(int sl, int lds, int gt) {
  const int rows = sl * lds * static_cast<int>(sizeof(T));
  const int partials =
      (kThreads / (lds / 4)) * gt * lds * static_cast<int>(sizeof(float));
  return rows > partials ? rows : partials;
}

// Bytes of a split's shared memory: K rows (or the P @ V partials), V
// rows, the heads' q, their scores and the page ids; the cluster kernel
// keeps its slots above them, from the next 16 bytes.
template <typename T, int GT>
__host__ __device__ __forceinline__ int split_bytes(int sl, int lds, int pps) {
  const int used = k_region<T>(sl, lds, GT) +
                   static_cast<int>(sizeof(T)) * (sl + GT) * lds +
                   static_cast<int>(sizeof(float)) * GT * sl +
                   static_cast<int>(sizeof(int)) * pps;
  return (used + 15) / 16 * 16;
}

// The block's place: sequence b, KV head h, query heads [g0, g0 + gn) of
// its group, split s (from blockIdx); then (fetch) the page id thread
// t < pps loads, and nv, the split's positions below the sequence's
// length (<= 0 past its end).
struct Split {
  int b, h, g0, gn, s, page, nv;
};

template <int GT>
__device__ __forceinline__ Split place(int hkv, int group) {
  const int n_hc = (group + GT - 1) / GT;
  const int bh = blockIdx.x / n_hc, hc = blockIdx.x % n_hc;
  Split x;
  x.b = bh / hkv;
  x.h = bh % hkv;
  x.s = blockIdx.y;
  x.g0 = hc * GT;
  x.gn = min(GT, group - x.g0);
  return x;
}

// The length and the split's page ids, loaded together.
__device__ __forceinline__ void fetch(Split& x, const int* pt,
                                      const int* lengths, int ps, int pp,
                                      int pps) {
  const int p = x.s * pps + threadIdx.x;
  x.page = (threadIdx.x < pps && p < pp)
      ? pt[static_cast<int64_t>(x.b) * pp + p] : -1;
  x.nv = min(visible(lengths, x.b, pp * ps) - x.s * pps * ps, pps * ps);
}

// Position i's page and slot in pages of ps slots: shifts where ps is a
// power of two (shift = log2(ps)), else a division (shift = -1).
__device__ __forceinline__ int page_of(int i, int ps, int shift) {
  return shift >= 0 ? i >> shift : i / ps;
}
__device__ __forceinline__ int slot_of(int i, int ps, int shift) {
  return shift >= 0 ? i & (ps - 1) : i % ps;
}

// q of the block's heads into shared memory, [GT][lds] of T (zero past D
// and past gn), read by the block once and coalesced: 16-byte loads where
// q's rows are aligned to them, element by element where not (the same
// values land).  Issued behind the length and the page ids, so that the
// three reads are in flight together.
template <typename T, int GT>
__device__ __forceinline__ void stage_q(T* qs, const T* __restrict__ q,
                                        const Split& x, int hkv, int group,
                                        int d) {
  constexpr int kPer = 16 / sizeof(T);
  const int lds = row_elems<T>(d), per_row = lds / kPer;
  const T* qb =
      q + (static_cast<int64_t>(x.b) * hkv * group + x.h * group + x.g0) * d;
  const bool whole =
      d % kPer == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  for (int i = threadIdx.x; i < GT * per_row; i += kThreads) {
    const int g = i / per_row, c = (i - g * per_row) * kPer;
    T* dst = qs + g * lds + c;
    if (whole) {
      *reinterpret_cast<uint4*>(dst) =
          g < x.gn ? *reinterpret_cast<const uint4*>(qb + g * d + c)
                   : make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    for (int e = 0; e < kPer; ++e) {
      if (g < x.gn && c + e < d) dst[e] = qb[g * d + c + e];
      else repro_torch::zero_as(dst + e);
    }
  }
}

// Where stage_q puts q: above the V rows.
template <typename T, int GT>
__device__ __forceinline__ T* q_stage(unsigned char* smem, int sl, int lds) {
  return reinterpret_cast<T*>(smem + k_region<T>(sl, lds, GT)) + sl * lds;
}

// One split's partial for the block's heads, from a block with x.nv > 0
// whose q is staged (stage_q, before a barrier): head g's m and l at
// part[g * stride] and part[g * stride + 1], its acc[D] from
// part[g * stride + 2] (global memory, or any block's shared memory).
template <typename T, int GT>
__device__ __forceinline__ void split_partial(
    const T* __restrict__ kp, const T* __restrict__ vp, unsigned char* smem,
    uint64_t* landed, const Split& x, float* part, int64_t stride,
    int n_pool, int ps, int hkv, int d, int pps, int lps, float scale) {
  const int sl = pps * ps, lds = row_elems<T>(d), chunks = lds / 4;
  T* ks = reinterpret_cast<T*>(smem);             // [sl][lds]
  T* vs = reinterpret_cast<T*>(smem + k_region<T>(sl, lds, GT));  // [sl][lds]
  T* qs = q_stage<T, GT>(smem, sl, lds);          // [GT][lds]
  float* sc = reinterpret_cast<float*>(qs + GT * lds);            // [GT][sl]
  int* pg = reinterpret_cast<int*>(sc + GT * sl);  // [pps] page ids
  const int shift = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = x.h, gn = x.gn, nv = x.nv, page = x.page;
  const bool live_page = page >= 0 && page < n_pool;
  if (tid < pps) pg[tid] = live_page ? page : -1;
  // rows go by TMA bulk copies where every row is 16-byte aligned, else
  // by 4-byte cp.async; the bulk path's barriers wait for the live rows
  const bool bulk = (d * sizeof(T)) % 16 == 0 && pps <= 32 &&
                    reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  if (bulk && warp == 0) {
    const int rows = __reduce_add_sync(
        0xffffffffu, (tid < pps && live_page) ? min(max(nv - tid * ps, 0), ps)
                                              : 0);
    if (lane == 0) {
      const unsigned bytes = static_cast<unsigned>(rows) * d * sizeof(T);
      repro_torch::mbar_init(&landed[0], 1);
      repro_torch::mbar_init(&landed[1], 1);
      repro_torch::fence_mbar_init();
      repro_torch::mbar_expect_tx(&landed[0], bytes);
      repro_torch::mbar_expect_tx(&landed[1], bytes);
    }
  }

  const int sub = lane & (lps - 1);
  __syncthreads();

  // start the copies of the K and V rows; a masked page's rows are zeros
  // (finite, so P @ V's zero weights keep them out)
  const int64_t slot_stride = static_cast<int64_t>(hkv) * d;
  // TMA: a thread a row, row i on warp i % 4 (each warp issues its lanes'
  // copies one after another), all K rows before any V row, so that K
  // lands first and the scores overlap V's copy
#pragma unroll
  for (int half = 0; bulk && half < 2; ++half) {
    const T* src = (half ? vp : kp) + static_cast<int64_t>(h) * d;
    T* dst = half ? vs : ks;
    for (int i = lane * kWarps + warp; i < nv; i += kThreads) {
      const int pid = pg[page_of(i, ps, shift)];
      if (pid >= 0) {
        repro_torch::bulk_copy(
            dst + i * lds,
            src + (static_cast<int64_t>(pid) * ps + slot_of(i, ps, shift)) *
                      slot_stride,
            d * sizeof(T), &landed[half]);
      } else {
        for (int e = 0; e < d; e += 4)
          repro_torch::store4(dst + i * lds + e,
                              make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
    if (half == 0) __syncthreads();               // every K copy queued
  }
  for (int half = 0; !bulk && half < 2; ++half) {      // a warp a row
    const T* src = (half ? vp : kp) + static_cast<int64_t>(h) * d;
    T* dst = half ? vs : ks;
    for (int i = warp; i < nv; i += kWarps) {
      T* drow = dst + i * lds;
      const int pid = pg[page_of(i, ps, shift)];
      const T* srow =
          src + (static_cast<int64_t>(pid) * ps + slot_of(i, ps, shift)) *
                    slot_stride;
      for (int e = lane; e < lds; e += 32) {
        if (pid >= 0 && e < d) repro_torch::copy_elem(drow + e, srow + e);
        else repro_torch::zero_as(drow + e);
      }
    }
    repro_torch::cp_async_commit();               // K, then V: two groups
  }

  // q of the block's heads into registers while the rows land: lane
  // `sub` of a slot's group holds chunks sub, sub + LPS, ... (zero past D)
  float4 qr[GT][kLaneChunks];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int j = 0; j < kLaneChunks; ++j) {
      const int c = sub + lps * j;
      qr[g][j] = c < chunks ? repro_torch::load4(qs + g * lds + 4 * c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (bulk) repro_torch::mbar_wait(&landed[0], 0);
  else repro_torch::cp_async_wait<1>();
  __syncthreads();                                // K rows are in

  // scores: each warp takes 32 / LPS slots, twice, a step (independent
  // chains); no branches: a slot past the end reads the last row and its
  // score is dropped, a chunk past D reads chunk 0 against a zero q
  const int per_warp = 32 / lps, step = kWarps * per_warp;
  for (int base = warp * per_warp; base < nv; base += 2 * step) {
    const int i0 = base + lane / lps;
    float dot[2][GT];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const T* krow = ks + min(i0 + u * step, nv - 1) * lds;
#pragma unroll
      for (int g = 0; g < GT; ++g) dot[u][g] = 0.f;
#pragma unroll
      for (int j = 0; j < kLaneChunks; ++j) {
        const int c = sub + lps * j;
        const float4 k4 = repro_torch::load4(krow + 4 * (c < chunks ? c : 0));
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          dot[u][g] = fmaf(qr[g][j].x, k4.x, dot[u][g]);
          dot[u][g] = fmaf(qr[g][j].y, k4.y, dot[u][g]);
          dot[u][g] = fmaf(qr[g][j].z, k4.z, dot[u][g]);
          dot[u][g] = fmaf(qr[g][j].w, k4.w, dot[u][g]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int g = 0; g < GT; ++g)
        dot[u][g] = repro_torch::warp_sum(dot[u][g], lps);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * step;
      if (sub == 0 && i < nv) {
        const bool live = pg[page_of(i, ps, shift)] >= 0;
#pragma unroll
        for (int g = 0; g < GT; ++g)
          if (g < gn)
            sc[g * sl + i] = live ? dot[u][g] * scale : repro_torch::kNegInf;
      }
    }
  }
  if (bulk) repro_torch::mbar_wait(&landed[1], 0);
  else repro_torch::cp_async_wait<0>();
  __syncthreads();                                // V rows, every score

  // softmax over the split, one warp a head; (m, l) to the partial
  for (int g = warp; g < gn; g += kWarps) {
    float* sg = sc + g * sl;
    float mx = repro_torch::kNegInf;
    for (int i = lane; i < nv; i += 32) mx = fmaxf(mx, sg[i]);
    mx = repro_torch::warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < nv; i += 32) {
      const float e =
          pg[page_of(i, ps, shift)] >= 0 ? expf(sg[i] - mx) : 0.f;
      sg[i] = e;
      sum += e;
    }
    sum = repro_torch::warp_sum(sum);
    if (lane == 0) {
      part[g * stride] = mx;
      part[g * stride + 1] = sum;
    }
  }
  __syncthreads();

  // P @ V: thread (grp, c) sums slots grp, grp + n_grp, ... of column
  // chunk c; the groups' partials go through shared memory (the K rows'
  // space) and are summed in group order
  const int n_grp = kThreads / chunks;
  const int c = tid % chunks, grp = tid / chunks;
  float4 acc[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (grp < n_grp) {
#pragma unroll 4
    for (int i = grp; i < nv; i += n_grp) {
      const float4 v4 = repro_torch::load4(vs + i * lds + 4 * c);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float pr = sc[g * sl + i];         // rows past gn: unused
        acc[g].x = fmaf(pr, v4.x, acc[g].x);
        acc[g].y = fmaf(pr, v4.y, acc[g].y);
        acc[g].z = fmaf(pr, v4.z, acc[g].z);
        acc[g].w = fmaf(pr, v4.w, acc[g].w);
      }
    }
    float* red = reinterpret_cast<float*>(smem);  // [n_grp][GT][lds]
#pragma unroll
    for (int g = 0; g < GT; ++g)
      *reinterpret_cast<float4*>(red + (grp * GT + g) * lds + 4 * c) = acc[g];
  }
  __syncthreads();
  // the groups' partials summed in group order, four outputs a thread at
  // a time (independent chains)
  const float* red = reinterpret_cast<const float*>(smem);
  const int n = gn * d;
  for (int base = tid; base < n; base += 4 * kThreads) {
    float a[4];
    int ge[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = min(base + u * kThreads, n - 1);
      ge[u][0] = idx / d;
      ge[u][1] = idx - ge[u][0] * d;
      a[u] = 0.f;
    }
    for (int r = 0; r < n_grp; ++r) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[u] += red[(r * GT + ge[u][0]) * lds + ge[u][1]];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (base + u * kThreads < n)
        part[ge[u][0] * stride + 2 + ge[u][1]] = a[u];
  }
}

template <typename T, int GT>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ pt,
                    const int* __restrict__ lengths, float* __restrict__ ws,
                    int n_pool, int ps, int hkv, int group, int d, int pp,
                    int pps, int n_split, int lps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t landed[2];                  // K rows, V rows (TMA)
  Split x = place<GT>(hkv, group);
  fetch(x, pt, lengths, ps, pp, pps);
  stage_q<T, GT>(q_stage<T, GT>(smem, pps * ps, row_elems<T>(d)), q, x, hkv,
                 group, d);
  if (x.nv <= 0) return;                          // past the end: no output
  const int64_t head0 =
      static_cast<int64_t>(x.b) * hkv * group + x.h * group + x.g0;
  split_partial<T, GT>(kp, vp, smem, landed, x,
                       ws + (head0 * n_split + x.s) * (d + 2),
                       static_cast<int64_t>(n_split) * (d + 2), n_pool, ps,
                       hkv, d, pps, lps, scale);
}

template <typename O, bool kLse>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ ws,
                      const int* __restrict__ lengths, O* __restrict__ out,
                      float* __restrict__ lse, int hq, int d, int cap, int sl,
                      int n_split) {
  extern __shared__ float ml[];                   // [2][used]: m then l
  const int bq = blockIdx.x;                      // b * Hq + query head
  const int used = (visible(lengths, bq / hq, cap) + sl - 1) / sl;
  const float* w = ws + static_cast<int64_t>(bq) * n_split * (d + 2);
  for (int s = threadIdx.x; s < used; s += kThreads) {  // all loads at once
    ml[s] = w[s * (d + 2)];
    ml[used + s] = w[s * (d + 2) + 1];
  }
  __syncthreads();
  float mx = repro_torch::kNegInf;
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, ml[s]);
  __syncthreads();                                // every m read: weights
  for (int s = threadIdx.x; s < used; s += kThreads) ml[s] = expf(ml[s] - mx);
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < used; ++s) l = fmaf(ml[s], ml[used + s], l);
  if (kLse && threadIdx.x == 0)                   // -inf where nothing is seen
    lse[bq] = l > 0.f ? mx + logf(l) : -__int_as_float(0x7f800000);
  for (int e = threadIdx.x; e < d; e += kThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < used; ++s) a = fmaf(ml[s], w[s * (d + 2) + 2 + e], a);
    repro_torch::store_as(out + static_cast<int64_t>(bq) * d + e,
                          a / fmaxf(l, 1e-30f));
  }
}

// The partial in one launch: the grid of decode_split_kernel, its splits
// of a (sequence, KV head, head chunk) one cluster of n_split blocks (at
// most kMaxCluster).  Each block writes its split's partial straight into
// block 0's shared memory (slot s of its [n_split][GT][D + 2] slots), then
// one cluster barrier, then block 0 merges them (see the header).  Every
// block announces at its start that it runs, and waits for the others'
// announcements before its first write into block 0.
template <typename T, int GT>
__global__ void __launch_bounds__(kThreads)
decode_cluster_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                      const T* __restrict__ vp, const int* __restrict__ pt,
                      const int* __restrict__ lengths,
                      float* __restrict__ out, float* __restrict__ lse,
                      int n_pool, int ps, int hkv, int group, int d, int pp,
                      int pps, int lps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t landed[2];                  // K rows, V rows (TMA)
  __shared__ float wt[GT][kMaxCluster];           // exp(m_s - mx) a head
  __shared__ float den[GT];                       // l a head
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int sl = pps * ps, lds = row_elems<T>(d), stride = d + 2;
  float* slots = reinterpret_cast<float*>(        // [n_split][GT][d + 2]
      smem + split_bytes<T, GT>(sl, lds, pps));
  Split x = place<GT>(hkv, group);
  fetch(x, pt, lengths, ps, pp, pps);
  stage_q<T, GT>(q_stage<T, GT>(smem, sl, lds), q, x, hkv, group, d);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* part = cluster.map_shared_rank(slots, 0) + x.s * GT * stride;
  if (x.nv > 0) {
    split_partial<T, GT>(kp, vp, smem, landed, x, part, stride, n_pool, ps,
                         hkv, d, pps, lps, scale);
  } else if (threadIdx.x < GT) {                  // past the end: empty
    part[threadIdx.x * stride] = -__int_as_float(0x7f800000);
    part[threadIdx.x * stride + 1] = 0.f;
  }
  cluster.sync();                                 // every split's partial
  if (x.s != 0) return;

  // block 0: the used splits merged in split order with
  // decode_combine_kernel's arithmetic; a thread a head first: the max,
  // the weights exp(m_s - mx), the fmaf chain of l, lse
  const int used = (visible(lengths, x.b, pp * ps) + sl - 1) / sl;
  const int64_t head0 =
      static_cast<int64_t>(x.b) * hkv * group + x.h * group + x.g0;
  if (threadIdx.x < x.gn) {
    const float* ml = slots + threadIdx.x * stride;   // split 0's m, l
    const int g = threadIdx.x, step = GT * stride;
    float mx = repro_torch::kNegInf;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s)
      if (s < used) mx = fmaxf(mx, ml[s * step]);
    float l = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      if (s < used) {
        wt[g][s] = expf(ml[s * step] - mx);
        l = fmaf(wt[g][s], ml[s * step + 1], l);
      }
    }
    den[g] = l;                                   // -inf where nothing is seen
    lse[head0 + g] = l > 0.f ? mx + logf(l) : -__int_as_float(0x7f800000);
  }
  __syncthreads();
  // then the outputs, four a thread at a time (independent chains)
  const int n = x.gn * d;
  for (int base = threadIdx.x; base < n; base += 4 * kThreads) {
    float a[4];
    int ge[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = min(base + u * kThreads, n - 1);
      ge[u][0] = idx / d;
      ge[u][1] = idx - ge[u][0] * d;
      a[u] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      if (s < used) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          a[u] = fmaf(wt[ge[u][0]][s],
                      slots[(s * GT + ge[u][0]) * stride + 2 + ge[u][1]],
                      a[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (base + u * kThreads < n)
        out[head0 * d + base + u * kThreads] =
            a[u] / fmaxf(den[ge[u][0]], 1e-30f);
  }
}

template <typename O, bool kLse>
int combine(const void* lengths, void* out, float* lse, const float* ws,
            int rows, int hq, int d, int cap, int sl, int n_split,
            cudaStream_t stream) {
  const size_t ml_bytes = sizeof(float) * 2 * n_split;
  const int rc = repro_torch::allow_shared(decode_combine_kernel<O, kLse>,
                                           ml_bytes);
  if (rc != 0) return rc;
  decode_combine_kernel<O, kLse><<<rows, kThreads, ml_bytes, stream>>>(
      ws, static_cast<const int*>(lengths), static_cast<O*>(out), lse, hq, d,
      cap, sl, n_split);
  return repro_torch::launch_status();
}

// decode_cluster_kernel: one launch, cluster (1, n_split, 1).
template <typename T, int GT>
int launch_cluster(const T* q, const T* k_pages, const T* v_pages,
                   const int* page_table, const int* lengths, float* out,
                   float* lse, int b, int hkv, int group, int d, int n_pool,
                   int ps, int pp, int pps, int n_split, int lps, float scale,
                   cudaStream_t stream) {
  const auto kernel = decode_cluster_kernel<T, GT>;
  const size_t bytes = split_bytes<T, GT>(pps * ps, row_elems<T>(d), pps) +
                       sizeof(float) * n_split * GT * (d + 2);
  int rc = repro_torch::allow_shared(kernel, bytes);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_split;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * hkv * ((group + GT - 1) / GT), n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, q, k_pages, v_pages, page_table, lengths, out, lse,
      n_pool, ps, hkv, group, d, pp, pps, lps, scale));
  if (rc != 0) return rc;
  return repro_torch::launch_status();
}

template <typename T, int GT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* lengths, void* out, void* lse,
           void* ws, int b, int hkv, int group, int d, int n_pool, int ps,
           int pp, int pps, int cluster, float scale, cudaStream_t stream) {
  const int lds = row_elems<T>(d), chunks = lds / 4;
  int lps = 1;                                    // lanes a key slot
  while (lps * kLaneChunks < chunks) lps *= 2;
  const int sl = pps * ps, n_split = (pp + pps - 1) / pps;
  if (cluster)                                    // the partial, one launch
    return launch_cluster<T, GT>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
        static_cast<const int*>(lengths), static_cast<float*>(out),
        static_cast<float*>(lse), b, hkv, group, d, n_pool, ps, pp, pps,
        n_split, lps, scale, stream);
  const size_t bytes = split_bytes<T, GT>(sl, lds, pps);
  if (n_split > 0) {                              // else: no position
    int rc = repro_torch::allow_shared(decode_split_kernel<T, GT>, bytes);
    if (rc != 0) return rc;
    const dim3 grid(b * hkv * ((group + GT - 1) / GT), n_split);
    decode_split_kernel<T, GT><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages),
        static_cast<const int*>(page_table), static_cast<const int*>(lengths),
        static_cast<float*>(ws), n_pool, ps, hkv, group, d, pp, pps, n_split,
        lps, scale);
    rc = repro_torch::launch_status();
    if (rc != 0) return rc;
  }
  const float* w = static_cast<const float*>(ws);
  if (lse != nullptr)                             // the partial: fp32, lse
    return combine<float, true>(lengths, out, static_cast<float*>(lse), w,
                                b * hkv * group, hkv * group, d, pp * ps, sl,
                                n_split, stream);
  return combine<T, false>(lengths, out, nullptr, w, b * hkv * group,
                           hkv * group, d, pp * ps, sl, n_split, stream);
}

template <typename T>
int run(const void* q, const void* k_pages, const void* v_pages,
        const void* page_table, const void* lengths, void* out, void* lse,
        void* ws, int b, int hkv, int group, int d, int n_pool, int ps,
        int pp, int pages_per_split, int cluster, float scale, void* stream) {
  const int n_split = pages_per_split < 1
      ? 0 : (pp + pages_per_split - 1) / pages_per_split;
  if (d < 1 || d > 4 * kThreads || pages_per_split < 1 ||
      pages_per_split > kThreads ||
      (cluster && (n_split < 1 || n_split > kMaxCluster)))
    return static_cast<int>(cudaErrorInvalidValue);
  // G <= 4 exactly, else chunks of 8 query heads a block
  const auto fn = group == 1 ? &launch<T, 1> : group == 2 ? &launch<T, 2>
                : group == 3 ? &launch<T, 3> : group == 4 ? &launch<T, 4>
                : &launch<T, 8>;
  return fn(q, k_pages, v_pages, page_table, lengths, out, lse, ws, b, hkv,
            group, d, n_pool, ps, pp, pages_per_split, cluster, scale,
            static_cast<cudaStream_t>(stream));
}

}  // namespace

// ws holds b * Hq * ceil(pp / pages_per_split) * (d + 2) floats; d <= 512
// and pages_per_split <= 128.
#define REPRO_DECODE_ENTRY(NAME, T)                                          \
  extern "C" int NAME(                                                      \
      const void* q, const void* k_pages, const void* v_pages,              \
      const void* page_table, const void* lengths, void* out, void* ws,     \
      int b, int hkv, int group, int d, int n_pool, int ps, int pp,         \
      int pages_per_split, float scale, void* stream) {                     \
    return run<T>(q, k_pages, v_pages, page_table, lengths, out, nullptr,   \
                  ws, b, hkv, group, d, n_pool, ps, pp, pages_per_split,    \
                  0, scale, stream);                                        \
  }

// The partial: out (b, Hq, d) fp32 and lse (b, Hq) fp32.  cluster 1: one
// launch of decode_cluster_kernel, ceil(pp / pages_per_split) <= 8 splits
// a cluster, no workspace (ws may be null); cluster 0: the split and
// combine kernels over ws, as above.
#define REPRO_DECODE_PARTIAL_ENTRY(NAME, T)                                  \
  extern "C" int NAME(                                                      \
      const void* q, const void* k_pages, const void* v_pages,              \
      const void* page_table, const void* lengths, void* out, void* lse,    \
      void* ws, int b, int hkv, int group, int d, int n_pool, int ps,       \
      int pp, int pages_per_split, int cluster, float scale,                \
      void* stream) {                                                       \
    return run<T>(q, k_pages, v_pages, page_table, lengths, out, lse, ws,   \
                  b, hkv, group, d, n_pool, ps, pp, pages_per_split,        \
                  cluster, scale, stream);                                  \
  }

REPRO_DECODE_ENTRY(repro_decode_attention_f32, float)
REPRO_DECODE_ENTRY(repro_decode_attention_bf16, __nv_bfloat16)
REPRO_DECODE_PARTIAL_ENTRY(repro_decode_attention_partial_f32, float)
REPRO_DECODE_PARTIAL_ENTRY(repro_decode_attention_partial_bf16, __nv_bfloat16)
