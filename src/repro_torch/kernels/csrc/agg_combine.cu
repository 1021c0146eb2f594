// Fused aggregate-combine for sm_90a, one GCN layer per launch:
//   out (D,O) = relu(mean_k(mask * h[nbr]) @ w + b)     (epilogue on)
//   out (D,O) = mean_k(mask * h[nbr]) @ w               (epilogue off)
//
// Replaces repro/kernels/agg_combine.py::_agg_combine_kernel.  Bound on the
// H100: bytes (the gathered rows of h) at the service's shapes, with the
// combine's 2*D*F*O fp32 FMAs close behind.  Each block owns BD destination
// rows: it gathers their aggregate into shared memory once and computes
// every output column from it, so the aggregate never goes to device
// memory.  The TPU kernel reused the aggregate across output tiles because
// its grid ran in order; blocks have no order, so here the reuse is a loop
// over column tiles inside the block.
//
// Gather and combine each run about as fast as the unfused spmm and gemm
// kernels; one after the other they are no faster than the pair.  So a
// block's warps are split in two roles that run at once:
//
//  * Producer warps (PW) gather the aggregate 128 columns at a time, all
//    BD rows of a chunk, and mark each chunk on its own mbarrier.  A warp
//    owns a (row, 128-column) item: it loads the row's K indices and masks
//    once, one slot a lane, broadcasts them with __shfl_sync (K > 32 in
//    chunks of 32), reads its columns of the gathered rows as 16-byte
//    float4s with up to kSlots gathers in flight before it sums any, and
//    sums in slot order with each product and sum rounded on its own, as
//    spmm.cu and spmm_ref do: the aggregate is the plain version's bit for
//    bit.  Where F % 4 != 0 or h is not 16-byte aligned, lanes own single
//    floats with the same arithmetic.
//  * Consumer warps run the combine on register tiles as in gemm.cu, k
//    stage by k stage, each stage waiting only for the chunk of the
//    aggregate it reads: the combine of chunk c runs while chunk c + 1 is
//    gathered.  w streams through STAGES cp.async stages of BK x BN
//    (started before the gather) behind a named barrier of the consumers
//    alone; each thread owns TM x 4 outputs and reads 16-byte fragments of
//    the aggregate and of w.  Each output is one chain of fused
//    multiply-adds over F in order; bias and relu are applied once, on the
//    store.  Column tiles (O > BN) follow each other in one pipeline.
//
// The aggregate's rows are padded to a stride of 4 mod 16 floats, so the
// rows a warp reads at once fall in different banks.  The tile is chosen
// by the wrapper from (F, O) alone (kernels/agg_combine.py::agg_tile): a
// row's result never depends on how many rows the launch has, which keeps
// fused batches bit-identical to serial runs.  The C entry instantiates the
// wrapper's table of tiles, TILES, which kernels/_build.py writes into
// agg_tiles.inc at build time.
#include "common.cuh"

namespace {

using repro_torch::load4;

constexpr int kSlots = 10;             // gathers a lane issues before summing
constexpr int kChunk = 128;            // aggregate columns a producer signal
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// Row stride of the aggregate: F rounded up to whole k stages, at least
// one (zeros past F, so F = 0 is one stage of zeros), plus 4 floats; and
// the chunks it is gathered in.
__host__ __device__ inline int agg_ld(int f, int bk) {
  return ((f > 1 ? f : 1) + bk - 1) / bk * bk + 4;
}
__host__ __device__ inline int agg_chunks(int f, int bk) {
  return (agg_ld(f, bk) - 4 + kChunk - 1) / kChunk;
}

// BD x BN outputs a block, TM x 4 a consumer thread, BK k a stage of w,
// STAGES stages, PW producer warps after the consumers.
template <int BD, int BN, int TM, int BK, int STAGES, int PW>
struct Tile {
  static_assert(BD % TM == 0 && BN % 4 == 0 && kChunk % BK == 0 &&
                BK % 4 == 0, "whole thread tiles and k stages");
  static_assert(STAGES >= 2, "a stage in flight while one is read");
  static constexpr int kRowsY = BD / TM;               // thread rows
  static constexpr int kConsumers = kRowsY * (BN / 4);
  static_assert(kConsumers % 32 == 0, "whole consumer warps");
  static constexpr int kThreads = kConsumers + PW * 32;
  static constexpr int kLdB = BN + 4;                  // padded w rows
  static constexpr int kStageElems = BK * kLdB;
  static size_t smem(int f) {
    return sizeof(float) * (static_cast<size_t>(BD) * agg_ld(f, BK) +
                            STAGES * kStageElems) +
           sizeof(uint64_t) * agg_chunks(f, BK);
  }
};

// The consumer warps' own barrier (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

// V consecutive floats of one lane: a float4 column, or one float.
template <int V>
struct Frag {
  float x[V];
};

template <int V>
__device__ __forceinline__ Frag<V> load_frag(const float* p) {
  Frag<V> r;
  if constexpr (V == 4) {
    const float4 t = load4(p);
    r.x[0] = t.x; r.x[1] = t.y; r.x[2] = t.z; r.x[3] = t.w;
  } else {
    r.x[0] = *p;
  }
  return r;
}

// Columns [c0, c0 + kChunk) of the aggregate of rows row0 .. row0 + rows - 1
// into agg (row stride lda): columns from F to lda - 5 zeroed, rows past D
// zeroed.  V = 4 needs F % 4 == 0 and h 16-byte aligned.
template <int V>
__device__ __forceinline__ void gather_chunk(
    float* agg, int lda, int c0, const float* __restrict__ h,
    const int* __restrict__ nbr, const float* __restrict__ mask,
    int64_t row0, int rows, int n, int f, int d, int k, int mean, int warp,
    int warps, int lane) {
  constexpr int kSub = kChunk / (32 * V);              // items a row
  const int fp = lda - 4;
  for (int item = warp; item < rows * kSub; item += warps) {
    const int r = item / kSub;
    const int col = c0 + (item - r * kSub) * 32 * V + lane * V;
    const int64_t row = row0 + r;
    Frag<V> acc = {};
    if (row < d) {                                     // uniform in the warp
      const int* nrow = nbr + row * k;
      const float* mrow = mask + row * k;
      float deg = 0.f;
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int cnt = min(32, k - j0);
        const int idx = lane < cnt ? nrow[j0 + lane] : 0;
        const float m = lane < cnt ? mrow[j0 + lane] : 0.f;
        for (int u0 = 0; u0 < cnt; u0 += kSlots) {
          Frag<V> v[kSlots];
#pragma unroll
          for (int u = 0; u < kSlots; ++u) {
            const int64_t src = repro_torch::gather_row(
                __shfl_sync(kFull, idx, (u0 + u) & 31), n);
            v[u] = (u0 + u < cnt && src >= 0 && col < f)
                       ? load_frag<V>(h + src * f + col) : Frag<V>{};
          }
#pragma unroll
          for (int u = 0; u < kSlots; ++u) {
            if (u0 + u >= cnt) break;
            const float mu = __shfl_sync(kFull, m, (u0 + u) & 31);
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc.x[e] = __fadd_rn(acc.x[e], __fmul_rn(v[u].x[e], mu));
            deg = __fadd_rn(deg, mu);
          }
        }
      }
      if (mean) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc.x[e] = __fdiv_rn(acc.x[e], fmaxf(deg, 1.f));
      }
    }
    if (col < fp) {
      float* dst = agg + r * lda + col;
      if constexpr (V == 4) {
        repro_torch::store4(dst, make_float4(acc.x[0], acc.x[1], acc.x[2],
                                             acc.x[3]));
      } else {
        *dst = acc.x[0];
      }
    }
  }
}

template <int BD, int BN, int TM, int BK, int STAGES, int PW>
__global__ void __launch_bounds__(
    (Tile<BD, BN, TM, BK, STAGES, PW>::kThreads), 1)
agg_combine_kernel(const float* __restrict__ h, const int* __restrict__ nbr,
                   const float* __restrict__ mask, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out,
                   int n, int f, int d, int k, int o, int mean, int epilogue,
                   int vec) {
  using T = Tile<BD, BN, TM, BK, STAGES, PW>;
  constexpr int C = T::kConsumers;
  extern __shared__ __align__(16) float smem[];
  const int lda = agg_ld(f, BK), chunks = agg_chunks(f, BK);
  float* agg = smem;                                   // BD x lda
  float* ws = agg + BD * lda;                          // STAGES x BK x kLdB
  uint64_t* ready = reinterpret_cast<uint64_t*>(ws + STAGES * T::kStageElems);
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BD;
  if (tid == 0) {
    for (int c = 0; c < chunks; ++c)
      repro_torch::mbar_init(ready + c, PW * 32);
    repro_torch::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= C) {                        // producers: the aggregate by chunks
    const int p = tid - C;
    for (int c = 0; c < chunks; ++c) {
      if (vec) {
        gather_chunk<4>(agg, lda, c * kChunk, h, nbr, mask, row0, BD, n, f,
                        d, k, mean, p / 32, PW, p % 32);
      } else {
        gather_chunk<1>(agg, lda, c * kChunk, h, nbr, mask, row0, BD, n, f,
                        d, k, mean, p / 32, PW, p % 32);
      }
      repro_torch::mbar_arrive(ready + c);
    }
    return;
  }

  // consumers: k stages of each column tile in turn
  const int ktiles = (lda - 4) / BK, otiles = (o + BN - 1) / BN;
  const int steps = otiles * ktiles;
  // whole, aligned tiles of w take the unchecked copy
  const bool w_rows = repro_torch::rows_aligned(w, o);
  int load_kt = 0, load_ot = 0;                        // next stage to load
  auto load_next = [&](int s) {
    const int o0 = load_ot * BN, k0 = load_kt * BK;
    float* dst = ws + s % STAGES * T::kStageElems;
    const float* src = w + static_cast<int64_t>(k0) * o + o0;
    if (w_rows && o0 + BN <= o && k0 + BK <= f) {
      repro_torch::load_tile_full<float, BK, BN, T::kLdB, C>(dst, src, o,
                                                             tid);
    } else {
      repro_torch::load_tile<float, BK, BN, T::kLdB, C>(dst, src, o, f - k0,
                                                        o - o0, tid);
    }
    if (++load_kt == ktiles) {
      load_kt = 0;
      ++load_ot;
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_next(s);
    repro_torch::cp_async_commit();
  }

  // a warp covers kRowsY thread rows of 32 / kRowsY column groups each,
  // so its aggregate reads fall in distinct banks
  const int ty = tid % T::kRowsY, tx = tid / T::kRowsY;
  int kt = 0, ot = 0, landed = 0;
  float acc[TM][4] = {};
  for (int s = 0; s < steps; ++s) {
    // the chunk of the aggregate this stage reads has been gathered
    for (const int need = (kt * BK + BK - 1) / kChunk; landed <= need;
         ++landed)
      repro_torch::mbar_wait(ready + landed, 0);
    repro_torch::cp_async_wait<STAGES - 2>();          // stage s has landed
    consumers_sync(C);                     // ... for every consumer thread
    if (s + STAGES - 1 < steps) load_next(s + STAGES - 1);
    repro_torch::cp_async_commit();
    const float* as = agg + kt * BK;
    const float* bs = ws + s % STAGES * T::kStageElems;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 av[TM], bv[4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = load4(as + (ty + i * T::kRowsY) * lda + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        bv[kk] = load4(bs + (kq + kk) * T::kLdB + tx * 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                        : kk == 2 ? av[i].z : av[i].w;
          acc[i][0] = fmaf(x, bv[kk].x, acc[i][0]);
          acc[i][1] = fmaf(x, bv[kk].y, acc[i][1]);
          acc[i][2] = fmaf(x, bv[kk].z, acc[i][2]);
          acc[i][3] = fmaf(x, bv[kk].w, acc[i][3]);
        }
      }
    }
    if (++kt < ktiles) continue;
    // the column tile is done: epilogue and store, then the next tile
    kt = 0;
    const int col = ot++ * BN + tx * 4;
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bias[j] = epilogue && col + j < o ? b[col + j] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t row = row0 + ty + i * T::kRowsY;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = epilogue ? fmaxf(__fadd_rn(acc[i][j], bias[j]), 0.f)
                        : acc[i][j];
        acc[i][j] = 0.f;
      }
      if (row >= d) continue;
      float* dst = out + row * o + col;
      if ((o & 3) == 0 && col + 4 <= o) {
        repro_torch::store4(dst, make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < o) dst[j] = v[j];
      }
    }
  }
  repro_torch::cp_async_wait<0>();
}

template <int BD, int BN, int TM, int BK, int STAGES, int PW>
int launch(const void* h, const void* nbr, const void* mask, const void* w,
           const void* b, void* out, int n, int f, int d, int k, int o,
           int mean, int epilogue, cudaStream_t stream) {
  using T = Tile<BD, BN, TM, BK, STAGES, PW>;
  auto kernel = agg_combine_kernel<BD, BN, TM, BK, STAGES, PW>;
  const size_t smem = T::smem(f);
  if (smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = repro_torch::allow_shared(kernel, smem);
  if (rc != 0) return rc;
  const int vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  const unsigned blocks = static_cast<unsigned>((d + BD - 1) / BD);
  kernel<<<blocks, T::kThreads, smem, stream>>>(
      static_cast<const float*>(h), static_cast<const int*>(nbr),
      static_cast<const float*>(mask), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), n, f, d, k, o,
      mean, epilogue, vec);
  return repro_torch::launch_status();
}

}  // namespace

// tile: an index into kernels/agg_combine.py's TILES, (BD, BN, TM, BK,
// STAGES, PW) each.
extern "C" int repro_agg_combine_f32(const void* h, const void* nbr,
                                     const void* mask, const void* w,
                                     const void* b, void* out, int n, int f,
                                     int d, int k, int o, int mean,
                                     int epilogue, int tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_AGG_TILE(ID, BD, BN, TM, BK, STAGES, PW)                      \
  case ID:                                                                  \
    return launch<BD, BN, TM, BK, STAGES, PW>(h, nbr, mask, w, b, out, n, f, \
                                              d, k, o, mean, epilogue, s);
  switch (tile) {
#include "agg_tiles.inc"
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_AGG_TILE
}
