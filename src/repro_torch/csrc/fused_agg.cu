// Selection and combine kernels of the fused aggregation path.
//
// Replaces, together with K1 (pairwise_gram.cu), the Pallas kernels of
// repro/kernels/fused_agg.py:
//   * select_kernel   - the in-kernel selection of _make_megakernel
//                       (select_weights, fused_agg.py:164);
//   * combine_*_kernel - K4, _make_pair_kernel via fused_coordinate,
//                       whose body is also the megakernel's phase 1.
// K5 (fused_aggregate) is K1 + select + combine on one stream, so the
// megakernel equals the kernel pair bit for bit by construction.
//
// Modes (the numbering of repro_torch/kernels/fused_agg.py::_MODE_IDS):
//   0 krum, 1 geomed, 2 multikrum, 3 bulyan-krum, 4 bulyan-geomed,
//   5 cwmed, 6 trimmed_mean.
//
// select_kernel: one CTA; n <= 64.  Bound: latency, not bytes (it reads
// n^2 floats).  The distances never change between rounds, only which
// workers are left, so each column is sorted once (ranks computed by
// 1024 threads) and every round walks the sorted order of the rows still
// available; the argmin is a warp reduction.
//
// combine (K4): bound by the n * d read of the stack.  Contracting the
// (theta_w, n) weights with each column through shared memory would
// cost ~3,400 shared accesses per coordinate for bulyan-krum at n = 39
// (3 per fmaf, then the sort), and the shared-memory pipe would set the
// time.  So each CTA decodes the weights once (one-hot, all-zero or
// general rows), then walks coordinate tiles
// of a persistent grid; per coordinate the values live in registers:
// every row is loaded once (for its value or, by the reference's 0 * x
// rule, for its finiteness), then sorted and windowed by common.cuh's
// register form.  Three kernels: combine_single_kernel (modes 0..2),
// combine_bulyan_kernel (3, 4) and K3's coord_stats_kernel (5, 6, its
// median or its trimmed mean alone; common.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "combine.cuh"
#include "common.cuh"

namespace repro_torch {


__device__ __forceinline__ float finalized(float raw, int i, int j) {
  // finalize_dists: clamp fp-cancellation negatives, zero the diagonal
  // (max(raw, 0) * (1 - eye), NaN kept as jnp.maximum keeps it)
  const float v = (raw < 0.f) ? 0.f : raw;
  return v * ((i == j) ? 0.f : 1.f);
}

// Sort key of a finalized distance (>= 0, +inf, NaN, or -0.0): unsigned
// order is the column sort's order, NaN last, -0.0 equal to +0.0.
__device__ __forceinline__ unsigned sort_key(float v) {
  if (v != v) return 0xffffffffu;
  return v == 0.f ? 0u : __float_as_uint(v);
}

// Argmin key of a score (>= 0, +inf or NaN): NaN smallest, so a round
// with a NaN score finds it and picks no one; -0.0 equal to +0.0.
__device__ __forceinline__ unsigned argmin_key(float s) {
  if (s != s) return 0u;
  return s == 0.f ? 1u : __float_as_uint(s) + 1u;
}

// The index all kSelWarps * 32 threads agree on: the first minimum of
// score over threads j < n, or -1 when the minimum is NaN.  A warp
// min-reduction and ballot, then one exchange through shared memory
// (slot_k / slot_i, used in turns by parity, so one barrier a round).
constexpr int kSelWarps = kMaxN / 32;
__device__ __forceinline__ int block_argmin(float score, bool own,
                                            unsigned* slot_k, int* slot_i,
                                            int parity) {
  const int j = threadIdx.x;
  const unsigned key = own ? argmin_key(score) : 0xffffffffu;
  const unsigned m = __reduce_min_sync(0xffffffffu, key);
  const unsigned hit = __ballot_sync(0xffffffffu, key == m);
  if ((j & 31) == 0) {
    slot_k[parity * kSelWarps + j / 32] = m;
    slot_i[parity * kSelWarps + j / 32] = (j & ~31) + __ffs(hit) - 1;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kSelWarps * 32));
  unsigned best = slot_k[parity * kSelWarps];
  int pick = slot_i[parity * kSelWarps];
#pragma unroll
  for (int w = 1; w < kSelWarps; ++w) {  // ties keep the lower warp
    if (slot_k[parity * kSelWarps + w] < best) {
      best = slot_k[parity * kSelWarps + w];
      pick = slot_i[parity * kSelWarps + w];
    }
  }
  return best == 0u ? -1 : pick;
}

// Krum score of column j: the sum, in sorted order, of the first k
// entries whose row is available (bits of `live`, by sorted position);
// NaN if an available entry is NaN; +inf when fewer than k rows are left
// (the reference then adds masked +inf entries).  These are the first k
// values of the reference's masked column sort, added in the same
// order, so the bits are the same.  Branch-free: up to the k-th live
// position (__fns), every sorted position adds its value or -0.0
// (x + -0.0 == x for every x, and the sum starts at -0.0 so the first
// value is taken as it is), so the shared loads need not wait on a
// chain of bit scans.
__device__ __forceinline__ float krum_walk(const float (*SV)[kMaxN], int j,
                                           unsigned long long live,
                                           unsigned long long nan_pos,
                                           int k) {
  if (live & nan_pos) return CUDART_NAN_F;
  const unsigned lo = (unsigned)live, hi = (unsigned)(live >> 32);
  const int c = __popc(lo);
  if (c + __popc(hi) < k) return CUDART_INF_F;
  const int last = k <= c ? (int)__fns(lo, 0, k)
                          : 32 + (int)__fns(hi, 0, k - c);
  float s = -0.f;
#pragma unroll 8
  for (int r = 0; r <= last; ++r)
    s = s + (((live >> r) & 1ull) ? SV[r][j] : -0.f);
  return s;
}

// GeoMed score of column j: sqrt distances summed in row order, masked
// rows adding +0.0 as the reference's masked entries do.
__device__ __forceinline__ float geomed_sum(const float (*RT)[kMaxN], int j,
                                            int n, unsigned long long rows) {
  float s = 0.f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) s = s + (((rows >> i) & 1ull) ? RT[i][j] : 0.f);
  return s;
}

// Sort once, walk every round.  Phase A (all threads): the finalized
// matrix's sort keys into shared memory (Krum modes), or its square
// roots (GeoMed modes, 0 for +inf).  Phase B (all threads, Krum modes):
// each column's off-diagonal entries ranked by key, ties by row, giving
// SV[r][j], the r-th smallest value of column j, and RK[i][j], the rank
// of row i in column j.  Phase C (kSelWarps warps, thread j owns column
// j): the rounds.  Column j's available rows are a bit mask by sorted
// position, so removing worker p clears bit RK[p][j], and a score is a
// walk over the sorted values.
constexpr int kSelThreads = 1024;

__global__ void __launch_bounds__(kSelThreads)
select_kernel(const float* __restrict__ dist2, int n, int f, int mode,
              float* __restrict__ weights, float* __restrict__ selected,
              float* __restrict__ scores_out) {
  __shared__ unsigned KE[kMaxN][kMaxN + 1];
  __shared__ float SV[kMaxN][kMaxN];        // or RT: sqrt of the matrix
  __shared__ unsigned char RK[kMaxN][kMaxN];
  __shared__ unsigned slot_k[2 * kSelWarps];
  __shared__ int slot_i[2 * kSelWarps];
  const int tid = threadIdx.x;
  const bool krum = (mode == 0 || mode == 2 || mode == 3);

  for (int e = tid; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    const float v = finalized(dist2[e], i, j);
    if (krum) KE[i][j] = sort_key(v);
    else SV[i][j] = sqrtf(isinf(v) ? 0.f : v);
  }
  __syncthreads();
  if (krum) {
    for (int e = tid; e < n * n; e += blockDim.x) {
      const int i = e / n, j = e % n;  // row i of column j
      if (i == j) continue;
      const unsigned k = KE[i][j];
      // entries before row i: smaller keys, or equal keys on earlier rows
      int rank = 0;
#pragma unroll 8
      for (int i2 = 0; i2 < i; ++i2) rank += KE[i2][j] <= k;
#pragma unroll 8
      for (int i2 = i + 1; i2 < n; ++i2) rank += KE[i2][j] < k;
      const unsigned kd = KE[j][j];  // the diagonal took part: undo it
      rank -= (j < i) ? (kd <= k) : (kd < k);
      SV[rank][j] = finalized(dist2[e], i, j);
      RK[i][j] = (unsigned char)rank;
    }
    __syncthreads();
  }
  if (tid >= kSelWarps * 32) return;

  const int j = tid;
  const bool own = j < n;
  unsigned long long avail = (n == 64) ? ~0ull : ((1ull << n) - 1ull);
  // column j's available rows by sorted position, and its NaN positions
  unsigned long long live = (1ull << (n - 1)) - 1ull;
  unsigned long long nan_pos = 0ull;
  if (krum && own)
    for (int r = 0; r < n - 1; ++r)
      if (SV[r][j] != SV[r][j]) nan_pos |= 1ull << r;

  auto score_of = [&](int n_rem) -> float {
    if (!own || !((avail >> j) & 1ull)) return CUDART_INF_F;
    if (krum)
      return krum_walk(SV, j, live, nan_pos, max(1, n_rem - f - 2));
    return geomed_sum(SV, j, n, avail & ~(1ull << j));
  };

  if (mode == 0 || mode == 1) {  // krum / geomed: one-hot winner
    const float s = score_of(n);
    const int pick = block_argmin(s, own, slot_k, slot_i, 0);
    if (own) {
      const float hot = (j == pick) ? 1.f : 0.f;
      weights[j] = hot;
      selected[j] = hot;
      scores_out[j] = s;
    }
    return;
  }
  if (mode == 2) {  // multikrum: uniform over the m best scores
    const float s = score_of(n);
    if (own) scores_out[j] = s;
    const int m = max(1, n - f - 2);
    float cur = s, acc = 0.f;
    for (int t = 0; t < m; ++t) {
      const int pick = block_argmin(cur, own, slot_k, slot_i, t & 1);
      if (j == pick) {
        acc = acc + 1.f;
        cur = CUDART_INF_F;
      }
    }
    if (own) {
      const float w = acc / (float)m;
      weights[j] = w;
      selected[j] = w;
    }
    return;
  }
  // bulyan-krum / bulyan-geomed: theta = n - 2f recursive picks
  const int theta = n - 2 * f;
  float acc = 0.f;
  for (int t = 0; t < theta; ++t) {
    const float s = score_of(n - t);
    const int pick = block_argmin(s, own, slot_k, slot_i, t & 1);
    if (own) {
      const float hot = (j == pick) ? 1.f : 0.f;
      weights[t * n + j] = hot;
      acc = acc + hot;
    }
    if (pick >= 0) {
      avail &= ~(1ull << pick);
      if (krum && own && pick != j) live &= ~(1ull << RK[pick][j]);
    }
  }
  if (own) {
    selected[j] = acc;
    scores_out[j] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// K4: combine
// ---------------------------------------------------------------------------

constexpr int kCombineThreads = 128;

// Once per CTA: classify each of the theta_w weight rows (warp w takes
// rows w, w + 4, ...; n <= 64 entries as two per lane).  A row is
// one-hot when exactly one entry is nonzero and that entry is exactly
// 1.0f; +-0.0 both count as zero, NaN as nonzero.  Every lane issues all
// its loads before the first ballot, so the decode costs one trip to L2.
constexpr int kRowsPerWarp = kMaxN / (kCombineThreads / 32);

__device__ __forceinline__ void decode_rows(const float* __restrict__ w,
                                            int theta_w, int n,
                                            int* __restrict__ kind) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float a[kRowsPerWarp], b[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int t = warp + j * (kCombineThreads / 32);
    a[j] = (t < theta_w && lane < n) ? w[t * n + lane] : 0.f;
    b[j] = (t < theta_w && lane + 32 < n) ? w[t * n + lane + 32] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int t = warp + j * (kCombineThreads / 32);
    const unsigned nz_a = __ballot_sync(0xffffffffu, a[j] != 0.f);
    const unsigned nz_b = __ballot_sync(0xffffffffu, b[j] != 0.f);
    const unsigned one_a = __ballot_sync(0xffffffffu, a[j] == 1.f);
    const unsigned one_b = __ballot_sync(0xffffffffu, b[j] == 1.f);
    int k = kRowGeneral;
    if ((nz_a | nz_b) == 0u) {
      k = kRowZero;
    } else if (__popc(nz_a) + __popc(nz_b) == 1 && nz_a == one_a &&
               nz_b == one_b) {
      k = nz_a ? __ffs(nz_a) - 1 : 32 + __ffs(nz_b) - 1;
    }
    if (lane == 0 && t < theta_w) kind[t] = k;
  }
  __syncthreads();
}

// krum, geomed, multikrum (modes 0..2): the one weight row's value.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_single_kernel(const T* __restrict__ x, int n, long long d,
                      const float* __restrict__ weights,
                      float* __restrict__ out) {
  __shared__ int kind[kMaxN];
  decode_rows(weights, 1, n, kind);
  const int k = kind[0];
  const long long step = (long long)gridDim.x * kCombineThreads;
  for (long long c = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
       c < d; c += step)
    out[c] = single_row(x + c, n, d, weights, k);
}

// bulyan-krum, bulyan-geomed (modes 3, 4): Bulyan's window over the
// theta_w rows' values, sorted in a register array of the bucket M of
// theta_w.  When the rows pick distinct workers (every selection that met
// no NaN), the values are the picked rows' own (combine.cuh's
// picked_column: each row of the stack loaded once); otherwise every row
// takes the fmaf chain.
template <typename T, int M>
__global__ void __launch_bounds__(kCombineThreads)
combine_bulyan_kernel(const T* __restrict__ x, int n, long long d,
                      const float* __restrict__ weights, int theta_w, int f,
                      float* __restrict__ out) {
  __shared__ int kind[kMaxN];
  __shared__ int other[kMaxN];
  decode_rows(weights, theta_w, n, kind);
  unsigned long long picked = 0ull;
  bool distinct = true;
  for (int t = 0; t < theta_w; ++t) {
    const int k = kind[t];
    distinct = distinct && k >= 0 && !((picked >> k) & 1ull);
    if (k >= 0) picked |= 1ull << k;
  }
  if (threadIdx.x < 32) {  // the rows left out, compacted in row order
    const int lane = threadIdx.x;
    const bool out_a = lane < n && !((picked >> lane) & 1ull);
    const bool out_b = lane + 32 < n && !((picked >> (lane + 32)) & 1ull);
    const unsigned ba = __ballot_sync(0xffffffffu, out_a);
    const unsigned bb = __ballot_sync(0xffffffffu, out_b);
    const unsigned below = (1u << lane) - 1u;
    if (out_a) other[__popc(ba & below)] = lane;
    if (out_b) other[__popc(ba) + __popc(bb & below)] = lane + 32;
  }
  __syncthreads();
  const BulyanRows<M> rows =
      distinct ? bulyan_rows<M>(kind, other, theta_w, n) : BulyanRows<M>{};
  const long long step = (long long)gridDim.x * kCombineThreads;
  for (long long c = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
       c < d; c += step) {
    float y[M];
    bool nan;
    if (distinct) {
      nan = picked_column(x + c, d, rows, theta_w, y);
    } else {
      chain_column(x + c, n, d, weights, theta_w, y);
      nan = any_nan(y);
    }
    sort_regs(y);
    const float r = bulyan_window_regs(y, theta_w, f);
    out[c] = nan ? CUDART_NAN_F : r;
  }
}

template <typename T>
static int launch_single(const T* x, int n, long long d,
                         const float* weights, float* out, cudaStream_t s) {
  static int resident = 0;
  const unsigned grid = persistent_grid(combine_single_kernel<T>,
                                        kCombineThreads, d, &resident);
  combine_single_kernel<T><<<grid, kCombineThreads, 0, s>>>(x, n, d,
                                                            weights, out);
  return (int)cudaGetLastError();
}

template <typename T, int M>
static int launch_bulyan(const T* x, int n, long long d,
                         const float* weights, int theta_w, int f,
                         float* out, cudaStream_t s) {
  static int resident = 0;
  const unsigned grid = persistent_grid(combine_bulyan_kernel<T, M>,
                                        kCombineThreads, d, &resident);
  combine_bulyan_kernel<T, M><<<grid, kCombineThreads, 0, s>>>(
      x, n, d, weights, theta_w, f, out);
  return (int)cudaGetLastError();
}

template <typename T>
static int combine(const T* x, int n, long long d, const float* weights,
                   int theta_w, int f, int mode, float* out,
                   void* stream_ptr) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (mode == 5)  // cwmed: K3's kernel, its median only
    return launch_coord_stats<kMedian>(x, n, d, f, out, nullptr, s);
  if (mode == 6)  // trimmed_mean: K3's kernel, its trimmed mean only
    return launch_coord_stats<kTrimmed>(x, n, d, f, nullptr, out, s);
  if (mode != 3 && mode != 4)  // krum, geomed, multikrum: one row
    return launch_single<T>(x, n, d, weights, out, s);
  return with_bucket(theta_w, [&](auto bucket) {
    return launch_bulyan<T, decltype(bucket)::value>(x, n, d, weights,
                                                     theta_w, f, out, s);
  });
}

}  // namespace repro_torch

extern "C" {

// dist2: (n, n) raw or finalized squared distances (finalized here;
// finalizing twice is exact); weights: (theta_w, n); selected, scores:
// (n,).  n <= 64, mode in 0..4.
int select_weights_f32(const void* dist2, int n, int f, int mode,
                       void* weights, void* selected, void* scores,
                       void* stream) {
  repro_torch::select_kernel<<<1, repro_torch::kSelThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist2), n, f, mode,
      static_cast<float*>(weights), static_cast<float*>(selected),
      static_cast<float*>(scores));
  return (int)cudaGetLastError();
}

// x: (n, d) row-major; weights: (theta_w, n) or null for modes 5 and 6;
// out: (d,).
int combine_f32(const void* x, int n, long long d, const void* weights,
                int theta_w, int f, int mode, void* out, void* stream) {
  return repro_torch::combine(static_cast<const float*>(x), n, d,
                              static_cast<const float*>(weights), theta_w,
                              f, mode, static_cast<float*>(out), stream);
}

int combine_bf16(const void* x, int n, long long d, const void* weights,
                 int theta_w, int f, int mode, void* out, void* stream) {
  return repro_torch::combine(static_cast<const __nv_bfloat16*>(x), n, d,
                              static_cast<const float*>(weights), theta_w,
                              f, mode, static_cast<float*>(out), stream);
}

}  // extern "C"
