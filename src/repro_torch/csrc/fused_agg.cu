// Selection and combine kernels of the fused aggregation path.
//
// Replaces, together with K1 (pairwise_gram.cu), the Pallas kernels of
// repro/kernels/fused_agg.py:
//   * select_kernel   - the in-kernel selection of _make_megakernel
//                       (select_weights, fused_agg.py:164);
//   * combine_kernel  - K4, _make_pair_kernel via fused_coordinate, whose
//                       body is also the megakernel's phase 1.
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
// combine_kernel: one thread per coordinate, loads coalesced along d,
// the weighted rows and the sort in shared memory (rows x threads,
// thread-major so neighbouring threads hit neighbouring banks).  Bound:
// the n * d read of the stack.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kMaxN = 64;
constexpr int kCombineThreads = 128;

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

// One output coordinate per thread.  Shared memory: the (theta_w, n)
// weights, then `rows` values per thread at buf[r * blockDim + tid].
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const T* __restrict__ x, int n, long long d,
               const float* __restrict__ weights, int theta_w, int f,
               int mode, float* __restrict__ out) {
  extern __shared__ float smem[];
  const bool coord = (mode == 5 || mode == 6);
  float* w = smem;
  float* buf = smem + (coord ? 0 : theta_w * n);
  const int tid = threadIdx.x;
  const int stride = blockDim.x;
  if (!coord) {
    for (int e = tid; e < theta_w * n; e += blockDim.x) w[e] = weights[e];
    __syncthreads();
  }
  const long long c = (long long)blockIdx.x * blockDim.x + tid;
  if (c >= d) return;
  float* col = buf + tid;

  if (coord) {
    for (int i = 0; i < n; ++i) col[i * stride] = to_float(x[i * d + c]);
    oe_sort_col(col, stride, n);
    out[c] = (mode == 5) ? coord_median_col(col, stride, n)
                         : coord_trimmed_mean_col(col, stride, n, f);
    return;
  }
  // y[t] = sum_i w[t][i] * x[i] in index order: an exact gather for
  // one-hot rows
  for (int t = 0; t < theta_w; ++t) col[t * stride] = 0.f;
  for (int i = 0; i < n; ++i) {
    const float xi = to_float(x[i * d + c]);
    for (int t = 0; t < theta_w; ++t)
      col[t * stride] = fmaf(w[t * n + i], xi, col[t * stride]);
  }
  if (mode == 3 || mode == 4) {
    oe_sort_col(col, stride, theta_w);
    out[c] = bulyan_window_col(col, stride, theta_w, f);
  } else {
    out[c] = col[0];
  }
}

template <typename T>
static int combine(const T* x, int n, long long d, const float* weights,
                   int theta_w, int f, int mode, float* out,
                   void* stream_ptr) {
  const bool coord = (mode == 5 || mode == 6);
  const int rows = coord ? n : theta_w;
  const size_t smem =
      sizeof(float) * ((coord ? 0 : theta_w * n) + rows * kCombineThreads);
  const long long blocks = (d + kCombineThreads - 1) / kCombineThreads;
  combine_kernel<T><<<(unsigned)blocks, kCombineThreads, smem,
                      static_cast<cudaStream_t>(stream_ptr)>>>(
      x, n, d, weights, theta_w, f, mode, out);
  return (int)cudaGetLastError();
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
