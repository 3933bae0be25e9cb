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
// select_kernel: one CTA of 64 threads, thread j owns worker j's column
// of the (n, n) matrix held in shared memory; n <= 64.  Bound: latency,
// not bytes (it reads n^2 floats); theta = n - 2f rounds of a column sort
// each.  combine_kernel: one thread per coordinate, loads coalesced along
// d, the weighted rows and the sort in shared memory (rows x threads,
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

// Scores of every available worker on the masked matrix, into score[].
__device__ void column_scores(float (*D)[kMaxN + 1], float (*S)[kMaxN + 1],
                              const float* avail, float* score, int n,
                              int f, int n_rem, bool krum) {
  const int j = threadIdx.x;
  if (j < n) {
    const bool aj = avail[j] > 0.5f;
    float s;
    if (krum) {
      for (int i = 0; i < n; ++i) {
        const bool masked = (i == j) || !(avail[i] > 0.5f) || !aj;
        S[i][j] = masked ? CUDART_INF_F : D[i][j];
      }
      oe_sort_col(&S[0][j], kMaxN + 1, n);
      const int k = max(1, n_rem - f - 2);
      s = S[0][j];
      for (int r = 1; r < k; ++r) s = s + S[r][j];
    } else {
      s = 0.f;
      for (int i = 0; i < n; ++i) {
        const bool masked = (i == j) || !(avail[i] > 0.5f) || !aj;
        const float v = masked ? CUDART_INF_F : D[i][j];
        s = s + sqrtf(isinf(v) ? 0.f : v);
      }
    }
    score[j] = aj ? s : CUDART_INF_F;
  }
  __syncthreads();
}

// First index of the minimum (n when the minimum is NaN), by thread 0.
__device__ void first_argmin(const float* score, int n, int* pick) {
  if (threadIdx.x == 0) {
    float m = score[0];
    for (int j = 1; j < n; ++j) m = nan_min(m, score[j]);
    int idx = n;
    for (int j = 0; j < n; ++j) {
      if (score[j] == m) {
        idx = j;
        break;
      }
    }
    *pick = idx;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxN)
select_kernel(const float* __restrict__ dist2, int n, int f, int mode,
              float* __restrict__ weights, float* __restrict__ selected,
              float* __restrict__ scores_out) {
  __shared__ float D[kMaxN][kMaxN + 1];
  __shared__ float S[kMaxN][kMaxN + 1];
  __shared__ float avail[kMaxN];
  __shared__ float score[kMaxN];
  __shared__ float acc[kMaxN];
  __shared__ int pick;
  const int j = threadIdx.x;

  for (int e = j; e < n * n; e += blockDim.x) {
    const int r = e / n, c = e % n;
    D[r][c] = finalized(dist2[e], r, c);
  }
  if (j < n) {
    avail[j] = 1.f;
    acc[j] = 0.f;
  }
  __syncthreads();

  if (mode == 0 || mode == 1) {  // krum / geomed: one-hot winner
    column_scores(D, S, avail, score, n, f, n, mode == 0);
    first_argmin(score, n, &pick);
    if (j < n) {
      const float hot = (j == pick) ? 1.f : 0.f;
      weights[j] = hot;
      selected[j] = hot;
      scores_out[j] = score[j];
    }
    return;
  }
  if (mode == 2) {  // multikrum: uniform over the m best scores
    column_scores(D, S, avail, score, n, f, n, true);
    if (j < n) scores_out[j] = score[j];
    __syncthreads();
    const int m = max(1, n - f - 2);
    for (int t = 0; t < m; ++t) {
      first_argmin(score, n, &pick);
      if (j < n && j == pick) {
        acc[j] = acc[j] + 1.f;
        score[j] = CUDART_INF_F;
      }
      __syncthreads();
    }
    if (j < n) {
      const float w = acc[j] / (float)m;
      weights[j] = w;
      selected[j] = w;
    }
    return;
  }
  // bulyan-krum / bulyan-geomed: theta = n - 2f recursive picks
  const int theta = n - 2 * f;
  for (int t = 0; t < theta; ++t) {
    column_scores(D, S, avail, score, n, f, n - t, mode == 3);
    first_argmin(score, n, &pick);
    if (j < n) {
      const float hot = (j == pick) ? 1.f : 0.f;
      weights[t * n + j] = hot;
      acc[j] = acc[j] + hot;
      avail[j] = avail[j] - hot;
    }
    __syncthreads();
  }
  if (j < n) {
    selected[j] = acc[j];
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
  repro_torch::select_kernel<<<1, repro_torch::kMaxN, 0,
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
