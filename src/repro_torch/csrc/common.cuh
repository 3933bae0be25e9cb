// Device-function twins of repro_torch/kernels/common.py.
//
// Each helper works on one coordinate's values held in a strided column
// of shared memory: element r lives at col[r * stride].  The arithmetic
// is the reference's step for step (repro/kernels/common.py): the
// odd-even transposition network, Bulyan's window by prefix sums with a
// first-window tiebreak, the median as the mean of the two middle values
// for even counts, and the f-trimmed mean, each summed in row order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// jnp.minimum / jnp.maximum propagate NaN; fminf / fmaxf would drop it.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Odd-even transposition sort of m values, ascending.
__device__ __forceinline__ void oe_sort_col(float* col, int stride, int m) {
  for (int p = 0; p < m; ++p) {
    for (int i = p & 1; i < m - 1; i += 2) {
      float a = col[i * stride];
      float b = col[(i + 1) * stride];
      col[i * stride] = nan_min(a, b);
      col[(i + 1) * stride] = nan_max(a, b);
    }
  }
}

// Mean of the best beta = theta - 2f window of sorted values around the
// lower-middle median.
__device__ __forceinline__ float bulyan_window_col(const float* col,
                                                   int stride, int theta,
                                                   int f) {
  const int beta = theta - 2 * f;
  const float med = col[((theta - 1) / 2) * stride];
  if (beta == theta) {
    float acc = col[0];
    for (int r = 1; r < theta; ++r) acc = acc + col[r * stride];
    return acc / (float)beta;
  }
  // pref_v[w + beta] - pref_v[w] with running prefix sums: keep the
  // prefixes of the window start and end as they advance.
  float pv_lo = 0.f, pd_lo = 0.f;  // prefixes at w
  float pv_hi = 0.f, pd_hi = 0.f;  // prefixes at w + beta
  for (int r = 0; r < beta; ++r) {
    const float v = col[r * stride];
    pv_hi = pv_hi + v;
    pd_hi = pd_hi + fabsf(v - med);
  }
  float best_dev = pd_hi - pd_lo;
  float best_sum = pv_hi - pv_lo;
  const int n_win = theta - beta + 1;
  for (int w = 1; w < n_win; ++w) {
    const float lo = col[(w - 1) * stride];
    pv_lo = pv_lo + lo;
    pd_lo = pd_lo + fabsf(lo - med);
    const float hi = col[(w + beta - 1) * stride];
    pv_hi = pv_hi + hi;
    pd_hi = pd_hi + fabsf(hi - med);
    const float dev = pd_hi - pd_lo;
    const float s = pv_hi - pv_lo;
    if (dev < best_dev) {  // first-window tiebreak
      best_dev = dev;
      best_sum = s;
    }
  }
  return best_sum / (float)beta;
}

__device__ __forceinline__ float coord_median_col(const float* col,
                                                  int stride, int n) {
  if (n % 2) return col[(n / 2) * stride];
  return 0.5f * (col[(n / 2 - 1) * stride] + col[(n / 2) * stride]);
}

__device__ __forceinline__ float coord_trimmed_mean_col(const float* col,
                                                        int stride, int n,
                                                        int f) {
  float acc = col[f * stride];
  for (int r = f + 1; r < n - f; ++r) acc = acc + col[r * stride];
  return acc / (float)(n - 2 * f);
}

}  // namespace repro_torch
