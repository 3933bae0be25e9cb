// K3: coordinate-wise median and f-trimmed mean from one sort.
//
// Replaces the Pallas kernel _make_kernel of repro/kernels/coord_stats.py
// (reached through coord_stats, :40).  Per coordinate of an (n, d)
// row-major stack: one odd-even sort of the n values, then the median
// (the mean of the two middle values for even n) and the mean of the
// sorted values f .. n - f - 1, both in fp32 whatever the input type.
//
// Bound: bytes.  It must read n * d elements and write 2 d floats; the
// sort's n^2 / 2 compare-exchanges per coordinate are far below the
// card's operation rate.  Design: as K2 (bulyan_select.cu): one thread
// per coordinate, 128 threads a block, coalesced loads along d, each
// column in dynamic shared memory thread-major (n <= 64 keeps a block at
// <= 32 KB), the sort and both combine bodies from common.cuh.  The two
// rules share the one sort, so the stack is read once for both outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kStatsThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
coord_stats_kernel(const T* __restrict__ x, int n, long long d, int f,
                   float* __restrict__ med, float* __restrict__ trim) {
  extern __shared__ float buf[];
  const long long c = (long long)blockIdx.x * kStatsThreads + threadIdx.x;
  if (c >= d) return;
  float* col = buf + threadIdx.x;
  for (int i = 0; i < n; ++i)
    col[i * kStatsThreads] = to_float(x[(long long)i * d + c]);
  oe_sort_col(col, kStatsThreads, n);
  med[c] = coord_median_col(col, kStatsThreads, n);
  trim[c] = coord_trimmed_mean_col(col, kStatsThreads, n, f);
}

template <typename T>
static int coord_stats(const T* x, int n, long long d, int f, float* med,
                       float* trim, void* stream) {
  const size_t smem = sizeof(float) * n * kStatsThreads;
  const long long blocks = (d + kStatsThreads - 1) / kStatsThreads;
  coord_stats_kernel<T><<<(unsigned)blocks, kStatsThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      x, n, d, f, med, trim);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" {

// x: (n, d) row-major, n <= 64, n > 2f; med, trim: (d,) fp32.
int coord_stats_f32(const void* x, int n, long long d, int f, void* med,
                    void* trim, void* stream) {
  return repro_torch::coord_stats(static_cast<const float*>(x), n, d, f,
                                  static_cast<float*>(med),
                                  static_cast<float*>(trim), stream);
}

int coord_stats_bf16(const void* x, int n, long long d, int f, void* med,
                     void* trim, void* stream) {
  return repro_torch::coord_stats(static_cast<const __nv_bfloat16*>(x), n,
                                  d, f, static_cast<float*>(med),
                                  static_cast<float*>(trim), stream);
}

}  // extern "C"
