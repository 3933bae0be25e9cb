// K3: coordinate-wise median and f-trimmed mean from one sort.
//
// Replaces the Pallas kernel _make_kernel of repro/kernels/coord_stats.py
// (reached through coord_stats, :40).  Per coordinate of an (n, d)
// row-major stack: one sort of the n values, then the median (the mean
// of the two middle values for even n) and the mean of the sorted values
// f .. n - f - 1, both in fp32 whatever the input type.
//
// Bound: bytes.  It must read n * d elements and write 2 d floats.  A
// column held in shared memory under the reference's odd-even network
// costs ~3,000 shared accesses per coordinate at n = 39, and the
// shared-memory pipe, not the read, would set the time.  Design
// (common.cuh's coord_stats_kernel, which K4's cwmed and trimmed_mean
// modes launch too): each thread owns one coordinate at a time and walks
// the coordinates with a grid stride (a persistent grid, a few CTAs per
// SM); the column lives in registers (common.cuh's register form: n
// padded with +inf to a compile-time bucket, Batcher's network fixed at
// compile time, a NaN flag), loads coalesced along d with every row's
// load issued before the sort.  No shared memory at all.  The two rules
// share the one sort, so the stack is read once for both outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

extern "C" {

// x: (n, d) row-major, n <= 64, n > 2f; med, trim: (d,) fp32.
int coord_stats_f32(const void* x, int n, long long d, int f, void* med,
                    void* trim, void* stream) {
  return repro_torch::launch_coord_stats<
      repro_torch::kMedian | repro_torch::kTrimmed>(
      static_cast<const float*>(x), n, d, f, static_cast<float*>(med),
      static_cast<float*>(trim), static_cast<cudaStream_t>(stream));
}

int coord_stats_bf16(const void* x, int n, long long d, int f, void* med,
                     void* trim, void* stream) {
  return repro_torch::launch_coord_stats<
      repro_torch::kMedian | repro_torch::kTrimmed>(
      static_cast<const __nv_bfloat16*>(x), n, d, f,
      static_cast<float*>(med), static_cast<float*>(trim),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
