// K2: Bulyan's coordinate phase, fused.
//
// Replaces the Pallas kernel _make_kernel of
// repro/kernels/bulyan_select.py (reached through bulyan_select, :51).
// Per coordinate of a (theta, d) row-major stack: a sort of the theta
// values, then the mean of the beta = theta - 2f sorted values closest
// to the lower-middle median (windowed prefix sums, first window wins
// ties), in fp32 whatever the input type.
//
// Bound: bytes.  It must read theta * d elements and write d floats; the
// sort's theta^2 / 2 compare-exchanges per coordinate are far below the
// card's operation rate.  The reference's odd-even network over a column
// held in shared memory costs ~900 shared accesses per coordinate at
// theta = 21, and the shared-memory pipe, not the read, would set the
// time.  Design: common.cuh's coord_stats_kernel with its Bulyan output,
// as K3 runs it: each thread owns one coordinate at a time and walks the
// coordinates with a grid stride (a persistent grid); the column lives
// in registers (theta padded with +inf to a compile-time bucket,
// Batcher's network fixed at compile time, a NaN flag), loads coalesced
// along d with every row's load issued before the sort.  No shared
// memory at all.  The window's running prefix sums add in the
// reference's order, and its mean scales by the rounded reciprocal of
// beta, as XLA rewrites the reference's division by a constant, so the
// result is the reference's to the bit; an inf is not a NaN here (no
// weights multiply it), so a +inf falls out of the best window and a
// -inf gives -inf, as in the reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

extern "C" {

// x: (theta, d) row-major, theta <= 64, theta - 2f >= 1; out: (d,) fp32.
int bulyan_select_f32(const void* x, int theta, long long d, int f,
                      void* out, void* stream) {
  return repro_torch::launch_coord_stats<repro_torch::kBulyan>(
      static_cast<const float*>(x), theta, d, f, static_cast<float*>(out),
      nullptr, static_cast<cudaStream_t>(stream));
}

int bulyan_select_bf16(const void* x, int theta, long long d, int f,
                       void* out, void* stream) {
  return repro_torch::launch_coord_stats<repro_torch::kBulyan>(
      static_cast<const __nv_bfloat16*>(x), theta, d, f,
      static_cast<float*>(out), nullptr, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
