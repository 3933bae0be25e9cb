// K2: Bulyan's coordinate phase, fused.
//
// Replaces the Pallas kernel _make_kernel of
// repro/kernels/bulyan_select.py (reached through bulyan_select, :51).
// Per coordinate of a (theta, d) row-major stack: odd-even sort of the
// theta values, then the mean of the beta = theta - 2f sorted values
// closest to the lower-middle median (windowed prefix sums, first window
// wins ties), in fp32 whatever the input type.
//
// Bound: bytes.  It must read theta * d elements and write d floats; the
// sort's theta^2 / 2 compare-exchanges per coordinate are far below the
// card's operation rate.  Design: one thread per coordinate, 128 threads
// a block, loads coalesced along d (neighbouring threads read
// neighbouring coordinates of a row).  Each thread's column lives in
// dynamic shared memory thread-major (value r at buf[r * 128 + tid]), so
// the runtime-sized sort never spills and neighbouring threads hit
// neighbouring banks; theta <= 64 keeps a block at <= 32 KB, under the
// 48 KB default.  The sort and window are common.cuh's, shared with K4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kSelectThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kSelectThreads)
bulyan_select_kernel(const T* __restrict__ x, int theta, long long d, int f,
                     float* __restrict__ out) {
  extern __shared__ float buf[];
  const long long c = (long long)blockIdx.x * kSelectThreads + threadIdx.x;
  if (c >= d) return;
  float* col = buf + threadIdx.x;
  for (int i = 0; i < theta; ++i)
    col[i * kSelectThreads] = to_float(x[(long long)i * d + c]);
  oe_sort_col(col, kSelectThreads, theta);
  out[c] = bulyan_window_col(col, kSelectThreads, theta, f);
}

template <typename T>
static int bulyan_select(const T* x, int theta, long long d, int f,
                         float* out, void* stream) {
  const size_t smem = sizeof(float) * theta * kSelectThreads;
  const long long blocks = (d + kSelectThreads - 1) / kSelectThreads;
  bulyan_select_kernel<T><<<(unsigned)blocks, kSelectThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      x, theta, d, f, out);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" {

// x: (theta, d) row-major, theta <= 64, theta - 2f >= 1; out: (d,) fp32.
int bulyan_select_f32(const void* x, int theta, long long d, int f,
                      void* out, void* stream) {
  return repro_torch::bulyan_select(static_cast<const float*>(x), theta, d,
                                    f, static_cast<float*>(out), stream);
}

int bulyan_select_bf16(const void* x, int theta, long long d, int f,
                       void* out, void* stream) {
  return repro_torch::bulyan_select(static_cast<const __nv_bfloat16*>(x),
                                    theta, d, f, static_cast<float*>(out),
                                    stream);
}

}  // extern "C"
