// K1: raw pairwise squared-distance partial of an (n, d) worker stack.
//
// Replaces the Pallas kernel repro/kernels/pairwise_gram.py::_gram_kernel
// (via pairwise_gram_partial).  Output: the raw (n, n) float32 sum of
// per-chunk partials sq_i + sq_j - 2 <x_i, x_j>, neither clamped nor
// with a zeroed diagonal (finalize_dists does that), so partials over
// disjoint coordinate slices add up.
//
// What bounds it on an H100: the stack is read once (n * d elements);
// the work is 2 n^2 d fp32 operations.  At n = 39 the two are close
// (bytes / 3.35 TB/s against ops / 67 TFLOP/s), so neither may be
// wasted.  Design: split-K over d.  Each CTA owns one contiguous chunk
// of coordinates, streams it through shared memory in (NP, 32) tiles
// (n padded to NP in {32, 48, 64}, coalesced loads along d, bf16 widened
// to fp32 on load) and accumulates a 4x4 block of the Gram per thread in
// fp32 FFMA (no TF32, no tensor cores).  It writes its (n, n) partial to
// scratch; a second short launch sums the partials in chunk order.  No
// float atomics, so a run repeats bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kTileK = 32;

template <typename T, int NP>
__global__ void __launch_bounds__((NP / 4) * (NP / 4))
gram_partial_kernel(const T* __restrict__ x, int n, long long d,
                    long long chunk, float* __restrict__ partials) {
  constexpr int TPR = NP / 4;     // threads along each Gram axis
  constexpr int NT = TPR * TPR;   // threads per CTA
  __shared__ float tile[kTileK][NP + 1];  // [k][row], padded vs banks
  __shared__ float gram[NP][NP + 1];

  const int tid = threadIdx.x;
  const int ty = tid / TPR;
  const int tx = tid % TPR;
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = min(d, c0 + chunk);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = c0; k0 < c1; k0 += kTileK) {
    for (int e = tid; e < NP * kTileK; e += NT) {
      const int r = e / kTileK;
      const int c = e % kTileK;
      const long long col = k0 + c;
      float v = 0.f;  // zero padding adds exactly 0 to every entry
      if (r < n && col < c1) v = to_float(x[(long long)r * d + col]);
      tile[c][r] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTileK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = tile[k][ty + i * TPR];
        b[i] = tile[k][tx + i * TPR];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gram[ty + i * TPR][tx + j * TPR] = acc[i][j];
  __syncthreads();

  float* out = partials + (long long)blockIdx.x * n * n;
  for (int e = tid; e < n * n; e += NT) {
    const int i = e / n;
    const int j = e % n;
    const float sq = gram[i][i] + gram[j][j];
    out[e] = __fsub_rn(sq, __fmul_rn(2.f, gram[i][j]));
  }
}

// raw[e] = partials[0][e] + partials[1][e] + ... in chunk order.
__global__ void gram_reduce_kernel(const float* __restrict__ partials,
                                   int nn, int n_chunks,
                                   float* __restrict__ raw) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nn) return;
  float s = partials[e];
  for (int c = 1; c < n_chunks; ++c) s = s + partials[(long long)c * nn + e];
  raw[e] = s;
}

template <typename T, int NP>
static void launch_partial(const T* x, int n, long long d, long long chunk,
                           int n_chunks, float* partials,
                           cudaStream_t stream) {
  constexpr int NT = (NP / 4) * (NP / 4);
  gram_partial_kernel<T, NP><<<n_chunks, NT, 0, stream>>>(x, n, d, chunk,
                                                         partials);
}

template <typename T>
static int gram_partial(const T* x, int n, long long d, long long chunk,
                        int n_chunks, float* partials, float* raw,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 32) {
    launch_partial<T, 32>(x, n, d, chunk, n_chunks, partials, stream);
  } else if (n <= 48) {
    launch_partial<T, 48>(x, n, d, chunk, n_chunks, partials, stream);
  } else {
    launch_partial<T, 64>(x, n, d, chunk, n_chunks, partials, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nn = n * n;
  gram_reduce_kernel<<<(nn + 255) / 256, 256, 0, stream>>>(partials, nn,
                                                           n_chunks, raw);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" {

// x: (n, d) row-major, n <= 64; partials: (n_chunks, n, n) scratch;
// raw: (n, n) output.  Chunk c covers coordinates [c * chunk, (c+1) *
// chunk).  Returns cudaGetLastError() after the launches.
int gram_partial_f32(const void* x, int n, long long d, long long chunk,
                     int n_chunks, void* partials, void* raw,
                     void* stream) {
  return repro_torch::gram_partial(static_cast<const float*>(x), n, d, chunk,
                                   n_chunks, static_cast<float*>(partials),
                                   static_cast<float*>(raw), stream);
}

int gram_partial_bf16(const void* x, int n, long long d, long long chunk,
                      int n_chunks, void* partials, void* raw,
                      void* stream) {
  return repro_torch::gram_partial(
      static_cast<const __nv_bfloat16*>(x), n, d, chunk, n_chunks,
      static_cast<float*>(partials), static_cast<float*>(raw), stream);
}

}  // extern "C"
