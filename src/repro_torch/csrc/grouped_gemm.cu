// The grouped GEMM of the dropless expert layer (DeepSeek-V2's routed
// experts, models/moe.py::grouped_moe_ffn): rows sorted by expert, each
// group of rows times its expert's weight.
//
// Replaces no Pallas kernel: the JAX package's MoE is the capacity-based
// GShard dispatch, whose einsums have no counterpart here.  It was added
// because the dropless layer multiplies a different number of rows per
// expert on every step, and the counts live on the device: a loop of
// per-expert products would read them on the host (a sync per layer) and
// launch one small product per expert, each too small to fill the card
// (384 rows x 1,408 columns is 33 tiles of 128 x 128 for 132 SMs).
//
// What bounds it on an H100: the FLOPs, 2 rows K N per product in fp32
// FFMA (TF32 off: 67 TFLOP/s); the bytes (the group's rows, its weight,
// the output) take about a twentieth of that time at the expert widths.
// Design:
//   * one launch covers every group: a grid of (column tiles, row tiles,
//     depth splits), with as many row tiles as the groups can have at
//     most (ceil(M / 128) + groups, since the groups' rows sum to at
//     most M); a block's thread 0 walks the groups' device-side ranges
//     to find its group and first row, and a block past the last tile
//     exits, so the host never reads a count;
//   * the depth (K) of a row product splits in two halves, each block
//     adding its half into the zeroed output with float atomics: a few
//     hundred 128 x 128 tiles (3,072 rows x 1,408 columns is some 300)
//     fill the 264 slots of 132 SMs in 1.2 waves, half of the second
//     idle; halves make 2.3 waves.  Two partial sums added to zero in
//     either order give the same bits (x + y = y + x, 0 + x = x), so a
//     run still repeats bit for bit;
//   * 128 x 128 output tiles, 256 threads of 8 x 8 outputs each (two
//     4 x 4 quadrants 64 apart, so the fragments are float4 reads of
//     shared memory without bank conflicts), depth-8 slices of A and B
//     in a double-buffered shared ring, the next slice's global loads
//     issued before the current slice's FFMAs;
//   * gmm_rows_kernel<TRANS_W>: out[r] = x[r] @ W[g % Gw] (or W^T: the
//     input gradient), rows outside every group untouched (the caller
//     zeroes the output); gmm_dw_kernel: dW[g] = x[rows of g]^T dy[rows
//     of g], one z-slice per group, each block looping over its group's
//     rows (an empty group writes zeros);
//   * the row counter: with a counter pointer, the first column tile of
//     each group's first row tile adds the group's rows to
//     counter[base + g % Gw] (an integer atomic: exact, and read once
//     after a run, never in the step).
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kBM = 128;   // output rows per block
constexpr int kBN = 128;   // output columns per block
constexpr int kBK = 8;     // depth of a shared slice
constexpr int kThreads = 256;

__device__ __forceinline__ float4 ld4(const float* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const float4*>(p))
            : make_float4(0.f, 0.f, 0.f, 0.f);
}

// acc[i][j] += a[i] * b[j] over one shared slice: rows {ty*4 + i,
// 64 + ty*4 + i}, columns {tx*4 + j, 64 + tx*4 + j}.
__device__ __forceinline__ void slice_ffma(const float (*As)[kBM],
                                           const float (*Bs)[kBN], int ty,
                                           int tx, float acc[8][8]) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Writes the 8 x 8 outputs of a thread: rows row0 + {ty*4 + i, 64 + ty*4
// + i} below row_end, columns col0 + {tx*4, 64 + tx*4} (float4) below n.
__device__ __forceinline__ void store_tile(float* out, long long ld,
                                           int row0, int row_end, int col0,
                                           int n, int ty, int tx,
                                           const float acc[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= row_end) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      if (c < n)
        *reinterpret_cast<float4*>(out + r * ld + c) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                        acc[i][h * 4 + 3]);
    }
  }
}

// The same outputs added into ``out`` with float atomics (one block's
// share of a depth split).
__device__ __forceinline__ void add_tile(float* out, long long ld, int row0,
                                         int row_end, int col0, int n,
                                         int ty, int tx,
                                         const float acc[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= row_end) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      if (c < n) {
        float* p = out + r * ld + c;
#pragma unroll
        for (int j = 0; j < 4; ++j) atomicAdd(p + j, acc[i][h * 4 + j]);
      }
    }
  }
}

// out[r, :] = x[r, :] @ B(g) for the rows r of group g, where B(g) is
// w[g % w_groups] stored (k, n) row-major, or, with TRANS_W, stored (n, k)
// and read transposed; gridDim.z splits the depth into equal parts added
// into the zeroed output.  k % (8 gridDim.z) == 0 and n % 4 == 0.
template <bool TRANS_W>
__global__ void __launch_bounds__(kThreads)
    gmm_rows_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ starts,
                    const int* __restrict__ ends, int groups, int w_groups,
                    int k, int n, unsigned long long* __restrict__ counter,
                    int count_base, float* __restrict__ out) {
  // this block's half of the depth (gridDim.z halves, each a multiple
  // of kBK)
  const int k_len = k / gridDim.z, k_begin = blockIdx.z * k_len;
  __shared__ int s_tile[3];
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int tid = threadIdx.x;
  if (tid == 0) {
    int t = blockIdx.y, g = -1, r0 = 0, r1 = 0;
    for (int j = 0; j < groups; ++j) {
      const int s = starts[j], e = ends[j];
      const int nt = e > s ? (e - s + kBM - 1) / kBM : 0;
      if (t < nt) {
        g = j;
        r0 = s + t * kBM;
        r1 = e;
        break;
      }
      t -= nt;
    }
    s_tile[0] = g;
    s_tile[1] = r0;
    s_tile[2] = r1;
    if (g >= 0 && counter != nullptr && blockIdx.x == 0 &&
        blockIdx.z == 0 && r0 == starts[g])
      atomicAdd(counter + count_base + g % w_groups,
                static_cast<unsigned long long>(r1 - r0));
  }
  __syncthreads();
  const int g = s_tile[0];
  if (g < 0) return;
  const int row0 = s_tile[1], row_end = min(s_tile[2], row0 + kBM);
  const int col0 = blockIdx.x * kBN;
  const float* wg = w + static_cast<long long>(g % w_groups) * k * n;
  const int tx = tid % 16, ty = tid / 16;

  // A: row tid / 2 of the tile, depth (tid % 2) * 4, stored transposed
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const bool a_ok = row0 + a_row < row_end;
  const float* a_src =
      x + static_cast<long long>(row0 + a_row) * k + k_begin + a_k;
  // B: plain, depth tid / 32 and columns (tid % 32) * 4; transposed,
  // column tid / 2 and depth (tid % 2) * 4
  const int b_k = TRANS_W ? (tid & 1) * 4 : tid >> 5;
  const int b_n = TRANS_W ? tid >> 1 : (tid & 31) * 4;
  const bool b_ok = col0 + b_n < n;
  const float* b_src =
      TRANS_W ? wg + static_cast<long long>(col0 + b_n) * k + k_begin + b_k
              : wg + static_cast<long long>(k_begin + b_k) * n + col0 + b_n;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto put = [&](int buf, const float4& ra, const float4& rb) {
    As[buf][a_k + 0][a_row] = ra.x;
    As[buf][a_k + 1][a_row] = ra.y;
    As[buf][a_k + 2][a_row] = ra.z;
    As[buf][a_k + 3][a_row] = ra.w;
    if (TRANS_W) {
      Bs[buf][b_k + 0][b_n] = rb.x;
      Bs[buf][b_k + 1][b_n] = rb.y;
      Bs[buf][b_k + 2][b_n] = rb.z;
      Bs[buf][b_k + 3][b_n] = rb.w;
    } else {
      *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = rb;
    }
  };
  const long long b_step = TRANS_W ? kBK : static_cast<long long>(kBK) * n;

  put(0, ld4(a_src, a_ok), ld4(b_src, b_ok));
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < k_len; k0 += kBK) {
    const bool more = k0 + kBK < k_len;
    float4 ra, rb;
    if (more) {
      ra = ld4(a_src + k0 + kBK, a_ok);
      rb = ld4(b_src + (k0 / kBK + 1) * b_step, b_ok);
    }
    slice_ffma(As[buf], Bs[buf], ty, tx, acc);
    if (more) put(buf ^ 1, ra, rb);
    __syncthreads();
    buf ^= 1;
  }
  if (gridDim.z == 1)
    store_tile(out, n, row0, row_end, col0, n, ty, tx, acc);
  else
    add_tile(out, n, row0, row_end, col0, n, ty, tx, acc);
}

// dw[g] (k x n) = x[rows of g]^T @ dy[rows of g]; one z-slice per group,
// rows in slices of 8.  k % 4 == 0 and n % 4 == 0.
__global__ void __launch_bounds__(kThreads)
    gmm_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  const int* __restrict__ starts,
                  const int* __restrict__ ends, int k, int n,
                  float* __restrict__ dw) {
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int g = blockIdx.z;
  const int s = starts[g], e = ends[g];
  const int m0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // both operands: slice row tid / 32, columns (tid % 32) * 4
  const int l_r = tid >> 5, l_c = (tid & 31) * 4;
  const bool a_ok = m0 + l_c < k, b_ok = col0 + l_c < n;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto fetch = [&](int r0, float4& ra, float4& rb) {
    const int r = r0 + l_r;
    ra = ld4(x + static_cast<long long>(r) * k + m0 + l_c, a_ok && r < e);
    rb = ld4(dy + static_cast<long long>(r) * n + col0 + l_c, b_ok && r < e);
  };
  if (e > s) {
    float4 ra, rb;
    fetch(s, ra, rb);
    *reinterpret_cast<float4*>(&As[0][l_r][l_c]) = ra;
    *reinterpret_cast<float4*>(&Bs[0][l_r][l_c]) = rb;
    __syncthreads();
    int buf = 0;
    for (int r0 = s; r0 < e; r0 += kBK) {
      const bool more = r0 + kBK < e;
      if (more) fetch(r0 + kBK, ra, rb);
      slice_ffma(As[buf], Bs[buf], ty, tx, acc);
      if (more) {
        *reinterpret_cast<float4*>(&As[buf ^ 1][l_r][l_c]) = ra;
        *reinterpret_cast<float4*>(&Bs[buf ^ 1][l_r][l_c]) = rb;
      }
      __syncthreads();
      buf ^= 1;
    }
  }
  store_tile(dw + static_cast<long long>(g) * k * n, n, m0, k, col0, n, ty,
             tx, acc);
}

}  // namespace repro_torch

extern "C" {

int gmm_rows_f32(const void* x, const void* w, const void* starts,
                 const void* ends, int groups, int w_groups, int k, int n,
                 int trans_w, void* counter, int count_base, void* out,
                 int row_tiles, int splits, void* stream) {
  using namespace repro_torch;
  const dim3 grid((n + kBN - 1) / kBN, row_tiles, splits);
  auto s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const int* sp = static_cast<const int*>(starts);
  const int* ep = static_cast<const int*>(ends);
  auto* cp = static_cast<unsigned long long*>(counter);
  float* of = static_cast<float*>(out);
  if (trans_w)
    gmm_rows_kernel<true><<<grid, kThreads, 0, s>>>(
        xf, wf, sp, ep, groups, w_groups, k, n, cp, count_base, of);
  else
    gmm_rows_kernel<false><<<grid, kThreads, 0, s>>>(
        xf, wf, sp, ep, groups, w_groups, k, n, cp, count_base, of);
  return static_cast<int>(cudaGetLastError());
}

int gmm_dw_f32(const void* x, const void* dy, const void* starts,
               const void* ends, int groups, int k, int n, void* dw,
               void* stream) {
  using namespace repro_torch;
  const dim3 grid((n + kBN - 1) / kBN, (k + kBM - 1) / kBM, groups);
  gmm_dw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const int*>(starts), static_cast<const int*>(ends), k, n,
      static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
