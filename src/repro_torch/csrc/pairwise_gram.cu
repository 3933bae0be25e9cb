// K1: raw pairwise squared-distance partial of an (n, d) worker stack.
//
// Replaces the Pallas kernel repro/kernels/pairwise_gram.py::_gram_kernel
// (via pairwise_gram_partial).  Output: the raw (n, n) float32
// sq_i + sq_j - 2 <x_i, x_j> over the whole stack, neither clamped nor
// with a zeroed diagonal (finalize_dists does that), so partials over
// disjoint coordinate slices add up.  It is exactly symmetric: each
// unordered pair is computed once and written to both places.
//
// What bounds it on an H100: the stack is read once (n * d elements, the
// bytes bound); the symmetric half of the Gram is n (n + 1) d fp32
// operations, about half the time of the read at n = 39.  Design:
//   * split-K over d with a chunk count fixed by the caller (not by the
//     card), one CTA per chunk of coordinates;
//   * each chunk streams through shared memory in row-major (NP, 64)
//     tiles (n padded to NP = 8 * NB), loaded with cp.async into a ring
//     of kStages tiles, so tile t + 3 loads while tile t is multiplied.
//     The rows of the main path's stacks are not 16-byte aligned (d = 2
//     mod 4), so the copy width is the widest of 16, 8 or 4 bytes that
//     the row stride and the base pointer allow (2-byte bf16 rows take
//     plain loads);
//   * only the NB (NB + 1) / 2 upper blocks of 8 x 8 Gram entries are
//     computed.  A thread owns one block and one slice of the tile's k
//     (KS threads per block, neighbouring lanes), keeps the 64 sums in
//     registers and reads two k values of each of its 16 rows per
//     shared load (float2; bf16: 4 bytes), 4 FFMA per shared word; fp32
//     FFMA only, no TF32;
//   * the KS slices of a block are summed by a warp butterfly, the CTA
//     writes its partial Gram (the packed upper triangle), and the
//     reduce runs in the same launch:
//     the last CTA of each group of kGroup chunks (found with
//     __threadfence and an integer atomic counter) sums the group's
//     partials in chunk order, and the last group to finish sums the
//     group sums in group order and writes the distances.  Every sum has
//     a fixed order and no float atomics, so a run repeats bit for bit.
//     The counters are scratch owned by the caller, zero before the
//     launch and reset to zero by the kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kTileK = 64;   // coordinates per tile
constexpr int kStages = 4;   // tiles in flight per CTA
constexpr int kGroup = 16;   // chunks per first-level reduce

template <int NB, int KS>
struct GramShape {
  static constexpr int NP = NB * 8;                    // padded rows
  static constexpr int P = NB * (NB + 1) / 2;          // upper blocks
  static constexpr int NT = (P * KS + 31) / 32 * 32;   // threads
};

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int vec_bytes, bool in_range) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_bytes = in_range ? vec_bytes : 0;  // 0: fill with zeros
  if (vec_bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
  } else if (vec_bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two consecutive values of one tile row, widened to fp32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Index of entry (i, j), i <= j, in the packed upper triangle.
__device__ __forceinline__ int tri(int i, int j, int n) {
  return i * n - i * (i - 1) / 2 + (j - i);
}

// out[u] = sum over c < count of src[c * T + u], in c order, for the
// packed entries u < T this thread owns (u = tid + k * NT): every load
// of a group is issued before the adds, so the sum costs one or two
// L2 round trips, not one per term.
template <int NT, int MAXE, int UNROLL>
__device__ __forceinline__ void ordered_sum(const float* __restrict__ src,
                                            int count, int T,
                                            float* __restrict__ out) {
  const int tid = threadIdx.x;
  float s[MAXE];
#pragma unroll
  for (int k = 0; k < MAXE; ++k) {
    const int u = tid + k * NT;
    s[k] = u < T ? __ldcg(src + u) : 0.f;
  }
  for (int c0 = 1; c0 < count; c0 += UNROLL) {
    float v[UNROLL][MAXE];
#pragma unroll
    for (int c = 0; c < UNROLL; ++c)
#pragma unroll
      for (int k = 0; k < MAXE; ++k) {
        const int u = tid + k * NT;
        v[c][k] = (c0 + c < count && u < T)
                      ? __ldcg(src + (long long)(c0 + c) * T + u)
                      : 0.f;
      }
#pragma unroll
    for (int c = 0; c < UNROLL; ++c)
#pragma unroll
      for (int k = 0; k < MAXE; ++k)
        if (c0 + c < count) s[k] = s[k] + v[c][k];
  }
#pragma unroll
  for (int k = 0; k < MAXE; ++k) {
    const int u = tid + k * NT;
    if (u < T) out[u] = s[k];
  }
}

// True in every thread of the CTA that arrives last of `arrivals` CTAs
// at *counter (which it resets to zero).  What the CTA's threads wrote
// before the call is visible to the last CTA after its call: the
// barrier orders the block's writes before thread 0's fence, and fences
// are cumulative.
__device__ __forceinline__ bool last_to_arrive(unsigned* counter,
                                               int arrivals, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = atomicAdd(counter, 1u) == (unsigned)(arrivals - 1);
    if (last) *counter = 0u;
    __threadfence();
    *flag = last;
  }
  __syncthreads();
  return *flag;
}

// Tile t of this CTA's chunk into one ring slot: rows < n, columns
// [k0, k0 + kTileK), zeros past the chunk's end.
template <typename T, int NT>
__device__ __forceinline__ void load_tile(T* slot, const T* __restrict__ x,
                                          int n, long long d, long long k0,
                                          long long c1, int vec_bytes) {
  const int tid = threadIdx.x;
  if (vec_bytes < 4) {  // 2-byte bf16 rows: plain loads
    for (int e = tid; e < n * kTileK; e += NT) {
      const int r = e / kTileK, c = e % kTileK;
      const long long col = k0 + c;
      slot[r * kTileK + c] =
          col < c1 ? x[(long long)r * d + col] : T(0.f);
    }
    return;
  }
  const int vec = vec_bytes / (int)sizeof(T);  // elements per copy
  const int per_row = kTileK / vec;            // a power of two
  const int lg = __ffs(per_row) - 1;
  for (int e = tid; e < n * per_row; e += NT) {
    const int r = e >> lg, c = (e & (per_row - 1)) * vec;
    const long long col = k0 + c;
    const bool in_range = col < c1;  // copies never straddle c1
    const T* src = in_range ? x + (long long)r * d + col : x;
    cp_async(slot + r * kTileK + c, src, vec_bytes, in_range);
  }
}

// two CTAs per SM where they fit (the main path's n = 39: 256 threads)
template <typename T, int NB, int KS>
__global__ void __launch_bounds__(GramShape<NB, KS>::NT,
                                  GramShape<NB, KS>::NT <= 256 ? 2 : 1)
gram_kernel(const T* __restrict__ x, int n, long long d, long long chunk,
            int n_chunks, int vec_bytes, float* __restrict__ partials,
            float* __restrict__ group_sums, unsigned* __restrict__ counters,
            float* __restrict__ raw) {
  using S = GramShape<NB, KS>;
  constexpr int NP = S::NP, P = S::P, NT = S::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane_s = tid % KS;            // k slice of this thread
  int p = tid / KS;                       // upper block of this thread
  const bool writer = (p < P) && (lane_s == 0);
  if (p >= P) p = P - 1;                  // padding threads: a copy
  int bi = 0, rem = p;
  while (rem >= NB - bi) {
    rem -= NB - bi;
    ++bi;
  }
  const int bj = bi + rem;

  // padding rows stay zero in every slot
  for (int e = tid; e < kStages * (NP - n) * kTileK; e += NT) {
    const int st = e / ((NP - n) * kTileK);
    const int o = e % ((NP - n) * kTileK);
    tiles[st * NP * kTileK + n * kTileK + o] = T(0.f);
  }

  const long long c0 = (long long)blockIdx.x * chunk;
  const long long c1 = min(d, c0 + chunk);
  const int ntiles = (int)((c1 - c0 + kTileK - 1) / kTileK);

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles)
      load_tile<T, NT>(tiles + st * NP * kTileK, x, n, d,
                       c0 + (long long)st * kTileK, c1, vec_bytes);
    cp_async_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t is in; slot (t - 1) % kStages is free
    const int nt = t + kStages - 1;
    if (nt < ntiles)
      load_tile<T, NT>(tiles + (nt % kStages) * NP * kTileK, x, n, d,
                       c0 + (long long)nt * kTileK, c1, vec_bytes);
    cp_async_commit();

    const T* slot = tiles + (t % kStages) * NP * kTileK;
    const T* arow = slot + bi * 8 * kTileK;
    const T* brow = slot + bj * 8 * kTileK;
#pragma unroll
    for (int g = lane_s; g < kTileK / 2; g += KS) {
      float2 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = load2(arow + i * kTileK + 2 * g);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = load2(brow + j * kTileK + 2 * g);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        }
    }
  }
  cp_async_wait<0>();

  // sum the KS slices of each block (a butterfly: every lane ends with
  // the same bits, since a + b == b + a)
#pragma unroll
  for (int off = KS / 2; off > 0; off /= 2)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);

  const int n_tri = n * (n + 1) / 2;  // packed upper triangle
  constexpr int MAXE = (NP * (NP + 1) / 2 + NT - 1) / NT;
  if (writer) {
    float* out = partials + (long long)blockIdx.x * n_tri;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = bi * 8 + i, c = bj * 8 + j;
        if (r < n && c < n && (bi < bj || i <= j))
          out[tri(r, c, n)] = acc[i][j];
      }
  }

  // level 1: the last CTA of this group sums the group's partials
  const int grp = blockIdx.x / kGroup;
  const int g0 = grp * kGroup;
  const int g1 = min(n_chunks, g0 + kGroup);
  const int n_groups = (n_chunks + kGroup - 1) / kGroup;
  if (!last_to_arrive(&counters[grp], g1 - g0, &s_last)) return;
  ordered_sum<NT, MAXE, 8>(partials + (long long)g0 * n_tri, g1 - g0,
                           n_tri, group_sums + grp * n_tri);

  // level 2: the last group sums the group sums and writes raw
  if (!last_to_arrive(&counters[n_groups], n_groups, &s_last)) return;
  float* gram = reinterpret_cast<float*>(smem_raw);  // ring is drained
  ordered_sum<NT, MAXE, 8>(group_sums, n_groups, n_tri, gram);
  __syncthreads();
  for (int e = tid; e < n * n; e += NT) {
    const int i = e / n, j = e % n;
    const float sq = gram[tri(i, i, n)] + gram[tri(j, j, n)];
    const float g = gram[tri(min(i, j), max(i, j), n)];
    raw[e] = __fsub_rn(sq, __fmul_rn(2.f, g));
  }
}

// Widest copy (16, 8 or 4 bytes) that every row start allows; 2 means
// 2-byte bf16 rows, which take plain loads.
static int copy_width(const void* x, long long d, int elem) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  for (int vb = 16; vb >= 4; vb /= 2)
    if ((d * elem) % vb == 0 && base % vb == 0) return vb;
  return elem;
}

template <typename T, int NB, int KS>
static int launch(const T* x, int n, long long d, long long chunk,
                  int n_chunks, float* partials, float* group_sums,
                  unsigned* counters, float* raw, cudaStream_t stream) {
  using S = GramShape<NB, KS>;
  const size_t ring = sizeof(T) * kStages * S::NP * kTileK;
  const size_t tri_bytes = sizeof(float) * n * (n + 1) / 2;
  const size_t smem = ring > tri_bytes ? ring : tri_bytes;
  auto kern = gram_kernel<T, NB, KS>;
  if (smem + 64 > 48 * 1024) {  // with the static s_last: an opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<n_chunks, S::NT, smem, stream>>>(
      x, n, d, chunk, n_chunks, copy_width(x, d, sizeof(T)), partials,
      group_sums, counters, raw);
  return (int)cudaGetLastError();
}

template <typename T>
static int gram(const T* x, int n, long long d, long long chunk,
                int n_chunks, float* partials, float* group_sums,
                unsigned* counters, float* raw, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch ((n + 7) / 8) {
    case 1: return launch<T, 1, 16>(x, n, d, chunk, n_chunks, partials,
                                    group_sums, counters, raw, s);
    case 2: return launch<T, 2, 16>(x, n, d, chunk, n_chunks, partials,
                                    group_sums, counters, raw, s);
    case 3: return launch<T, 3, 16>(x, n, d, chunk, n_chunks, partials,
                                    group_sums, counters, raw, s);
    case 4: return launch<T, 4, 16>(x, n, d, chunk, n_chunks, partials,
                                    group_sums, counters, raw, s);
    case 5: return launch<T, 5, 16>(x, n, d, chunk, n_chunks, partials,
                                    group_sums, counters, raw, s);
    case 6: return launch<T, 6, 8>(x, n, d, chunk, n_chunks, partials,
                                   group_sums, counters, raw, s);
    case 7: return launch<T, 7, 8>(x, n, d, chunk, n_chunks, partials,
                                   group_sums, counters, raw, s);
    default: return launch<T, 8, 8>(x, n, d, chunk, n_chunks, partials,
                                    group_sums, counters, raw, s);
  }
}

}  // namespace repro_torch

extern "C" {

// x: (n, d) row-major, 1 <= n <= 64; chunk: a multiple of 64
// coordinates, chunk c covering [c * chunk, (c + 1) * chunk); partials:
// n_chunks * n (n + 1) / 2 floats of scratch; group_sums:
// ceil(n_chunks / 16) * n (n + 1) / 2 floats of scratch; counters:
// ceil(n_chunks / 16) + 1 unsigned ints, zero before the launch and zero
// again after it; raw: (n, n) output.  Returns
// cudaGetLastError() after the launch.
int gram_partial_f32(const void* x, int n, long long d, long long chunk,
                     int n_chunks, void* partials, void* group_sums,
                     void* counters, void* raw, void* stream) {
  return repro_torch::gram(static_cast<const float*>(x), n, d, chunk,
                           n_chunks, static_cast<float*>(partials),
                           static_cast<float*>(group_sums),
                           static_cast<unsigned*>(counters),
                           static_cast<float*>(raw), stream);
}

int gram_partial_bf16(const void* x, int n, long long d, long long chunk,
                      int n_chunks, void* partials, void* group_sums,
                      void* counters, void* raw, void* stream) {
  return repro_torch::gram(static_cast<const __nv_bfloat16*>(x), n, d,
                           chunk, n_chunks, static_cast<float*>(partials),
                           static_cast<float*>(group_sums),
                           static_cast<unsigned*>(counters),
                           static_cast<float*>(raw), stream);
}

}  // extern "C"
