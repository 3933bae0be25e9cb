// Device-function twins of repro_torch/kernels/common.py, and the
// coordinate kernel of K2 and K3.
//
// The register form holds one coordinate's values in a fixed-size
// register array float v[M], M a compile-time size bucket (bucket_of),
// padded with +inf: a sorting network fixed at compile time (Batcher's
// odd-even merge sort, its comparators that touch a padding slot
// dropped), then Bulyan's window, the median and the trimmed mean with
// runtime counts but only compile-time register indices.  The file also
// holds coord_stats_kernel, which K2 (Bulyan's window), K3 (median and
// trimmed mean) and K4's cwmed and trimmed_mean modes launch; K4's
// Bulyan modes sort and window their gathered values with the same
// functions.
//
// The arithmetic of the combine bodies is the reference's
// (repro/kernels/common.py): Bulyan's window by running prefix sums with
// a first-window tiebreak, the median as the mean of the two middle
// values for even counts, the f-trimmed mean, each summed in row order
// of the sorted values.  The reference sorts with an odd-even
// transposition network of NaN-propagating min / max; the register
// network sorts with fminf / fmaxf, which drop NaN, so its callers carry
// a NaN flag per coordinate: the reference's network turns a column that
// holds one NaN into NaN at every position, and so does every result of
// that column.  Without NaN the two networks give the same sorted
// values, up to the order of -0.0 and +0.0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <type_traits>
#include <utility>

namespace repro_torch {

constexpr int kMaxN = 64;  // the kernels take n <= 64 rows

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------------
// register form
// ---------------------------------------------------------------------------

// The size buckets of the register form: a column of m <= 64 values runs
// in the smallest of 8, 16, 24, 32, 40, 48 and 64 that holds it.
constexpr int bucket_of(int m) {
  return m <= 48 ? (m + 7) / 8 * 8 : 64;
}

// launch(std::integral_constant<int, M>{}) for the size bucket M of m
// values: the one switch from a runtime count to a kernel instance.
template <typename Launch>
static int with_bucket(int m, Launch&& launch) {
  switch (bucket_of(m)) {
    case 8: return launch(std::integral_constant<int, 8>{});
    case 16: return launch(std::integral_constant<int, 16>{});
    case 24: return launch(std::integral_constant<int, 24>{});
    case 32: return launch(std::integral_constant<int, 32>{});
    case 40: return launch(std::integral_constant<int, 40>{});
    case 48: return launch(std::integral_constant<int, 48>{});
    default: return launch(std::integral_constant<int, 64>{});
  }
}

__host__ __device__ constexpr int pow2_at_least(int m) {
  int p = 1;
  while (p < m) p *= 2;
  return p;
}

__host__ __device__ constexpr int log2_ceil(int m) {
  int b = 0;
  while ((1 << b) < m) ++b;
  return b;
}

// Batcher's odd-even merge sort over P = 2^k >= M slots, keeping only the
// comparators (a < b, min to a) with b < M: slots M.. would hold +inf,
// which no comparator moves, so the rest sorts any M values.
constexpr int kMaxComparators = 543;  // P = 64
struct Comparators {
  int a[kMaxComparators];
  int b[kMaxComparators];
  int count;
};

__host__ __device__ constexpr Comparators batcher_network(int m) {
  Comparators net{};
  const int P = pow2_at_least(m);
  for (int p = 1; p < P; p *= 2)
    for (int k = p; k >= 1; k /= 2)
      for (int j = k % p; j + k < P; j += 2 * k)
        for (int i = 0; i < k && i < P - j - k; ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p) && i + j + k < m) {
            net.a[net.count] = i + j;
            net.b[net.count] = i + j + k;
            ++net.count;
          }
  return net;
}

template <int M>
struct SortNetwork {
  static constexpr Comparators net = batcher_network(M);
};

template <int M, int A, int B>
__device__ __forceinline__ void compare_exchange(float (&v)[M]) {
  const float lo = fminf(v[A], v[B]);
  v[B] = fmaxf(v[A], v[B]);
  v[A] = lo;
}

template <int M, std::size_t... I>
__device__ __forceinline__ void run_network(float (&v)[M],
                                            std::index_sequence<I...>) {
  (compare_exchange<M, SortNetwork<M>::net.a[I], SortNetwork<M>::net.b[I]>(
       v),
   ...);
}

// Ascending sort of M register values (NaN-free: see the header).
template <int M>
__device__ __forceinline__ void sort_regs(float (&v)[M]) {
  run_network<M>(v, std::make_index_sequence<SortNetwork<M>::net.count>{});
}

template <int M>
__device__ __forceinline__ bool any_nan(const float (&v)[M]) {
  bool nan = false;
#pragma unroll
  for (int i = 0; i < M; ++i) nan |= v[i] != v[i];
  return nan;
}

// v[k] for a runtime (warp-uniform) k, by selects over the compile-time
// slots: a runtime index into a register array would move it to local
// memory.
template <int M>
__device__ __forceinline__ float reg_at(const float (&v)[M], int k) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < M; ++i) r = (k == i) ? v[i] : r;
  return r;
}

// Column c of an (n, d) row-major stack into v, +inf past row n.
// Returns whether the column holds a NaN.
template <int M, typename T>
__device__ __forceinline__ bool load_column(const T* __restrict__ x, int n,
                                            long long d, long long c,
                                            float (&v)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
    v[i] = (i < n) ? to_float(x[(long long)i * d + c]) : CUDART_INF_F;
  return any_nan(v);
}

// The median of n sorted values: the middle one, or the mean of the two
// middle ones for even n.
template <int M>
__device__ __forceinline__ float median_regs(const float (&s)[M], int n) {
  if (n % 2) return reg_at(s, n / 2);
  return 0.5f * (reg_at(s, n / 2 - 1) + reg_at(s, n / 2));
}

// The mean of sorted values f .. n - f - 1, summed in that order.
template <int M>
__device__ __forceinline__ float trimmed_mean_regs(const float (&s)[M], int n,
                                                   int f) {
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < M; ++r)
    if (r >= f && r < n - f) acc = (r == f) ? s[r] : acc + s[r];
  return acc * (1.f / (float)(n - 2 * f));
}

// The grid of a kernel that walks d coordinates with a grid stride, one
// per thread at a time: as many CTAs of `threads` as the card holds at
// once (counted at the first launch of each kernel instance, into
// *resident), or fewer when d needs fewer.  Per-CTA set-up then runs once
// per resident CTA, not once per tile.
template <typename Kernel>
static unsigned persistent_grid(Kernel kernel, int threads, long long d,
                                int* resident) {
  if (!*resident) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    *resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles = (d + threads - 1) / threads;
  return (unsigned)(tiles < *resident ? (tiles > 0 ? tiles : 1)
                                      : *resident);
}

// lo[r] = lo[r - SH] for r >= SH.  SH is a template argument, so every
// index is a constant and lo stays in registers.
template <int SH, int M>
__device__ __forceinline__ void shift_up(float (&lo)[M]) {
#pragma unroll
  for (int r = M - 1; r >= SH; --r) lo[r] = lo[r - SH];
}

// Shift lo up by a runtime (warp-uniform) count: one fixed shift per set
// bit of `by`.
template <int M, std::size_t... B>
__device__ __forceinline__ void shift_up_by(float (&lo)[M], int by,
                                            std::index_sequence<B...>) {
  ((by & (1 << B) ? shift_up<(1 << B)>(lo) : void()), ...);
}

// Bulyan's window over theta sorted values (theta <= M, the rest +inf):
// the mean of the best beta = theta - 2f consecutive values around the
// lower-middle median, by running prefix sums that add in the order of
// the reference's pref_v / pref_d: at sorted position r the window
// [r - beta + 1, r] gains s[r] and loses s[r - beta].  That second index
// is runtime, so `lo` holds s shifted up by beta (a barrel shift over
// beta's bits, each a warp-uniform branch of register moves:
// shift_up_by), and lo[r] = s[r - beta].  Slots past theta (the +inf
// padding) are never read.
template <int M>
__device__ __forceinline__ float bulyan_window_regs(const float (&s)[M],
                                                    int theta, int f) {
  const int beta = theta - 2 * f;
  const float med = reg_at(s, (theta - 1) / 2);
  if (beta == theta) {
    float acc = s[0];
#pragma unroll
    for (int r = 1; r < M; ++r) {
      if (r >= theta) break;
      acc = acc + s[r];
    }
    return acc * (1.f / (float)beta);
  }
  float lo[M];
#pragma unroll
  for (int r = 0; r < M; ++r) lo[r] = s[r];
  shift_up_by(lo, beta, std::make_index_sequence<log2_ceil(M)>{});
  float pv_lo = 0.f, pd_lo = 0.f, pv_hi = 0.f, pd_hi = 0.f;
  float best_dev = 0.f, best_sum = 0.f;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r >= theta) break;  // warp-uniform
    pv_hi = pv_hi + s[r];
    pd_hi = pd_hi + fabsf(s[r] - med);
    if (r >= beta) {
      pv_lo = pv_lo + lo[r];
      pd_lo = pd_lo + fabsf(lo[r] - med);
    }
    if (r >= beta - 1) {
      const float dev = pd_hi - pd_lo;
      const float sum = pv_hi - pv_lo;
      if (r == beta - 1 || dev < best_dev) {  // first-window tiebreak
        best_dev = dev;
        best_sum = sum;
      }
    }
  }
  return best_sum * (1.f / (float)beta);
}

// ---------------------------------------------------------------------------
// the coordinate kernel (K2, K3, and K4's cwmed and trimmed_mean modes)
// ---------------------------------------------------------------------------

constexpr int kStatsThreads = 128;

// The outputs coord_stats_kernel writes, fixed at compile time: a
// runtime choice cost K3 and K4's coordinate modes 2-6 us on the CNN's
// stack (PERF.md §6).  kMedian and kBulyan both write loc.
constexpr int kMedian = 1, kTrimmed = 2, kBulyan = 4;

// Per coordinate of an (n, d) row-major stack: one sort of the n values,
// then, as Out asks, the median (kMedian) or the mean of Bulyan's window
// of n - 2f values (kBulyan) into loc, and the mean of the sorted values
// f .. n - f - 1 into trim; NaN wherever the column holds a NaN.  One
// coordinate per thread at a time, walked with a grid stride.
template <typename T, int M, int Out>
__global__ void __launch_bounds__(kStatsThreads)
coord_stats_kernel(const T* __restrict__ x, int n, long long d, int f,
                   float* __restrict__ loc, float* __restrict__ trim) {
  static_assert(!((Out & kMedian) && (Out & kBulyan)),
                "the median and Bulyan's window share loc");
  const long long step = (long long)gridDim.x * kStatsThreads;
  for (long long c = (long long)blockIdx.x * kStatsThreads + threadIdx.x;
       c < d; c += step) {
    float v[M];
    const bool nan = load_column<M>(x, n, d, c, v);
    sort_regs(v);
    const float m = (Out & kMedian)   ? median_regs(v, n)
                    : (Out & kBulyan) ? bulyan_window_regs(v, n, f)
                                      : 0.f;
    const float t = (Out & kTrimmed) ? trimmed_mean_regs(v, n, f) : 0.f;
    if (Out & (kMedian | kBulyan)) loc[c] = nan ? CUDART_NAN_F : m;
    if (Out & kTrimmed) trim[c] = nan ? CUDART_NAN_F : t;
  }
}

// coord_stats_kernel in the bucket of n on a persistent grid.
template <int Out, typename T>
static int launch_coord_stats(const T* x, int n, long long d, int f,
                              float* loc, float* trim, cudaStream_t stream) {
  return with_bucket(n, [&](auto bucket) {
    constexpr int M = decltype(bucket)::value;
    static int resident = 0;
    const unsigned grid = persistent_grid(coord_stats_kernel<T, M, Out>,
                                          kStatsThreads, d, &resident);
    coord_stats_kernel<T, M, Out><<<grid, kStatsThreads, 0, stream>>>(
        x, n, d, f, loc, trim);
    return (int)cudaGetLastError();
  });
}

}  // namespace repro_torch
