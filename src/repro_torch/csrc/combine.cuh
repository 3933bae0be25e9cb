// K4's per-coordinate contraction of the selection weights, in registers.
//
// The reference contracts each (n, block_d) slab with the (theta_w, n)
// weights by dot_general (repro/kernels/fused_agg.py:246 _combine_tile).
// The weights come from the selection, so each row is almost always
// one-hot (krum, geomed, Bulyan's picks) or all zero (a selection that
// met a NaN picks no one); multikrum's one row is general (1/m on its m
// picks).  fused_agg.cu decodes each row once per CTA: the picked row,
// kRowZero or kRowGeneral.
//
// One-hot and all-zero rows are the fmaf chain of a general row,
// acc = fmaf(w[t][i], x[i], acc) for i = 0..n-1 from +0.0, to the bit,
// without its n multiply-adds: 0 * x is +-0 for a finite x, and adding
// +-0 to the chain changes nothing but the sign of a zero, while 0 * inf
// and 0 * NaN are NaN.  So row t's value is NaN when any row other than
// pick[t] is not finite at the coordinate, else x[pick[t]] + 0.0f (inf
// for a picked inf, NaN for a picked NaN, +0.0 for a picked -0.0), and
// +0.0 for an all-zero row.  Every row of the stack is read, as the
// reference reads it.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace repro_torch {

// decoded weight rows: a row index for a one-hot row, else one of these
constexpr int kRowZero = -1;     // every weight 0
constexpr int kRowGeneral = -2;  // anything else

// y[t] = the fmaf chain of weight row t < theta_w at one coordinate, +inf
// past theta_w.  xc points at the coordinate in row 0; rows lie d apart.
// Rows outer, so every y[t] keeps a fixed register.
template <int M, typename T>
__device__ __forceinline__ void chain_column(const T* __restrict__ xc,
                                             int n, long long d,
                                             const float* __restrict__ w,
                                             int theta_w, float (&y)[M]) {
#pragma unroll
  for (int t = 0; t < M; ++t) y[t] = t < theta_w ? 0.f : CUDART_INF_F;
  for (int i = 0; i < n; ++i) {
    const float xi = to_float(xc[(long long)i * d]);
#pragma unroll
    for (int t = 0; t < M; ++t)
      if (t < theta_w) y[t] = fmaf(w[t * n + i], xi, y[t]);
  }
}

// The value of the one weight row of krum, geomed and multikrum at one
// coordinate, by the row's decoded kind.
template <typename T>
__device__ __forceinline__ float single_row(const T* __restrict__ xc, int n,
                                            long long d,
                                            const float* __restrict__ w,
                                            int kind) {
  if (kind == kRowGeneral) {
    float y[1];
    chain_column(xc, n, d, w, 1, y);
    return y[0];
  }
  // each row read once; the loads are independent and predicated, so
  // all n are in flight at once.  All kMaxN slots, not n's size bucket:
  // the bucket's fewer registers let more CTAs share an SM, and the
  // kernel read the stack slower (PERF.md §6)
  float v = 0.f;  // the picked row's value (kRowZero: none, +0.0)
  int bad = 0;    // rows not finite at this coordinate
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    const float xi = i < n ? to_float(xc[(long long)i * d]) : 0.f;
    bad += !(fabsf(xi) < CUDART_INF_F);
    v = (i == kind) ? xi : v;
  }
  const int own = !(fabsf(v) < CUDART_INF_F);
  return (bad - own > 0) ? CUDART_NAN_F : v + 0.f;
}

// Row indices of a CTA's decoded weights, four to a 32-bit register (the
// stack has n <= 64 rows), for compile-time slots t < K.
template <int K>
struct PackedRows {
  unsigned word[(K + 3) / 4];
  __device__ __forceinline__ int operator[](int t) const {
    return (word[t >> 2] >> (8 * (t & 3))) & 0xffu;
  }
};

// Bulyan's theta_w rows when they pick distinct rows: the picked rows
// (pick) and the u = n - theta_w rows no weight row picks (other), in
// slots fixed at compile time.  For Bulyan u = 2f < theta_w <= M.
template <int M>
struct BulyanRows {
  PackedRows<M> pick;
  PackedRows<M> other;
  int u;
};

// From the decoded kinds (kind[t] >= 0, distinct: see the caller) and
// the rows no weight row picks, in row order (other[0 .. n - theta_w)).
template <int M>
__device__ __forceinline__ BulyanRows<M> bulyan_rows(const int* kind,
                                                     const int* other,
                                                     int theta_w, int n) {
  BulyanRows<M> r;
  r.u = n - theta_w;
#pragma unroll
  for (int q = 0; q < (M + 3) / 4; ++q) {
    r.pick.word[q] = 0u;
    r.other.word[q] = 0u;
  }
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const unsigned p = t < theta_w ? (unsigned)kind[t] : 0u;
    const unsigned o = t < r.u ? (unsigned)other[t] : 0u;
    r.pick.word[t >> 2] |= p << (8 * (t & 3));
    r.other.word[t >> 2] |= o << (8 * (t & 3));
  }
  return r;
}

// Bulyan's theta_w >= 2 rows at one coordinate when they pick distinct
// rows: y[t] = x[pick[t]] for t < theta_w, +inf past it; every other row
// read only for its finiteness.  Returns whether any row is not finite
// at the coordinate: then some row's value is NaN (0 * x of another row,
// or the picked NaN), and so is Bulyan's result.  Every load is
// independent and predicated, so all are in flight at once.
template <int M, typename T>
__device__ __forceinline__ bool picked_column(const T* __restrict__ xc,
                                              long long d,
                                              const BulyanRows<M>& rows,
                                              int theta_w, float (&y)[M]) {
#pragma unroll
  for (int t = 0; t < M; ++t)
    y[t] = t < theta_w ? to_float(xc[(long long)rows.pick[t] * d])
                       : CUDART_INF_F;
  int bad = 0;
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const float v = t < rows.u ? to_float(xc[(long long)rows.other[t] * d])
                               : 0.f;
    bad += (t < theta_w) & !(fabsf(y[t]) < CUDART_INF_F);
    bad += !(fabsf(v) < CUDART_INF_F);
  }
  return bad > 0;
}

}  // namespace repro_torch
