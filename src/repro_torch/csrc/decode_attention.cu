// Decode attention over a KV cache, read where it lies: the queries of a
// few new tokens per cache slot against that slot's keys and values, up
// to each query's valid length (models/attention.py::decode_attention
// and verify_attention, the serving steps' cached attention).
//
// Replaces no Pallas kernel: the JAX package's decode_attention is plain
// jnp.  It was added because the plain path (two einsums around a masked
// softmax) copies K and V into (b, h, k, d) order before its products and
// reads every position of the cache, attended or not: at the serving
// cell's 7 replicas x 12 slots x 4 layers of 2,048 positions, 14 GB
// copied and read again per decode step.
//
// What bounds it on an H100: the bytes.  Each key and value up to a
// query's valid length is read once (2 x D x 4 B a position and KV head
// in fp32) for 2 x G x Sq FLOPs per element: well under one FLOP a byte,
// so the least time is the K/V bytes up to the valid lengths at
// 3.35 TB/s.  Design:
//   * one block per (row, KV head, query group, split of the length): a
//     row is one (replica, slot) pair, found through the two leading
//     batch strides of q, k and v, so a period view of the replica-
//     stacked cache is read in place, never copied; the last three dims
//     (L, Hkv, D) of k and v are dense;
//   * each block streams tiles of its KV head's K and V rows (4,096 / D
//     positions, at most 128) into shared memory with 16-byte cp.async
//     copies, double-buffered, and uses each tile for all G x Sq queries
//     of that head (GQA and verify blocks); positions at or past the
//     largest valid length of the block's queries are never read (their
//     shared rows are zero-filled), and a query's positions past its own
//     length score -inf, whose exp is exactly 0 in fp32;
//   * scores q.k / sqrt(D), the online softmax's running max and sum and
//     the output accumulator are fp32 FFMA (TF32 plays no part); a bf16
//     cache is widened to fp32 as it is read, and the output is written
//     in the cache's dtype;
//   * the length splits into pieces of split_len positions, chosen by the
//     wrapper from L alone; with more than one piece each block writes
//     its unnormalised partial (max, sum, accumulator) and a second
//     kernel combines the pieces of each query in piece order.  The
//     split, the tiles and every sum's order come from the shapes alone
//     and no float atomic is used, so identical inputs in two rows give
//     identical bits whatever the number of rows (a replica's row run
//     alone and run among the ensemble's agree bit for bit).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of a row as fp32: 4 floats, or 8 bf16 widened exactly.
__device__ __forceinline__ void unpack(const float* p, float* f) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}

__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float* f) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Tile {
  // positions per shared tile: 16 KB of fp32 K rows, at most 128
  static constexpr int kRows = (4096 / D < 128) ? 4096 / D : 128;
};

// The shared-memory bytes of one block (the wrapper's launch needs them).
template <typename T, int D>
__host__ __device__ constexpr size_t tile_bytes() {
  return 2 * 2 * static_cast<size_t>(Tile<D>::kRows) * D * sizeof(T);
}

template <typename T, int D>
size_t shared_bytes(int qper) {
  return tile_bytes<T, D>() +
         sizeof(float) * (2 * static_cast<size_t>(qper) * D +
                          static_cast<size_t>(qper) * Tile<D>::kRows +
                          4 * static_cast<size_t>(qper));
}

struct Shape {
  long long qs0, qs1, ks0, ks1, vs0, vs1;  // the two leading batch strides
  int batch;      // slots per replica: row r is (r / batch, r % batch)
  int sq, hq, hkv, length;
  int split_len, splits;  // pieces of the length
  int qgroups, qper;      // query groups of a KV head, queries per group
  long long parts;        // rows x hkv x G x sq x splits
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ valid,
                            T* __restrict__ out, float* __restrict__ part,
                            Shape s) {
  constexpr int kVec = 16 / sizeof(T);           // elements per 16 bytes
  constexpr int kChunks = D / kVec;              // 16-byte chunks a row
  constexpr int kTile = Tile<D>::kRows;
  constexpr int kLanes = kChunks < 8 ? kChunks : 8;  // lanes per dot
  constexpr int kPer = kChunks / kLanes;         // chunks per lane
  constexpr int kGroups = kThreads / kLanes;     // dots in flight

  extern __shared__ __align__(16) unsigned char smem[];
  T* kv_s = reinterpret_cast<T*>(smem);  // [stage][K, V][kTile][D]
  float* q_s = reinterpret_cast<float*>(smem + tile_bytes<T, D>());
  float* acc_s = q_s + s.qper * D;       // [qper][D]
  float* p_s = acc_s + s.qper * D;       // [qper][kTile]
  float* m_s = p_s + s.qper * kTile;     // running max
  float* l_s = m_s + s.qper;             // running sum
  float* c_s = l_s + s.qper;             // this tile's correction
  int* len_s = reinterpret_cast<int*>(c_s + s.qper);

  const int tid = threadIdx.x;
  long long b = blockIdx.x;
  const int split = static_cast<int>(b % s.splits);
  b /= s.splits;
  const int qg = static_cast<int>(b % s.qgroups);
  b /= s.qgroups;
  const int h = static_cast<int>(b % s.hkv);
  const long long row = b / s.hkv;
  const long long n = row / s.batch, bi = row % s.batch;
  const int g_heads = s.hq / s.hkv;
  const int qn = g_heads * s.sq;  // queries of one KV head
  const int q0 = qg * s.qper;
  const int nq = min(s.qper, qn - q0);

  // query i of the block is qi = q0 + i: token qi / G, head h G + qi % G
  const T* qrow = q + n * s.qs0 + bi * s.qs1;
  for (int i = tid; i < nq * D; i += kThreads) {
    const int qi = q0 + i / D;
    q_s[i] = widen(qrow[(static_cast<long long>(qi / g_heads) * s.hq +
                         h * g_heads + qi % g_heads) *
                            D +
                        i % D]);
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < nq; i += kThreads) {
    const int len = valid[row * s.sq + (q0 + i) / g_heads];
    len_s[i] = min(max(len, 0), s.length);
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  __syncthreads();
  int longest = 0;
  for (int i = 0; i < nq; ++i) longest = max(longest, len_s[i]);
  const int start = split * s.split_len;
  const int end = min(start + s.split_len, longest);

  const T* kbase = k + n * s.ks0 + bi * s.ks1 + static_cast<long long>(h) * D;
  const T* vbase = v + n * s.vs0 + bi * s.vs1 + static_cast<long long>(h) * D;
  const long long pos_stride = static_cast<long long>(s.hkv) * D;
  auto load_tile = [&](int first, int stage) {
    T* ks = kv_s + stage * 2 * kTile * D;
    T* vs = ks + kTile * D;
    const int rows = min(kTile, end - first);
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int t = i / kChunks, c = i % kChunks;
      T* dk = ks + t * D + c * kVec;
      T* dv = vs + t * D + c * kVec;
      if (t < rows) {
        const long long off = (first + t) * pos_stride + c * kVec;
        cp_async16(dk, kbase + off);
        cp_async16(dv, vbase + off);
      } else {  // past the block's longest length: never read
        *reinterpret_cast<uint4*>(dk) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dv) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  const float sqrt_d = sqrtf(static_cast<float>(D));
  const int tiles = end > start ? (end - start + kTile - 1) / kTile : 0;
  if (tiles > 0) load_tile(start, 0);
  for (int it = 0; it < tiles; ++it) {
    const int first = start + it * kTile;
    if (it + 1 < tiles) {
      load_tile(first + kTile, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = kv_s + (it & 1) * 2 * kTile * D;
    const T* vs = ks + kTile * D;

    // scores: kLanes neighbouring lanes share one (query, position) dot,
    // each over its chunks, then a butterfly over the lanes (every lane
    // of a warp runs the same number of rounds)
    const int lane = tid % kLanes, grp = tid / kLanes;
    for (int base = 0; base < nq * kTile; base += kGroups) {
      const int pair = base + grp;
      const bool ok = pair < nq * kTile;
      const int qi = ok ? pair / kTile : 0, t = ok ? pair % kTile : 0;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = j * kLanes + lane;
        float kf[kVec], qf[kVec];
        unpack(ks + t * D + c * kVec, kf);
#pragma unroll
        for (int e = 0; e < kVec; e += 4)
          unpack(q_s + qi * D + c * kVec + e, qf + e);
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qf[e], kf[e], dot);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(kFull, dot, o);
      if (ok && lane == 0)
        p_s[qi * kTile + t] =
            first + t < min(len_s[qi], end) ? dot / sqrt_d : -INFINITY;
    }
    __syncthreads();

    // the online softmax, one warp per query
    const int warp = tid / 32, wl = tid % 32;
    for (int qi = warp; qi < nq; qi += kThreads / 32) {
      float* p = p_s + qi * kTile;
      float mt = -INFINITY;
      for (int t = wl; t < kTile; t += 32) mt = fmaxf(mt, p[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, o));
      const float m_old = m_s[qi];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      for (int t = wl; t < kTile; t += 32) {
        const float e = p[t] == -INFINITY ? 0.f : expf(p[t] - m_new);
        p[t] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      if (wl == 0) {
        const float corr = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        c_s[qi] = corr;
        l_s[qi] = fmaf(l_s[qi], corr, sum);
        m_s[qi] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . V, one thread per (query, 16-byte chunk)
    for (int u = tid; u < nq * kChunks; u += kThreads) {
      const int qi = u / kChunks, c = u % kChunks;
      const float* p = p_s + qi * kTile;
      float sum[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) sum[e] = 0.f;
#pragma unroll 4
      for (int t = 0; t < kTile; ++t) {
        float vf[kVec];
        unpack(vs + t * D + c * kVec, vf);
        const float pt = p[t];
#pragma unroll
        for (int e = 0; e < kVec; ++e) sum[e] = fmaf(pt, vf[e], sum[e]);
      }
      float* a = acc_s + qi * D + c * kVec;
      const float corr = c_s[qi];
#pragma unroll
      for (int e = 0; e < kVec; ++e) a[e] = fmaf(a[e], corr, sum[e]);
    }
    __syncthreads();
  }

  if (s.splits == 1) {  // the whole length: normalise and write
    for (int i = tid; i < nq * D; i += kThreads) {
      const int qi = q0 + i / D;
      const float l = l_s[i / D];
      put(out + ((row * s.sq + qi / g_heads) * s.hq + h * g_heads +
                 qi % g_heads) *
                        D +
                    i % D,
          l > 0.f ? acc_s[i] / l : 0.f);
    }
    return;
  }
  // a piece: its unnormalised partial, (row, h, query, piece) major to
  // minor; a piece past every length has max -inf and is skipped
  const long long first_part =
      ((row * s.hkv + h) * qn + q0) * s.splits + split;
  for (int i = tid; i < nq * D; i += kThreads)
    part[(first_part + static_cast<long long>(i / D) * s.splits) * D +
         i % D] = acc_s[i];
  float* ml = part + s.parts * D;
  for (int i = tid; i < nq; i += kThreads) {
    ml[2 * (first_part + static_cast<long long>(i) * s.splits)] = m_s[i];
    ml[2 * (first_part + static_cast<long long>(i) * s.splits) + 1] = l_s[i];
  }
}

// One block per (row, KV head, query): the pieces in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attention_combine(const float* __restrict__ part,
                             T* __restrict__ out, int d, Shape s) {
  const int g_heads = s.hq / s.hkv;
  const int qn = g_heads * s.sq;
  const long long idx = blockIdx.x;
  const int qi = static_cast<int>(idx % qn);
  const long long rh = idx / qn;
  const int h = static_cast<int>(rh % s.hkv);
  const long long row = rh / s.hkv;
  const float* acc = part + idx * s.splits * d;
  const float* ml = part + s.parts * d + idx * s.splits * 2;
  float m = -INFINITY;
  for (int p = 0; p < s.splits; ++p) m = fmaxf(m, ml[2 * p]);
  float l = 0.f;
  for (int p = 0; p < s.splits; ++p)
    if (ml[2 * p] != -INFINITY) l = fmaf(ml[2 * p + 1], expf(ml[2 * p] - m), l);
  T* o = out + ((row * s.sq + qi / g_heads) * s.hq + h * g_heads +
                qi % g_heads) *
                   d;
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float a = 0.f;
    for (int p = 0; p < s.splits; ++p)
      if (ml[2 * p] != -INFINITY)
        a = fmaf(acc[static_cast<long long>(p) * d + e],
                 expf(ml[2 * p] - m), a);
    put(o + e, l > 0.f ? a / l : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, void* part, long long rows, const Shape& s,
           cudaStream_t stream) {
  const size_t bytes = shared_bytes<T, D>(s.qper);
  auto kern = decode_attention_kernel<T, D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks =
      rows * s.hkv * static_cast<long long>(s.qgroups) * s.splits;
  kern<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(valid),
      static_cast<T*>(out), static_cast<float*>(part), s);
  if (s.splits > 1) {
    const long long queries =
        rows * s.hkv * static_cast<long long>(s.hq / s.hkv) * s.sq;
    decode_attention_combine<T>
        <<<static_cast<unsigned>(queries), kThreads, 0, stream>>>(
            static_cast<const float*>(part), static_cast<T*>(out), D, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* valid, void* out, void* part, long long rows,
             const Shape& s, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, 8>(q, k, v, valid, out, part, rows, s, stream);
    case 16: return launch<T, 16>(q, k, v, valid, out, part, rows, s, stream);
    case 32: return launch<T, 32>(q, k, v, valid, out, part, rows, s, stream);
    case 64: return launch<T, 64>(q, k, v, valid, out, part, rows, s, stream);
    case 128:
      return launch<T, 128>(q, k, v, valid, out, part, rows, s, stream);
    case 256:
      return launch<T, 256>(q, k, v, valid, out, part, rows, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro_torch

extern "C" {

// q (N, B, Sq, Hq, D) with strides (qs0, qs1, Sq-Hq-D dense); k, v
// (N, B, L, Hkv, D) with strides (ks0, ks1) / (vs0, vs1), L-Hkv-D dense;
// valid (N B Sq) int32; out (N, B, Sq, Hq, D) dense; part the pieces'
// scratch, (rows Hkv G Sq splits) x (D + 2) floats when splits > 1.
int decode_attention_run(int bf16, const void* q, long long qs0,
                         long long qs1, const void* k, long long ks0,
                         long long ks1, const void* v, long long vs0,
                         long long vs1, const void* valid, void* out,
                         void* part, int n, int batch, int sq, int hq,
                         int hkv, int length, int d, int split_len,
                         int splits, int qgroups, int qper, void* stream) {
  using namespace repro_torch;
  const long long rows = static_cast<long long>(n) * batch;
  Shape s{qs0, qs1, ks0, ks1, vs0, vs1, batch, sq, hq, hkv, length,
          split_len, splits, qgroups, qper,
          rows * hkv * static_cast<long long>(hq / hkv) * sq * splits};
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, valid, out, part, rows,
                                        s, st)
              : dispatch<float>(d, q, k, v, valid, out, part, rows, s, st);
}

}  // extern "C"
