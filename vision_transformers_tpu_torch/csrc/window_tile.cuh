// CUDA-core body of the window-attention forwards (window_attention.cu,
// window_fused_attention.cu): the fp32 kernels of rows 9, 11, 12 and 13 (in
// bf16 all of them run on the tensor cores, window_mma_tile.cuh); the fp32
// backward of row 10 (window_attention_bwd.cu) shares its row I/O, and the
// chunked fp32 kernels of rows 10 and 11 (other head dims) its chunk I/O
// (stage_chunk). For one (window, head)
//   out = softmax(q·kᵀ·scale + bias)·v,   N <= 128 tokens, D = 1, 2, 4, 8,
//   16, 32 or 64 (rows read by 16-byte vectors, or a float2 or a float at
//   D 2 and 1),
// with q, k, v read in place from a packed projection whose token rows the
// caller's RowMap names (row index → q at column h·D, k one section further,
// v two), so the same body serves the partitioned (G, N, 3·H·D) tensor and
// the un-rolled NHWC map.
//
// Design. A window is small (N <= 128 keys), so its K and V fit in shared
// memory as fp32 and ONE THREAD OWNS ONE QUERY ROW: q (scaled) and the output
// accumulator live in registers, every lane of a window reads the same K/V
// address (a shared-memory broadcast), and no two threads ever exchange a
// value: no warp shuffles and no barrier inside the softmax. Keys go by in
// chunks of 8 with an online softmax (one rescale of the accumulator per
// chunk), so no N×N score tile is stored anywhere. This is the opposite
// trade of attention_tile.cuh (one lane per key, ~1 shared load per FMA):
// here a 16-byte shared load feeds 4 FMAs in each of the warp's 32 rows.
// The products are fp32 FMAs on the CUDA cores.
//
// Numerics follow the TPU kernels: fp32 scores and statistics; the row max
// is taken before any exp, so a mask of −100 or −1e9 (never a whole row)
// only ever gives exp(very negative) = 0. The TPU kernels round the
// normalised probabilities to the compute dtype before P·V; in fp32 that
// rounding is the identity, and one pass with the division after P·V gives
// the same function to summation order.
#pragma once

#include <type_traits>

#include "attention_tile.cuh"

namespace vtt {

constexpr int kWinChunk = 8;         // keys per online-softmax step
constexpr int kWinMaxThreads = 256;  // query rows per block
constexpr int kWinMaxTokens = 128;

// 16-byte vector load/store of kVec elements of T to/from fp32.
template <typename T>
struct RowIO;

template <>
struct RowIO<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void load(const float* p, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* src) {
    *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
  }
};

// The vector width of a row of D elements of T: RowIO's 16 bytes, or at a
// head dim below 4 (fp32 dh 1 and 2) the whole row, whose offsets (h·D, the
// sections, the rows) keep only D elements' alignment.
template <typename T, int D>
__host__ __device__ constexpr int row_vec() {
  return D < RowIO<T>::kVec ? D : RowIO<T>::kVec;
}

// V elements of fp32 at p to/from registers: RowIO's 16-byte vector, or a
// float2 or a float.
template <int V>
__device__ __forceinline__ void row_load(const float* p, float* dst) {
  if constexpr (V == 4) {
    RowIO<float>::load(p, dst);
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
    dst[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void row_store(float* p, const float* src) {
  if constexpr (V == 4)
    RowIO<float>::store(p, src);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(src[0], src[1]);
  else
    *p = src[0];
}

// Tokens of the partitioned (G, N, ·) tensor: window g, token i → row g·N + i.
struct PackedRows {
  int n;
  __device__ __forceinline__ long long operator()(long long g, int i) const {
    return g * n + i;
  }
};

// K and V of head column `col` (= h·D) of windows [w0, w0 + count) into
// shared memory as fp32: ks/vs[(w·n + i)·D + d]. Consecutive threads take
// consecutive 16-byte pieces of one token's D elements, then the next token.
template <typename T, int D, typename RowMap>
__device__ __forceinline__ void stage_kv(
    const T* __restrict__ qkv, const RowMap& map, long long w0, int count,
    int n, long long col, long long sec, long long row_stride,
    float* __restrict__ ks, float* __restrict__ vs) {
  constexpr int V = row_vec<T, D>();
  constexpr int C = D / V;
  const int total = count * n * C;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int c = idx % C;
    const int tok = idx / C;
    const int w = tok / n, i = tok % n;
    const T* src = qkv + map(w0 + w, i) * row_stride + col + c * V;
    float tmp[V];
    row_load<V>(src + sec, tmp);
    float* kd = ks + tok * D + c * V;
#pragma unroll
    for (int e = 0; e < V; ++e) kd[e] = tmp[e];
    row_load<V>(src + 2 * sec, tmp);
    float* vd = vs + tok * D + c * V;
#pragma unroll
    for (int e = 0; e < V; ++e) vd[e] = tmp[e];
  }
}

// r · x for a register vector r and a 16-byte aligned shared-memory row x.
template <int D>
__device__ __forceinline__ float dot_row(const float* r,
                                         const float* __restrict__ x) {
  if constexpr (D < 4) {  // fp32 dh 1 and 2: rows of D floats
    float a = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) a = fmaf(r[d], x[d], a);
    return a;
  }
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float a = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 xx = x4[d4];
    a = fmaf(r[4 * d4], xx.x, a);
    a = fmaf(r[4 * d4 + 1], xx.y, a);
    a = fmaf(r[4 * d4 + 2], xx.z, a);
    a = fmaf(r[4 * d4 + 3], xx.w, a);
  }
  return a;
}

// r += c · x.
template <int D>
__device__ __forceinline__ void axpy_row(float c, const float* __restrict__ x,
                                         float* r) {
  if constexpr (D < 4) {
#pragma unroll
    for (int d = 0; d < D; ++d) r[d] = fmaf(c, x[d], r[d]);
    return;
  }
  const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 xx = x4[d4];
    r[4 * d4] = fmaf(c, xx.x, r[4 * d4]);
    r[4 * d4 + 1] = fmaf(c, xx.y, r[4 * d4 + 1]);
    r[4 * d4 + 2] = fmaf(c, xx.z, r[4 * d4 + 2]);
    r[4 * d4 + 3] = fmaf(c, xx.w, r[4 * d4 + 3]);
  }
}

// One query row against its window's n keys. q_row, o_row: this row's D
// elements in device memory (16-byte aligned). ks, vs: the window's K and V
// in shared memory. b_row: this row's n bias values (shared memory fp32 or
// device memory T) or null.
template <typename T, int D, typename B>
__device__ __forceinline__ void attend_row(
    const T* __restrict__ q_row, const float* __restrict__ ks,
    const float* __restrict__ vs, const B* __restrict__ b_row, int n,
    float scale, T* __restrict__ o_row) {
  static_assert(D == 1 || D == 2 || D == 4 || D == 8 || D == 16 || D == 32 ||
                    D == 64,
                "head dim must be 1, 2, 4, 8, 16, 32 or 64");
  static_assert(std::is_same_v<T, float>, "bf16 takes window_mma_tile.cuh");
  constexpr int V = row_vec<T, D>();
  float q[D], acc[D];
#pragma unroll
  for (int c = 0; c < D / V; ++c) row_load<V>(q_row + c * V, q + c * V);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] *= scale;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  // one pass: p = exp(s − m) against the running max, the accumulator
  // rescaled once a chunk, the output divided by l after P·V
  for (int j0 = 0; j0 < n; j0 += kWinChunk) {
    float s[kWinChunk];
#pragma unroll
    for (int c = 0; c < kWinChunk; ++c) {
      const int j = j0 + c;
      float x = -CUDART_INF_F;  // past the window's last key: p = 0
      if (j < n) {
        float a = 0.f;
        if constexpr (D < 4) {
          a = dot_row<D>(q, ks + j * D);
        } else {
          const float4* k4 = reinterpret_cast<const float4*>(ks + j * D);
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 kk = k4[d4];
            a = fmaf(q[4 * d4], kk.x, a);
            a = fmaf(q[4 * d4 + 1], kk.y, a);
            a = fmaf(q[4 * d4 + 2], kk.z, a);
            a = fmaf(q[4 * d4 + 3], kk.w, a);
          }
        }
        x = a;
        if (b_row != nullptr) x += to_f32(b_row[j]);
      }
      s[c] = x;
    }
    float m_new = m;  // key j0 is in the window, so m_new is finite
#pragma unroll
    for (int c = 0; c < kWinChunk; ++c) m_new = fmaxf(m_new, s[c]);
    const float alpha = expf(m - m_new);  // first chunk: exp(-inf) = 0
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int c = 0; c < kWinChunk; ++c) {
      const int j = j0 + c;
      if (j < n) {
        const float p = expf(s[c] - m_new);
        l += p;
        if constexpr (D < 4) {
          axpy_row<D>(p, vs + j * D, acc);
        } else {
          const float4* v4 = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 vv = v4[d4];
            acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
            acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
            acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
            acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
          }
        }
      }
    }
    m = m_new;
  }

  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] *= inv;
#pragma unroll
  for (int c = 0; c < D / V; ++c) row_store<V>(o_row + c * V, acc + c * V);
}

// Columns a chunk of the chunked fp32 kernels of rows 10 and 11
// (window_batched_chunked_kernel, window_bwd_chunked_kernel): at a head dim
// outside 1, 2, 4, 8, 16, 32 and 64 they keep a window's N × N scores in
// shared memory, one thread a row, and pass the head dim in chunks of this
// many columns (ops/flash_attention.py's _WINDOW_CHUNK).
constexpr int kWinCols = 32;

// Columns [c0, c0 + kWinCols) of `rows` consecutive token rows of a head dim
// dh, rows `row_stride` elements apart from `src` (column 0 of the head), into
// shared memory as fp32 (rows, kWinCols), columns >= dh zero; consecutive
// threads on consecutive columns.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ src,
                                            long long row_stride, int rows,
                                            int c0, int dh,
                                            float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < rows * kWinCols; idx += blockDim.x) {
    const int r = idx / kWinCols, c = idx % kWinCols;
    dst[idx] = c0 + c < dh ? src[r * row_stride + c0 + c] : 0.f;
  }
}

// Columns [c0, c0 + kWinCols) of one row of head dim dh into registers,
// zeros past dh.
__device__ __forceinline__ void load_chunk(const float* __restrict__ src,
                                           int c0, int dh, float* r) {
#pragma unroll
  for (int c = 0; c < kWinCols; ++c) r[c] = c0 + c < dh ? src[c0 + c] : 0.f;
}

// The columns of a chunk below dh to one row.
__device__ __forceinline__ void store_chunk(float* __restrict__ dst, int c0,
                                            int dh, const float* r) {
#pragma unroll
  for (int c = 0; c < kWinCols; ++c)
    if (c0 + c < dh) dst[c0 + c] = r[c];
}

// Bytes of dynamic shared memory for K and V of p windows.
inline size_t window_kv_bytes(int p, int n, int d) {
  return static_cast<size_t>(p) * n * d * 2 * sizeof(float);
}

// Common argument checks of the C entries.
inline bool window_launch_ok(int n, int p, int threads) {
  return n >= 1 && n <= kWinMaxTokens && p >= 1 && threads >= 32 &&
         threads <= kWinMaxThreads && threads % 32 == 0 && p * n <= threads;
}

}  // namespace vtt
