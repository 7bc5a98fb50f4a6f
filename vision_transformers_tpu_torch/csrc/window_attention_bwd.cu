// Backward of window attention on the partitioned projection: one kernel for
// the packed, the batched and (around plain roll/partition steps) the two
// fused forward kernels.
//
// Replaces the TPU kernel vision_transformers_tpu/ops/flash_attention.py::
// _window_pack_bwd_kernel (:1466, reached through _window_pack_bwd_pallas
// :1562 from the rules at :1630, :1779 and :2310).
//
// qkv: (G, N, 3·H·D) as in window_attention.cu; bias: null or (nW', H, N, N)
// in the compute dtype, window g reads row g mod nW'; dout: (G, N, H·D).
// Per (window g, head h), everything recomputed from qkv and bias (no
// statistic of the forward is kept):
//   s  = q·kᵀ·scale + bias          p  = softmax(s), max taken before any exp
//   dp = dO·vᵀ                      ds = p ⊙ (dp − rowsum(dp ⊙ p))
//   dv = pᵀ·dO     dq = (ds·scale)·k     dk = (ds·scale)ᵀ·q
// dqkv: (G, N, 3·H·D), [dq | dk | dv] in the places of [q | k | v]; every
// element is written. ds_out: null, or (G, H, N, N) in the compute dtype, the
// score gradient before the scale: the caller sums it over the windows that
// share a bias row, in fp32, into the bias gradient.
//
// What bounds it on the H100 (Swin-T @224 stage 1, batch 32: G = 2048,
// N = 49, H = 3, D = 32, bf16): 10·G·H·N²·D = 4.7 GFLOP, 4.8 µs at
// 989 TFLOP/s, against 57.8 MB of qkv and 19.3 MB of dout read, 57.8 MB of
// dqkv written and, where the bias gradient is wanted, 29.5 MB of ds_out:
// 49 µs at 3.35 TB/s. Bytes. So the N×N tiles must never reach device
// memory except as ds_out, and qkv and dout are read once each.
//
// bf16 runs window_bwd_mma_kernel, every product on the tensor cores
// (window_mma_tile.cuh: a block takes wpb windows of one head, a warp per 16
// query rows and then per 16 keys of a window, p, ds·scale and ds staged as
// bf16 tiles in shared memory; its launch shape comes from N alone and the C
// entry's p and threads, the CUDA-core plan, are only checked; grid
// x = ceil(G / wpb), y = H). fp32 runs window_bwd_kernel, below.
//
// Design of window_bwd_kernel. A block takes P windows of one head; one
// thread owns one row, as in window_tile.cuh, and the block's two N×N tiles
// (p, then dp and ds) live in shared memory as fp32, so each of the five
// products is computed once (5·D FMAs per score) and nothing is recomputed
// for the transposed ones:
//   phase A, thread = query row i, K and V in shared memory read by
//     broadcast: s → tile 1 and the row max; exp and row sum; dp → tile 2,
//     p → tile 1, δ = Σ p·dp; ds → tile 2, dq accumulated in registers.
//     One D-vector of registers at a time (q, then dO, then dq).
//   phase B, thread = key row j, after a barrier; Q and dO replace K and V in
//     the same shared buffers: dk_j = Σ_i ds_ij·scale·q_i, dv_j = Σ_i p_ij·dO_i
//     down column j of the tiles, and ds_out written with consecutive lanes on
//     consecutive addresses.
// Every output element has one owner and every sum a fixed order: no atomics,
// so two runs give equal bits. The tiles' row stride is odd, so the lanes of a
// warp (rows in phase A, columns in phase B) fall in distinct banks. The
// products are fp32 FMAs on the CUDA cores, with their operands rounded to
// the compute dtype where _window_pack_bwd_kernel rounds them (:1521-1522):
// dv takes p rounded (probs_c), dq and dk take ds·scale rounded (ds_c). δ and
// ds are formed from the fp32 p of the tile, so p is rounded only where dv
// reads it in phase B; ds_out is the pre-scale ds rounded once, as the TPU
// kernel emits it. It is instantiated for fp32 alone, where every rounding is
// the identity.
// Grid: x = ceil(G / P), y = H; a ragged last block is bounds-checked.
//
// Other head dims (the backward of row 11, whose JAX plan takes any dh: the
// JAX package differentiates _window_pack_ref with jnp there, :1779-1800;
// here the kernel takes those dh too). bf16: window_bwd_mma_padded_kernel<T,
// NK> runs dh up to 64 in the tile T of window_tile(dh), the columns past dh
// read as zeros and never stored, the dh a runtime argument;
// window_bwd_mma_chunked_kernel<NK> takes the head dim in 64-column chunks
// above 64 (window_chunk_tile.cuh). fp32: window_bwd_chunked_kernel, phase A and B
// as below with the two score tiles in shared memory and K, V (then K, then
// Q and dO) staged in 32-column chunks (kWinCols).
#include "window_chunk_tile.cuh"
#include "window_mma_tile.cuh"
#include "window_tile.cuh"
#include "launch_log.cuh"

namespace {

using vtt::axpy_row;
using vtt::dot_row;
using vtt::kWinMaxThreads;
using vtt::row_load;
using vtt::row_store;
using vtt::row_vec;

constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block can ask for

// `rows` consecutive token rows of D elements, from column base `src` with
// `row_stride` elements between rows, into shared memory as fp32 (rows, D).
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           long long row_stride, int rows,
                                           float* __restrict__ dst) {
  constexpr int V = row_vec<T, D>();
  constexpr int C = D / V;
  for (int idx = threadIdx.x; idx < rows * C; idx += blockDim.x) {
    const int c = idx % C, r = idx / C;
    float tmp[V];
    row_load<V>(src + r * row_stride + c * V, tmp);
    float* d = dst + r * D + c * V;
#pragma unroll
    for (int e = 0; e < V; ++e) d[e] = tmp[e];
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_row(const T* __restrict__ src, float* r) {
  constexpr int V = row_vec<T, D>();
#pragma unroll
  for (int c = 0; c < D / V; ++c) row_load<V>(src + c * V, r + c * V);
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* __restrict__ dst, const float* r) {
  constexpr int V = row_vec<T, D>();
#pragma unroll
  for (int c = 0; c < D / V; ++c) row_store<V>(dst + c * V, r + c * V);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWinMaxThreads)
window_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                  const T* __restrict__ dout, T* __restrict__ dqkv,
                  T* __restrict__ ds_out, long long g, int n, int heads,
                  int bias_windows, float scale, int p) {
  static_assert(D == 1 || D == 2 || D == 4 || D == 8 || D == 16 || D == 32 ||
                    D == 64,
                "head dim must be 1, 2, 4, 8, 16, 32 or 64");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n | 1;  // odd row stride of the two score tiles
  float* xs = reinterpret_cast<float*>(smem_raw);  // K, then Q: (P·N, D)
  float* ys = xs + p * n * D;                      // V, then dO: (P·N, D)
  float* pt = ys + p * n * D;                      // p:          (P·N, ld)
  float* dt = pt + p * n * ld;                     // dp, then ds: (P·N, ld)

  const int h = blockIdx.y;
  const long long hd = static_cast<long long>(heads) * D;
  const long long w0 = static_cast<long long>(blockIdx.x) * p;
  const int count = static_cast<int>(min(static_cast<long long>(p), g - w0));
  const int rows = count * n;
  const T* q_base = qkv + w0 * n * 3 * hd + h * D;   // q of the first token
  const T* do_base = dout + w0 * n * hd + h * D;
  T* dq_base = dqkv + w0 * n * 3 * hd + h * D;

  stage_rows<T, D>(q_base + hd, 3 * hd, rows, xs);      // K
  stage_rows<T, D>(q_base + 2 * hd, 3 * hd, rows, ys);  // V
  __syncthreads();

  const int w = threadIdx.x / n, i = threadIdx.x % n;
  const bool active = w < count;
  const int t = w * n + i;  // this thread's token row within the block
  const float* xw = xs + w * n * D;
  const float* yw = ys + w * n * D;
  float r[D];

  if (active) {  // phase A: query row i of window w
    float* prow = pt + t * ld;
    float* drow = dt + t * ld;
    const T* b_row = bias == nullptr
        ? nullptr
        : bias + ((((w0 + w) % bias_windows) * heads + h) * n + i) * n;

    load_row<T, D>(q_base + t * 3 * hd, r);
#pragma unroll
    for (int d = 0; d < D; ++d) r[d] *= scale;
    float m = -CUDART_INF_F;
    for (int j = 0; j < n; ++j) {
      float s = dot_row<D>(r, xw + j * D);
      if (b_row != nullptr) s += vtt::to_f32(b_row[j]);
      prow[j] = s;
      m = fmaxf(m, s);
    }
    float l = 0.f;
    for (int j = 0; j < n; ++j) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      l += e;
    }
    const float inv = 1.f / l;

    load_row<T, D>(do_base + t * hd, r);
    float delta = 0.f;
    for (int j = 0; j < n; ++j) {
      const float dp = dot_row<D>(r, yw + j * D);
      const float pj = prow[j] * inv;
      prow[j] = pj;
      drow[j] = dp;
      delta = fmaf(pj, dp, delta);
    }

#pragma unroll
    for (int d = 0; d < D; ++d) r[d] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float ds = prow[j] * (drow[j] - delta);
      drow[j] = ds;
      axpy_row<D>(vtt::to_f32(vtt::from_f32<T>(ds * scale)), xw + j * D, r);
    }
    store_row<T, D>(dq_base + t * 3 * hd, r);
  }

  __syncthreads();  // K and V have been read; both tiles are complete
  stage_rows<T, D>(q_base, 3 * hd, rows, xs);  // Q
  stage_rows<T, D>(do_base, hd, rows, ys);     // dO
  __syncthreads();

  if (active) {  // phase B: key row i of window w, down column i of the tiles
    float dv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      r[d] = 0.f;  // dk
      dv[d] = 0.f;
    }
    const float* pcol = pt + w * n * ld + i;
    const float* dcol = dt + w * n * ld + i;
    T* ds_col = ds_out == nullptr
        ? nullptr
        : ds_out + ((w0 + w) * heads + h) * n * n + i;
    for (int a = 0; a < n; ++a) {
      const float pa = pcol[a * ld];
      const float ds = dcol[a * ld];
      if (ds_col != nullptr) ds_col[a * n] = vtt::from_f32<T>(ds);
      axpy_row<D>(vtt::to_f32(vtt::from_f32<T>(ds * scale)), xw + a * D, r);
      axpy_row<D>(vtt::to_f32(vtt::from_f32<T>(pa)), yw + a * D, dv);
    }
    store_row<T, D>(dq_base + t * 3 * hd + hd, r);
    store_row<T, D>(dq_base + t * 3 * hd + 2 * hd, dv);
  }
}

// Each window's shared memory: Q, K, V, dO (NK rows of T + 8), then the
// tiles bf16(p), bf16(ds·scale) and the bias, overwritten by bf16(ds)
// (NK rows of NK + 8), for window gw by the mt warps of window slot w. DH:
// the head dim, in the tile of width T (16 for DH 1-8), or 0 for the
// runtime dh of the padded kernel.
template <int T, int NK, int DH>
__device__ __forceinline__ void window_bwd_mma_window(
    const __nv_bfloat16* __restrict__ qkv,
    const __nv_bfloat16* __restrict__ bias,
    const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dqkv,
    __nv_bfloat16* __restrict__ ds_out, long long gw, int n, int heads,
    int bias_windows, float scale, int mt, int w, int t, int lane, int dh) {
  using vtt::mma::bf16;
  constexpr int S = T + 8, SB = NK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw)
             + w * vtt::mma::window_smem_elems<T, NK>(4, 3);
  bf16* ks = qs + NK * S;
  bf16* vs = ks + NK * S;
  bf16* dos = vs + NK * S;
  bf16* pt = dos + NK * S;  // bf16(p)
  bf16* dt = pt + NK * SB;  // bf16(ds·scale)
  bf16* xt = dt + NK * SB;  // the bias, then bf16(ds)

  const int h = blockIdx.y;
  const long long hd = static_cast<long long>(heads) * dh;
  const long long row0 = gw * n;  // token 0 of the window
  const bf16* src = qkv + row0 * 3 * hd + h * dh;
  const int tid = t * 32 + lane, count = mt * 32;
  vtt::mma::window_stage<T, NK, DH>(qs, src, n, 3 * hd, tid, count, dh);
  vtt::mma::window_stage<T, NK, DH>(ks, src + hd, n, 3 * hd, tid, count, dh);
  vtt::mma::window_stage<T, NK, DH>(vs, src + 2 * hd, n, 3 * hd, tid, count,
                                    dh);
  vtt::mma::window_stage<T, NK, DH>(dos, dout + row0 * hd + h * dh, n, hd,
                                    tid, count, dh);
  vtt::mma::cp_async_commit();
  if (bias != nullptr)
    vtt::mma::window_stage_bias<NK>(
        xt, bias + ((gw % bias_windows) * heads + h) * n * n, n, t, mt, lane);
  vtt::mma::cp_async_wait<0>();
  vtt::mma::window_sync(w, count);

  bf16* dq = dqkv + row0 * 3 * hd + h * dh;
  vtt::mma::window_bwd_rows_mma<T, NK, DH>(
      qs, ks, vs, dos, bias == nullptr ? nullptr : xt,
      ds_out == nullptr ? nullptr : xt, pt, dt, n, t, scale, dq, 3 * hd,
      lane, dh);
  vtt::mma::window_sync(w, count);  // every query tile's p and ds is staged

  if (ds_out != nullptr) {  // rows of N, consecutive lanes on consecutive
    bf16* d = ds_out + (gw * heads + h) * n * n;  // elements
    for (int r = t; r < n; r += mt)
      for (int c = lane; c < n; c += 32) d[r * n + c] = xt[r * SB + c];
  }
  vtt::mma::window_bwd_keys_mma<T, NK, DH>(qs, dos, pt, dt, n, t, mt,
                                           dq + hd, dq + 2 * hd, 3 * hd, lane,
                                           dh);
}

// D: the head dim, in the tile of width window_tile(D) (16 for D 1-8).
template <int D, int NK>
__global__ void __launch_bounds__(vtt::mma::kWinMmaMaxThreads)
window_bwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                      const __nv_bfloat16* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ dout,
                      __nv_bfloat16* __restrict__ dqkv,
                      __nv_bfloat16* __restrict__ ds_out, long long g, int n,
                      int heads, int bias_windows, float scale, int mt,
                      int wpb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp / mt, t = warp % mt;  // window of the block, tile
  const long long gw = static_cast<long long>(blockIdx.x) * wpb + w;
  if (gw >= g) return;  // a ragged last block: this window's warps only
  window_bwd_mma_window<vtt::mma::window_tile(D), NK, D>(
      qkv, bias, dout, dqkv, ds_out, gw, n, heads, bias_windows, scale, mt, w,
      t, lane, D);
}

// A head dim dh outside WINDOW_HEAD_DIMS, dh <= D, in the tile D.
template <int D, int NK>
__global__ void __launch_bounds__(vtt::mma::kWinMmaMaxThreads)
window_bwd_mma_padded_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const __nv_bfloat16* __restrict__ bias,
                             const __nv_bfloat16* __restrict__ dout,
                             __nv_bfloat16* __restrict__ dqkv,
                             __nv_bfloat16* __restrict__ ds_out, long long g,
                             int n, int heads, int dh, int bias_windows,
                             float scale, int mt, int wpb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp / mt, t = warp % mt;
  const long long gw = static_cast<long long>(blockIdx.x) * wpb + w;
  if (gw >= g) return;
  window_bwd_mma_window<D, NK, 0>(qkv, bias, dout, dqkv, ds_out, gw, n, heads,
                                  bias_windows, scale, mt, w, t, lane, dh);
}

// Above head dim 128 (and from 65 at N > 64): 64-column chunks.
template <int NK>
__global__ void __launch_bounds__(vtt::mma::kWinMmaMaxThreads)
window_bwd_mma_chunked_kernel(const __nv_bfloat16* __restrict__ qkv,
                              const __nv_bfloat16* __restrict__ bias,
                              const __nv_bfloat16* __restrict__ dout,
                              __nv_bfloat16* __restrict__ dqkv,
                              __nv_bfloat16* __restrict__ ds_out, long long g,
                              int n, int heads, int dh, int bias_windows,
                              float scale, int mt, int wpb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp / mt, t = warp % mt;
  const long long gw = static_cast<long long>(blockIdx.x) * wpb + w;
  if (gw >= g) return;
  vtt::mma::window_bwd_chunked_mma<NK>(qkv, bias, dout, dqkv, ds_out, gw, n,
                                       heads, dh, bias_windows, scale, w, t,
                                       mt, lane);
}

// fp32 at a head dim outside WINDOW_HEAD_DIMS: window_bwd_kernel's phases
// with K and V (phase A's scores), K (its dq), then Q and dO (phase B)
// staged in 32-column chunks; the two score tiles whole.
__global__ void __launch_bounds__(kWinMaxThreads)
window_bwd_chunked_kernel(const float* __restrict__ qkv,
                          const float* __restrict__ bias,
                          const float* __restrict__ dout,
                          float* __restrict__ dqkv, float* __restrict__ ds_out,
                          long long g, int n, int heads, int dh,
                          int bias_windows, float scale, int p) {
  using vtt::kWinCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n | 1;  // odd row stride of the two score tiles
  float* xs = reinterpret_cast<float*>(smem_raw);  // K, then Q: (P·N, C)
  float* ys = xs + p * n * kWinCols;               // V, then dO: (P·N, C)
  float* pt = ys + p * n * kWinCols;               // p:           (P·N, ld)
  float* dt = pt + p * n * ld;                     // dp, then ds: (P·N, ld)

  const int h = blockIdx.y;
  const long long hd = static_cast<long long>(heads) * dh;
  const long long w0 = static_cast<long long>(blockIdx.x) * p;
  const int count = static_cast<int>(min(static_cast<long long>(p), g - w0));
  const int rows = count * n;
  const float* q_base = qkv + w0 * n * 3 * hd + h * dh;  // q of 1st token
  const float* do_base = dout + w0 * n * hd + h * dh;
  float* dq_base = dqkv + w0 * n * 3 * hd + h * dh;

  const int w = threadIdx.x / n, i = threadIdx.x % n;
  const bool active = w < count;
  const int t = w * n + i;  // this thread's token row within the block
  const float* xw = xs + w * n * kWinCols;
  const float* yw = ys + w * n * kWinCols;
  float* prow = pt + t * ld;
  float* drow = dt + t * ld;
  float r[kWinCols];

  // phase A: query row i of window w; s and dp over chunks of K and V
  for (int c0 = 0; c0 < dh; c0 += kWinCols) {
    __syncthreads();  // the previous chunk has been read
    vtt::stage_chunk(q_base + hd, 3 * hd, rows, c0, dh, xs);      // K
    vtt::stage_chunk(q_base + 2 * hd, 3 * hd, rows, c0, dh, ys);  // V
    __syncthreads();
    if (!active) continue;
    vtt::load_chunk(q_base + t * 3 * hd, c0, dh, r);
    for (int j = 0; j < n; ++j)
      prow[j] = (c0 == 0 ? 0.f : prow[j]) +
                vtt::dot_row<kWinCols>(r, xw + j * kWinCols);
    vtt::load_chunk(do_base + t * hd, c0, dh, r);
    for (int j = 0; j < n; ++j)
      drow[j] = (c0 == 0 ? 0.f : drow[j]) +
                vtt::dot_row<kWinCols>(r, yw + j * kWinCols);
  }
  if (active) {
    const float* b_row = bias == nullptr
        ? nullptr
        : bias + (((w0 + w) % bias_windows) * heads + h) * n * n + i * n;
    float m = -CUDART_INF_F;
    for (int j = 0; j < n; ++j) {
      float s = prow[j] * scale;
      if (b_row != nullptr) s += b_row[j];
      prow[j] = s;
      m = fmaxf(m, s);
    }
    float l = 0.f;
    for (int j = 0; j < n; ++j) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      l += e;
    }
    float delta = 0.f;
    for (int j = 0; j < n; ++j) {
      const float pj = prow[j] / l;
      prow[j] = pj;
      delta = fmaf(pj, drow[j], delta);
    }
    for (int j = 0; j < n; ++j) drow[j] = prow[j] * (drow[j] - delta);
  }
  // dq of row i: (ds·scale)·K over chunks of K
  for (int c0 = 0; c0 < dh; c0 += kWinCols) {
    __syncthreads();
    vtt::stage_chunk(q_base + hd, 3 * hd, rows, c0, dh, xs);  // K
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int c = 0; c < kWinCols; ++c) r[c] = 0.f;
    for (int j = 0; j < n; ++j)
      vtt::axpy_row<kWinCols>(drow[j] * scale, xw + j * kWinCols, r);
    vtt::store_chunk(dq_base + t * 3 * hd, c0, dh, r);
  }
  // phase B: key row i of window w, down column i of the tiles (complete:
  // the barriers above follow every thread's phase A)
  const float* pcol = pt + w * n * ld + i;
  const float* dcol = dt + w * n * ld + i;
  if (active && ds_out != nullptr) {
    float* ds_col = ds_out + ((w0 + w) * heads + h) * n * n + i;
    for (int a = 0; a < n; ++a) ds_col[a * n] = dcol[a * ld];
  }
  for (int c0 = 0; c0 < dh; c0 += kWinCols) {
    __syncthreads();
    vtt::stage_chunk(q_base, 3 * hd, rows, c0, dh, xs);  // Q
    vtt::stage_chunk(do_base, hd, rows, c0, dh, ys);     // dO
    __syncthreads();
    if (!active) continue;
    float dv[kWinCols];
#pragma unroll
    for (int c = 0; c < kWinCols; ++c) r[c] = dv[c] = 0.f;  // dk, dv
    for (int a = 0; a < n; ++a) {
      vtt::axpy_row<kWinCols>(dcol[a * ld] * scale, xw + a * kWinCols, r);
      vtt::axpy_row<kWinCols>(pcol[a * ld], yw + a * kWinCols, dv);
    }
    vtt::store_chunk(dq_base + t * 3 * hd + hd, c0, dh, r);
    vtt::store_chunk(dq_base + t * 3 * hd + 2 * hd, c0, dh, dv);
  }
}

size_t bwd_smem_bytes(int p, int n, int d) {
  return static_cast<size_t>(p) * n * (2 * d + 2 * (n | 1)) * sizeof(float);
}

template <typename T, int D>
int launch_bwd(const void* qkv, const void* bias, const void* dout,
               void* dqkv, void* ds_out, int g, int n, int heads,
               int bias_windows, float scale, int p, int threads,
               cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(p, n, D);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = window_bwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g + p - 1) / p, heads);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(bias),
      static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<T*>(ds_out), g, n, heads, bias_windows, scale, p);
  return vtt::launched("window_bwd_kernel");
}

template <int D, int NK>
int launch_bwd_mma(const void* qkv, const void* bias, const void* dout,
                   void* dqkv, void* ds_out, int g, int n, int heads,
                   int bias_windows, float scale, cudaStream_t stream) {
  const vtt::mma::WindowGeometry geo = vtt::mma::window_mma_geometry(n);
  const size_t smem = static_cast<size_t>(geo.wpb) *
                      vtt::mma::window_smem_elems<vtt::mma::window_tile(D),
                                                  NK>(4, 3) *
                      sizeof(__nv_bfloat16);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = window_bwd_mma_kernel<D, NK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g + geo.wpb - 1) / geo.wpb, heads);
  kernel<<<grid, geo.threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<__nv_bfloat16*>(ds_out),
      g, n, heads, bias_windows, scale, geo.mt, geo.wpb);
  return vtt::launched("window_bwd_mma_kernel");
}

template <int D, int NK>
int launch_bwd_mma_padded(const void* qkv, const void* bias, const void* dout,
                          void* dqkv, void* ds_out, int g, int n, int heads,
                          int dh, int bias_windows, float scale,
                          cudaStream_t stream) {
  const vtt::mma::WindowGeometry geo = vtt::mma::window_mma_geometry(n);
  const size_t smem = static_cast<size_t>(geo.wpb) *
                      vtt::mma::window_smem_elems<D, NK>(4, 3) *
                      sizeof(__nv_bfloat16);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = window_bwd_mma_padded_kernel<D, NK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g + geo.wpb - 1) / geo.wpb, heads);
  kernel<<<grid, geo.threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<__nv_bfloat16*>(ds_out),
      g, n, heads, dh, bias_windows, scale, geo.mt, geo.wpb);
  return vtt::launched("window_bwd_mma_padded_kernel");
}

template <int NK>
int launch_bwd_mma_chunked(const void* qkv, const void* bias,
                           const void* dout, void* dqkv, void* ds_out, int g,
                           int n, int heads, int dh, int bias_windows,
                           float scale, cudaStream_t stream) {
  const vtt::mma::WindowGeometry geo = vtt::mma::window_mma_geometry(n);
  const size_t smem = static_cast<size_t>(geo.wpb) *
                      vtt::mma::window_bwd_chunked_elems<NK>() *
                      sizeof(__nv_bfloat16);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = window_bwd_mma_chunked_kernel<NK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g + geo.wpb - 1) / geo.wpb, heads);
  kernel<<<grid, geo.threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<__nv_bfloat16*>(ds_out),
      g, n, heads, dh, bias_windows, scale, geo.mt, geo.wpb);
  return vtt::launched("window_bwd_mma_chunked_kernel");
}

// bf16 at a head dim outside WINDOW_HEAD_DIMS: the padded tile of
// window_tile(dh) up to 64, the chunks above (ops/flash_attention.py's
// window_mma_tile).
template <int NK>
int launch_bwd_mma_other(const void* qkv, const void* bias, const void* dout,
                         void* dqkv, void* ds_out, int g, int n, int heads,
                         int dh, int bias_windows, float scale,
                         cudaStream_t st) {
  if (dh > 64)
    return launch_bwd_mma_chunked<NK>(qkv, bias, dout, dqkv, ds_out, g, n,
                                      heads, dh, bias_windows, scale, st);
  switch (vtt::mma::window_tile(dh)) {
    case 16:
      return launch_bwd_mma_padded<16, NK>(qkv, bias, dout, dqkv, ds_out, g,
                                           n, heads, dh, bias_windows, scale,
                                           st);
    case 32:
      return launch_bwd_mma_padded<32, NK>(qkv, bias, dout, dqkv, ds_out, g,
                                           n, heads, dh, bias_windows, scale,
                                           st);
    default:
      return launch_bwd_mma_padded<64, NK>(qkv, bias, dout, dqkv, ds_out, g,
                                           n, heads, dh, bias_windows, scale,
                                           st);
  }
}

int launch_bwd_chunked(const void* qkv, const void* bias, const void* dout,
                       void* dqkv, void* ds_out, int g, int n, int heads,
                       int dh, int bias_windows, float scale, int p,
                       int threads, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(p, n, vtt::kWinCols);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      window_bwd_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g + p - 1) / p, heads);
  window_bwd_chunked_kernel<<<grid, threads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(dout), static_cast<float*>(dqkv),
      static_cast<float*>(ds_out), g, n, heads, dh, bias_windows, scale, p);
  return vtt::launched("window_bwd_chunked_kernel");
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch. bias may be null (then
// bias_windows is ignored); ds_out may be null (no bias gradient wanted).
// is_bf16: 1 = bf16, 0 = fp32 (qkv, bias, dout, dqkv and ds_out). bf16
// takes the tensor cores (window_bwd_mma_kernel, its own launch shape), fp32
// the CUDA cores (window_bwd_kernel, the launch shape p, threads), at dh 1,
// 2, 4, 8, 16, 32 and 64; any other dh >= 1 window_bwd_mma_padded_kernel or
// window_bwd_mma_chunked_kernel (bf16), window_bwd_chunked_kernel (fp32).
int window_attention_bwd(const void* qkv, const void* bias, const void* dout,
                         void* dqkv, void* ds_out, int g, int n, int heads,
                         int dh, int bias_windows, float scale, int p,
                         int threads, int is_bf16, void* stream) {
  if (g < 1 || heads < 1 || heads > 65535 ||
      !vtt::window_launch_ok(n, p, threads) ||
      (bias != nullptr && bias_windows < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VTT_BWD(D)                                                        \
  (is_bf16 ? vtt::mma::with_window_keys(n, [&](auto nk) {                \
               return launch_bwd_mma<D, decltype(nk)::value>(              \
                   qkv, bias, dout, dqkv, ds_out, g, n, heads,             \
                   bias_windows, scale, st);                               \
             })                                                            \
           : launch_bwd<float, D>(qkv, bias, dout, dqkv, ds_out, g, n,       \
                                  heads, bias_windows, scale, p, threads,    \
                                  st))
  switch (dh) {
    case 1: return VTT_BWD(1);
    case 2: return VTT_BWD(2);
    case 4: return VTT_BWD(4);
    case 8: return VTT_BWD(8);
    case 16: return VTT_BWD(16);
    case 32: return VTT_BWD(32);
    case 64: return VTT_BWD(64);
    default: break;
  }
#undef VTT_BWD
  if (dh < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16)
    return launch_bwd_chunked(qkv, bias, dout, dqkv, ds_out, g, n, heads, dh,
                              bias_windows, scale, p, threads, st);
  return vtt::mma::with_window_keys(n, [&](auto nk) {
    return launch_bwd_mma_other<decltype(nk)::value>(
        qkv, bias, dout, dqkv, ds_out, g, n, heads, dh, bias_windows, scale,
        st);
  });
}

const char* window_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
