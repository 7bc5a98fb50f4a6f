// Tensor-core tile of the fused LayerNorm + Dense (+ GELU) in bf16:
//
//   out = act((LN(x)·γ + β)·W + bias)
//
// ln_dense_mma_tile replaces, for bf16 inputs whose widths D and N are
// multiples of 8, the TPU kernel vision_transformers_tpu/ops/fused_dense.py::
// _ln_dense_kernel (:72), through ln_dense.cu (row 14 of PERF.md's kernel
// table). fp32 inputs and other bf16 widths keep dense_tile.cuh's CUDA-core
// tile.
//
// dense_residual_mma_tile, the same products with A streamed as it is (no
// LayerNorm) and an epilogue that adds the bias and a residual, is row 8's
// out-projection (fused_block.cu, _fused_block_kernel :1028), whose first
// phase is ln_dense_mma_tile itself.
//
// What bounds it on the H100 (ViT-B/16 at batch 32: R = 6304, D = 768):
// [ln_1 + QKV], N = 2304, is 2·R·D·N = 22.3 GFLOP, 22.6 µs at 989 TFLOP/s,
// against 42.3 MB of x, W and out, 12.6 µs at 3.35 TB/s; [ln_2 + fc1],
// N = 3072, 29.7 GFLOP, 30.1 µs. So the bound is the products, and the
// normalised rows never go to device memory. The design, mma.sync on the
// helpers of attention_mma_tile.cuh:
//
//   - 256 threads, 8 warps, a block tile of 128 rows × 128 columns: warp w
//     owns rows 64·(w / 4) .. +63 and columns 32·(w % 4) .. +31, 4 × 4
//     m16n8k16 accumulator tiles (64 fp32 registers), so each A fragment
//     read from shared memory feeds 4 products and each B fragment 4.
//   - The row statistics once per row, not once per column tile: a short
//     first launch (row_stats, a warp per row) writes (μ, rstd) of every row,
//     8 bytes a row, and each tile reads its rows'. Computed inside the tile
//     they cost each of the N / 128 column tiles two more passes over its x
//     rows from L2, as many bytes as its K loop reads (16 KB of x and W a
//     step), and at these shapes the bytes from L2, not the tensor cores,
//     set the pace.
//   - K steps of 32. Each thread owns two 16-byte chunks of x's slice (rows
//     tid / 4 and tid / 4 + 64, columns 8·(tid % 4) .. +7): it reads the next
//     slice's chunks into registers a step ahead, then normalises them with
//     its rows' statistics and the step's γ, β, rounds them to bf16 and
//     stores them into the other of two shared A buffers, rows padded to 40
//     elements (the eight 16-byte rows one ldmatrix phase reads fall in
//     eight distinct 4-bank groups). γ and β reach shared memory by cp.async
//     two steps ahead, so no load waits between the products and the store.
//   - W's slice streams by 16-byte cp.async into the other of two buffers,
//     one step ahead: the (in, out) layout (ldn = 1) as 32 k-rows of 128 + 8
//     columns, read by ldmatrix.trans; torch's (out, in) layout (ldk = 1) as
//     128 n-rows of 32 + 8, read by plain ldmatrix. Both put the same values
//     in the same fragments, so the two layouts give the same bits.
//   - The epilogue on the accumulator fragments, in fp32: + bias, the
//     activation, one rounding to bf16. Rows >= R, columns >= N and k >= D
//     are zero-filled and never stored.
//   - Occupancy: 256 threads asked at 2 blocks an SM (at most 128
//     registers), 41 KB (ldk = 1) or 38 KB (ldn = 1) of static shared memory.
//   - The normalised rows never go to device memory; the statistics do.
//
// Numerics (ln_dense.cu's contract): per row the fp32 mean, then the fp32
// mean of squared deviations; xn = (x − μ)·rsqrt(var + eps)·γ + β in fp32,
// rounded to bf16; xn·W accumulated in fp32; + the fp32 bias; the
// activation in fp32; one rounding into out.
//
// Contract of the caller: bf16 x (R, D), W and out (R, N); D and N multiples
// of 8; W's leading stride (ldk for ldn = 1, ldn for ldk = 1) a multiple of
// 8; x, W, out, γ and β 16-byte aligned (ln_dense.cu checks all of it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_mma_tile.cuh"
#include "dense_tile.cuh"

namespace vtt {
namespace dense_mma {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;    // 8 warps
constexpr int kBM = 128;         // rows of a block tile
constexpr int kBN = 128;         // columns of a block tile
constexpr int kBK = 32;          // k of one step
constexpr int kAS = kBK + 8;     // shared row stride of A, and of W (ldk = 1)
constexpr int kWS = kBN + 8;     // shared row stride of W (ldn = 1)

// kWk: W's k is contiguous (torch's (out, in) Linear weight, ldk = 1).
template <bool kWk>
struct Smem {
  __align__(16) bf16 a[2][kBM * kAS];
  __align__(16) bf16 w[2][kWk ? kBN * kAS : kBK * kWS];
  __align__(16) float gb[2][2 * kBK];  // one step's γ, then its β
};

// Eight bf16 (one 16-byte load) as fp32, exactly.
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// This thread's two chunks of x's slice at column k (rows row[0], row[1]),
// zero past R or D.
__device__ __forceinline__ void fetch_x(uint4 (&xr)[2],
                                        const bf16* __restrict__ x, int rows,
                                        int d, const int (&row)[2], int k) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    xr[i] = row[i] < rows && k < d
                ? *reinterpret_cast<const uint4*>(
                      x + static_cast<long long>(row[i]) * d + k)
                : make_uint4(0u, 0u, 0u, 0u);
}

// The statistics of row `row` of x (row stride d) into stats[2·row],
// stats[2·row + 1] (μ, rstd), by one warp: 16-byte loads, the fp32 mean,
// then the fp32 mean of squared deviations over the row again (from L1),
// rstd = rsqrt(var + eps).
__device__ __forceinline__ void row_stats(const bf16* __restrict__ x, int d,
                                          int row, float eps,
                                          float* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const bf16* xr = x + static_cast<long long>(row) * d;
  float s = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += f[e];
  }
  const float mu = warp_sum(s) / d;
  float v = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float t = f[e] - mu;
      v = fmaf(t, t, v);
    }
  }
  const float rs = rsqrtf(warp_sum(v) / d + eps);
  if (lane == 0)
    *reinterpret_cast<float2*>(stats + 2 * static_cast<long long>(row)) =
        make_float2(mu, rs);
}

// One step's γ and β (columns k0 .. k0 + kBK) into a shared buffer by
// cp.async, threads 0-7 γ's eight 16-byte chunks, threads 8-15 β's; zero
// past D. The caller commits.
__device__ __forceinline__ void load_gb(float* s,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        int d, int k0) {
  const int i = threadIdx.x;
  if (i < 16) {
    const int k = k0 + (i & 7) * 4;
    const bool in = k < d;
    mma::cp_async_16(s + i * 4, (i < 8 ? gamma : beta) + (in ? k : 0), in);
  }
}

// The chunks fetch_x read, normalised with γ and β of the step (gb, the
// shared buffer load_gb filled), rounded to bf16 and stored at shared rows
// r[0], r[1], column c of one A buffer; zero for k >= D.
__device__ __forceinline__ void store_a(bf16* s, const uint4 (&xr)[2],
                                        const float (&mu)[2],
                                        const float (&rs)[2],
                                        const float* gb, int d, int k,
                                        const int (&r)[2], int c) {
  uint4 o[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
  if (k < d) {
    const float4 g0 = *reinterpret_cast<const float4*>(gb + c);
    const float4 g1 = *reinterpret_cast<const float4*>(gb + c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(gb + kBK + c);
    const float4 b1 = *reinterpret_cast<const float4*>(gb + kBK + c + 4);
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float f[8];
      unpack8(xr[i], f);
      uint32_t p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = mma::pack_bf16(
            (f[2 * e] - mu[i]) * rs[i] * g[2 * e] + b[2 * e],
            (f[2 * e + 1] - mu[i]) * rs[i] * g[2 * e + 1] + b[2 * e + 1]);
      o[i] = make_uint4(p[0], p[1], p[2], p[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    *reinterpret_cast<uint4*>(s + r[i] * kAS + c) = o[i];
}

// W's slice k0 .. k0 + kBK of columns n0 .. n0 + kBN into one buffer by
// cp.async, 512 16-byte chunks, two a thread; zero past D or N. ldw: W's
// leading stride (ldk when ldn = 1, ldn when ldk = 1). The caller commits.
template <bool kWk>
__device__ __forceinline__ void load_w(bf16* s, const bf16* __restrict__ w,
                                       long long ldw, int d, int n, int n0,
                                       int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if constexpr (kWk) {  // n-rows of 4 chunks of k
      const int r = idx >> 2, c = (idx & 3) * 8;
      const int gn = n0 + r, gk = k0 + c;
      const bool in = gn < n && gk < d;
      mma::cp_async_16(s + r * kAS + c, w + (in ? gn * ldw + gk : 0), in);
    } else {              // k-rows of 16 chunks of n
      const int r = idx >> 4, c = (idx & 15) * 8;
      const int gk = k0 + r, gn = n0 + c;
      const bool in = gk < d && gn < n;
      mma::cp_async_16(s + r * kWS + c, w + (in ? gk * ldw + gn : 0), in);
    }
  }
}

// acc += one kBK step of A (as: kBM rows of kAS) times W (ws, as load_w
// stores it) for warp (wm, wn): rows 64·wm .. +63, columns 32·wn .. +31,
// 4 m16 A tiles against 4 n8 tiles, each fragment read from shared memory
// once.
template <bool kWk>
__device__ __forceinline__ void mma_step(float (&acc)[4][4][4],
                                         const bf16* as, const bf16* ws,
                                         int lane, int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mma::ldsm_x4(a[i], as + (wm * 64 + i * 16 + (lane & 7)
                               + ((lane >> 3) & 1) * 8) * kAS
                             + kk * 16 + (lane >> 4) * 8);
    uint32_t b[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t f[4];
      if constexpr (kWk)
        mma::ldsm_x4(f, ws + (wn * 32 + np * 16 + (lane & 7)
                              + ((lane >> 4) << 3)) * kAS
                            + kk * 16 + ((lane >> 3) & 1) * 8);
      else
        mma::ldsm_x4_t(f, ws + (kk * 16 + (lane & 7)
                                + ((lane >> 3) & 1) * 8) * kWS
                              + wn * 32 + np * 16 + (lane >> 4) * 8);
      b[2 * np][0] = f[0];
      b[2 * np][1] = f[1];
      b[2 * np + 1][0] = f[2];
      b[2 * np + 1][1] = f[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma::mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
  }
}

// The output tile at (m0, n0), with the rows' (μ, rstd) in stats (row_stats
// ran first). The caller launched kThreads threads.
template <bool kWk>
__device__ __forceinline__ void ln_dense_mma_tile(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const bf16* __restrict__ w, long long ldw,
    const float* __restrict__ bias, const float* __restrict__ stats,
    bf16* __restrict__ out, int rows, int d, int n, int act, int m0, int n0,
    Smem<kWk>& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int steps = (d + kBK - 1) / kBK;
  const int ac = (tid & 3) * 8;                    // this thread's chunks of
  const int ar[2] = {tid >> 2, (tid >> 2) + 64};   // each A slice
  const int grow[2] = {m0 + ar[0], m0 + ar[1]};

  // W's step 0 and γ, β of steps 0 and 1 stream in while the statistics
  // are read. From here on γ, β of step t + 2 go out with W's step t + 1
  // in iteration t: store_a of step t + 1 comes before that iteration's
  // wait
  load_w<kWk>(sm.w[0], w, ldw, d, n, n0, 0);
  load_gb(sm.gb[0], gamma, beta, d, 0);
  load_gb(sm.gb[1], gamma, beta, d, kBK);
  mma::cp_async_commit();
  float mu[2], rs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // through L2 (ld.global.cg): fused_block.cu writes them earlier in the
    // same launch, which the non-coherent path does not allow
    const float2 st =
        grow[i] < rows
            ? __ldcg(reinterpret_cast<const float2*>(
                  stats + 2 * static_cast<long long>(grow[i])))
            : make_float2(0.f, 0.f);
    mu[i] = st.x;
    rs[i] = st.y;
  }
  uint4 xr[2];
  fetch_x(xr, x, rows, d, grow, ac);
  mma::cp_async_wait<0>();
  __syncthreads();
  store_a(sm.a[0], xr, mu, rs, sm.gb[0], d, ac, ar, ac);
  if (steps > 1) fetch_x(xr, x, rows, d, grow, kBK + ac);
  __syncthreads();

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) {
      load_w<kWk>(sm.w[buf ^ 1], w, ldw, d, n, n0, (t + 1) * kBK);
      // γ, β of step t lie in gb[buf], read by store_a before the last
      // barrier
      if (t + 2 < steps) load_gb(sm.gb[buf], gamma, beta, d, (t + 2) * kBK);
      mma::cp_async_commit();
    }
    mma_step<kWk>(acc, sm.a[buf], sm.w[buf], lane, wm, wn);
    if (t + 1 < steps) {
      // the other buffer's readers finished at the last barrier
      store_a(sm.a[buf ^ 1], xr, mu, rs, sm.gb[buf ^ 1], d,
              (t + 1) * kBK + ac, ar, ac);
      if (t + 2 < steps) fetch_x(xr, x, rows, d, grow, (t + 2) * kBK + ac);
    }
    mma::cp_async_wait<0>();
    __syncthreads();
  }

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (row >= rows) continue;
      bf16* orow = out + static_cast<long long>(row) * n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * tq;
        if (col >= n) continue;  // n % 8 == 0: col + 1 < n too
        float y0 = acc[i][j][2 * h], y1 = acc[i][j][2 * h + 1];
        if (bias != nullptr) {
          y0 += bias[col];
          y1 += bias[col + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(activate(y0, act), activate(y1, act));
      }
    }
}

// The shared buffers of dense_residual_mma_tile: two A slices (128 rows of
// kAS) and two W slices, as load_w stores them.
template <bool kWk>
struct PlainSmem {
  __align__(16) bf16 a[2][kBM * kAS];
  __align__(16) bf16 w[2][kWk ? kBN * kAS : kBK * kWS];
};

// A's slice k0 .. k0 + kBK of rows m0 .. m0 + kBM (an (R, D) bf16 matrix)
// into one buffer by cp.async, 512 16-byte chunks, two a thread; zero past R
// or D. The caller commits.
__device__ __forceinline__ void load_a(bf16* s, const bf16* __restrict__ a,
                                       int rows, int d, int m0, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 2, c = (idx & 3) * 8;
    const int gr = m0 + r, gk = k0 + c;
    const bool in = gr < rows && gk < d;
    mma::cp_async_16(s + r * kAS + c,
                     a + (in ? static_cast<long long>(gr) * d + gk : 0), in);
  }
}

// The output tile at (m0, n0), kBM × kBN, of out = round(a·W + bias +
// resid) with no LayerNorm: a (R, D), resid and out (R, N), bf16; bias fp32
// (N,). A and W stream by cp.async, double-buffered one k step ahead; the
// products are mma_step's, as in ln_dense_mma_tile; the epilogue adds the
// bias and resid (read in fp32) to the fp32 accumulators and rounds once.
// The caller launched kThreads threads.
template <bool kWk>
__device__ __forceinline__ void dense_residual_mma_tile(
    const bf16* __restrict__ a, const bf16* __restrict__ w, long long ldw,
    const float* __restrict__ bias, const bf16* __restrict__ resid,
    bf16* __restrict__ out, int rows, int d, int n, int m0, int n0,
    PlainSmem<kWk>& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int steps = (d + kBK - 1) / kBK;
  load_a(sm.a[0], a, rows, d, m0, 0);
  load_w<kWk>(sm.w[0], w, ldw, d, n, n0, 0);
  mma::cp_async_commit();

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) {
      load_a(sm.a[buf ^ 1], a, rows, d, m0, (t + 1) * kBK);
      load_w<kWk>(sm.w[buf ^ 1], w, ldw, d, n, n0, (t + 1) * kBK);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    mma_step<kWk>(acc, sm.a[buf], sm.w[buf], lane, wm, wn);
    __syncthreads();  // every warp is done with this buffer
  }

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (row >= rows) continue;
      const long long off = static_cast<long long>(row) * n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * tq;
        if (col >= n) continue;  // n % 8 == 0: col + 1 < n too
        const float2 r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(resid + off + col));
        *reinterpret_cast<__nv_bfloat162*>(out + off + col) =
            __floats2bfloat162_rn(acc[i][j][2 * h] + bias[col] + r.x,
                                  acc[i][j][2 * h + 1] + bias[col + 1] + r.y);
      }
    }
}

}  // namespace dense_mma
}  // namespace vtt
