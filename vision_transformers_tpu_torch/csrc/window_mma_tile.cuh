// Tensor-core bodies of the bf16 window attention: the per-window forward
// and the backward the window kernels share.
//
// Replace, for bf16 inputs, two TPU kernels of vision_transformers_tpu/ops/
// flash_attention.py (rows of PERF.md's kernel table):
//   - row 9, _window_pack_kernel (:1295), through window_attention.cu's
//     window_packed_mma_kernel: window_attend_mma;
//   - row 10, _window_pack_bwd_kernel (:1466), through
//     window_attention_bwd.cu's window_bwd_mma_kernel: window_bwd_rows_mma
//     (query rows), then window_bwd_keys_mma (key rows).
// fp32 inputs, and the bf16 kernels of rows 11-13, keep window_tile.cuh.
//
// What bounds them on the H100: bytes (window_attention.cu,
// window_attention_bwd.cu: at Swin-T's and SwinV2-T's stage 1 the products
// take 2-5 µs at the bf16 peak, the bytes 23-49 µs). The CUDA-core tiles
// run the products as fp32 FMAs, one thread a row, and in bf16 walk the
// keys twice (m and l first, then the rounded p); these run every product
// as mma.sync.m16n8k16 and keep the whole score row on chip, so nothing is
// recomputed and the time left is the copies.
//
// Design. A window holds N <= 128 tokens, so one (window, head)'s N × N
// scores fit in the accumulators of its warps and nothing streams:
//   - a block takes `wpb` windows of one head; each window's ceil(N / 16)
//     query tiles of 16 rows take one warp each (window_mma_geometry: 4
//     windows of 1 warp at N <= 16, 2 of 2 at N <= 32, else 1 of 3-8). The
//     windows of a block share nothing: each meets at its own named barrier
//     (1 + w), and the warps of a window past G (a ragged last block) leave
//     at once;
//   - the window's Q, K and V rows (the backward's also dO) go to shared
//     memory as bf16 by 16-byte cp.async, in rows padded to D + 8 elements
//     (attention_mma_tile.cuh's conflict-free ldmatrix stride). Rows >= N are
//     zero-filled (source size 0): in the partitioned tensor they belong to
//     the next window or lie past the end of qkv, and 0 · garbage can be NaN;
//   - the bias row g mod nW' of the head, N·N bf16 values that start at an
//     odd element where N·N is odd (N 49), is copied element by element
//     (2-byte loads, consecutive lanes on consecutive elements) into a tile
//     of row stride NK + 8, and read back in the accumulator layout as bf16
//     pairs (an even column, an even stride: 4-byte aligned, no conflicts);
//   - S = Q·Kᵀ over NK keys, NK the least of 16, 32, 64 and 128 that holds N
//     (a template parameter, so N 16 does not pay for 64): NK / 2 fp32
//     accumulators a lane, 32 at N <= 64. A row lives in the four lanes of a
//     quad, so its max and sum are exact after two __shfl_xor_sync each:
//     one pass, no online rescaling, no recompute.
//   - Occupancy (ptxas -v, printed by chip_smoke.py; no kernel spills): the
//     forward 40-78 registers at NK <= 64 (64 at D 32, NK 64, the Swin
//     shapes: 24 KB of shared memory a window, 8 blocks of 128 threads an
//     SM) and 127-128 at NK 128; the backward 64-128 at NK <= 64 (96 at
//     D 32, NK 64: 47 KB a window, 4 blocks of 128 threads an SM, by shared
//     memory) and 207-222 at NK 128 (178 KB at D 64: one block of 256).
//
// Numerics, as _window_pack_kernel and window_attention_reference: s =
// acc·scale + bias in fp32, two roundings (never an FMA: the plain version
// multiplies, then adds), the bias held in bf16 and widened at the add;
// keys >= N replaced by -inf BY INDEX before the max (the models' masks, -100
// and -1e9, stay ordinary values); p = exp(s − m) / l, an IEEE division;
// the forward rounds p to bf16 as P·V's A fragments and divides nothing
// after P·V. The scale is applied to the fp32 product: folding it into a
// bf16 q would round q·(1/√32) and be another function.
//
// Backward (per (window, head), from qkv and the bias alone, no statistic
// of the forward): p in fp32 as above; dP = dO·Vᵀ; δ = rowsum(p ⊙ dP) from
// the fp32 p and dP; ds = p ⊙ (dP − δ). bf16(p), bf16(ds·scale) and, when
// the bias gradient is wanted, bf16(ds) (before the scale) go to three
// shared tiles of row stride NK + 8 (the last one the bias tile, each lane
// overwriting exactly the elements it read); dQ = bf16(ds·scale)·K from the
// same rounded values in registers. After the window's barrier, warp t owns
// key tile t: dK = bf16(ds·scale)ᵀ·Q and dV = bf16(p)ᵀ·dO with the tiles
// read transposed by ldmatrix.trans as A fragments, Q and dO as P·V reads
// V. So every product sees the values _window_pack_bwd_kernel rounds once
// (its ds_c and probs_c). Query rows >= N get p = ds = 0 explicitly, so
// they add nothing to dK and dV, whatever dO holds; keys >= N have p = 0
// and get no row. ds_out is copied from its tile as rows of N, consecutive
// lanes on consecutive elements (a row of N 49 starts at an odd element).
// Every output element has one owner and every sum a fixed order: no
// atomics, reruns bit-equal.
#pragma once

#include "attention_mma_tile.cuh"

namespace vtt {
namespace mma {

constexpr int kWinMmaMaxThreads = 256;  // 8 query tiles of N 128

// Keys of a window's tiles: the least of 16, 32, 64 and 128 that holds n.
__host__ __device__ constexpr int window_keys(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
}

// Query tiles (= warps) a window takes, windows a block takes, threads.
struct WindowGeometry {
  int mt, wpb, threads;
};

inline WindowGeometry window_mma_geometry(int n) {
  const int mt = (n + 15) / 16;
  const int wpb = mt >= 4 ? 1 : 4 / mt;
  return {mt, wpb, 32 * mt * wpb};
}

// bf16 elements of shared memory a window takes: `rows` matrices of NK
// rows of D + 8, then `tiles` score tiles of NK rows of NK + 8.
template <int D, int NK>
__host__ __device__ constexpr int window_smem_elems(int rows, int tiles) {
  return rows * NK * (D + 8) + tiles * NK * (NK + 8);
}

// The warps of window w of the block meet (named barrier 1 + w; barrier 0
// is __syncthreads').
__device__ __forceinline__ void window_sync(int w, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + w), "r"(threads) : "memory");
}

// Rows [0, n) of an (n, D) bf16 matrix whose rows lie `stride` elements
// apart into shared memory of row stride D + 8, rows [n, NK) zero-filled,
// by the `count` threads numbered tid; the caller commits.
template <int D, int NK>
__device__ __forceinline__ void window_stage(bf16* s, const bf16* g, int n,
                                             long long stride, int tid,
                                             int count) {
  constexpr int C = D / 8;  // 16-byte chunks a row
  for (int idx = tid; idx < NK * C; idx += count) {
    const int r = idx / C, c = idx % C;
    const bool in = r < n;
    cp_async_16(s + r * (D + 8) + c * 8, g + (in ? r : 0) * stride + c * 8,
                in);
  }
}

// The bias rows [0, n) × [0, n) of one (window, head), n·n consecutive
// bf16 values, into shared memory of row stride NK + 8: warp t of the
// window's mt takes rows t, t + mt, ..., its lanes consecutive columns.
template <int NK>
__device__ __forceinline__ void window_stage_bias(bf16* s,
                                                  const bf16* __restrict__ b,
                                                  int n, int t, int mt,
                                                  int lane) {
  for (int r = t; r < n; r += mt)
    for (int c = lane; c < n; c += 32) s[r * (NK + 8) + c] = b[r * n + c];
}

// The A fragments (16 rows × D) of rows a[0 .. 16) of a shared-memory
// matrix of row stride D + 8, by ldmatrix.x4.
template <int D>
__device__ __forceinline__ void load_a_smem(uint32_t (&f)[D / 16][4],
                                            const bf16* a, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(f[kk], a + (lane & 15) * (D + 8) + kk * 16 + (lane >> 4) * 8);
}

// The A fragment of the transpose of a 16 × 16 block of a shared-memory
// tile of row stride NK + 8 whose rows are the k index: block rows
// [k0, k0 + 16), columns [m0, m0 + 16), by ldmatrix.x4.trans.
template <int NK>
__device__ __forceinline__ void load_at_smem(uint32_t (&f)[4], const bf16* t,
                                             int k0, int m0, int lane) {
  ldsm_x4_t(f, t + (k0 + (lane & 7) + ((lane >> 4) << 3)) * (NK + 8) + m0
                   + ((lane >> 3) & 1) * 8);
}

// s: this lane's accumulators of Q·Kᵀ for rows r0 and r0 + 8 of the window
// (columns n8·8 + 2·tq + {0, 1}) → p = exp(s·scale + bias − m) / l in fp32,
// keys >= n at exactly 0. bs: the window's bias tile or null. Rows >= n are
// left as computed (the scores of zero queries); the caller decides.
template <int NK>
__device__ __forceinline__ void window_probs(float (&s)[NK / 8][4],
                                             const bf16* bs, int r0, int n,
                                             int tq, float scale) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i, kj = n8 * 8 + 2 * tq;
      float2 b = make_float2(0.f, 0.f);
      if (bs != nullptr && r < n)
        b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bs + r * (NK + 8) + kj));
      float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
      if (kj < n) x0 = __fadd_rn(__fmul_rn(s[n8][2 * i], scale), b.x);
      if (kj + 1 < n) x1 = __fadd_rn(__fmul_rn(s[n8][2 * i + 1], scale), b.y);
      s[n8][2 * i] = x0;
      s[n8][2 * i + 1] = x1;
      mx[i] = fmaxf(mx[i], fmaxf(x0, x1));
    }
  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    l[i] = 0.f;
  }
#pragma unroll
  for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[n8][e] - mx[e >> 1]);  // key 0 < n: m finite
      s[n8][e] = p;
      l[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n8][e] = s[n8][e] / l[e >> 1];
}

// Query tile t (rows 16·t .. 16·t + 15) of one (window, head): out rows < n
// in bf16 at row stride o_stride. qs, ks, vs: the window's Q, K, V tiles
// (row stride D + 8, rows >= n zero); bs: its bias tile or null.
template <int D, int NK>
__device__ __forceinline__ void window_attend_mma(
    const bf16* qs, const bf16* ks, const bf16* vs, const bf16* bs, int n,
    int t, float scale, bf16* __restrict__ o, long long o_stride, int lane) {
  static_assert(D == 16 || D == 32 || D == 64, "head dim must be 16, 32 or 64");
  constexpr int S = D + 8;
  const int tq = lane & 3;
  const int r0 = t * 16 + (lane >> 2);

  uint32_t qf[D / 16][4];
  load_a_smem<D>(qf, qs + t * 16 * S, lane);
  float s[NK / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n8][e] = 0.f;
  mma_abt<D, NK / 8>(s, qf, ks, lane);
  window_probs<NK>(s, bs, r0, n, tq, scale);

  float acc[D / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n8][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[4];
    acc_to_a(a, s[2 * kk], s[2 * kk + 1]);  // p rounded to bf16 here
    mma_ab<D>(acc, a, vs + kk * 16 * S, lane);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= n) continue;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      *reinterpret_cast<__nv_bfloat162*>(o + r * o_stride + n8 * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[n8][2 * i], acc[n8][2 * i + 1]);
  }
}

// The backward's query tile t of one (window, head): p, ds and dq. qs, ks,
// vs, dos: the window's Q, K, V, dO tiles (row stride D + 8, rows >= n
// zero); bs: its bias tile or null; xs: null, or the tile for bf16(ds)
// (the bias tile itself where there is one: each lane writes exactly the
// elements it read); pt, dt: bf16(p) and bf16(ds·scale) (row stride
// NK + 8), every element of rows 16·t .. 16·t + 15 written. dq rows < n in
// bf16 at row stride dq_stride.
template <int D, int NK>
__device__ __forceinline__ void window_bwd_rows_mma(
    const bf16* qs, const bf16* ks, const bf16* vs, const bf16* dos,
    const bf16* bs, bf16* xs, bf16* pt, bf16* dt, int n, int t, float scale,
    bf16* __restrict__ dq, long long dq_stride, int lane) {
  static_assert(D == 16 || D == 32 || D == 64, "head dim must be 16, 32 or 64");
  constexpr int S = D + 8, SB = NK + 8;
  const int tq = lane & 3;
  const int r0 = t * 16 + (lane >> 2);

  float p[NK / 8][4];
  {
    uint32_t qf[D / 16][4];
    load_a_smem<D>(qf, qs + t * 16 * S, lane);
#pragma unroll
    for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n8][e] = 0.f;
    mma_abt<D, NK / 8>(p, qf, ks, lane);
  }
  window_probs<NK>(p, bs, r0, n, tq, scale);
  float dp[NK / 8][4];
  {
    uint32_t df[D / 16][4];
    load_a_smem<D>(df, dos + t * 16 * S, lane);
#pragma unroll
    for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n8][e] = 0.f;
    mma_abt<D, NK / 8>(dp, df, vs, lane);
  }
  const bool live[2] = {r0 < n, r0 + 8 < n};
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!live[e >> 1]) p[n8][e] = 0.f;  // padded query rows add nothing
      delta[e >> 1] += p[n8][e] * dp[n8][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
  }
#pragma unroll
  for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int off = (r0 + 8 * i) * SB + n8 * 8 + 2 * tq;
      float ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        ds[c] = live[i] ? p[n8][2 * i + c] * (dp[n8][2 * i + c] - delta[i])
                        : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(pt + off) =
          __floats2bfloat162_rn(p[n8][2 * i], p[n8][2 * i + 1]);
      if (xs != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(xs + off) =
            __floats2bfloat162_rn(ds[0], ds[1]);
      dp[n8][2 * i] = ds[0] * scale;
      dp[n8][2 * i + 1] = ds[1] * scale;
      *reinterpret_cast<__nv_bfloat162*>(dt + off) =
          __floats2bfloat162_rn(dp[n8][2 * i], dp[n8][2 * i + 1]);
    }

  float acc[D / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n8][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[4];
    acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);  // the bits dt holds
    mma_ab<D>(acc, a, ks + kk * 16 * S, lane);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      *reinterpret_cast<__nv_bfloat162*>(dq + (r0 + 8 * i) * dq_stride
                                         + n8 * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[n8][2 * i], acc[n8][2 * i + 1]);
  }
}

// The backward's key tile t (keys 16·t .. 16·t + 15) of one (window, head),
// after every query tile's window_bwd_rows_mma: dk = bf16(ds·scale)ᵀ·Q and
// dv = bf16(p)ᵀ·dO over the mt query tiles, rows < n in bf16 at row stride
// stride.
template <int D, int NK>
__device__ __forceinline__ void window_bwd_keys_mma(
    const bf16* qs, const bf16* dos, const bf16* pt, const bf16* dt, int n,
    int t, int mt, bf16* __restrict__ dk, bf16* __restrict__ dv,
    long long stride, int lane) {
  constexpr int S = D + 8;
  const int tq = lane & 3;
  const int j0 = t * 16 + (lane >> 2);
  float ak[D / 8][4], av[D / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n8][e] = av[n8][e] = 0.f;
  for (int kk = 0; kk < mt; ++kk) {
    uint32_t a[4];
    load_at_smem<NK>(a, dt, kk * 16, t * 16, lane);
    mma_ab<D>(ak, a, qs + kk * 16 * S, lane);
    load_at_smem<NK>(a, pt, kk * 16, t * 16, lane);
    mma_ab<D>(av, a, dos + kk * 16 * S, lane);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = j0 + 8 * i;
    if (j >= n) continue;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      const long long off = j * stride + n8 * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(ak[n8][2 * i], ak[n8][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(av[n8][2 * i], av[n8][2 * i + 1]);
    }
  }
}

}  // namespace mma
}  // namespace vtt
