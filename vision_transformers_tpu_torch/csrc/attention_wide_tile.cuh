// Rows 1-7 of PERF.md's kernel table at a head dim above 128: the forward
// and the two backward passes, on the tensor cores for bf16 and on the CUDA
// cores for fp32, split along the head dim across the grid.
//
// Replace, at d > 128, the TPU kernels of vision_transformers_tpu/ops/
// flash_attention.py that the 16, 32, 64 and 128 tiles of
// attention_mma_tile.cuh, attention_bwd_mma_tile.cuh, attention_tile.cuh and
// attention_bwd_tile.cuh replace at d <= 128:
//   - the forward, attend_rows_wide_mma (bf16) / attend_rows_wide (fp32):
//     row 1 _packed_fwd_kernel (:796, NoMask, dropout, the packed strides),
//     row 2 _attn_kernel (:75, NoMask, a bias), row 3 _large_kernel (:229,
//     ReplaceByte), row 5 _drop_fwd_kernel (:491, AddFloat, dropout);
//   - the backward, bwd_dq_rows_wide* then bwd_dkv_rows_wide*: row 4
//     _bwd_kernel (:362, ScaledGrads), row 6 _drop_bwd_kernel (:525,
//     ScaledDs, key mask, dropout), row 7 _packed_bwd_kernel (:833, the
//     packed strides).
// The JAX kernels take any head dim. The tiles of width 128 cannot simply
// grow: at D 128 they already hold 223-255 registers a thread (Q fragments,
// scores and a D-wide output accumulator), and D 256 doubles two of the
// three.
//
// Design: a split of D across the grid. Grid z is the output chunk c: a
// block owns output columns [c·W, c·W + W) of its rows, W = 128 (bf16
// forward and dq pass), 64 (bf16 dk/dv pass, whose two accumulators dk and
// dv are both W wide) or 64 (fp32, the shared-memory tiles of the CUDA-core
// bodies). Each block accumulates the scores over every 128-column (fp32:
// 64-column) chunk of the head dim, staging K (and V, Q, dO) chunk by chunk
// through shared memory, so the scores are the whole head dim's; then it
// runs today's softmax or gradient arithmetic and multiplies by its own
// chunk of V (K, Q, dO) into a W-column accumulator. So every chunk block
// recomputes the scores: at d 256 the forward does 1.5× the products of
// one pass (2 blocks × (256 + 128) columns against 256 + 256), the dq pass
// (2 blocks × (2·256 + 128)) / (3·256) = 1.7×, the dk/dv pass (4 blocks ×
// (2·256 + 2·64)) / (4·256) = 2.5×. Nothing is exchanged between blocks: no
// atomics, a fixed summation order, reruns bit-equal. lse is written by
// chunk 0's blocks only, δ (the dq pass's scratch for the dk/dv pass) too;
// every chunk block computes δ = rowsum(dO ⊙ O) over the whole head dim
// itself, the same sums in the same order.
//
// Chunks: a head dim that is not a multiple of the chunk (129, 160, 200)
// reads its last chunk's columns past d as zeros and writes only d columns.
// Copies at the widest grain every offset keeps (rows and head offsets are
// multiples of d, chunk offsets of 64): 16-byte cp.async for d a multiple
// of 8, 4-byte for an even d, 2-byte loads and stores for an odd one, as
// attention_mma_tile.cuh's PaddedStrided layout; the operands' base
// pointers aligned as strided_align_mask(d) says (the C entries check). The
// packed layout of rows 1 and 7 is read in place: head h's chunk j starts
// at column h·d + j·128 of its q, k or v section.
//
// Dropout: the keep bit of philox.cuh's f(seed, group, row, column), so
// every chunk block draws the same mask (bf16: dropout_keep4, the lane
// scheme of the D <= 128 tiles; fp32: dropout_keep). Row 3 and row 5's
// bf16 forward keep the trailing-tile skip (last_live_tile) and add their
// tiles to the kernels' counters from chunk 0's blocks, so the counts are
// those of one pass over the rows.
//
// Numerics are those of the D <= 128 bodies (see their headers): fp32
// scores·scale, then bias / kv_valid / key mask, the max before any exp, the
// unnormalised probabilities rounded to bf16 before P·V and divided by l
// after it (ReplaceByte: max(l, 1e-30)); in the backward p = exp(s − lse),
// pd and ds rounded to bf16 before their products, ds·scale (ScaledDs) or
// ds unscaled with dq, dk scaled in fp32 (ScaledGrads). The scores sum the
// chunks' products in chunk order, so they differ from the D <= 128 tiles'
// in the last bits, as any two summation orders do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "attention_bwd_mma_tile.cuh"
#include "attention_tile.cuh"

namespace vtt {
namespace wide {

using mma::bf16;
using mma::KeyMask;
using mma::kLog2e;

constexpr int kW = 128;    // bf16: score chunk, forward and dq output chunk
constexpr int kWkv = 64;   // bf16: dk/dv output chunk
constexpr int kRows = 64;  // bf16: query rows (forward, dq) or keys (dk/dv)
constexpr int kKeys = 64;  // bf16: keys of a forward tile
constexpr int kTile = 32;  // bf16: keys (dq) or queries (dk/dv) of a tile
constexpr int kFW = 64;    // fp32: every chunk

// Where a group's rows lie: d its head dim; q, k, v (and dq, dk, dv) rows
// qkv apart, out and do rows o apart, lse entries lse apart.
struct Rows {
  int d;
  long long qkv, o, lse;
};

__host__ __device__ constexpr int chunks(int d, int w) {
  return (d + w - 1) / w;
}

// Rows [row0, row0 + R) and columns [0, dc) of a bf16 matrix whose rows lie
// `stride` elements apart into shared memory of row stride W + 8; rows >= n
// and columns >= dc zero. The grain by the head dim d (above); plain loads
// are published by the caller's barrier, as the copies. The caller commits.
template <int R, int W>
__device__ __forceinline__ void load_chunk(bf16* s, const bf16* g, int row0,
                                           int n, int dc, long long stride,
                                           int d) {
  const int tid = static_cast<int>(threadIdx.x);
  if ((d & 7) == 0) {
    constexpr int C = W / 8;
#pragma unroll 4
    for (int idx = tid; idx < R * C; idx += mma::kThreads) {
      const int r = idx / C, c = idx % C, gr = row0 + r;
      const bool in = gr < n && c * 8 < dc;
      mma::cp_async_16(s + r * (W + 8) + c * 8,
                       g + (in ? gr * stride + c * 8 : 0ll), in);
    }
  } else if ((d & 1) == 0) {
    constexpr int C = W / 2;
#pragma unroll 4
    for (int idx = tid; idx < R * C; idx += mma::kThreads) {
      const int r = idx / C, c = 2 * (idx % C), gr = row0 + r;
      const bool in = gr < n && c < dc;
      mma::cp_async_4(s + r * (W + 8) + c, g + (in ? gr * stride + c : 0ll),
                      in);
    }
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(g);
    unsigned short* su = reinterpret_cast<unsigned short*>(s);
#pragma unroll 4
    for (int idx = tid; idx < R * W; idx += mma::kThreads) {
      const int r = idx / W, c = idx % W, gr = row0 + r;
      su[r * (W + 8) + c] = gr < n && c < dc ? u[gr * stride + c] : 0;
    }
  }
}

// The A fragments (16 rows × W) of rows row[0], row[1] = row[0] + 8 of a
// bf16 matrix at row stride `stride`, columns [0, dc), read from device
// memory; rows >= n and columns >= dc zero. 4-byte loads for an even head
// dim (a fragment's column pair is then wholly in or out), 2-byte ones for
// an odd one.
template <int W>
__device__ __forceinline__ void load_a_chunk(uint32_t (&f)[W / 16][4],
                                             const bf16* p,
                                             const int (&row)[2], int n,
                                             int dc, long long stride,
                                             bool even) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row[j & 1];
      const int c = kk * 16 + (j >> 1) * 8 + 2 * tq;
      uint32_t w = 0u;
      if (r < n && c < dc) {
        const long long b = r * stride + c;
        if (even) {
          w = *reinterpret_cast<const uint32_t*>(p + b);
        } else {
          w = u[b];
          if (c + 1 < dc) w |= static_cast<uint32_t>(u[b + 1]) << 16;
        }
      }
      f[kk][j] = w;
    }
}

// Columns col, col + 1 (< dc) of a bf16 row: one 4-byte store for an even
// head dim, one element at a time for an odd one.
__device__ __forceinline__ void store_pair(bf16* p, int col, int dc,
                                           bool even, float x0, float x1) {
  if (even) {
    if (col < dc)
      *reinterpret_cast<__nv_bfloat162*>(p + col) =
          __floats2bfloat162_rn(x0, x1);
  } else {
    mma::store_pair_padded(p, col, dc, x0, x1);
  }
}

// ---- bf16, the tensor cores ------------------------------------------------

// Forward: rows [q0, q0 + 64) of one group, output chunk c. Arguments as
// attend_rows_mma's (attention_mma_tile.cuh); lay: the group's rows.
// 4 warps of 16 rows; K (chunk by chunk) and V (chunk c) of a 64-key tile
// in shared memory, Q's A fragments read chunk by chunk from device memory.
template <KeyMask kMask, bool kDrop>
__device__ __forceinline__ void attend_rows_wide_mma(
    int q0, int c, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    bf16* __restrict__ o, float* __restrict__ lse, int sq, int sk,
    int kv_valid, float scale, const void* __restrict__ kmask, Dropout drop,
    uint32_t rng_group, unsigned long long* tile_counts, Rows lay) {
  constexpr int S = kW + 8;
  constexpr bool kMasked = kMask != KeyMask::NoMask;
  __shared__ __align__(16) bf16 ks[kKeys * S];
  __shared__ __align__(16) bf16 vs[kKeys * S];
  __shared__ uint32_t keep_s[kMask == KeyMask::ReplaceByte ? 2 : 1];
  __shared__ float add_s[kMask == KeyMask::AddFloat ? kKeys : 1];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tq = lane & 3;
  const int row[2] = {q0 + warp * 16 + (lane >> 2),
                      q0 + warp * 16 + (lane >> 2) + 8};
  const int nc = chunks(lay.d, kW);
  const int dco = min(kW, lay.d - c * kW);
  const bool even = (lay.d & 1) == 0;

  int tiles = (sk + kKeys - 1) / kKeys;
  if constexpr (kMasked) {
    __shared__ int last_s;
    const int last = kmask == nullptr
                         ? (kv_valid - 1) / kKeys  // key 0 is attended
                         : mma::last_live_tile<kMask>(&last_s, kmask,
                                                      kv_valid);
    if (last >= 0) tiles = last + 1;
    if (tile_counts != nullptr && c == 0 && threadIdx.x == 0) {
      atomicAdd(&tile_counts[0], static_cast<unsigned long long>(tiles));
      atomicAdd(&tile_counts[1],
                static_cast<unsigned long long>((sk + kKeys - 1) / kKeys));
    }
  }

  float acc[kW / 8][4];
#pragma unroll
  for (int n = 0; n < kW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float mr[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int t = 0; t < tiles; ++t) {
    __syncthreads();  // every warp is done with the last tile's buffers
    load_chunk<kKeys, kW>(vs, v + c * kW, t * kKeys, sk, dco, lay.qkv,
                          lay.d);
    mma::cp_async_commit();
    if constexpr (kMasked) {
      int raw[2] = {0, 0};
      float add = 0.f;
      mma::fetch_tile_mask<kMask>(raw, add, kmask, t, sk, kv_valid);
      mma::store_tile_mask<kMask>(keep_s, add_s, raw, add);
    }
    float s[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int j = 0; j < nc; ++j) {
      const int dj = min(kW, lay.d - j * kW);
      if (j > 0) __syncthreads();  // every warp has read chunk j - 1
      load_chunk<kKeys, kW>(ks, k + j * kW, t * kKeys, sk, dj, lay.qkv,
                            lay.d);
      mma::cp_async_commit();
      uint32_t qf[kW / 16][4];
      load_a_chunk<kW>(qf, q + j * kW, row, sq, dj, lay.qkv, even);
      mma::cp_async_wait<0>();
      __syncthreads();
      mma::mma_abt<kW, kKeys / 8>(s, qf, ks, lane);
    }

    const int k0 = t * kKeys;
    uint32_t kw[2] = {0u, 0u};
    if constexpr (kMask == KeyMask::ReplaceByte) {
      kw[0] = keep_s[0] >> (2 * tq);
      kw[1] = keep_s[1] >> (2 * tq);
    }
    float mx[2] = {mr[0], mr[1]};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = n * 8 + (e & 1);  // in the tile, - 2·tq
        const int kj = k0 + n * 8 + 2 * tq + (e & 1);
        const int r = row[e >> 1];
        float x = s[n][e] * scale;
        if (bias != nullptr && kj < sk && r < sq)
          x += bias[static_cast<long long>(r) * sk + kj];
        if constexpr (kMask == KeyMask::ReplaceByte) {
          if (((kw[cc >> 5] >> (cc & 31)) & 1u) == 0u) x = kMaskValue;
        } else {
          if (kj >= kv_valid) x = kMaskValue;
          if constexpr (kMask == KeyMask::AddFloat)
            if (kmask != nullptr) x += add_s[cc + 2 * tq];
        }
        s[n][e] = x;
        if (kj < sk) mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f((mr[i] - mx[i]) * kLog2e);
      mr[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + 2 * tq + (e & 1);
        const float p =
            kj < sk ? exp2f((s[n][e] - mr[e >> 1]) * kLog2e) : 0.f;
        s[n][e] = p;
        l[e >> 1] += p;  // the undropped sum normalises, and is lse's
      }
    if constexpr (kDrop) {
      // lane tq draws row[tq & 1]'s keep bits of columns
      // k0 + n·8 + 4·(tq / 2) .. +3, its neighbour the other row's
      if (drop.thresh != 0u)
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n) {
          uint32_t keep =
              dropout_keep4(drop, rng_group, (tq & 1) ? row[1] : row[0],
                            (k0 + n * 8 + (tq >> 1) * 4) >> 2)
              << (4 * (tq & 1));
          keep |= __shfl_xor_sync(0xffffffffu, keep, 1);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (((keep >> (4 * (e >> 1) + 2 * (tq & 1) + (e & 1))) & 1u) ==
                0u)
              s[n][e] = 0.f;
            else
              s[n][e] *= drop.inv_keep;
        }
    }
#pragma unroll
    for (int n = 0; n < kW / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4];
      mma::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
      mma::mma_ab<kW>(acc, a, vs + kk * 16 * S, lane);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if constexpr (kMask == KeyMask::ReplaceByte) li = fmaxf(li, 1e-30f);
    const int r = row[i];
    if (r >= sq) continue;
    bf16* orow = o + r * lay.o + c * kW;
#pragma unroll
    for (int n = 0; n < kW / 8; ++n)
      store_pair(orow, n * 8 + 2 * tq, dco, even, acc[n][2 * i] / li,
                 acc[n][2 * i + 1] / li);
    if (c == 0 && tq == 0) lse[r * lay.lse] = mr[i] + logf(li);
  }
}

// Backward pass 1: dq of rows [q0, q0 + 64) of one group, output chunk c,
// and (chunk 0) δ of those rows into the delta scratch. Arguments as
// bwd_dq_rows_mma's. Key tiles of 32: K and V chunk by chunk, then K's
// chunk c, in shared memory; Q and dO's A fragments from device memory.
template <bool kMayDrop, class Scale>
__device__ __forceinline__ void bwd_dq_rows_wide_mma(
    int q0, int c, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const bf16* __restrict__ out, const float* __restrict__ lse,
    const float* __restrict__ kmask, bf16* __restrict__ dq,
    float* __restrict__ delta, int sq, int sk, int kv_valid, float scale,
    Dropout drop, uint32_t rng_group, Rows lay) {
  constexpr int S = kW + 8;
  __shared__ __align__(16) bf16 ks[kTile * S];
  __shared__ __align__(16) bf16 vs[kTile * S];
  __shared__ __align__(16) bf16 kc[kTile * S];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tq = lane & 3;
  const int row[2] = {q0 + warp * 16 + (lane >> 2),
                      q0 + warp * 16 + (lane >> 2) + 8};
  const int nc = chunks(lay.d, kW);
  const int dco = min(kW, lay.d - c * kW);
  const bool even = (lay.d & 1) == 0;

  // δ and lse·log2 e of this lane's two rows; the four lanes of a row split
  // its d columns and meet by shuffles
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row[i];
    float part = 0.f;
    if (r < sq) {
      const long long base = r * lay.o;
      for (int col = tq; col < lay.d; col += 4)
        part = fmaf(__bfloat162float(dout[base + col]),
                    __bfloat162float(out[base + col]), part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    delta_r[i] = part;
    lse_r[i] = r < sq ? lse[r * lay.lse] * kLog2e : 0.f;
    if (c == 0 && tq == 0 && r < sq) delta[r] = part;
  }

  float acc[kW / 8][4];
#pragma unroll
  for (int n = 0; n < kW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int tiles = (sk + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    __syncthreads();  // every warp is done with the last tile's buffers
    load_chunk<kTile, kW>(kc, k + c * kW, t * kTile, sk, dco, lay.qkv, lay.d);
    mma::cp_async_commit();
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    for (int j = 0; j < nc; ++j) {
      const int dj = min(kW, lay.d - j * kW);
      if (j > 0) __syncthreads();  // every warp has read chunk j - 1
      load_chunk<kTile, kW>(ks, k + j * kW, t * kTile, sk, dj, lay.qkv,
                            lay.d);
      load_chunk<kTile, kW>(vs, v + j * kW, t * kTile, sk, dj, lay.qkv,
                            lay.d);
      mma::cp_async_commit();
      {
        uint32_t f[kW / 16][4];
        load_a_chunk<kW>(f, q + j * kW, row, sq, dj, lay.qkv, even);
        mma::cp_async_wait<0>();
        __syncthreads();
        mma::mma_abt<kW, kTile / 8>(s, f, ks, lane);
      }
      {
        uint32_t f[kW / 16][4];
        load_a_chunk<kW>(f, dout + j * kW, row, sq, dj, lay.o, even);
        mma::mma_abt<kW, kTile / 8>(dp, f, vs, lane);
      }
    }

    const int k0 = t * kTile;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      uint32_t keep = 0xffffffffu;
      if (kMayDrop && drop.thresh != 0u) {
        // this lane draws row[tq & 1]'s block of columns 4·(tq / 2) .. +3
        keep = dropout_keep4(drop, rng_group, (tq & 1) ? row[1] : row[0],
                             (k0 + n * 8 + (tq >> 1) * 4) >> 2)
               << (4 * (tq & 1));
        keep |= __shfl_xor_sync(0xffffffffu, keep, 1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kj = k0 + n * 8 + 2 * tq + (e & 1);
        float x = s[n][e] * scale;
        if (kj >= kv_valid) x = kMaskValue;
        if (kmask != nullptr && kj < sk) x += kmask[kj];
        const float p = (kj < sk && row[i] < sq)
                            ? exp2f(fmaf(x, kLog2e, -lse_r[i])) : 0.f;
        float dpv = dp[n][e];
        if (kMayDrop && drop.thresh != 0u)
          dpv = (keep >> (4 * i + 2 * (tq & 1) + (e & 1))) & 1u
                    ? dpv * drop.inv_keep : 0.f;
        if constexpr (Scale::kAfter)
          s[n][e] = p * (dpv - delta_r[i]);
        else
          s[n][e] = p * (dpv - delta_r[i]) * scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      mma::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
      mma::mma_ab<kW>(acc, a, kc + kk * 16 * S, lane);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row[i];
    if (r >= sq) continue;
    bf16* drow = dq + r * lay.qkv + c * kW;
#pragma unroll
    for (int n = 0; n < kW / 8; ++n) {
      float x0 = acc[n][2 * i], x1 = acc[n][2 * i + 1];
      if constexpr (Scale::kAfter) {
        x0 *= scale;
        x1 *= scale;
      }
      store_pair(drow, n * 8 + 2 * tq, dco, even, x0, x1);
    }
  }
}

// Backward pass 2: dk and dv of keys [k0, k0 + 64) of one group, output
// chunk c (64 columns), over every query tile of 32. Q and dO chunk by
// chunk, then their chunk c, in shared memory with each tile's lse and δ;
// K and V's A fragments from device memory (keys as the M dimension, as
// bwd_dkv_rows_mma).
template <bool kMayDrop, class Scale>
__device__ __forceinline__ void bwd_dkv_rows_wide_mma(
    int k0, int c, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ kmask, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int sq, int sk, int kv_valid, float scale,
    Dropout drop, uint32_t rng_group, Rows lay) {
  constexpr int S = kW + 8, SO = kWkv + 8;
  __shared__ __align__(16) bf16 qs[kTile * S];
  __shared__ __align__(16) bf16 dos[kTile * S];
  __shared__ __align__(16) bf16 qc[kTile * SO];
  __shared__ __align__(16) bf16 dc[kTile * SO];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int key[2] = {k0 + warp * 16 + gr, k0 + warp * 16 + gr + 8};
  const int nc = chunks(lay.d, kW);
  const int dco = min(kWkv, lay.d - c * kWkv);
  const bool even = (lay.d & 1) == 0;
  float madd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    madd[i] = (kmask != nullptr && key[i] < sk) ? kmask[key[i]] : 0.f;
  // the Philox block this lane draws in each n8 tile: keys 4a .. 4a+3
  // (jq < 2) or 8+4a .. (jq >= 2) of this warp's 16, query column
  // 2·tq + (jq & 1)
  const int jq = gr & 3;
  const uint32_t quad = (k0 + warp * 16 + (jq >> 1) * 8 + (gr >> 2) * 4) >> 2;

  float acc_k[kWkv / 8][4], acc_v[kWkv / 8][4];
#pragma unroll
  for (int n = 0; n < kWkv / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int tiles = (sq + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    __syncthreads();  // every warp is done with the last tile's buffers
    load_chunk<kTile, kWkv>(qc, q + c * kWkv, t * kTile, sq, dco, lay.qkv,
                            lay.d);
    load_chunk<kTile, kWkv>(dc, dout + c * kWkv, t * kTile, sq, dco, lay.o,
                            lay.d);
    mma::cp_async_commit();
    if (threadIdx.x < kTile) {
      const int qi = t * kTile + threadIdx.x;
      lse_s[threadIdx.x] = qi < sq ? lse[qi * lay.lse] * kLog2e : 0.f;
      delta_s[threadIdx.x] = qi < sq ? delta[qi] : 0.f;
    }
    float st[kTile / 8][4], dpt[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    for (int j = 0; j < nc; ++j) {
      const int dj = min(kW, lay.d - j * kW);
      if (j > 0) __syncthreads();  // every warp has read chunk j - 1
      load_chunk<kTile, kW>(qs, q + j * kW, t * kTile, sq, dj, lay.qkv,
                            lay.d);
      load_chunk<kTile, kW>(dos, dout + j * kW, t * kTile, sq, dj, lay.o,
                            lay.d);
      mma::cp_async_commit();
      {
        uint32_t f[kW / 16][4];
        load_a_chunk<kW>(f, k + j * kW, key, sk, dj, lay.qkv, even);
        mma::cp_async_wait<0>();
        __syncthreads();
        mma::mma_abt<kW, kTile / 8>(st, f, qs, lane);
      }
      {
        uint32_t f[kW / 16][4];
        load_a_chunk<kW>(f, v + j * kW, key, sk, dj, lay.qkv, even);
        mma::mma_abt<kW, kTile / 8>(dpt, f, dos, lane);
      }
    }

    const int q0 = t * kTile;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      const int c0 = n * 8 + 2 * tq;  // this lane's two columns
      uint32_t keep = 0xffffffffu;
      if (kMayDrop && drop.thresh != 0u) {
        keep = dropout_keep4(drop, rng_group, q0 + c0 + (jq & 1), quad)
               << (4 * jq);
        keep |= __shfl_xor_sync(0xffffffffu, keep, 4);
        keep |= __shfl_xor_sync(0xffffffffu, keep, 8);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = c0 + (e & 1);
        float x = st[n][e] * scale;
        if (key[i] >= kv_valid) x = kMaskValue;
        x += madd[i];
        const float p = (key[i] < sk && q0 + col < sq)
                            ? exp2f(fmaf(x, kLog2e, -lse_s[col])) : 0.f;
        float pd = p, dpv = dpt[n][e];
        if (kMayDrop && drop.thresh != 0u) {
          const bool kept = (keep >> (4 * e + jq)) & 1u;
          pd = kept ? p * drop.inv_keep : 0.f;
          dpv = kept ? dpv * drop.inv_keep : 0.f;
        }
        st[n][e] = pd;
        if constexpr (Scale::kAfter)
          dpt[n][e] = p * (dpv - delta_s[col]);
        else
          dpt[n][e] = p * (dpv - delta_s[col]) * scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      mma::acc_to_a(a, st[2 * kk], st[2 * kk + 1]);
      mma::mma_ab<kWkv>(acc_v, a, dc + kk * 16 * SO, lane);
      mma::acc_to_a(a, dpt[2 * kk], dpt[2 * kk + 1]);
      mma::mma_ab<kWkv>(acc_k, a, qc + kk * 16 * SO, lane);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = key[i];
    if (kr >= sk) continue;
    const long long off = kr * lay.qkv + c * kWkv;
#pragma unroll
    for (int n = 0; n < kWkv / 8; ++n) {
      float k0v = acc_k[n][2 * i], k1v = acc_k[n][2 * i + 1];
      if constexpr (Scale::kAfter) {
        k0v *= scale;
        k1v *= scale;
      }
      store_pair(dk + off, n * 8 + 2 * tq, dco, even, k0v, k1v);
      store_pair(dv + off, n * 8 + 2 * tq, dco, even, acc_v[n][2 * i],
                 acc_v[n][2 * i + 1]);
    }
  }
}

// ---- fp32, the CUDA cores --------------------------------------------------
//
// attention_tile.cuh's layout with a chunk loop: 128 threads, warp w owns
// rows w, w + 4, ... of the block's 32 and lane j key j of a 32-key tile;
// the scores summed over 64-column chunks staged in shared memory as fp32,
// then the block's own 64 output columns.

// Columns [0, dc) of rows [row0, row0 + 32) at row stride `stride` into a
// shared (32, ld) fp32 tile; the rest zero.
template <int LD>
__device__ __forceinline__ void stage_f32(float (*s)[LD],
                                          const float* __restrict__ g,
                                          int row0, int n, int dc,
                                          long long stride) {
  for (int idx = threadIdx.x; idx < kBlockQ * kFW; idx += kThreads) {
    const int r = idx / kFW, cc = idx % kFW, gr = row0 + r;
    s[r][cc] = gr < n && cc < dc ? g[gr * stride + cc] : 0.f;
  }
}

// Forward: rows [q0, q0 + 32) of one group, output chunk c (64 columns).
// bias: this group's (Sq, Sk) fp32 slice or null (NoMask); kmask: the
// group's uint8 row (ReplaceByte) or fp32 row (AddFloat), or null.
template <KeyMask kMask>
__device__ __forceinline__ void attend_rows_wide(
    int q0, int c, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const void* __restrict__ kmask, float* __restrict__ o,
    float* __restrict__ lse, int sq, int sk, int kv_valid, float scale,
    Dropout drop, uint32_t rng_group, Rows lay) {
  __shared__ float qs[kBlockQ][kFW];
  __shared__ float ks[kBlockK][kFW + 1];  // +1: lane-strided reads
  __shared__ float vs[kBlockK][kFW];
  __shared__ float ps[kBlockQ][kBlockK + 1];
  __shared__ float alpha_s[kBlockQ];
  __shared__ float l_s[kBlockQ];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = chunks(lay.d, kFW);
  const int dco = min(kFW, lay.d - c * kFW);
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -CUDART_INF_F;
    l_run[r] = 0.f;
  }
  constexpr int kOutStride = kThreads / kFW;
  constexpr int kOutRows = kBlockQ / kOutStride;
  const int od = tid % kFW, orow = tid / kFW;
  float acc[kOutRows];
#pragma unroll
  for (int i = 0; i < kOutRows; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    for (int j = 0; j < nc; ++j) {
      const int dj = min(kFW, lay.d - j * kFW);
      __syncthreads();  // the last chunk's (and tile's) readers are done
      stage_f32<kFW>(qs, q + j * kFW, q0, sq, dj, lay.qkv);
      stage_f32<kFW + 1>(ks, k + j * kFW, k0, sk, dj, lay.qkv);
      __syncthreads();
#pragma unroll 16
      for (int cc = 0; cc < kFW; ++cc) {
        const float kc = ks[lane][cc];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          s[r] = fmaf(qs[warp + kWarps * r][cc], kc, s[r]);
      }
    }
    stage_f32<kFW>(vs, v + c * kFW, k0, sk, dco, lay.qkv);

    const int kj = k0 + lane;
    const bool key_in = kj < sk;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      const int qi = q0 + row;
      float x = s[r] * scale;
      if (bias != nullptr && key_in && qi < sq) x += bias[qi * static_cast<long long>(sk) + kj];
      if constexpr (kMask == KeyMask::ReplaceByte) {
        if (kj >= kv_valid ||
            (kmask != nullptr && key_in &&
             static_cast<const unsigned char*>(kmask)[kj] == 0))
          x = kMaskValue;
      } else {
        if (kj >= kv_valid) x = kMaskValue;
        if constexpr (kMask == KeyMask::AddFloat)
          if (kmask != nullptr && key_in)
            x += static_cast<const float*>(kmask)[kj];
      }
      const float m_new =
          fmaxf(m_run[r], warp_max(key_in ? x : -CUDART_INF_F));
      const float p = key_in ? expf(x - m_new) : 0.f;
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + warp_sum(p);
      m_run[r] = m_new;
      float pd = p;
      if (drop.thresh != 0u)
        pd = dropout_keep(drop, rng_group, qi, kj) ? p * drop.inv_keep : 0.f;
      ps[row][lane] = pd;
      if (lane == 0) alpha_s[row] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kOutRows; ++i) {
      const int row = orow + kOutStride * i;
      float a = acc[i] * alpha_s[row];
#pragma unroll 8
      for (int jj = 0; jj < kBlockK; ++jj) a = fmaf(ps[row][jj], vs[jj][od], a);
      acc[i] = a;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      const int qi = q0 + row;
      float li = l_run[r];
      if constexpr (kMask == KeyMask::ReplaceByte) li = fmaxf(li, 1e-30f);
      l_s[row] = li;
      if (c == 0 && qi < sq) lse[qi * lay.lse] = m_run[r] + logf(li);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kOutRows; ++i) {
    const int row = orow + kOutStride * i;
    const int qi = q0 + row;
    if (qi < sq && od < dco) o[qi * lay.o + c * kFW + od] = acc[i] / l_s[row];
  }
}

// Backward pass 1 (fp32): dq of rows [q0, q0 + 32), output chunk c, and
// (chunk 0) δ of the rows. kmask: fp32 per key or null.
template <class Scale>
__device__ __forceinline__ void bwd_dq_rows_wide(
    int q0, int c, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ out, const float* __restrict__ lse,
    const float* __restrict__ kmask, float* __restrict__ dq,
    float* __restrict__ delta, int sq, int sk, int kv_valid, float scale,
    Dropout drop, uint32_t rng_group, Rows lay) {
  __shared__ float qs[kBlockQ][kFW];
  __shared__ float dos[kBlockQ][kFW];
  __shared__ float ks[kBlockK][kFW + 1];
  __shared__ float vs[kBlockK][kFW + 1];
  __shared__ float dss[kBlockQ][kBlockK + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = chunks(lay.d, kFW);
  const int dco = min(kFW, lay.d - c * kFW);

  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp + kWarps * r;
    float part = 0.f;
    if (qi < sq)
      for (int cc = lane; cc < lay.d; cc += 32)
        part = fmaf(dout[qi * lay.o + cc], out[qi * lay.o + cc], part);
    delta_r[r] = warp_sum(part);
    lse_r[r] = qi < sq ? lse[qi * lay.lse] : 0.f;
    if (c == 0 && lane == 0 && qi < sq) delta[qi] = delta_r[r];
  }

  constexpr int kOutStride = kThreads / kFW;
  constexpr int kOutRows = kBlockQ / kOutStride;
  const int od = tid % kFW, orow = tid / kFW;
  float acc[kOutRows];
#pragma unroll
  for (int i = 0; i < kOutRows; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    for (int j = 0; j < nc; ++j) {
      const int dj = min(kFW, lay.d - j * kFW);
      __syncthreads();
      stage_f32<kFW>(qs, q + j * kFW, q0, sq, dj, lay.qkv);
      stage_f32<kFW>(dos, dout + j * kFW, q0, sq, dj, lay.o);
      stage_f32<kFW + 1>(ks, k + j * kFW, k0, sk, dj, lay.qkv);
      stage_f32<kFW + 1>(vs, v + j * kFW, k0, sk, dj, lay.qkv);
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < kFW; ++cc) {
        const float kc = ks[lane][cc], vc = vs[lane][cc];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          s[r] = fmaf(qs[warp + kWarps * r][cc], kc, s[r]);
          dp[r] = fmaf(dos[warp + kWarps * r][cc], vc, dp[r]);
        }
      }
    }

    const int kj = k0 + lane;
    const bool key_in = kj < sk;
    const float madd = (kmask != nullptr && key_in) ? kmask[kj] : 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      const int qi = q0 + row;
      float x = s[r] * scale;
      if (kj >= kv_valid) x = kMaskValue;
      x += madd;
      const float p = (key_in && qi < sq) ? expf(x - lse_r[r]) : 0.f;
      float dpv = dp[r];
      if (drop.thresh != 0u)
        dpv = dropout_keep(drop, rng_group, qi, kj) ? dpv * drop.inv_keep
                                                    : 0.f;
      dss[row][lane] = Scale::kAfter ? p * (dpv - delta_r[r])
                                     : p * (dpv - delta_r[r]) * scale;
    }
    __syncthreads();  // dss written; every warp has read ks
    stage_f32<kFW + 1>(ks, k + c * kFW, k0, sk, dco, lay.qkv);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kOutRows; ++i) {
      const int row = orow + kOutStride * i;
      float a = acc[i];
#pragma unroll 8
      for (int jj = 0; jj < kBlockK; ++jj) a = fmaf(dss[row][jj], ks[jj][od], a);
      acc[i] = a;
    }
  }

#pragma unroll
  for (int i = 0; i < kOutRows; ++i) {
    const int qi = q0 + orow + kOutStride * i;
    if (qi < sq && od < dco)
      dq[qi * lay.qkv + c * kFW + od] = Scale::kAfter ? acc[i] * scale
                                                      : acc[i];
  }
}

// Backward pass 2 (fp32): dk and dv of keys [k0, k0 + 32), output chunk c,
// over every query tile of 32; delta holds δ of every query row.
template <class Scale>
__device__ __forceinline__ void bwd_dkv_rows_wide(
    int k0, int c, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ kmask, float* __restrict__ dk,
    float* __restrict__ dv, int sq, int sk, int kv_valid, float scale,
    Dropout drop, uint32_t rng_group, Rows lay) {
  __shared__ float ks[kBlockK][kFW];
  __shared__ float vs[kBlockK][kFW];
  __shared__ float qs[kBlockQ][kFW + 1];
  __shared__ float dos[kBlockQ][kFW + 1];
  __shared__ float pds[kBlockK][kBlockQ + 1];  // [key][query row]
  __shared__ float dss[kBlockK][kBlockQ + 1];
  __shared__ float lse_s[kBlockQ];
  __shared__ float delta_s[kBlockQ];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = chunks(lay.d, kFW);
  const int dco = min(kFW, lay.d - c * kFW);
  float madd[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int kj = k0 + warp + kWarps * r;
    madd[r] = (kmask != nullptr && kj < sk) ? kmask[kj] : 0.f;
  }
  constexpr int kOutStride = kThreads / kFW;
  constexpr int kOutRows = kBlockK / kOutStride;
  const int od = tid % kFW, orow = tid / kFW;
  float acc_k[kOutRows], acc_v[kOutRows];
#pragma unroll
  for (int i = 0; i < kOutRows; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += kBlockQ) {
    float st[kRowsPerWarp], dpt[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) st[r] = dpt[r] = 0.f;
    for (int j = 0; j < nc; ++j) {
      const int dj = min(kFW, lay.d - j * kFW);
      __syncthreads();
      stage_f32<kFW>(ks, k + j * kFW, k0, sk, dj, lay.qkv);
      stage_f32<kFW>(vs, v + j * kFW, k0, sk, dj, lay.qkv);
      stage_f32<kFW + 1>(qs, q + j * kFW, q0, sq, dj, lay.qkv);
      stage_f32<kFW + 1>(dos, dout + j * kFW, q0, sq, dj, lay.o);
      if (j == 0 && tid < kBlockQ) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < sq ? lse[qi * lay.lse] : 0.f;
        delta_s[tid] = qi < sq ? delta[qi] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < kFW; ++cc) {
        const float qc = qs[lane][cc], dc = dos[lane][cc];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          st[r] = fmaf(ks[warp + kWarps * r][cc], qc, st[r]);
          dpt[r] = fmaf(vs[warp + kWarps * r][cc], dc, dpt[r]);
        }
      }
    }

    const int qi = q0 + lane;
    const bool row_in = qi < sq;
    const float lse_i = lse_s[lane], delta_i = delta_s[lane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int key = warp + kWarps * r;
      const int kj = k0 + key;
      float x = st[r] * scale;
      if (kj >= kv_valid) x = kMaskValue;
      x += madd[r];
      const float p = (row_in && kj < sk) ? expf(x - lse_i) : 0.f;
      float pd = p, dpv = dpt[r];
      if (drop.thresh != 0u) {
        const bool keep = dropout_keep(drop, rng_group, qi, kj);
        pd = keep ? p * drop.inv_keep : 0.f;
        dpv = keep ? dpv * drop.inv_keep : 0.f;
      }
      pds[key][lane] = pd;
      dss[key][lane] = Scale::kAfter ? p * (dpv - delta_i)
                                     : p * (dpv - delta_i) * scale;
    }
    __syncthreads();  // pds, dss written; every warp has read qs and dos
    stage_f32<kFW + 1>(qs, q + c * kFW, q0, sq, dco, lay.qkv);
    stage_f32<kFW + 1>(dos, dout + c * kFW, q0, sq, dco, lay.o);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kOutRows; ++i) {
      const int key = orow + kOutStride * i;
      float ak = acc_k[i], av = acc_v[i];
#pragma unroll 8
      for (int jj = 0; jj < kBlockQ; ++jj) {
        av = fmaf(pds[key][jj], dos[jj][od], av);
        ak = fmaf(dss[key][jj], qs[jj][od], ak);
      }
      acc_k[i] = ak;
      acc_v[i] = av;
    }
  }

#pragma unroll
  for (int i = 0; i < kOutRows; ++i) {
    const int kj = k0 + orow + kOutStride * i;
    if (kj < sk && od < dco) {
      const long long off = kj * lay.qkv + c * kFW + od;
      dk[off] = Scale::kAfter ? acc_k[i] * scale : acc_k[i];
      dv[off] = acc_v[i];
    }
  }
}

}  // namespace wide
}  // namespace vtt
