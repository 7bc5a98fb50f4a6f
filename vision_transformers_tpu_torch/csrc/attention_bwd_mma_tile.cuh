// Tensor-core bodies of the bf16 split-head attention backward.
//
// Replace, for bf16 inputs, the TPU kernel vision_transformers_tpu/ops/
// flash_attention.py::_drop_bwd_kernel (:525), through dropout_attention.cu's
// dropout_attention_bwd (row 6 of PERF.md's kernel table): the dropout
// backward, and at rate 0 the bias-free backward of flash_attention. fp32
// inputs keep bwd_dq_rows / bwd_dkv_rows (attention_bwd_tile.cuh), and so
// does the packed backward (row 7).
//
// The formulas are those of attention_bwd_tile.cuh (the TPU kernel's):
//   s  = q·kᵀ·scale, keys >= kv_valid → -0.7·FLT_MAX, + key mask
//   p  = exp(s − lse), δ = rowsum(do ⊙ out), dp = do·vᵀ
//   dropout: pd = keep·p/(1−r), dp ← keep·dp/(1−r)
//   dv = pdᵀ·do, ds = p ⊙ (dp − δ)·scale, dq = ds·k, dk = dsᵀ·q
// and, as _drop_bwd_kernel does, pd and ds are rounded to bf16 before their
// products (the fp32 bodies keep them fp32).
//
// What bounds it on the H100: 10·G·Sq·Sk·D operations (5 products) against
// q, k, v, do, out, dq, dk, dv once: at G 96, S 1025, D 64, 64.6 GFLOP, 65 µs
// of bf16 tensor-core work against 30 µs of memory — the products. The fp32
// bodies run them as FMAs on the CUDA cores at about 1% of that peak; these
// run every product as mma.sync.m16n8k16 (bf16 in, fp32 accumulators), with
// the streamed tiles double-buffered through padded shared memory by cp.async
// and read with ldmatrix (attention_mma_tile.cuh), and the A operands of the
// second products taken straight from the first products' accumulators.
//
// Two passes that each own their outputs, as before — no float atomics, and
// gradients bit-equal from run to run:
//
//   bwd_dq_rows_mma: one block per (group, 64 query rows); Q and dO live in
//     registers as A fragments. Computes δ for its rows (stored to the
//     delta scratch for pass 2), streams K/V tiles of 64 keys, recomputes
//     S = Q·Kᵀ and dP = dO·Vᵀ, forms dS on the fragments and accumulates
//     dQ += dS·K (K read transposed). 3 products per tile, each 32-key half
//     of a tile finished before the next (fewer live accumulators).
//   bwd_dkv_rows_mma: one block per (group, 64 keys, chunk of query tiles);
//     K and V live in registers. It computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
//     directly, keys as the M dimension (chosen over staging P
//     through shared memory): Pdᵀ and dSᵀ are then already the A fragments of
//     dV += Pdᵀ·dO and dK += dSᵀ·Q, with dO and Q read transposed. lse and δ
//     are per column there, staged in shared memory with each Q tile. Each
//     32-query half of a tile is finished before the next, so the live
//     accumulators stay at 2·16 + 2·D/2 per lane. 4 products per tile.
//
// Occupancy (ptxas -v, printed by chip_smoke.py): both passes 168 registers
// at D 64 (3 blocks of 128 threads an SM), 125-128 at D 32 (4; the dk/dv pass
// spills 16 bytes), 96 at D 16 (5); 12-38 KB of shared memory.
//
// So the pair does 7 tile products where the mathematics needs 5, the price
// of no atomics. When the dk/dv grid alone cannot fill the card (PVT's Sk 49:
// G 32 blocks of one key tile each, on 132 SMs), the caller splits the query
// loop into `chunks` fixed ranges; each writes fp32 partial dK/dV to a
// scratch, and a third launch (dropout_attention.cu's drop_bwd_dkv_sum_kernel)
// adds the partials in chunk order and rounds once.
// The split depends on the shape alone, so reruns stay bit-equal.
//
// Dropout: each Philox call gives four keep bits (dropout_keep4), which the
// lanes holding those four columns share by shuffles — one call per four
// probabilities instead of one per probability (philox.cuh):
//   pass 1 (rows = queries, columns = keys): lanes 2u, 2u+1 of a quad hold
//     columns 4u .. 4u+3 of rows g and g+8; the even lane draws row g's
//     block, the odd lane row g+8's, one __shfl_xor_sync(1) swaps them.
//   pass 2 (rows = keys): the four lanes with g = 4a .. 4a+3 and the same
//     lane % 4 hold keys 4a .. 4a+3 and 8+4a .. 8+4a+3 of query columns
//     c, c+1: four calls, one per lane, gathered by __shfl_xor_sync 4 and 8.
//
// Masking: keys past Sk (the zero-filled tail) and query rows past Sq are
// masked by index, their probabilities exactly 0; nothing is written for
// them. A key >= kv_valid (or hidden by the key mask) has p = 0, so its dk
// and dv are written as 0. exp(x − lse) is exp2f(x·log2 e − lse·log2 e), one
// fused multiply-add: a masked score gives -inf there and p = 0.
#pragma once

#include "attention_mma_tile.cuh"

namespace vtt {
namespace mma {

// Pass 1: rows [q0, q0 + kRows) of one group. Pointers are the group's row 0
// (row stride D; lse and delta one value per row). kmask: fp32 per key or
// null.
template <int D>
__device__ __forceinline__ void bwd_dq_rows_mma(
    int q0, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const bf16* __restrict__ out, const float* __restrict__ lse,
    const float* __restrict__ kmask, bf16* __restrict__ dq,
    float* __restrict__ delta, int sq, int sk, int kv_valid, float scale,
    Dropout drop, uint32_t rng_group) {
  static_assert(D == 16 || D == 32 || D == 64, "head dim must be 16, 32 or 64");
  constexpr int S = D + 8;
  __shared__ __align__(16) bf16 ks[2][kCols * S];
  __shared__ __align__(16) bf16 vs[2][kCols * S];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  const int row[2] = {q0 + warp * 16 + (lane >> 2),
                      q0 + warp * 16 + (lane >> 2) + 8};

  load_tile<D>(ks[0], k, 0, sk);
  load_tile<D>(vs[0], v, 0, sk);
  cp_async_commit();
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a_frags<D>(qf, q, row, sq);
  load_a_frags<D>(df, dout, row, sq);

  // δ and lse·log2 e of this lane's two rows; the four lanes of a row split
  // its D columns and meet by shuffles
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row[i];
    float part = 0.f;
    if (r < sq) {
      const long long base = static_cast<long long>(r) * D + tq * (D / 4);
#pragma unroll
      for (int c = 0; c < D / 4; c += 2) {
        const float2 d2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + base + c));
        const float2 o2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(out + base + c));
        part = fmaf(d2.x, o2.x, part);
        part = fmaf(d2.y, o2.y, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    delta_r[i] = part;
    lse_r[i] = r < sq ? lse[r] * kLog2e : 0.f;
    if (tq == 0 && r < sq) delta[r] = part;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int tiles = (sk + kCols - 1) / kCols;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_tile<D>(ks[buf ^ 1], k, (t + 1) * kCols, sk);
      load_tile<D>(vs[buf ^ 1], v, (t + 1) * kCols, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < 2; ++h) {  // keys 32·h .. 32·h + 31 of the tile
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      mma_abt<D, 4>(s, qf, ks[buf] + h * 32 * S, lane);
      mma_abt<D, 4>(dp, df, vs[buf] + h * 32 * S, lane);

      const int k0 = t * kCols + h * 32;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t keep = 0xffffffffu;
        if (drop.thresh != 0u) {
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
          if (drop.thresh != 0u)
            dpv = (keep >> (4 * i + 2 * (tq & 1) + (e & 1))) & 1u
                      ? dpv * drop.inv_keep : 0.f;
          s[n][e] = p * (dpv - delta_r[i]) * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
        mma_ab<D>(acc, a, ks[buf] + (h * 32 + kk * 16) * S, lane);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row[i];
    if (r >= sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + static_cast<long long>(r) * D + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// Query tile t of Q and dO (cp.async; the caller commits), and its lse·log2 e
// and δ; rows >= Sq are zero.
template <int D>
__device__ __forceinline__ void load_q_tile(
    bf16* qs, bf16* dos, float* lse_s, float* delta_s, const bf16* q,
    const bf16* dout, const float* lse, const float* delta, int t, int sq) {
  load_tile<D>(qs, q, t * kCols, sq);
  load_tile<D>(dos, dout, t * kCols, sq);
  if (threadIdx.x < kCols) {
    const int qi = t * kCols + threadIdx.x;
    lse_s[threadIdx.x] = qi < sq ? lse[qi] * kLog2e : 0.f;
    delta_s[threadIdx.x] = qi < sq ? delta[qi] : 0.f;
  }
}

// Pass 2: keys [k0, k0 + kRows) of one group against query tiles
// [t_begin, t_end). Writes bf16 dk, dv (row stride D) when part_k is null,
// else this chunk's fp32 partials to part_k, part_v (row stride D).
template <int D>
__device__ __forceinline__ void bwd_dkv_rows_mma(
    int k0, int t_begin, int t_end, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ kmask,
    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part_k,
    float* __restrict__ part_v, int sq, int sk, int kv_valid, float scale,
    Dropout drop, uint32_t rng_group) {
  static_assert(D == 16 || D == 32 || D == 64, "head dim must be 16, 32 or 64");
  constexpr int S = D + 8;
  __shared__ __align__(16) bf16 qs[2][kCols * S];
  __shared__ __align__(16) bf16 dos[2][kCols * S];
  __shared__ float lse_s[2][kCols];
  __shared__ float delta_s[2][kCols];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int key[2] = {k0 + warp * 16 + gr, k0 + warp * 16 + gr + 8};

  if (t_begin < t_end) {
    load_q_tile<D>(qs[0], dos[0], lse_s[0], delta_s[0], q, dout, lse, delta,
                   t_begin, sq);
    cp_async_commit();
  }
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, k, key, sk);
  load_a_frags<D>(vf, v, key, sk);
  float madd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    madd[i] = (kmask != nullptr && key[i] < sk) ? kmask[key[i]] : 0.f;
  // the Philox block this lane draws in each n8 tile: keys 4a .. 4a+3 (j < 2)
  // or 8+4a .. (j >= 2) of this warp's 16, query column 2·tq + (j & 1)
  const int j = gr & 3;
  const uint32_t quad = (k0 + warp * 16 + (j >> 1) * 8 + (gr >> 2) * 4) >> 2;

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_q_tile<D>(qs[buf ^ 1], dos[buf ^ 1], lse_s[buf ^ 1],
                     delta_s[buf ^ 1], q, dout, lse, delta, t + 1, sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int q0 = t * kCols;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // query columns 32·h .. 32·h + 31
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      mma_abt<D, 4>(st, kf, qs[buf] + h * 32 * S, lane);
      mma_abt<D, 4>(dpt, vf, dos[buf] + h * 32 * S, lane);

#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c0 = h * 32 + n * 8 + 2 * tq;  // this lane's two columns
        uint32_t keep = 0xffffffffu;
        if (drop.thresh != 0u) {
          keep = dropout_keep4(drop, rng_group, q0 + c0 + (j & 1), quad)
                 << (4 * j);
          keep |= __shfl_xor_sync(0xffffffffu, keep, 4);
          keep |= __shfl_xor_sync(0xffffffffu, keep, 8);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = c0 + (e & 1);
          float x = st[n][e] * scale;
          if (key[i] >= kv_valid) x = kMaskValue;
          x += madd[i];
          const float p = (key[i] < sk && q0 + c < sq)
                              ? exp2f(fmaf(x, kLog2e, -lse_s[buf][c])) : 0.f;
          float pd = p, dpv = dpt[n][e];
          if (drop.thresh != 0u) {
            const bool kept = (keep >> (4 * e + j)) & 1u;
            pd = kept ? p * drop.inv_keep : 0.f;
            dpv = kept ? dpv * drop.inv_keep : 0.f;
          }
          st[n][e] = pd;
          dpt[n][e] = p * (dpv - delta_s[buf][c]) * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int r0 = (h * 32 + kk * 16) * S;
        uint32_t a[4];
        acc_to_a(a, st[2 * kk], st[2 * kk + 1]);
        mma_ab<D>(acc_v, a, dos[buf] + r0, lane);
        acc_to_a(a, dpt[2 * kk], dpt[2 * kk + 1]);
        mma_ab<D>(acc_k, a, qs[buf] + r0, lane);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = key[i];
    if (kr >= sk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const long long off = static_cast<long long>(kr) * D + n * 8 + 2 * tq;
      if (part_k == nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off) =
            __floats2bfloat162_rn(acc_k[n][2 * i], acc_k[n][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) =
            __floats2bfloat162_rn(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
      } else {
        *reinterpret_cast<float2*>(part_k + off) =
            make_float2(acc_k[n][2 * i], acc_k[n][2 * i + 1]);
        *reinterpret_cast<float2*>(part_v + off) =
            make_float2(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
      }
    }
  }
}

}  // namespace mma
}  // namespace vtt
