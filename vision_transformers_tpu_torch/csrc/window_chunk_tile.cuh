// Tensor-core bodies of rows 10 and 11 (the window backward and the batched
// window forward, bf16) at a head dim their tiles do not hold: the head dim
// passed in chunks of 64 columns.
//
// Replace, for bf16 inputs at those head dims, two TPU kernels of
// vision_transformers_tpu/ops/flash_attention.py (rows of PERF.md's kernel
// table):
//   - row 11, _window_batched_kernel (:1708), whose plan (:1680) has no
//     head-dim term, through window_attention.cu's
//     window_batched_mma_chunked_kernel (dh above 64): window_run_chunked_mma;
//   - row 10, _window_pack_bwd_kernel (:1466), the backward row 11 shares
//     (the JAX package takes the jnp VJP of _window_pack_ref at these dh,
//     :1779-1800), through window_attention_bwd.cu's
//     window_bwd_mma_chunked_kernel (dh above 64): window_bwd_chunked_mma.
// Up to 64 both take window_mma_tile.cuh's tiles (16, 32, 64) with the
// columns past dh zero.
//
// What bounds them on the H100: bytes, as at every window shape
// (window_attention.cu): at N 49 a window's products are 4·N²·dh flops
// against 8·N·dh bytes of q, k, v and out, 25 flops a byte in the forward,
// far below the card's 295.
//
// Design. A window's scores (N <= 128 keys) still fit one warp's
// accumulators however wide the head dim, so the softmax stays one pass, as
// in window_mma_tile.cuh: only the operands stream.
//   - Forward: S = Q·Kᵀ accumulates over the chunks of Q and K, each pair
//     staged in shared memory (row stride 64 + 8), the warp's 16 query rows
//     against all NK keys; then p = softmax(S) in registers, rounded to bf16
//     as P·V's A fragments (NK / 16 × 4 registers), and each 64-column chunk
//     of V staged in turn and multiplied, its 64 output columns stored.
//     Nothing is recomputed: q, k and v are read once each. A block belongs
//     to one head and walks a run of windows (window_run_launch's plan), the
//     shared bias staged once per block as bf16 (the point of row 11), a
//     per-window bias staged per window; each window slot meets at its own
//     named barrier, as in window_run_mma.
//   - Backward: S = Q·Kᵀ and dP = dO·Vᵀ accumulate over the chunks of Q, K,
//     dO and V together; window_bwd_ds gives δ and ds and stages bf16(p),
//     bf16(ds·scale) and bf16(ds) as shared NK × NK tiles (as
//     window_bwd_rows_mma); then, over the chunks of K, Q and dO again, dq =
//     bf16(ds·scale)·K from registers and, warp t owning key tile t, dk =
//     bf16(ds·scale)ᵀ·Q and dv = bf16(p)ᵀ·dO from the tiles read transposed
//     (as window_bwd_keys_mma). K, Q and dO are read twice (the second time
//     from L2), v once.
// Copies go by the grain of the head dim (window_stage_cols: 16 bytes for dh
// a multiple of 8, 8, 4 or 2 for others), a chunk's columns past dh read as
// zeros and never stored. Every output element has one owner and every sum
// a fixed order: no atomics, reruns bit-equal. Numerics are
// window_mma_tile.cuh's.
#pragma once

#include "window_mma_tile.cuh"

namespace vtt {
namespace mma {

constexpr int kChunkCols = 64;  // columns of a head-dim chunk

// bf16 elements of a forward window slot: the chunk tiles A (Q, then V) and
// B (K), then with a per-window bias its tile (row stride NK + 8).
template <int NK>
__host__ __device__ constexpr int window_chunk_slot_elems(bool own_bias) {
  return 2 * NK * (kChunkCols + 8) + (own_bias ? NK * (NK + 8) : 0);
}

// bf16 elements of a forward block's shared memory: the shared bias tile
// (nW' = 1), then wpb slots.
template <int NK>
__host__ __device__ constexpr int window_chunk_elems(int wpb, bool shared_bias,
                                                     bool own_bias) {
  return (shared_bias ? NK * (NK + 8) : 0) +
         wpb * window_chunk_slot_elems<NK>(own_bias);
}

// bf16 elements of a backward window slot: the chunk tiles of Q, K, V and
// dO, then bf16(p), bf16(ds·scale) and the bias, overwritten by bf16(ds).
template <int NK>
__host__ __device__ constexpr int window_bwd_chunked_elems() {
  return 4 * NK * (kChunkCols + 8) + 3 * NK * (NK + 8);
}

// Windows of head blockIdx.y of the partitioned (G, N, 3·H·dh) qkv, `run`
// steps of wpb windows from window `first` on (window slot w takes
// first + w, first + w + wpb, ...), those below `end`: out (G, N, H·dh) =
// softmax(q·kᵀ·scale + bias)·v for each. bias: null or (nW', H, N, N)
// bf16, window g reading row g mod nW'.
template <int NK>
__device__ __forceinline__ void window_run_chunked_mma(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
    bf16* __restrict__ out, long long first, long long end, int n, int heads,
    int dh, int bias_windows, float scale, int mt, int wpb, int run) {
  constexpr int C = kChunkCols, S = C + 8, SB = NK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp / mt, t = warp % mt;  // window slot, query tile
  const int tid = t * 32 + lane, count = mt * 32;
  const int tq = lane & 3, r0 = t * 16 + (lane >> 2);
  const int h = blockIdx.y;
  const long long sec = static_cast<long long>(heads) * dh;
  const bool shared_bias = bias != nullptr && bias_windows == 1;
  const bool own_bias = bias != nullptr && bias_windows > 1;
  bf16* sb = reinterpret_cast<bf16*>(smem_raw);  // the shared bias tile
  bf16* as = sb + (shared_bias ? NK * SB : 0) +
             w * window_chunk_slot_elems<NK>(own_bias);
  bf16* bs = as + NK * S;
  bf16* ob = bs + NK * S;  // the window's own bias tile
  const bf16* tile_bias = shared_bias ? sb : own_bias ? ob : nullptr;
  const RowStride rows{3 * sec};

  if (shared_bias)  // once, by every warp of the block
    window_stage_bias<NK>(sb, bias + static_cast<long long>(h) * n * n, n,
                          warp, mt * wpb, lane);
  __syncthreads();
  for (int s = 0; s < run; ++s) {
    const long long gw = first + w + static_cast<long long>(s) * wpb;
    if (gw >= end) break;  // the same for every warp of the slot
    const bf16* src = qkv + gw * n * 3 * sec + h * dh;  // q of token 0
    // every warp of the slot is past the last window's softmax, the one
    // reader of ob; the first chunk's barrier publishes these stores
    if (own_bias)
      window_stage_bias<NK>(
          ob, bias + ((gw % bias_windows) * heads + h) * n * n, n, t, mt,
          lane);
    float sc[NK / 8][4];
#pragma unroll
    for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n8][e] = 0.f;
    for (int c0 = 0; c0 < dh; c0 += C) {
      window_sync(w, count);  // the slot's warps have read its tiles
      window_stage_cols<C, NK>(as, src, n, rows, c0, dh, tid, count);
      window_stage_cols<C, NK>(bs, src + sec, n, rows, c0, dh, tid, count);
      cp_async_commit();
      cp_async_wait<0>();
      window_sync(w, count);
      uint32_t qf[C / 16][4];
      load_a_smem<C>(qf, as + t * 16 * S, lane);
      mma_abt<C, NK / 8>(sc, qf, bs, lane);
    }
    window_probs<NK>(sc, tile_bias, r0, n, tq, scale);
    uint32_t pa[NK / 16][4];
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      acc_to_a(pa[kk], sc[2 * kk], sc[2 * kk + 1]);  // p rounded to bf16
    bf16* o = out + gw * n * sec + h * dh;
    for (int c0 = 0; c0 < dh; c0 += C) {
      window_sync(w, count);
      window_stage_cols<C, NK>(as, src + 2 * sec, n, rows, c0, dh, tid,
                               count);
      cp_async_commit();
      cp_async_wait<0>();
      window_sync(w, count);
      float acc[C / 8][4];
#pragma unroll
      for (int n8 = 0; n8 < C / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n8][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
        mma_ab<C>(acc, pa[kk], as + kk * 16 * S, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        if (r >= n) continue;
#pragma unroll
        for (int n8 = 0; n8 < C / 8; ++n8)
          window_store_cols(o + r * sec + c0, n8 * 8 + 2 * tq, dh - c0,
                            acc[n8][2 * i], acc[n8][2 * i + 1]);
      }
    }
  }
}

// The backward of window gw, head blockIdx.y, by the mt warps of window
// slot w (warp t: query tile t, then key tile t): dqkv (G, N, 3·H·dh) in the
// places of q, k, v and, where ds_out is not null, bf16(ds) (G, H, N, N),
// from qkv, bias (null or (nW', H, N, N) bf16) and dout (G, N, H·dh).
template <int NK>
__device__ __forceinline__ void window_bwd_chunked_mma(
    const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
    const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
    bf16* __restrict__ ds_out, long long gw, int n, int heads, int dh,
    int bias_windows, float scale, int w, int t, int mt, int lane) {
  constexpr int C = kChunkCols, S = C + 8, SB = NK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = t * 32 + lane, count = mt * 32;
  const int tq = lane & 3, r0 = t * 16 + (lane >> 2);
  const int h = blockIdx.y;
  const long long sec = static_cast<long long>(heads) * dh;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw) +
             w * window_bwd_chunked_elems<NK>();
  bf16* ks = qs + NK * S;
  bf16* vs = ks + NK * S;
  bf16* dos = vs + NK * S;
  bf16* pt = dos + NK * S;  // bf16(p)
  bf16* dt = pt + NK * SB;  // bf16(ds·scale)
  bf16* xt = dt + NK * SB;  // the bias, then bf16(ds)
  const long long row0 = gw * n;  // token 0 of the window
  const bf16* src = qkv + row0 * 3 * sec + h * dh;
  const bf16* dsrc = dout + row0 * sec + h * dh;
  const RowStride rows{3 * sec}, drows{sec};

  // published by the first chunk's barrier
  if (bias != nullptr)
    window_stage_bias<NK>(xt, bias + ((gw % bias_windows) * heads + h) * n * n,
                          n, t, mt, lane);
  float p[NK / 8][4], dp[NK / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[n8][e] = dp[n8][e] = 0.f;
  for (int c0 = 0; c0 < dh; c0 += C) {
    if (c0 > 0) window_sync(w, count);  // the slot's warps have read them
    window_stage_cols<C, NK>(qs, src, n, rows, c0, dh, tid, count);
    window_stage_cols<C, NK>(ks, src + sec, n, rows, c0, dh, tid, count);
    window_stage_cols<C, NK>(vs, src + 2 * sec, n, rows, c0, dh, tid, count);
    window_stage_cols<C, NK>(dos, dsrc, n, drows, c0, dh, tid, count);
    cp_async_commit();
    cp_async_wait<0>();
    window_sync(w, count);
    uint32_t f[C / 16][4];
    load_a_smem<C>(f, qs + t * 16 * S, lane);
    mma_abt<C, NK / 8>(p, f, ks, lane);
    load_a_smem<C>(f, dos + t * 16 * S, lane);
    mma_abt<C, NK / 8>(dp, f, vs, lane);
  }
  window_probs<NK>(p, bias == nullptr ? nullptr : xt, r0, n, tq, scale);
  window_bwd_ds<NK>(p, dp, ds_out == nullptr ? nullptr : xt, pt, dt, r0, n,
                    tq, scale);
  uint32_t da[NK / 16][4];  // bf16(ds·scale), the bits dt holds
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
    acc_to_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
  // every query tile's p and ds is staged, every chunk tile read
  window_sync(w, count);

  if (ds_out != nullptr) {  // rows of N, consecutive lanes on consecutive
    bf16* d = ds_out + (gw * heads + h) * n * n;  // elements
    for (int r = t; r < n; r += mt)
      for (int c = lane; c < n; c += 32) d[r * n + c] = xt[r * SB + c];
  }
  bf16* dq = dqkv + row0 * 3 * sec + h * dh;
  const int j0 = t * 16 + (lane >> 2);  // this warp's key rows
  for (int c0 = 0; c0 < dh; c0 += C) {
    if (c0 > 0) window_sync(w, count);
    window_stage_cols<C, NK>(qs, src, n, rows, c0, dh, tid, count);
    window_stage_cols<C, NK>(ks, src + sec, n, rows, c0, dh, tid, count);
    window_stage_cols<C, NK>(dos, dsrc, n, drows, c0, dh, tid, count);
    cp_async_commit();
    cp_async_wait<0>();
    window_sync(w, count);
    float acc[C / 8][4];
#pragma unroll
    for (int n8 = 0; n8 < C / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n8][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      mma_ab<C>(acc, da[kk], ks + kk * 16 * S, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= n) continue;
#pragma unroll
      for (int n8 = 0; n8 < C / 8; ++n8)
        window_store_cols(dq + r * 3 * sec + c0, n8 * 8 + 2 * tq, dh - c0,
                          acc[n8][2 * i], acc[n8][2 * i + 1]);
    }
    float ak[C / 8][4], av[C / 8][4];
#pragma unroll
    for (int n8 = 0; n8 < C / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) ak[n8][e] = av[n8][e] = 0.f;
    for (int kk = 0; kk < mt; ++kk) {
      uint32_t a[4];
      load_at_smem<NK>(a, dt, kk * 16, t * 16, lane);
      mma_ab<C>(ak, a, qs + kk * 16 * S, lane);
      load_at_smem<NK>(a, pt, kk * 16, t * 16, lane);
      mma_ab<C>(av, a, dos + kk * 16 * S, lane);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = j0 + 8 * i;
      if (j >= n) continue;
#pragma unroll
      for (int n8 = 0; n8 < C / 8; ++n8) {
        window_store_cols(dq + j * 3 * sec + sec + c0, n8 * 8 + 2 * tq,
                          dh - c0, ak[n8][2 * i], ak[n8][2 * i + 1]);
        window_store_cols(dq + j * 3 * sec + 2 * sec + c0, n8 * 8 + 2 * tq,
                          dh - c0, av[n8][2 * i], av[n8][2 * i + 1]);
      }
    }
  }
}

}  // namespace mma
}  // namespace vtt
