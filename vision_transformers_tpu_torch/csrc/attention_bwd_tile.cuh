// Shared bodies of the CUDA-core attention backward kernels: row 7
// (packed_attention.cu) and row 6 (dropout_attention.cu) for fp32 inputs;
// bf16 row 6 runs on the tensor cores (attention_bwd_mma_tile.cuh), which
// row 7 is to take next. From (q, k, v, do, out, lse) of one (batch, head)
// group they recompute the probabilities and give dq, dk, dv; the S×S scores
// never reach device memory.
//
//   s  = q·kᵀ·scale, keys >= kv_valid set to -0.7·FLT_MAX, + key mask
//   p  = exp(s − lse)                      (the undropped softmax)
//   δ  = rowsum(do ⊙ out)                  (fp32)
//   dp = do·vᵀ
//   dropout replay: pd = keep ⊙ p/(1−r), dp ← keep ⊙ dp/(1−r)   (philox.cuh)
//   dv = pdᵀ·do,  ds = p ⊙ (dp − δ)·scale,  dq = ds·k,  dk = dsᵀ·q
//
// (the TPU kernels' formulas, flash_attention.py:555-583 and :858-887).
//
// dk and dv sum over every query row and dq over every key. The TPU keeps
// dk/dv in a resident fp32 block across a sequential grid axis; blocks on
// this card run in no order, so the work is split into two passes that each
// own their outputs and sum in a fixed order — no float atomics, and
// gradients that are bit-equal from run to run:
//
//   bwd_dq_rows:  one block per (group, tile of kBlockQ query rows), loops
//                 over key tiles; also computes δ for its rows and stores it
//                 to a scratch vector for the second pass.
//   bwd_dkv_rows: one block per (group, tile of kBlockK keys), loops over
//                 query tiles, reads δ; launched after the first pass on the
//                 same stream.
//
// Both recompute s and dp, so the pair does 7 tile products where the
// mathematics needs 5. Query rows past Sq and keys past Sk (ragged last
// tiles) are bounds-checked: their probabilities are exactly 0 and nothing is
// written for them. Every row < Sq of dq and every row < Sk of dk and dv is
// written, keys >= kv_valid with zeros (their p is exp(-0.7·FLT_MAX − lse) = 0).
//
// Design as the forward: fp32 FMAs on the CUDA cores, operands staged in
// shared memory as fp32, accumulators in fp32 registers, one cast at the
// store; pd and ds stay fp32 (the plain versions and the TPU kernels round
// them to the input dtype). Warp w owns rows w, w+4, ... of the block's own
// tile and lane j owns row j of the streamed tile. What bounds it on the
// H100 is the products on the CUDA cores, and the Philox call per element.
#pragma once

#include "attention_tile.cuh"

namespace vtt {

// The shared bytes the fp32 backward passes take from the dynamic memory at
// D 128: q, do, k and v of one tile (bwd_dkv_rows stages the same four).
template <int D>
__host__ __device__ constexpr int bwd_dyn_bytes() {
  return D > 64 ? 4 * (2 * kBlockQ * D + 2 * kBlockK * (D + 1)) : 0;
}

// Pointers are the group's row 0; *_rs are row strides in elements. dout and
// out share o_rs. delta is this group's fp32 scratch vector (Sq values).
// kPad (row 6 at a head dim dc below the tile's D): columns >= dc read as 0
// and not written; D 128 takes bwd_dyn_bytes<D>() of dynamic shared memory.
template <typename T, int D, bool kPad = false>
__device__ __forceinline__ void bwd_dq_rows(
    const T* __restrict__ q, long long q_rs,
    const T* __restrict__ k, const T* __restrict__ v, long long kv_rs,
    const T* __restrict__ dout, const T* __restrict__ out, long long o_rs,
    const float* __restrict__ lse, long long lse_rs,
    const float* __restrict__ kmask,
    T* __restrict__ dq, long long dq_rs, float* __restrict__ delta,
    int sq, int sk, int kv_valid, float scale, Dropout drop,
    uint32_t rng_group, int dc = D) {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "head dim must be 16, 32, 64 or 128");
  constexpr bool kDyn = D > 64;
  __shared__ float qs_st[kDyn ? 1 : kBlockQ][kDyn ? 1 : D];
  __shared__ float dos_st[kDyn ? 1 : kBlockQ][kDyn ? 1 : D];
  __shared__ float ks_st[kDyn ? 1 : kBlockK][kDyn ? 1 : D + 1];
  __shared__ float vs_st[kDyn ? 1 : kBlockK][kDyn ? 1 : D + 1];
  // +1 in ks, vs: lane-strided reads hit 32 banks
  float (&qs)[kBlockQ][D] = smem_array<float[kBlockQ][D]>(qs_st, 0);
  float (&dos)[kBlockQ][D] =
      smem_array<float[kBlockQ][D]>(dos_st, 4 * kBlockQ * D);
  float (&ks)[kBlockK][D + 1] =
      smem_array<float[kBlockK][D + 1]>(ks_st, 8 * kBlockQ * D);
  float (&vs)[kBlockK][D + 1] = smem_array<float[kBlockK][D + 1]>(
      vs_st, 4 * (2 * kBlockQ * D + kBlockK * (D + 1)));
  __shared__ float dss[kBlockQ][kBlockK + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.y * kBlockQ;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, qi = q0 + r;
    const bool in = qi < sq && (!kPad || c < dc);
    qs[r][c] = in ? to_f32(q[qi * q_rs + c]) : 0.f;
    dos[r][c] = in ? to_f32(dout[qi * o_rs + c]) : 0.f;
  }
  __syncthreads();

  // per-row constants of rows warp + kWarps·r, replicated across the lanes
  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp + kWarps * r;
    const int qi = q0 + row;
    float part = 0.f;
    if (qi < sq)
      for (int c = lane; c < (kPad ? dc : D); c += 32)
        part = fmaf(dos[row][c], to_f32(out[qi * o_rs + c]), part);
    delta_r[r] = warp_sum(part);
    lse_r[r] = qi < sq ? lse[qi * lse_rs] : 0.f;
    if (lane == 0 && qi < sq) delta[qi] = delta_r[r];
  }

  constexpr int kOutStride = kThreads / D;
  constexpr int kOutRows = kBlockQ / kOutStride;
  const int od = tid % D;
  const int orow = tid / D;
  float acc[kOutRows];
#pragma unroll
  for (int i = 0; i < kOutRows; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, kj = k0 + r;
      const bool in = kj < sk && (!kPad || c < dc);
      ks[r][c] = in ? to_f32(k[kj * kv_rs + c]) : 0.f;
      vs[r][c] = in ? to_f32(v[kj * kv_rs + c]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float kc = ks[lane][c], vc = vs[lane][c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = fmaf(qs[warp + kWarps * r][c], kc, s[r]);
        dp[r] = fmaf(dos[warp + kWarps * r][c], vc, dp[r]);
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
        dpv = dropout_keep(drop, rng_group, qi, kj) ? dpv * drop.inv_keep : 0.f;
      dss[row][lane] = p * (dpv - delta_r[r]) * scale;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kOutRows; ++i) {
      const int row = orow + kOutStride * i;
      float a = acc[i];
#pragma unroll 8
      for (int j = 0; j < kBlockK; ++j) a = fmaf(dss[row][j], ks[j][od], a);
      acc[i] = a;
    }
  }

#pragma unroll
  for (int i = 0; i < kOutRows; ++i) {
    const int qi = q0 + orow + kOutStride * i;
    if (qi < sq && (!kPad || od < dc)) dq[qi * dq_rs + od] = from_f32<T>(acc[i]);
  }
}

// Keys [blockIdx.y·kBlockK, +kBlockK) of one group. delta holds δ of every
// query row of the group (written by bwd_dq_rows). dk and dv share dkv_rs.
// kPad, dc and D 128 as bwd_dq_rows.
template <typename T, int D, bool kPad = false>
__device__ __forceinline__ void bwd_dkv_rows(
    const T* __restrict__ q, long long q_rs,
    const T* __restrict__ k, const T* __restrict__ v, long long kv_rs,
    const T* __restrict__ dout, long long o_rs,
    const float* __restrict__ lse, long long lse_rs,
    const float* __restrict__ delta, const float* __restrict__ kmask,
    T* __restrict__ dk, T* __restrict__ dv, long long dkv_rs,
    int sq, int sk, int kv_valid, float scale, Dropout drop,
    uint32_t rng_group, int dc = D) {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "head dim must be 16, 32, 64 or 128");
  constexpr bool kDyn = D > 64;
  __shared__ float ks_st[kDyn ? 1 : kBlockK][kDyn ? 1 : D];
  __shared__ float vs_st[kDyn ? 1 : kBlockK][kDyn ? 1 : D];
  __shared__ float qs_st[kDyn ? 1 : kBlockQ][kDyn ? 1 : D + 1];
  __shared__ float dos_st[kDyn ? 1 : kBlockQ][kDyn ? 1 : D + 1];
  // ks, vs: this block's keys, resident; qs, dos: streamed, lane-strided
  // reads
  float (&ks)[kBlockK][D] = smem_array<float[kBlockK][D]>(ks_st, 0);
  float (&vs)[kBlockK][D] =
      smem_array<float[kBlockK][D]>(vs_st, 4 * kBlockK * D);
  float (&qs)[kBlockQ][D + 1] =
      smem_array<float[kBlockQ][D + 1]>(qs_st, 8 * kBlockK * D);
  float (&dos)[kBlockQ][D + 1] = smem_array<float[kBlockQ][D + 1]>(
      dos_st, 4 * (2 * kBlockK * D + kBlockQ * (D + 1)));
  __shared__ float pds[kBlockK][kBlockQ + 1];  // [key][query row]
  __shared__ float dss[kBlockK][kBlockQ + 1];
  __shared__ float lse_s[kBlockQ];
  __shared__ float delta_s[kBlockQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = blockIdx.y * kBlockK;

  for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, kj = k0 + r;
    const bool in = kj < sk && (!kPad || c < dc);
    ks[r][c] = in ? to_f32(k[kj * kv_rs + c]) : 0.f;
    vs[r][c] = in ? to_f32(v[kj * kv_rs + c]) : 0.f;
  }

  // per-key constants of keys warp + kWarps·r (the same for every lane)
  float madd[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int kj = k0 + warp + kWarps * r;
    madd[r] = (kmask != nullptr && kj < sk) ? kmask[kj] : 0.f;
  }

  constexpr int kOutStride = kThreads / D;
  constexpr int kOutRows = kBlockK / kOutStride;
  const int od = tid % D;
  const int orow = tid / D;
  float acc_k[kOutRows], acc_v[kOutRows];
#pragma unroll
  for (int i = 0; i < kOutRows; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += kBlockQ) {
    __syncthreads();  // the previous tile's readers are done (ks/vs loaded)
    for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, qi = q0 + r;
      const bool in = qi < sq && (!kPad || c < dc);
      qs[r][c] = in ? to_f32(q[qi * q_rs + c]) : 0.f;
      dos[r][c] = in ? to_f32(dout[qi * o_rs + c]) : 0.f;
    }
    if (tid < kBlockQ) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < sq ? lse[qi * lse_rs] : 0.f;
      delta_s[tid] = qi < sq ? delta[qi] : 0.f;
    }
    __syncthreads();

    // transposed scores: key warp + kWarps·r against query row `lane`
    float st[kRowsPerWarp], dpt[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) st[r] = dpt[r] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float qc = qs[lane][c], dc = dos[lane][c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        st[r] = fmaf(ks[warp + kWarps * r][c], qc, st[r]);
        dpt[r] = fmaf(vs[warp + kWarps * r][c], dc, dpt[r]);
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
      dss[key][lane] = p * (dpv - delta_i) * scale;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kOutRows; ++i) {
      const int key = orow + kOutStride * i;
      float ak = acc_k[i], av = acc_v[i];
#pragma unroll 8
      for (int j = 0; j < kBlockQ; ++j) {
        av = fmaf(pds[key][j], dos[j][od], av);
        ak = fmaf(dss[key][j], qs[j][od], ak);
      }
      acc_k[i] = ak;
      acc_v[i] = av;
    }
  }

#pragma unroll
  for (int i = 0; i < kOutRows; ++i) {
    const int kj = k0 + orow + kOutStride * i;
    if (kj < sk && (!kPad || od < dc)) {
      dk[kj * dkv_rs + od] = from_f32<T>(acc_k[i]);
      dv[kj * dkv_rs + od] = from_f32<T>(acc_v[i]);
    }
  }
}

}  // namespace vtt
