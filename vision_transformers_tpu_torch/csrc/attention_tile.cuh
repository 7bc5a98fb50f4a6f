// Shared body of the CUDA-core attention forward kernels of PERF.md's rows 1
// (packed_attention.cu), 5 (dropout_attention.cu's forward) and 8
// (fused_block.cu), and of row 2 (flash_attention.cu) for fp32 inputs; row 3
// (flash_attention_large.cu) uses its constants and helpers. bf16 row 2 runs
// on the tensor cores (attention_mma_tile.cuh). One thread block computes
// dropout(softmax(q·kᵀ·scale + bias + key mask))·v for a tile of kBlockQ query
// rows of one (batch, head) group, streaming the keys in tiles of kBlockK
// with an online softmax.
//
// The caller hands in base pointers and row strides for this group, so the
// same body reads q/k/v in place out of the packed (B, S, 3·H·dh) projection
// (row stride 3·H·dh) or out of contiguous (G, S, D) tensors (row stride D).
//
// Numerics follow the TPU kernels: fp32 scores, bias added after the scale,
// keys >= kv_valid set to DEFAULT_MASK_VALUE = -0.7·FLT_MAX (the TPU kernels'
// finite mask), then the additive key mask (0 or DEFAULT_MASK_VALUE per key),
// fp32 row max / sum, output divided by the row sum after the PV product,
// lse = m + log(l). Keys past the end of the sequence (the ragged last tile)
// get probability exactly 0.
//
// Dropout (philox.cuh) zeroes unnormalised probabilities and scales the kept
// ones by 1/(1 − rate) on their way into the PV product only: the running
// sum that normalises the output, and lse, are of the undropped softmax, as
// in the TPU kernels (flash_attention.py:815-830).
//
// Overflow: the running max m is taken over the tile's scores before any
// exp, so every exp argument s - m is <= 0. Key 0 is always valid
// (kv_valid >= 1, checked by the wrapper), so m is finite from the first tile
// on and a tile whose keys are all masked gives exp(-0.7·FLT_MAX - m) = 0,
// never inf or NaN. The first tile's correction factor is exp(-inf) = 0. A key
// hidden by both kv_valid and the key mask scores 2·(-0.7·FLT_MAX) = -inf,
// and exp(-inf - m) = 0 as well; key 0 is never such a key.
//
// Design: plain fp32 FMAs on CUDA cores, operands staged in shared memory as
// fp32. Warp w owns query rows w, w+4, ...; lane j owns key j of the tile, so
// a warp computes its rows' scores and their softmax statistics with warp
// shuffles and no block barrier in between. What bounds it on the H100 is
// the products on the CUDA cores (about 1% of the bf16 tensor-core peak at
// row 2's shape); attention_mma_tile.cuh is the tensor-core redesign, which
// rows 5 and 3 are to take next.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "philox.cuh"

namespace vtt {

constexpr int kThreads = 128;          // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 32;            // query rows per block
constexpr int kBlockK = 32;            // keys per tile = one key per lane
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr float kMaskValue = -0.7f * 3.40282346638528859812e+38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [q0, q0 + kBlockQ) of one group. Pointers are the group's row 0;
// *_rs are row strides in elements. bias (fp32, row stride bias_rs) may be
// null; kmask (fp32, one value per key) may be null. lse is fp32 with row
// stride lse_rs, or null when the caller does not need it. rng_group is the
// group's index b·H + h for the dropout mask.
template <typename T, int D>
__device__ __forceinline__ void attend_rows(
    int q0, const T* __restrict__ q, long long q_rs,
    const T* __restrict__ k, const T* __restrict__ v, long long kv_rs,
    const float* __restrict__ bias, long long bias_rs,
    const float* __restrict__ kmask,
    T* __restrict__ o, long long o_rs,
    float* __restrict__ lse, long long lse_rs,
    int sq, int sk, int kv_valid, float scale, Dropout drop,
    uint32_t rng_group) {
  static_assert(D == 16 || D == 32 || D == 64, "head dim must be 16, 32 or 64");
  __shared__ float qs[kBlockQ][D];
  __shared__ float ks[kBlockK][D + 1];  // +1: lane-strided reads hit 32 banks
  __shared__ float vs[kBlockK][D];
  __shared__ float ps[kBlockQ][kBlockK + 1];
  __shared__ float alpha_s[kBlockQ];
  __shared__ float l_s[kBlockQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, qi = q0 + r;
    qs[r][c] = qi < sq ? to_f32(q[qi * q_rs + c]) : 0.f;
  }

  // softmax state of rows warp + kWarps·r, replicated across the warp's lanes
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -CUDART_INF_F;
    l_run[r] = 0.f;
  }

  // output accumulator: column od of rows orow + kOutStride·i
  constexpr int kOutStride = kThreads / D;
  constexpr int kOutRows = kBlockQ / kOutStride;
  const int od = tid % D;
  const int orow = tid / D;
  float acc[kOutRows];
#pragma unroll
  for (int i = 0; i < kOutRows; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done (and qs is loaded)
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, kj = k0 + r;
      const bool in = kj < sk;
      ks[r][c] = in ? to_f32(k[kj * kv_rs + c]) : 0.f;
      vs[r][c] = in ? to_f32(v[kj * kv_rs + c]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 16
    for (int c = 0; c < D; ++c) {
      const float kc = ks[lane][c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(qs[warp + kWarps * r][c], kc, s[r]);
    }

    const int kj = k0 + lane;
    const bool key_in = kj < sk;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      const int qi = q0 + row;
      float x = s[r] * scale;
      if (bias != nullptr && key_in && qi < sq) x += bias[qi * bias_rs + kj];
      if (kj >= kv_valid) x = kMaskValue;
      if (kmask != nullptr && key_in) x += kmask[kj];
      const float m_new = fmaxf(m_run[r], warp_max(key_in ? x : -CUDART_INF_F));
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
      for (int j = 0; j < kBlockK; ++j) a = fmaf(ps[row][j], vs[j][od], a);
      acc[i] = a;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      const int qi = q0 + row;
      l_s[row] = l_run[r];
      if (qi < sq && lse != nullptr)
        lse[qi * lse_rs] = m_run[r] + logf(l_run[r]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kOutRows; ++i) {
    const int row = orow + kOutStride * i;
    const int qi = q0 + row;
    if (qi < sq) o[qi * o_rs + od] = from_f32<T>(acc[i] / l_s[row]);
  }
}

}  // namespace vtt
