// Shared body of the CUDA-core attention forward kernels of PERF.md's rows 1
// (packed_attention.cu), 2 (flash_attention.cu) and 5 (dropout_attention.cu's
// forward) for fp32 inputs, and of row 8's CUDA-core route (fused_block.cu,
// fp32 and bf16 with mixed weight layouts); row 3's fp32 kernel
// (flash_attention_large.cu) uses its constants and helpers. In bf16, rows 1,
// 2, 3 and 5 run on the tensor cores (attention_mma_tile.cuh). One thread block computes
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
// row 2's shape); attention_mma_tile.cuh is the tensor-core redesign.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <mutex>
#include <utility>
#include <vector>

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

// Load policies for the operands a kernel may have written itself, earlier in
// the same launch (fused_block.cu's workspaces, across a grid barrier).
// PlainLoads, the default, reads them as every other operand: through a
// const __restrict__ pointer nvcc may take the non-coherent path
// (ld.global.nc), which PTX allows only for data the launch never writes.
// L2Loads reads them with __ldcg (ld.global.cg), through L2, which holds
// what the other blocks wrote before the barrier.
struct PlainLoads {
  static constexpr bool kThroughL2 = false;
};
struct L2Loads {
  static constexpr bool kThroughL2 = true;
};

// The launch's dynamic shared memory. The D 128 tiles of rows 2, 5 and 6 take
// their large buffers from it: they need more than the 48 KB a block may
// declare statically.
__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(16) unsigned char vtt_dyn_smem[];
  return vtt_dyn_smem;
}

// A shared array of type A: the static one `st` when it has A's size, else
// (D 128: `st` declared with one element) A's bytes at `off` of the dynamic
// shared memory.
template <class A, class St>
__device__ __forceinline__ A& smem_array(St& st, unsigned off) {
  if constexpr (sizeof(St) == sizeof(A))
    return reinterpret_cast<A&>(st);
  else
    return *reinterpret_cast<A*>(dyn_smem() + off);
}

// Lets `kernel` take `bytes` of dynamic shared memory, past the 48 KB a
// launch gets without asking; set once per kernel and device (0 bytes:
// nothing to set). Returns 0 or the cudaError_t.
inline int allow_dynamic_smem(const void* kernel, int bytes) {
  if (bytes <= 0) return 0;
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;  // (kernel, device)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& kd : done)
    if (kd.first == kernel && kd.second == dev) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.emplace_back(kernel, dev);
  return static_cast<int>(err);
}

template <class Kernel>
int allow_dynamic_smem(Kernel* kernel, int bytes) {
  return allow_dynamic_smem(reinterpret_cast<const void*>(kernel), bytes);
}

// The fp32 forward's shared bytes taken from the dynamic memory at D 128:
// q, k and v of one tile.
template <int D>
__host__ __device__ constexpr int attend_dyn_bytes() {
  return D > 64 ? 4 * (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D) : 0;
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
// group's index b·H + h for the dropout mask. Loads: how q, k and v are read
// (PlainLoads, or L2Loads where the launch wrote them). kPad (rows 2 and 5,
// and row 8's CUDA-core route, at a head dim dc below the tile's D): columns
// >= dc read as 0 and not written; D 128 takes attend_dyn_bytes<D>() of
// dynamic shared memory.
template <typename T, int D, class Loads = PlainLoads, bool kPad = false>
__device__ __forceinline__ void attend_rows(
    int q0, const T* __restrict__ q, long long q_rs,
    const T* __restrict__ k, const T* __restrict__ v, long long kv_rs,
    const float* __restrict__ bias, long long bias_rs,
    const float* __restrict__ kmask,
    T* __restrict__ o, long long o_rs,
    float* __restrict__ lse, long long lse_rs,
    int sq, int sk, int kv_valid, float scale, Dropout drop,
    uint32_t rng_group, int dc = D) {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "head dim must be 16, 32, 64 or 128");
  constexpr bool kDyn = D > 64;
  __shared__ float qs_st[kDyn ? 1 : kBlockQ][kDyn ? 1 : D];
  __shared__ float ks_st[kDyn ? 1 : kBlockK][kDyn ? 1 : D + 1];
  __shared__ float vs_st[kDyn ? 1 : kBlockK][kDyn ? 1 : D];
  // +1 in ks: lane-strided reads hit 32 banks
  float (&qs)[kBlockQ][D] = smem_array<float[kBlockQ][D]>(qs_st, 0);
  float (&ks)[kBlockK][D + 1] =
      smem_array<float[kBlockK][D + 1]>(ks_st, 4 * kBlockQ * D);
  float (&vs)[kBlockK][D] = smem_array<float[kBlockK][D]>(
      vs_st, 4 * (kBlockQ * D + kBlockK * (D + 1)));
  __shared__ float ps[kBlockQ][kBlockK + 1];
  __shared__ float alpha_s[kBlockQ];
  __shared__ float l_s[kBlockQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, qi = q0 + r;
    if constexpr (Loads::kThroughL2 && kPad)
      qs[r][c] = qi < sq && c < dc ? to_f32(__ldcg(q + qi * q_rs + c)) : 0.f;
    else if constexpr (Loads::kThroughL2)
      qs[r][c] = qi < sq ? to_f32(__ldcg(q + qi * q_rs + c)) : 0.f;
    else if constexpr (kPad)
      qs[r][c] = qi < sq && c < dc ? to_f32(q[qi * q_rs + c]) : 0.f;
    else
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
      if constexpr (Loads::kThroughL2 && kPad) {
        ks[r][c] = in && c < dc ? to_f32(__ldcg(k + kj * kv_rs + c)) : 0.f;
        vs[r][c] = in && c < dc ? to_f32(__ldcg(v + kj * kv_rs + c)) : 0.f;
      } else if constexpr (Loads::kThroughL2) {
        ks[r][c] = in ? to_f32(__ldcg(k + kj * kv_rs + c)) : 0.f;
        vs[r][c] = in ? to_f32(__ldcg(v + kj * kv_rs + c)) : 0.f;
      } else if constexpr (kPad) {
        ks[r][c] = in && c < dc ? to_f32(k[kj * kv_rs + c]) : 0.f;
        vs[r][c] = in && c < dc ? to_f32(v[kj * kv_rs + c]) : 0.f;
      } else {
        ks[r][c] = in ? to_f32(k[kj * kv_rs + c]) : 0.f;
        vs[r][c] = in ? to_f32(v[kj * kv_rs + c]) : 0.f;
      }
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
    if (qi < sq && (!kPad || od < dc))
      o[qi * o_rs + od] = from_f32<T>(acc[i] / l_s[row]);
  }
}

}  // namespace vtt
