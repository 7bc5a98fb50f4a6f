// Backward of bias-free, mask-free split-head attention at small S.
//
// Replaces the TPU kernel vision_transformers_tpu/ops/flash_attention.py::
// _bwd_kernel (:362), launched by _flash_bwd_pallas (:399) and taken by
// _flash_attention_bwd (:2416-2425) under USE_PALLAS_BWD for Sq·Sk < 512²+1:
// the DETR decoder's self attention (100 × 100) in a train step at dropout 0,
// or ViT-B/16's split-head attention at S = 197.
//
// q, do, out: (G, Sq, D); k, v: (G, Sk, D); lse: (G, Sq) fp32; contiguous,
// bf16 or fp32. Writes dq (G, Sq, D), dk and dv (G, Sk, D) in the input dtype:
//
//   s  = q·kᵀ·scale, keys >= kv_valid set to -0.7·FLT_MAX
//   p  = exp(s − lse),  δ = rowsum(do ⊙ out) (fp32),  dp = do·vᵀ
//   ds = p ⊙ (dp − δ),  dq = ds·k·scale,  dv = pᵀ·do,  dk = dsᵀ·q·scale
//
// (the TPU kernel's formulas, :373-397). Two routes, by dtype:
//
// bf16: flash_bwd_dq_mma_kernel, then flash_bwd_dkv_mma_kernel, on
// attention_bwd_mma_tile.cuh's two passes <D, Contiguous<D>, false,
// ScaledGrads> (row 6's tiles without dropout code or key mask): every
// product as mma.sync.m16n8k16 (bf16 in, fp32 accumulators). The rounding is
// _bwd_kernel's: ds = p ⊙ (dp − δ) rounded to bf16 unscaled (:384, :395), pᵀ
// rounded before dv (:393), and dq, dk multiplied by the scale in fp32
// before their one rounding (:385, :396). The first pass (grid G × ceil(Sq /
// 64)) writes dq, and δ of its rows to a scratch; the second (grid G ×
// ceil(Sk / 64)) writes dk and dv over every query tile. Unlike row 6 the
// second pass's query loop is not split (dkv_chunks): at the DETR decoder's
// shape, its one path shape, a block walks only two query tiles, so a split
// would buy little parallelism for a third launch and fp32 partials.
// 7 tile products where the mathematics needs 5, no atomics, so two runs
// give equal bits. Each block holds one 64-row tile of Q and dO (or K and V)
// in registers and streams the other operands, so nothing about the group's
// size limits it; the route keeps flash_bwd_smem_bytes's rule all the same,
// as the contract of this entry.
//
// fp32: flash_bwd_kernel, fp32 FMAs on the CUDA cores. One thread block owns
// one group and every output of it, in one launch and without atomics. It
// keeps the group's K and V resident in shared memory as fp32 and works in
// two phases, the TPU kernel's two orientations:
//   1. per tile of 32 query rows: δ and lse of the rows into shared memory,
//      then s and dp against every key tile, ds into a shared tile, and dq of
//      the rows accumulated in registers and written;
//   2. per tile of 32 keys: sᵀ and dpᵀ against every query tile (q and do
//      streamed from device memory, L2-resident at these sizes), pᵀ and dsᵀ
//      into shared tiles, dk and dv of the keys accumulated and written.
// The whole group's K and V must fit the block's shared memory
// (flash_attention.py::flash_bwd_smem_bytes, the same formula as here): the
// route takes this entry only then, as _BWD_SCORE_BUDGET bounds it on the
// TPU; outside it the backward is dropout_attention_bwd at rate 0.
//
// Head dims: D 16, 32, 64 and 128 are instantiations of both routes' kernels
// (the bf16 D 128 passes with their streamed tiles in dynamic shared
// memory). Any other D from 1 to 128 (ViT-H/14's 80, TNT's 12) runs in the
// next tile width, 16, 32, 64 or 128, with the columns past D read as zeros
// and not written: flash_bwd_{dq,dkv}_mma_padded_kernel (bf16, the GroupPad
// layouts; a bf16 operand aligned as align_mask(D) says) and
// flash_bwd_padded_kernel (fp32, rows D + 1 apart in shared memory, so the
// group's footprint is smem_floats(sq, sk, D) exactly). The route's rule,
// flash_attention.py::flash_bwd_smem_bytes, is the fp32 kernel's footprint;
// the bf16 passes take at most 71 KB whatever the shape (the 128 tile's four
// 17 KB tile buffers and the staged lse and δ), under a block's 227 KB, so
// every shape the rule admits runs on both routes. A D above 128 takes
// flash_bwd_{dq,dkv}_mma_wide_kernel (bf16) or flash_bwd_{dq,dkv}_wide_kernel
// (fp32): attention_wide_tile.cuh's two passes under ScaledGrads, D split
// across grid z, at most 27 KB of shared memory a block whatever the shape.
// The rule stays the entry's contract there too, unchanged: at D 256 it
// admits Sq, Sk <= 64, and from D 437 on no shape at all (one 32-row tile
// of K, V, q and do as fp32 already passes 227 KB), so those backwards take
// row 6 at rate 0.
//
// What bounds it on the H100 (ViT-B/16 @224, batch 32: G = 384, S = 197,
// D = 64, bf16): 10·G·S²·D = 9.5 GFLOP, 9.6 µs at 989 TFLOP/s, against
// 8·G·S·D·2 + G·S·4 = 77.8 MB moved, 23 µs at 3.35 TB/s: the bytes. At the
// DETR decoder shape (G = 16, S = 100, D = 32) the card is barely occupied:
// 32 blocks a pass on 132 SMs, each walking 2 tiles, so the launches' fixed
// cost is most of the time.
#include <cstdint>

#include "attention_bwd_mma_tile.cuh"
#include "attention_tile.cuh"
#include "attention_wide_tile.cuh"
#include "launch_log.cuh"

namespace {

using vtt::kBlockK;
using vtt::kBlockQ;
using vtt::kMaskValue;
using vtt::kRowsPerWarp;
using vtt::kThreads;
using vtt::kWarps;

constexpr int kTile = kBlockK + 1;  // row stride of the 32 × 32 score tiles

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// fp32 words of shared memory for one group; keep in step with
// flash_attention.py::flash_bwd_smem_bytes.
__host__ __device__ inline long long smem_floats(int sq, int sk, int d) {
  const long long dp = d + 1;
  return 2LL * round_up(sk, kBlockK) * dp + 2LL * round_up(sq, kBlockQ) +
         2LL * kBlockQ * dp + 2LL * kBlockK * kTile;
}

// One group's dq, dk and dv. kPad: the head dim dc runs in the tile of
// width D (dc <= D): rows dc apart in device memory and dc + 1 in shared
// memory (so smem_floats(sq, sk, dc) holds), columns >= dc never read or
// written, the threads of such columns idle in the products.
template <typename T, int D, bool kPad>
__device__ __forceinline__ void bwd_group(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ out,
    const float* __restrict__ lse, const T* __restrict__ dout,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    int sq, int sk, int kv_valid, float scale, int dc) {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "head dim must be 16, 32, 64 or 128");
  // the global row width, and the odd shared row stride (lane-strided reads
  // hit 32 banks)
  const int w = kPad ? dc : D;
  const int DP = w + 1;
  extern __shared__ float smem[];
  const int sk_pad = round_up(sk, kBlockK);
  const int sq_pad = round_up(sq, kBlockQ);
  float* ks = smem;                 // [sk_pad][DP], resident
  float* vs = ks + sk_pad * DP;     // [sk_pad][DP], resident
  float* lse_s = vs + sk_pad * DP;  // [sq_pad]
  float* delta_s = lse_s + sq_pad;  // [sq_pad]
  float* qs = delta_s + sq_pad;     // [kBlockQ][DP], streamed
  float* dos = qs + kBlockQ * DP;   // [kBlockQ][DP], streamed
  float* t1 = dos + kBlockQ * DP;   // [32][kTile]
  float* t2 = t1 + kBlockQ * kTile;  // [32][kTile]

  const long long g = blockIdx.x;
  q += g * sq * w;
  out += g * sq * w;
  dout += g * sq * w;
  dq += g * sq * w;
  lse += g * sq;
  k += g * sk * w;
  v += g * sk * w;
  dk += g * sk * w;
  dv += g * sk * w;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kOutStride = kThreads / D;
  constexpr int kOutRows = kBlockQ / kOutStride;
  const int od = tid % D;
  const int orow = tid / D;
  const bool col_in = !kPad || od < dc;  // this thread's output column

  for (int idx = tid; idx < sk_pad * w; idx += kThreads) {
    const int r = idx / w, c = idx % w;
    const bool in = r < sk;
    ks[r * DP + c] = in ? vtt::to_f32(k[r * w + c]) : 0.f;
    vs[r * DP + c] = in ? vtt::to_f32(v[r * w + c]) : 0.f;
  }

  // stage rows [q0, q0 + 32) of q and do as fp32, zeros past Sq
  auto load_rows = [&](int q0) {
    for (int idx = tid; idx < kBlockQ * w; idx += kThreads) {
      const int r = idx / w, c = idx % w, qi = q0 + r;
      const bool in = qi < sq;
      qs[r * DP + c] = in ? vtt::to_f32(q[qi * w + c]) : 0.f;
      dos[r * DP + c] = in ? vtt::to_f32(dout[qi * w + c]) : 0.f;
    }
  };

  // ---- phase 1: dq, one query tile at a time ------------------------------
  for (int q0 = 0; q0 < sq; q0 += kBlockQ) {
    __syncthreads();  // K/V staged; the previous tile's readers are done
    load_rows(q0);
    __syncthreads();

    // δ and lse of rows warp + kWarps·r, replicated across the warp's lanes
    float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      const int qi = q0 + row;
      float part = 0.f;
      if (qi < sq)
        for (int c = lane; c < w; c += 32)
          part = fmaf(dos[row * DP + c], vtt::to_f32(out[qi * w + c]), part);
      delta_r[r] = vtt::warp_sum(part);
      lse_r[r] = qi < sq ? lse[qi] : 0.f;
      if (lane == 0) {
        delta_s[q0 + row] = delta_r[r];
        lse_s[q0 + row] = lse_r[r];
      }
    }

    float acc[kOutRows];
#pragma unroll
    for (int i = 0; i < kOutRows; ++i) acc[i] = 0.f;

    for (int k0 = 0; k0 < sk; k0 += kBlockK) {
      float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
      const float* kr = ks + (k0 + lane) * DP;
      const float* vr = vs + (k0 + lane) * DP;
#pragma unroll 8
      for (int c = 0; c < w; ++c) {
        const float kc = kr[c], vc = vr[c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int row = warp + kWarps * r;
          s[r] = fmaf(qs[row * DP + c], kc, s[r]);
          dp[r] = fmaf(dos[row * DP + c], vc, dp[r]);
        }
      }
      const int kj = k0 + lane;
      const bool key_in = kj < sk;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = warp + kWarps * r;
        const bool row_in = q0 + row < sq;
        const float x = kj < kv_valid ? s[r] * scale : kMaskValue;
        const float p = (key_in && row_in) ? expf(x - lse_r[r]) : 0.f;
        t1[row * kTile + lane] = p * (dp[r] - delta_r[r]);
      }
      __syncthreads();
      if (col_in)
#pragma unroll
        for (int i = 0; i < kOutRows; ++i) {
          const int row = orow + kOutStride * i;
          float a = acc[i];
#pragma unroll 8
          for (int j = 0; j < kBlockK; ++j)
            a = fmaf(t1[row * kTile + j], ks[(k0 + j) * DP + od], a);
          acc[i] = a;
        }
      __syncthreads();  // t1 is rewritten by the next key tile
    }
#pragma unroll
    for (int i = 0; i < kOutRows; ++i) {
      const int qi = q0 + orow + kOutStride * i;
      if (qi < sq && col_in) dq[qi * w + od] = vtt::from_f32<T>(acc[i] * scale);
    }
  }

  // ---- phase 2: dk and dv, one key tile at a time --------------------------
  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    float acc_k[kOutRows], acc_v[kOutRows];
#pragma unroll
    for (int i = 0; i < kOutRows; ++i) acc_k[i] = acc_v[i] = 0.f;

    for (int q0 = 0; q0 < sq; q0 += kBlockQ) {
      __syncthreads();  // the previous tile's readers are done
      load_rows(q0);
      __syncthreads();

      // transposed scores: key warp + kWarps·r against query row `lane`
      float st[kRowsPerWarp], dpt[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) st[r] = dpt[r] = 0.f;
      const float* qr = qs + lane * DP;
      const float* dr = dos + lane * DP;
#pragma unroll 8
      for (int c = 0; c < w; ++c) {
        const float qc = qr[c], dc_ = dr[c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int key = k0 + warp + kWarps * r;
          st[r] = fmaf(ks[key * DP + c], qc, st[r]);
          dpt[r] = fmaf(vs[key * DP + c], dc_, dpt[r]);
        }
      }
      const int qi = q0 + lane;
      const bool row_in = qi < sq;
      const float lse_i = row_in ? lse_s[qi] : 0.f;
      const float delta_i = row_in ? delta_s[qi] : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int key = warp + kWarps * r;
        const int kj = k0 + key;
        const float x = kj < kv_valid ? st[r] * scale : kMaskValue;
        const float p = (row_in && kj < sk) ? expf(x - lse_i) : 0.f;
        t1[key * kTile + lane] = p;
        t2[key * kTile + lane] = p * (dpt[r] - delta_i);
      }
      __syncthreads();
      if (col_in)
#pragma unroll
        for (int i = 0; i < kOutRows; ++i) {
          const int key = orow + kOutStride * i;
          float ak = acc_k[i], av = acc_v[i];
#pragma unroll 8
          for (int j = 0; j < kBlockQ; ++j) {
            av = fmaf(t1[key * kTile + j], dos[j * DP + od], av);
            ak = fmaf(t2[key * kTile + j], qs[j * DP + od], ak);
          }
          acc_k[i] = ak;
          acc_v[i] = av;
        }
    }
#pragma unroll
    for (int i = 0; i < kOutRows; ++i) {
      const int kj = k0 + orow + kOutStride * i;
      if (kj < sk && col_in) {
        dk[kj * w + od] = vtt::from_f32<T>(acc_k[i] * scale);
        dv[kj * w + od] = vtt::from_f32<T>(acc_v[i]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ out,
                 const float* __restrict__ lse, const T* __restrict__ dout,
                 T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                 int sq, int sk, int kv_valid, float scale) {
  bwd_group<T, D, false>(q, k, v, out, lse, dout, dq, dk, dv, sq, sk,
                         kv_valid, scale, D);
}

// Any other head dim d from 1 to 128 in the tile of width D.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_padded_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ out,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        T* __restrict__ dk, T* __restrict__ dv, int sq,
                        int sk, int kv_valid, float scale, int d) {
  bwd_group<T, D, true>(q, k, v, out, lse, dout, dq, dk, dv, sq, sk,
                        kv_valid, scale, d);
}

// ---- the tensor-core route (bf16) ------------------------------------------

namespace mm = vtt::mma;
using bf16 = __nv_bfloat16;

// Pass 1: dq of query rows [64·y, 64·y + 64) of group x, and δ of those rows
// into the delta scratch (G·Sq fp32) for pass 2.
template <int D>
__global__ void __launch_bounds__(mm::kThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const bf16* __restrict__ out,
                        const float* __restrict__ lse, bf16* __restrict__ dq,
                        float* __restrict__ delta, int sq, int sk,
                        int kv_valid, float scale) {
  const long long g = blockIdx.x;
  mm::bwd_dq_rows_mma<D, mm::Contiguous<D>, false, mm::ScaledGrads>(
      blockIdx.y * mm::kRows, q + g * sq * D, k + g * sk * D, v + g * sk * D,
      dout + g * sq * D, out + g * sq * D, lse + g * sq, nullptr,
      dq + g * sq * D, delta + g * sq, sq, sk, kv_valid, scale,
      vtt::make_dropout(0u, 1.f, 0ull), 0u);
}

// Pass 2: dk, dv of keys [64·y, 64·y + 64) of group x, over every query
// tile.
template <int D>
__global__ void __launch_bounds__(mm::kThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int sq,
                         int sk, int kv_valid, float scale) {
  const long long g = blockIdx.x;
  mm::bwd_dkv_rows_mma<D, mm::Contiguous<D>, false, mm::ScaledGrads>(
      blockIdx.y * mm::kRows, 0, (sq + mm::kCols - 1) / mm::kCols,
      q + g * sq * D, k + g * sk * D, v + g * sk * D, dout + g * sq * D,
      lse + g * sq, delta + g * sq, nullptr, dk + g * sk * D,
      dv + g * sk * D, nullptr, nullptr, sq, sk, kv_valid, scale,
      vtt::make_dropout(0u, 1.f, 0ull), 0u);
}

// Both passes at any other head dim d from 1 to 128, in the tile of width D
// under the Padded layout: rows d apart, columns d .. D zeros, only d
// columns written.
template <int D>
__global__ void __launch_bounds__(mm::kThreads)
flash_bwd_dq_mma_padded_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const bf16* __restrict__ out,
                               const float* __restrict__ lse,
                               bf16* __restrict__ dq,
                               float* __restrict__ delta, int sq, int sk,
                               int kv_valid, float scale, int d) {
  const long long g = blockIdx.x;
  mm::bwd_dq_rows_mma<D, mm::GroupPad<D>, false, mm::ScaledGrads>(
      blockIdx.y * mm::kRows, q + g * sq * d, k + g * sk * d, v + g * sk * d,
      dout + g * sq * d, out + g * sq * d, lse + g * sq, nullptr,
      dq + g * sq * d, delta + g * sq, sq, sk, kv_valid, scale,
      vtt::make_dropout(0u, 1.f, 0ull), 0u, mm::group_pad<D>(d));
}

template <int D>
__global__ void __launch_bounds__(mm::kThreads)
flash_bwd_dkv_mma_padded_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int sq, int sk, int kv_valid, float scale,
                                int d) {
  const long long g = blockIdx.x;
  mm::bwd_dkv_rows_mma<D, mm::GroupPad<D>, false, mm::ScaledGrads>(
      blockIdx.y * mm::kRows, 0, (sq + mm::kCols - 1) / mm::kCols,
      q + g * sq * d, k + g * sk * d, v + g * sk * d, dout + g * sq * d,
      lse + g * sq, delta + g * sq, nullptr, dk + g * sk * d,
      dv + g * sk * d, nullptr, nullptr, sq, sk, kv_valid, scale,
      vtt::make_dropout(0u, 1.f, 0ull), 0u, mm::group_pad<D>(d));
}

// ---- head dims above 128 (both dtypes): attention_wide_tile.cuh's two
// passes under ScaledGrads, d split across grid z; delta is the dq pass's
// scratch for the dk/dv pass in fp32 too.

__global__ void __launch_bounds__(mm::kThreads)
flash_bwd_dq_mma_wide_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const bf16* __restrict__ out,
                             const float* __restrict__ lse,
                             bf16* __restrict__ dq, float* __restrict__ delta,
                             int sq, int sk, int kv_valid, float scale,
                             int d) {
  const long long g = blockIdx.x;
  vtt::wide::bwd_dq_rows_wide_mma<false, mm::ScaledGrads>(
      blockIdx.y * vtt::wide::kRows, blockIdx.z, q + g * sq * d,
      k + g * sk * d, v + g * sk * d, dout + g * sq * d, out + g * sq * d,
      lse + g * sq, nullptr, dq + g * sq * d, delta + g * sq, sq, sk,
      kv_valid, scale, vtt::make_dropout(0u, 1.f, 0ull), 0u,
      vtt::wide::Rows{d, d, d, 1});
}

__global__ void __launch_bounds__(mm::kThreads)
flash_bwd_dkv_mma_wide_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int sq, int sk, int kv_valid, float scale,
                              int d) {
  const long long g = blockIdx.x;
  vtt::wide::bwd_dkv_rows_wide_mma<false, mm::ScaledGrads>(
      blockIdx.y * vtt::wide::kRows, blockIdx.z, q + g * sq * d,
      k + g * sk * d, v + g * sk * d, dout + g * sq * d, lse + g * sq,
      delta + g * sq, nullptr, dk + g * sk * d, dv + g * sk * d, sq, sk,
      kv_valid, scale, vtt::make_dropout(0u, 1.f, 0ull), 0u,
      vtt::wide::Rows{d, d, d, 1});
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ out,
                         const float* __restrict__ lse, float* __restrict__ dq,
                         float* __restrict__ delta, int sq, int sk,
                         int kv_valid, float scale, int d) {
  const long long g = blockIdx.x;
  vtt::wide::bwd_dq_rows_wide<mm::ScaledGrads>(
      blockIdx.y * kBlockQ, blockIdx.z, q + g * sq * d, k + g * sk * d,
      v + g * sk * d, dout + g * sq * d, out + g * sq * d, lse + g * sq,
      nullptr, dq + g * sq * d, delta + g * sq, sq, sk, kv_valid, scale,
      vtt::make_dropout(0u, 1.f, 0ull), 0u, vtt::wide::Rows{d, d, d, 1});
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int sq, int sk, int kv_valid, float scale, int d) {
  const long long g = blockIdx.x;
  vtt::wide::bwd_dkv_rows_wide<mm::ScaledGrads>(
      blockIdx.y * kBlockK, blockIdx.z, q + g * sq * d, k + g * sk * d,
      v + g * sk * d, dout + g * sq * d, lse + g * sq, delta + g * sq,
      nullptr, dk + g * sk * d, dv + g * sk * d, sq, sk, kv_valid, scale,
      vtt::make_dropout(0u, 1.f, 0ull), 0u, vtt::wide::Rows{d, d, d, 1});
}

struct Args {
  const void *q, *k, *v, *out, *lse, *dout;
  void *dq, *dk, *dv, *delta;
  int g, sq, sk, kv_valid;
  float scale;
  size_t smem;  // the CUDA-core kernel's
  cudaStream_t stream;
};

// kPad: the head dim d runs in the tile of width D (d < D); D 128 takes its
// streamed tile buffers from dynamic shared memory.
template <int D, bool kPad>
int launch_mma(const Args& a, int d) {
  constexpr int smem = mm::mma_dyn_bytes<D>();
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* dout = static_cast<const bf16*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse);
  auto* delta = static_cast<float*>(a.delta);
  const dim3 grid_q(a.g, (a.sq + mm::kRows - 1) / mm::kRows);
  int rc;
  if constexpr (kPad) {
    rc = vtt::allow_dynamic_smem(flash_bwd_dq_mma_padded_kernel<D>, smem);
    if (rc != 0) return rc;
    flash_bwd_dq_mma_padded_kernel<D><<<grid_q, mm::kThreads, smem,
                                        a.stream>>>(
        q, k, v, dout, static_cast<const bf16*>(a.out), lse,
        static_cast<bf16*>(a.dq), delta, a.sq, a.sk, a.kv_valid, a.scale, d);
    rc = vtt::launched("flash_bwd_dq_mma_padded_kernel");
  } else {
    rc = vtt::allow_dynamic_smem(flash_bwd_dq_mma_kernel<D>, smem);
    if (rc != 0) return rc;
    flash_bwd_dq_mma_kernel<D><<<grid_q, mm::kThreads, smem, a.stream>>>(
        q, k, v, dout, static_cast<const bf16*>(a.out), lse,
        static_cast<bf16*>(a.dq), delta, a.sq, a.sk, a.kv_valid, a.scale);
    rc = vtt::launched("flash_bwd_dq_mma_kernel");
  }
  if (rc != 0) return rc;
  const dim3 grid_k(a.g, (a.sk + mm::kRows - 1) / mm::kRows);
  if constexpr (kPad) {
    rc = vtt::allow_dynamic_smem(flash_bwd_dkv_mma_padded_kernel<D>, smem);
    if (rc != 0) return rc;
    flash_bwd_dkv_mma_padded_kernel<D><<<grid_k, mm::kThreads, smem,
                                         a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.sq, a.sk, a.kv_valid, a.scale, d);
    return vtt::launched("flash_bwd_dkv_mma_padded_kernel");
  } else {
    rc = vtt::allow_dynamic_smem(flash_bwd_dkv_mma_kernel<D>, smem);
    if (rc != 0) return rc;
    flash_bwd_dkv_mma_kernel<D><<<grid_k, mm::kThreads, smem, a.stream>>>(
        q, k, v, dout, lse, delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.sq, a.sk, a.kv_valid, a.scale);
    return vtt::launched("flash_bwd_dkv_mma_kernel");
  }
}

// ---- the CUDA-core route (fp32) --------------------------------------------

template <int D, bool kPad>
int launch(const Args& a, int d) {
  if constexpr (kPad) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_padded_kernel<float, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(a.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_padded_kernel<float, D><<<a.g, kThreads, a.smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.out),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.dout),
        static_cast<float*>(a.dq), static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.sq, a.sk, a.kv_valid, a.scale, d);
    return vtt::launched("flash_bwd_padded_kernel");
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_kernel<float, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(a.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_kernel<float, D><<<a.g, kThreads, a.smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.out),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.dout),
        static_cast<float*>(a.dq), static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.sq, a.sk, a.kv_valid, a.scale);
    return vtt::launched("flash_bwd_kernel");
  }
}

// The wide passes (d > 128), either dtype.
int launch_wide(const Args& a, int d, int is_bf16) {
  const auto* lse = static_cast<const float*>(a.lse);
  auto* delta = static_cast<float*>(a.delta);
  int rc;
  if (is_bf16) {
    const dim3 grid_q(a.g, (a.sq + vtt::wide::kRows - 1) / vtt::wide::kRows,
                      vtt::wide::chunks(d, vtt::wide::kW));
    flash_bwd_dq_mma_wide_kernel<<<grid_q, mm::kThreads, 0, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const bf16*>(a.out), lse, static_cast<bf16*>(a.dq), delta,
        a.sq, a.sk, a.kv_valid, a.scale, d);
    rc = vtt::launched("flash_bwd_dq_mma_wide_kernel");
    if (rc != 0) return rc;
    const dim3 grid_k(a.g, (a.sk + vtt::wide::kRows - 1) / vtt::wide::kRows,
                      vtt::wide::chunks(d, vtt::wide::kWkv));
    flash_bwd_dkv_mma_wide_kernel<<<grid_k, mm::kThreads, 0, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), lse,
        delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.sq, a.sk,
        a.kv_valid, a.scale, d);
    return vtt::launched("flash_bwd_dkv_mma_wide_kernel");
  }
  const int nc = vtt::wide::chunks(d, vtt::wide::kFW);
  const dim3 grid_q(a.g, (a.sq + kBlockQ - 1) / kBlockQ, nc);
  flash_bwd_dq_wide_kernel<<<grid_q, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.out), lse, static_cast<float*>(a.dq), delta,
      a.sq, a.sk, a.kv_valid, a.scale, d);
  rc = vtt::launched("flash_bwd_dq_wide_kernel");
  if (rc != 0) return rc;
  const dim3 grid_k(a.g, (a.sk + kBlockK - 1) / kBlockK, nc);
  flash_bwd_dkv_wide_kernel<<<grid_k, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), lse,
      delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq,
      a.sk, a.kv_valid, a.scale, d);
  return vtt::launched("flash_bwd_dkv_wide_kernel");
}

template <int D, bool kPad>
int launch_d(const Args& a, int d, int is_bf16) {
  return is_bf16 ? launch_mma<D, kPad>(a, d) : launch<D, kPad>(a, d);
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of a launch; cudaErrorInvalidValue when the
// shape is outside the route (flash_attention.py::flash_bwd_smem_bytes over
// one block's 227 KB of shared memory). is_bf16: 1 = bf16 (the tensor
// cores), 0 = fp32. d >= 1. bf16, and fp32 at d > 128: delta, fp32
// scratch of G·Sq elements (δ, written by the first pass and read by the
// second); bf16: a q, k, v, out, do, dq, dk or dv off its copies' grain
// (align_mask(d)) is refused (cudaErrorMisalignedAddress).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* lse, const void* dout,
                        void* dq, void* dk, void* dv, void* delta, int g,
                        int sq, int sk, int d, int kv_valid, float scale,
                        int is_bf16, void* stream) {
  const size_t smem = static_cast<size_t>(smem_floats(sq, sk, d)) * 4;
  if (g < 1 || sq < 1 || sk < 1 || kv_valid < 1 || kv_valid > sk ||
      smem > 232448 || ((is_bf16 || d > 128) && delta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto addr = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  if (is_bf16 && ((addr(q) | addr(k) | addr(v) | addr(out) | addr(dout) |
                   addr(dq) | addr(dk) | addr(dv)) &
                  vtt::mma::align_mask(d)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{q, k, v, out, lse, dout, dq, dk, dv, delta, g, sq, sk,
               kv_valid, scale, smem, static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return launch_d<16, false>(a, d, is_bf16);
    case 32: return launch_d<32, false>(a, d, is_bf16);
    case 64: return launch_d<64, false>(a, d, is_bf16);
    case 128: return launch_d<128, false>(a, d, is_bf16);
    default:
      if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
      if (d > 128) return launch_wide(a, d, is_bf16);
      return d < 16   ? launch_d<16, true>(a, d, is_bf16)
             : d < 32 ? launch_d<32, true>(a, d, is_bf16)
             : d < 64 ? launch_d<64, true>(a, d, is_bf16)
                      : launch_d<128, true>(a, d, is_bf16);
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
