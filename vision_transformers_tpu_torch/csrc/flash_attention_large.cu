// Streaming split-head attention with a runtime key-padding mask.
//
// Replaces the TPU kernel vision_transformers_tpu/ops/flash_attention.py::
// _large_kernel (:229), launched by _flash_fwd_large (:276) and reached
// through _flash_fwd (:143-147) for any kv_mask and for bias-free
// Sq·Sk > 1.5 M: the DETR encoder's self attention and decoder's cross
// attention (key padding of each image), a ViT at 576 px or a ViT detection
// backbone at COCO size, T2T-ViT_t's token transformer at 3136 tokens. Row 3
// of PERF.md's kernel table.
//
// q: (G, Sq, D), k/v: (G, Sk, D), contiguous, G = B·H with heads fastest.
// kmask: null or uint8 (n, Sk), nonzero = attend, n dividing G: group g
// reads row g / (G / n). No bias. Writes out (G, Sq, D) in the input dtype
// and lse (G, Sq) fp32.
//
// Numerics are the TPU kernel's: the score times the scale is REPLACED by
// DEFAULT_MASK_VALUE = -0.7·FLT_MAX where the key is >= kv_valid or masked,
// before the running max; denom = max(l, 1e-30); lse = m + log(denom); the
// unnormalised probabilities are rounded to the value dtype before P·V.
// Keys past Sk (the ragged last tile) take no part at all. So a row whose
// keys are all masked is the uniform average over its Sk keys
// (mha_reference's answer); the TPU kernel, whose zero-padded block keys
// count too, gives Σv / Sk_padded there. The TPU kernel's running max
// starts at DEFAULT_MASK_VALUE, the bf16 kernel's at -inf (fp32:
// DEFAULT_MASK_VALUE): every tile either walks holds a key < Sk, whose
// replaced score is >= DEFAULT_MASK_VALUE, so both give the same max.
//
// What bounds it on the H100 (the DETR-R50 encoder at the 896 × 1344 bucket,
// batch 4: G = 32, S = 4704, D = 32, bf16): 4·G·S²·D = 90.6 GFLOP, 0.092 ms
// at 989 TFLOP/s, against 38.5 MB of q/k/v read and out/lse written, 0.0115
// ms at 3.35 TB/s: the operations. One image's (8, 4704, 4704) fp32 scores
// would be 708 MB, so they never leave the block. Two routes, by dtype:
//   bf16: flash_large_mma_kernel on attend_rows_mma<D, ReplaceByte, false>
//     (attention_mma_tile.cuh): the products on the tensor cores (mma.sync
//     m16n8k16), K/V tiles of 64 keys double-buffered by cp.async, each
//     tile's 64 keep bits staged beside it, and the 64-key tiles past the
//     last one that holds an attended key (the bottom rows of padding of a
//     COCO image) skipped.
//     Grid: x = G, y = ceil(Sq / 128) (D 16, 32) or ceil(Sq / 64) (D 64);
//     128 threads. Every bf16 pointer must be 16-byte aligned (checked here).
//   fp32: flash_large_kernel, fp32 FMAs on the CUDA cores (attention_tile.cuh's
//     layout): keys stream through shared memory in tiles of 32 with an
//     online softmax, each lane reading its own key's mask byte beside the
//     tile. Grid: x = G, y = ceil(Sq / 32); 128 threads.
// Head dims: D 16, 32, 64 and 128 are instantiations of these kernels (D 128
// with its tile buffers in dynamic shared memory). Any other D from 1 to 128
// (ViT-H/14's D 80 at 518 px, S 1370; TNT's D 12) runs in the next tile
// width with the columns past D read as zeros and not written:
// flash_large_mma_padded_kernel (bf16, attention_mma_tile.cuh's GroupPad
// layouts, the same mask policy and skipped trailing tiles) and
// flash_large_padded_kernel (fp32). A D above 128 (ViT-B/16's widths at 3
// heads, D 256, at 576 px) takes flash_large_mma_wide_kernel /
// flash_large_wide_kernel (attention_wide_tile.cuh: D split across grid z,
// the same mask policy and, in bf16, the same skipped tiles).
#include <cstdint>
#include <type_traits>

#include "attention_mma_tile.cuh"
#include "attention_wide_tile.cuh"
#include "launch_log.cuh"

namespace {

using vtt::kBlockK;
using vtt::kBlockQ;
using vtt::kMaskValue;
using vtt::kRowsPerWarp;
using vtt::kThreads;
using vtt::kWarps;

// Rows [blockIdx.y·kBlockQ, +kBlockQ) of group blockIdx.x. kPad: the head
// dim dc runs in the tile of width D (dc <= D; rows dc apart, columns >= dc
// read as 0 and not written); D 128 takes its q, k and v tiles from the
// dynamic shared memory (attend_dyn_bytes<D>()).
template <typename T, int D, bool kPad>
__device__ __forceinline__ void large_rows(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const unsigned char* __restrict__ kmask, T* __restrict__ out,
    float* __restrict__ lse, int groups_per_row, int sq, int sk, int kv_valid,
    float scale, int dc) {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "head dim must be 16, 32, 64 or 128");
  constexpr bool kDyn = D > 64;
  __shared__ float qs_st[kDyn ? 1 : kBlockQ][kDyn ? 1 : D];
  __shared__ float ks_st[kDyn ? 1 : kBlockK][kDyn ? 1 : D + 1];
  __shared__ float vs_st[kDyn ? 1 : kBlockK][kDyn ? 1 : D];
  // +1 in ks: lane-strided reads hit 32 banks
  float (&qs)[kBlockQ][D] = vtt::smem_array<float[kBlockQ][D]>(qs_st, 0);
  float (&ks)[kBlockK][D + 1] =
      vtt::smem_array<float[kBlockK][D + 1]>(ks_st, 4 * kBlockQ * D);
  float (&vs)[kBlockK][D] = vtt::smem_array<float[kBlockK][D]>(
      vs_st, 4 * (kBlockQ * D + kBlockK * (D + 1)));
  __shared__ float ps[kBlockQ][kBlockK + 1];
  __shared__ float alpha_s[kBlockQ];
  __shared__ float l_s[kBlockQ];
  // the global row width: D, or the padded head dim
  const int w = kPad ? dc : D;

  const long long g = blockIdx.x;
  const T* qg = q + g * sq * w;
  const T* kg = k + g * sk * w;
  const T* vg = v + g * sk * w;
  const unsigned char* mrow =
      kmask == nullptr ? nullptr : kmask + (g / groups_per_row) * sk;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.y * kBlockQ;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, qi = q0 + r;
    qs[r][c] = qi < sq && (!kPad || c < dc)
                   ? vtt::to_f32(qg[static_cast<long long>(qi) * w + c])
                   : 0.f;
  }

  // softmax state of rows warp + kWarps·r, replicated across the warp's lanes
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = kMaskValue;
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
      const bool in = kj < sk && (!kPad || c < dc);
      const long long off = static_cast<long long>(kj) * w + c;
      ks[r][c] = in ? vtt::to_f32(kg[off]) : 0.f;
      vs[r][c] = in ? vtt::to_f32(vg[off]) : 0.f;
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

    // lane j's key: in the sequence, and attended (kv_valid and the mask)
    const int kj = k0 + lane;
    const bool key_in = kj < sk;
    const bool attend = key_in && kj < kv_valid &&
                        (mrow == nullptr || mrow[kj] != 0);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      const float x = attend ? s[r] * scale : kMaskValue;
      // keys past Sk stay out of the max and the sum
      const float m_new =
          fmaxf(m_run[r], vtt::warp_max(key_in ? x : -CUDART_INF_F));
      const float p = key_in ? expf(x - m_new) : 0.f;
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + vtt::warp_sum(p);
      m_run[r] = m_new;
      ps[row][lane] = p;
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
      const float denom = fmaxf(l_run[r], 1e-30f);
      l_s[row] = denom;
      if (qi < sq) lse[g * sq + qi] = m_run[r] + logf(denom);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kOutRows; ++i) {
    const int row = orow + kOutStride * i;
    const int qi = q0 + row;
    if (qi < sq && (!kPad || od < dc))
      out[g * sq * w + static_cast<long long>(qi) * w + od] =
          vtt::from_f32<T>(acc[i] / l_s[row]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_large_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v,
                   const unsigned char* __restrict__ kmask,
                   T* __restrict__ out, float* __restrict__ lse,
                   int groups_per_row, int sq, int sk, int kv_valid,
                   float scale) {
  large_rows<T, D, false>(q, k, v, kmask, out, lse, groups_per_row, sq, sk,
                          kv_valid, scale, D);
}

// Any other head dim d from 1 to 128 in the tile of width D.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_large_padded_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const unsigned char* __restrict__ kmask,
                          T* __restrict__ out, float* __restrict__ lse,
                          int groups_per_row, int sq, int sk, int kv_valid,
                          float scale, int d) {
  large_rows<T, D, true>(q, k, v, kmask, out, lse, groups_per_row, sq, sk,
                         kv_valid, scale, d);
}

using bf16 = __nv_bfloat16;

// The key tiles the bf16 forward walked and the key tiles its blocks' rows
// hold, summed over its launches since the last read
// (flash_attention_large_tile_counts).
__device__ unsigned long long tile_counts[2];

template <int D>
__device__ __forceinline__ void large_mma_rows(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const unsigned char* __restrict__ kmask,
    bf16* __restrict__ out, float* __restrict__ lse, int groups_per_row,
    int sq, int sk, int kv_valid, float scale) {
  const long long g = blockIdx.x;
  vtt::mma::attend_rows_mma<D, vtt::mma::KeyMask::ReplaceByte, false>(
      blockIdx.y * vtt::mma::fwd_rows<D>(), q + g * sq * D, k + g * sk * D,
      v + g * sk * D, nullptr, out + g * sq * D, lse + g * sq, sq, sk,
      kv_valid, scale,
      kmask == nullptr ? nullptr : kmask + (g / groups_per_row) * sk,
      vtt::Dropout{}, 0u, tile_counts);
}

template <int D>
__global__ void __launch_bounds__(vtt::mma::kThreads)
flash_large_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const unsigned char* __restrict__ kmask,
                       bf16* __restrict__ out, float* __restrict__ lse,
                       int groups_per_row, int sq, int sk, int kv_valid,
                       float scale) {
  large_mma_rows<D>(q, k, v, kmask, out, lse, groups_per_row, sq, sk,
                    kv_valid, scale);
}

// D 64 asks for four blocks an SM (at most 128 registers): left free, ptxas
// takes 142 and only three fit. At D 32 and 16 a block hint makes it take
// more registers than it does free, and the launches run slower.
template <>
__global__ void __launch_bounds__(vtt::mma::kThreads, 4)
flash_large_mma_kernel<64>(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const unsigned char* __restrict__ kmask,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int groups_per_row, int sq, int sk, int kv_valid,
                           float scale) {
  large_mma_rows<64>(q, k, v, kmask, out, lse, groups_per_row, sq, sk,
                     kv_valid, scale);
}

// Any other head dim d from 1 to 128 in the tile of width D under the
// Padded layout (the 128 tile's K/V buffers in dynamic shared memory).
template <int D>
__global__ void __launch_bounds__(vtt::mma::kThreads)
flash_large_mma_padded_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const unsigned char* __restrict__ kmask,
                              bf16* __restrict__ out, float* __restrict__ lse,
                              int groups_per_row, int sq, int sk,
                              int kv_valid, float scale, int d) {
  const long long g = blockIdx.x;
  vtt::mma::attend_rows_mma<D, vtt::mma::KeyMask::ReplaceByte, false,
                            vtt::mma::GroupPad<D>>(
      blockIdx.y * vtt::mma::fwd_rows<D>(), q + g * sq * d, k + g * sk * d,
      v + g * sk * d, nullptr, out + g * sq * d, lse + g * sq, sq, sk,
      kv_valid, scale,
      kmask == nullptr ? nullptr : kmask + (g / groups_per_row) * sk,
      vtt::Dropout{}, 0u, tile_counts, vtt::mma::group_pad<D>(d));
}

// Any head dim d above 128: attention_wide_tile.cuh's split of d across grid
// z, the same mask policy (and, in bf16, skipped trailing tiles and tile
// counts, from chunk 0's blocks).
__global__ void __launch_bounds__(vtt::mma::kThreads)
flash_large_mma_wide_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const unsigned char* __restrict__ kmask,
                            bf16* __restrict__ out, float* __restrict__ lse,
                            int groups_per_row, int sq, int sk, int kv_valid,
                            float scale, int d) {
  const long long g = blockIdx.x;
  vtt::wide::attend_rows_wide_mma<vtt::mma::KeyMask::ReplaceByte, false>(
      blockIdx.y * vtt::wide::kRows, blockIdx.z, q + g * sq * d,
      k + g * sk * d, v + g * sk * d, nullptr, out + g * sq * d,
      lse + g * sq, sq, sk, kv_valid, scale,
      kmask == nullptr ? nullptr : kmask + (g / groups_per_row) * sk,
      vtt::Dropout{}, 0u, tile_counts, vtt::wide::Rows{d, d, d, 1});
}

__global__ void __launch_bounds__(kThreads)
flash_large_wide_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const unsigned char* __restrict__ kmask,
                        float* __restrict__ out, float* __restrict__ lse,
                        int groups_per_row, int sq, int sk, int kv_valid,
                        float scale, int d) {
  const long long g = blockIdx.x;
  vtt::wide::attend_rows_wide<vtt::mma::KeyMask::ReplaceByte>(
      blockIdx.y * kBlockQ, blockIdx.z, q + g * sq * d, k + g * sk * d,
      v + g * sk * d, nullptr,
      kmask == nullptr ? nullptr : kmask + (g / groups_per_row) * sk,
      out + g * sq * d, lse + g * sq, sq, sk, kv_valid, scale,
      vtt::make_dropout(0u, 1.f, 0ull), 0u, vtt::wide::Rows{d, d, d, 1});
}

int launch_wide(const void* q, const void* k, const void* v,
                const void* kmask, void* out, void* lse, int g, int mask_rows,
                int sq, int sk, int d, int kv_valid, float scale, int is_bf16,
                cudaStream_t stream) {
  const int per_row = kmask == nullptr ? 1 : g / mask_rows;
  const auto* m_ = static_cast<const unsigned char*>(kmask);
  auto* l_ = static_cast<float*>(lse);
  if (is_bf16) {
    const dim3 grid(g, (sq + vtt::wide::kRows - 1) / vtt::wide::kRows,
                    vtt::wide::chunks(d, vtt::wide::kW));
    flash_large_mma_wide_kernel<<<grid, vtt::mma::kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), m_, static_cast<bf16*>(out), l_, per_row,
        sq, sk, kv_valid, scale, d);
    return vtt::launched("flash_large_mma_wide_kernel");
  }
  const dim3 grid(g, (sq + kBlockQ - 1) / kBlockQ,
                  vtt::wide::chunks(d, vtt::wide::kFW));
  flash_large_wide_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), m_, static_cast<float*>(out), l_, per_row,
      sq, sk, kv_valid, scale, d);
  return vtt::launched("flash_large_wide_kernel");
}

// kPad: the head dim d runs in the tile of width D (d < D).
template <typename T, int D, bool kPad>
int launch(const void* q, const void* k, const void* v, const void* kmask,
           void* out, void* lse, int g, int mask_rows, int sq, int sk, int d,
           int kv_valid, float scale, cudaStream_t stream) {
  const int per_row = kmask == nullptr ? 1 : g / mask_rows;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const auto* m_ = static_cast<const unsigned char*>(kmask);
  T* o_ = static_cast<T*>(out);
  float* l_ = static_cast<float*>(lse);
  if constexpr (std::is_same_v<T, bf16>) {
    constexpr int rows = vtt::mma::fwd_rows<D>();
    constexpr int smem = vtt::mma::mma_dyn_bytes<D>();
    const dim3 grid(g, (sq + rows - 1) / rows);
    if constexpr (kPad) {
      const int rc =
          vtt::allow_dynamic_smem(flash_large_mma_padded_kernel<D>, smem);
      if (rc != 0) return rc;
      flash_large_mma_padded_kernel<D><<<grid, vtt::mma::kThreads, smem,
                                         stream>>>(
          q_, k_, v_, m_, o_, l_, per_row, sq, sk, kv_valid, scale, d);
      return vtt::launched("flash_large_mma_padded_kernel");
    } else {
      const int rc = vtt::allow_dynamic_smem(flash_large_mma_kernel<D>, smem);
      if (rc != 0) return rc;
      flash_large_mma_kernel<D><<<grid, vtt::mma::kThreads, smem, stream>>>(
          q_, k_, v_, m_, o_, l_, per_row, sq, sk, kv_valid, scale);
      return vtt::launched("flash_large_mma_kernel");
    }
  } else {
    constexpr int smem = vtt::attend_dyn_bytes<D>();
    const dim3 grid(g, (sq + kBlockQ - 1) / kBlockQ);
    if constexpr (kPad) {
      const int rc =
          vtt::allow_dynamic_smem(flash_large_padded_kernel<T, D>, smem);
      if (rc != 0) return rc;
      flash_large_padded_kernel<T, D><<<grid, kThreads, smem, stream>>>(
          q_, k_, v_, m_, o_, l_, per_row, sq, sk, kv_valid, scale, d);
      return vtt::launched("flash_large_padded_kernel");
    } else {
      const int rc = vtt::allow_dynamic_smem(flash_large_kernel<T, D>, smem);
      if (rc != 0) return rc;
      flash_large_kernel<T, D><<<grid, kThreads, smem, stream>>>(
          q_, k_, v_, m_, o_, l_, per_row, sq, sk, kv_valid, scale);
      return vtt::launched("flash_large_kernel");
    }
  }
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* kmask,
               void* out, void* lse, int g, int mask_rows, int sq, int sk,
               int d, int kv_valid, float scale, cudaStream_t stream) {
#define VTT_LAUNCH(D, PAD) \
  launch<T, D, PAD>(q, k, v, kmask, out, lse, g, mask_rows, sq, sk, d, \
                    kv_valid, scale, stream)
  switch (d) {
    case 16: return VTT_LAUNCH(16, false);
    case 32: return VTT_LAUNCH(32, false);
    case 64: return VTT_LAUNCH(64, false);
    case 128: return VTT_LAUNCH(128, false);
    default:
      if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
      if (d > 128)
        return launch_wide(q, k, v, kmask, out, lse, g, mask_rows, sq, sk, d,
                           kv_valid, scale, std::is_same_v<T, bf16>, stream);
      return d < 16   ? VTT_LAUNCH(16, true)
             : d < 32 ? VTT_LAUNCH(32, true)
             : d < 64 ? VTT_LAUNCH(64, true) : VTT_LAUNCH(128, true);
  }
#undef VTT_LAUNCH
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch. kmask may be null (then
// mask_rows is ignored); else mask_rows must divide g. is_bf16: 1 = bf16,
// 0 = fp32. d >= 1. sq / 32 query tiles must fit the grid's y dimension.
// A bf16 q, k, v or out off its copies' grain (align_mask(d): 16 bytes at D
// 16, 32, 64, 128 and a multiple of 8 above 64, 4 at another even D, none
// at an odd D) is refused (cudaErrorMisalignedAddress):
// the tensor-core route reads them with copies of that width. The mask may
// start at any byte.
int flash_attention_large_fwd(const void* q, const void* k, const void* v,
                              const void* kmask, void* out, void* lse, int g,
                              int mask_rows, int sq, int sk, int d,
                              int kv_valid, float scale, int is_bf16,
                              void* stream) {
  if (g < 1 || sq < 1 || sk < 1 || kv_valid < 1 || kv_valid > sk ||
      (sq + kBlockQ - 1) / kBlockQ > 65535 ||
      (kmask != nullptr && (mask_rows < 1 || g % mask_rows != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && ((reinterpret_cast<std::uintptr_t>(q) |
                   reinterpret_cast<std::uintptr_t>(k) |
                   reinterpret_cast<std::uintptr_t>(v) |
                   reinterpret_cast<std::uintptr_t>(out)) &
                  vtt::mma::align_mask(d)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? dispatch_d<__nv_bfloat16>(q, k, v, kmask, out, lse, g, mask_rows, sq, sk, d, kv_valid, scale, st)
      : dispatch_d<float>(q, k, v, kmask, out, lse, g, mask_rows, sq, sk, d, kv_valid, scale, st);
}

// Copies the two tile counts of the bf16 forward into counts, and zeroes
// them. Returns 0 or the cudaError_t of the copies.
int flash_attention_large_tile_counts(unsigned long long* counts) {
  const unsigned long long zero[2] = {0ull, 0ull};
  cudaError_t e = cudaMemcpyFromSymbol(counts, tile_counts, sizeof zero);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(tile_counts, zero, sizeof zero);
  return static_cast<int>(e);
}

const char* flash_attention_large_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
