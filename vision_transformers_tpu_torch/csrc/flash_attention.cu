// Split-head attention with an optional additive bias.
//
// Replaces the TPU kernel vision_transformers_tpu/ops/flash_attention.py::
// _attn_kernel (:75), reached through _flash_fwd (:136) and flash_attention
// (:2472). Row 2 of PERF.md's kernel table.
//
// q: (G, Sq, D), k/v: (G, Sk, D), contiguous, G = B·H with heads fastest.
// bias: null or fp32 (bias_g, Sq, Sk); group g adds bias[g % bias_g] after
// the scale (bias_g = 1, H or any multiple of H dividing G: Swin's
// per-window bias). Then keys >= kv_valid are masked. Sq != Sk is allowed.
// Writes out (G, Sq, D) in the input dtype and lse (G, Sq) fp32.
//
// What bounds it on the H100 (ViT-B/16 @512, G = 8·12, S = 1025, D = 64,
// bf16): 4·G·S²·D = 25.8 GFLOP, 26 µs at 989 TFLOP/s, against 50 MB of
// q/k/v read and out written, 15 µs at 3.35 TB/s. So the bound is the
// operations, and S×S scores (0.4 GB in fp32) must never reach device
// memory. Two routes, by dtype:
//   bf16: flash_fwd_mma_kernel on attend_rows_mma (attention_mma_tile.cuh),
//     the products on the tensor cores (mma.sync m16n8k16), K/V tiles of 64
//     double-buffered by cp.async. Grid: x = G, y = ceil(Sq / 128) (D 16,
//     32) or ceil(Sq / 64) (D 64); 128 threads. Every bf16 pointer must be 16-byte aligned (checked here).
//   fp32: flash_fwd_kernel on attend_rows (attention_tile.cuh), fp32 FMAs on
//     the CUDA cores, 32 × 32 tiles. Grid: x = G, y = ceil(Sq / 32); 128
//     threads.
// Head dims: D 16, 32, 64 and 128 are instantiations of these kernels (D 128
// with its tile buffers in dynamic shared memory: TNT's outer attention, D
// 128 at S 17). Any other D from 1 to 128 (TNT's inner attention, D 12 at S
// 4; ViT-H/14's D 80 at S 577) runs in the next tile width, 16, 32, 64 or
// 128, with the columns past D read as zeros and not written:
// flash_fwd_mma_padded_kernel (bf16, attention_mma_tile.cuh's GroupPad
// layouts: Padded below 128, a bf16 operand 4-byte aligned for an even D;
// the 128 tile in dynamic shared memory with PaddedStrided's copies, 16-byte
// aligned for D a multiple of 8) and flash_fwd_padded_kernel (fp32). A D
// above 128 takes flash_fwd_mma_wide_kernel / flash_fwd_wide_kernel
// (attention_wide_tile.cuh: D split across grid z, each block's scores
// summed over every chunk of q and k).
#include <cstdint>
#include <type_traits>

#include "attention_mma_tile.cuh"
#include "attention_wide_tile.cuh"
#include "launch_log.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int sq, int sk,
                 int bias_g, int kv_valid, float scale) {
  const long long g = blockIdx.x;
  const float* bg = bias == nullptr
      ? nullptr
      : bias + (g % bias_g) * static_cast<long long>(sq) * sk;
  vtt::attend_rows<T, D>(blockIdx.y * vtt::kBlockQ, q + g * sq * D, D,
                         k + g * sk * D, v + g * sk * D, D,
                         bg, sk, nullptr, out + g * sq * D, D, lse + g * sq, 1,
                         sq, sk, kv_valid, scale,
                         vtt::make_dropout(0u, 1.f, 0ull), blockIdx.x);
}

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
flash_fwd_padded_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias, T* __restrict__ out,
                        float* __restrict__ lse, int sq, int sk, int bias_g,
                        int kv_valid, float scale, int d) {
  const long long g = blockIdx.x;
  const float* bg = bias == nullptr
      ? nullptr
      : bias + (g % bias_g) * static_cast<long long>(sq) * sk;
  vtt::attend_rows<T, D, vtt::PlainLoads, true>(
      blockIdx.y * vtt::kBlockQ, q + g * sq * d, d, k + g * sk * d,
      v + g * sk * d, d, bg, sk, nullptr, out + g * sq * d, d, lse + g * sq,
      1, sq, sk, kv_valid, scale, vtt::make_dropout(0u, 1.f, 0ull),
      blockIdx.x, d);
}

template <int D>
__global__ void __launch_bounds__(vtt::mma::kThreads)
flash_fwd_mma_padded_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ bias,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int sq, int sk,
                            int bias_g, int kv_valid, float scale, int d) {
  const long long g = blockIdx.x;
  const float* bg = bias == nullptr
      ? nullptr
      : bias + (g % bias_g) * static_cast<long long>(sq) * sk;
  vtt::mma::attend_rows_mma<D, vtt::mma::KeyMask::NoMask, false,
                            vtt::mma::GroupPad<D>>(
      blockIdx.y * vtt::mma::fwd_rows<D>(), q + g * sq * d, k + g * sk * d,
      v + g * sk * d, bg, out + g * sq * d, lse + g * sq, sq, sk, kv_valid,
      scale, nullptr, vtt::Dropout{}, 0u, nullptr, vtt::mma::group_pad<D>(d));
}

template <int D>
__global__ void __launch_bounds__(vtt::mma::kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int sq, int sk, int bias_g, int kv_valid, float scale) {
  const long long g = blockIdx.x;
  const float* bg = bias == nullptr
      ? nullptr
      : bias + (g % bias_g) * static_cast<long long>(sq) * sk;
  vtt::mma::attend_rows_mma<D>(blockIdx.y * vtt::mma::fwd_rows<D>(),
                               q + g * sq * D,
                               k + g * sk * D, v + g * sk * D, bg,
                               out + g * sq * D, lse + g * sq, sq, sk,
                               kv_valid, scale);
}

// Any head dim d above 128: attention_wide_tile.cuh's split of d across grid
// z, contiguous (G, S, d) groups.
__device__ __forceinline__ const float* group_bias(const float* bias,
                                                  int bias_g, int sq,
                                                  int sk) {
  return bias == nullptr
      ? nullptr
      : bias + (blockIdx.x % bias_g) * static_cast<long long>(sq) * sk;
}

__global__ void __launch_bounds__(vtt::mma::kThreads)
flash_fwd_mma_wide_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int sq, int sk,
                          int bias_g, int kv_valid, float scale, int d) {
  const long long g = blockIdx.x;
  vtt::wide::attend_rows_wide_mma<vtt::mma::KeyMask::NoMask, false>(
      blockIdx.y * vtt::wide::kRows, blockIdx.z, q + g * sq * d,
      k + g * sk * d, v + g * sk * d, group_bias(bias, bias_g, sq, sk),
      out + g * sq * d, lse + g * sq, sq, sk, kv_valid, scale, nullptr,
      vtt::Dropout{}, 0u, nullptr, vtt::wide::Rows{d, d, d, 1});
}

__global__ void __launch_bounds__(vtt::kThreads)
flash_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias, float* __restrict__ out,
                      float* __restrict__ lse, int sq, int sk, int bias_g,
                      int kv_valid, float scale, int d) {
  const long long g = blockIdx.x;
  vtt::wide::attend_rows_wide<vtt::mma::KeyMask::NoMask>(
      blockIdx.y * vtt::kBlockQ, blockIdx.z, q + g * sq * d, k + g * sk * d,
      v + g * sk * d, group_bias(bias, bias_g, sq, sk), nullptr,
      out + g * sq * d, lse + g * sq, sq, sk, kv_valid, scale,
      vtt::make_dropout(0u, 1.f, 0ull), 0u, vtt::wide::Rows{d, d, d, 1});
}

int launch_wide(const void* q, const void* k, const void* v,
                const void* bias, void* out, void* lse, int g, int sq, int sk,
                int d, int bias_g, int kv_valid, float scale, int is_bf16,
                cudaStream_t stream) {
  const auto* b_ = static_cast<const float*>(bias);
  auto* l_ = static_cast<float*>(lse);
  if (is_bf16) {
    using bf16 = __nv_bfloat16;
    const dim3 grid(g, (sq + vtt::wide::kRows - 1) / vtt::wide::kRows,
                    vtt::wide::chunks(d, vtt::wide::kW));
    flash_fwd_mma_wide_kernel<<<grid, vtt::mma::kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), b_, static_cast<bf16*>(out), l_, sq, sk,
        bias_g, kv_valid, scale, d);
    return vtt::launched("flash_fwd_mma_wide_kernel");
  }
  const dim3 grid(g, (sq + vtt::kBlockQ - 1) / vtt::kBlockQ,
                  vtt::wide::chunks(d, vtt::wide::kFW));
  flash_fwd_wide_kernel<<<grid, vtt::kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), b_, static_cast<float*>(out), l_, sq, sk,
      bias_g, kv_valid, scale, d);
  return vtt::launched("flash_fwd_wide_kernel");
}

// kPad: the head dim d runs in the tile of width D (d < D).
template <typename T, int D, bool kPad>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, void* lse, int g, int sq, int sk, int d, int bias_g,
           int kv_valid, float scale, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const float* b_ = static_cast<const float*>(bias);
  T* o_ = static_cast<T*>(out);
  float* l_ = static_cast<float*>(lse);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    constexpr int rows = vtt::mma::fwd_rows<D>();
    const dim3 grid(g, (sq + rows - 1) / rows);
    if constexpr (kPad) {
      constexpr int smem = vtt::mma::mma_dyn_bytes<D>();
      const int rc =
          vtt::allow_dynamic_smem(flash_fwd_mma_padded_kernel<D>, smem);
      if (rc != 0) return rc;
      flash_fwd_mma_padded_kernel<D><<<grid, vtt::mma::kThreads, smem,
                                       stream>>>(
          q_, k_, v_, b_, o_, l_, sq, sk, bias_g, kv_valid, scale, d);
      return vtt::launched("flash_fwd_mma_padded_kernel");
    } else {
      constexpr int smem = vtt::mma::mma_dyn_bytes<D>();
      const int rc = vtt::allow_dynamic_smem(flash_fwd_mma_kernel<D>, smem);
      if (rc != 0) return rc;
      flash_fwd_mma_kernel<D><<<grid, vtt::mma::kThreads, smem, stream>>>(
          q_, k_, v_, b_, o_, l_, sq, sk, bias_g, kv_valid, scale);
      return vtt::launched("flash_fwd_mma_kernel");
    }
  } else {
    const dim3 grid(g, (sq + vtt::kBlockQ - 1) / vtt::kBlockQ);
    if constexpr (kPad) {
      constexpr int smem = vtt::attend_dyn_bytes<D>();
      const int rc =
          vtt::allow_dynamic_smem(flash_fwd_padded_kernel<T, D>, smem);
      if (rc != 0) return rc;
      flash_fwd_padded_kernel<T, D><<<grid, vtt::kThreads, smem, stream>>>(
          q_, k_, v_, b_, o_, l_, sq, sk, bias_g, kv_valid, scale, d);
      return vtt::launched("flash_fwd_padded_kernel");
    } else {
      constexpr int smem = vtt::attend_dyn_bytes<D>();
      const int rc = vtt::allow_dynamic_smem(flash_fwd_kernel<T, D>, smem);
      if (rc != 0) return rc;
      flash_fwd_kernel<T, D><<<grid, vtt::kThreads, smem, stream>>>(
          q_, k_, v_, b_, o_, l_, sq, sk, bias_g, kv_valid, scale);
      return vtt::launched("flash_fwd_kernel");
    }
  }
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* bias,
               void* out, void* lse, int g, int sq, int sk, int d, int bias_g,
               int kv_valid, float scale, cudaStream_t stream) {
#define VTT_LAUNCH(D, PAD) \
  launch<T, D, PAD>(q, k, v, bias, out, lse, g, sq, sk, d, bias_g, kv_valid, \
                    scale, stream)
  switch (d) {
    case 16: return VTT_LAUNCH(16, false);
    case 32: return VTT_LAUNCH(32, false);
    case 64: return VTT_LAUNCH(64, false);
    case 128: return VTT_LAUNCH(128, false);
    default:
      if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
      if (d > 128)
        return launch_wide(q, k, v, bias, out, lse, g, sq, sk, d, bias_g,
                           kv_valid, scale,
                           std::is_same_v<T, __nv_bfloat16>, stream);
      return d < 16   ? VTT_LAUNCH(16, true)
             : d < 32 ? VTT_LAUNCH(32, true)
             : d < 64 ? VTT_LAUNCH(64, true) : VTT_LAUNCH(128, true);
  }
#undef VTT_LAUNCH
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch. bias may be null (then bias_g
// is ignored). is_bf16: 1 = bf16, 0 = fp32. d >= 1. A bf16 q, k, v
// or out off its copies' grain (align_mask(d): 16 bytes at D 16, 32, 64,
// 128 and a multiple of 8 above 64, 4 at another even D, none at an odd D) is refused (cudaErrorMisalignedAddress): the
// tensor-core route reads them with copies of that width.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* bias, void* out, void* lse, int g, int sq,
                        int sk, int d, int bias_g, int kv_valid, float scale,
                        int is_bf16, void* stream) {
  if (g < 1 || sq < 1 || sk < 1 || kv_valid < 1 || kv_valid > sk ||
      (bias != nullptr && (bias_g < 1 || g % bias_g != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && ((reinterpret_cast<std::uintptr_t>(q) |
                   reinterpret_cast<std::uintptr_t>(k) |
                   reinterpret_cast<std::uintptr_t>(v) |
                   reinterpret_cast<std::uintptr_t>(out)) &
                  vtt::mma::align_mask(d)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? dispatch_d<__nv_bfloat16>(q, k, v, bias, out, lse, g, sq, sk, d, bias_g, kv_valid, scale, st)
      : dispatch_d<float>(q, k, v, bias, out, lse, g, sq, sk, d, bias_g, kv_valid, scale, st);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
