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
#include <cstdint>
#include <type_traits>

#include "attention_mma_tile.cuh"

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, void* lse, int g, int sq, int sk, int bias_g,
           int kv_valid, float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    constexpr int rows = vtt::mma::fwd_rows<D>();
    const dim3 grid(g, (sq + rows - 1) / rows);
    flash_fwd_mma_kernel<D><<<grid, vtt::mma::kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(bias),
        static_cast<T*>(out), static_cast<float*>(lse), sq, sk, bias_g,
        kv_valid, scale);
  } else {
    const dim3 grid(g, (sq + vtt::kBlockQ - 1) / vtt::kBlockQ);
    flash_fwd_kernel<T, D><<<grid, vtt::kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(bias),
        static_cast<T*>(out), static_cast<float*>(lse), sq, sk, bias_g,
        kv_valid, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* bias,
               void* out, void* lse, int g, int sq, int sk, int d, int bias_g,
               int kv_valid, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, bias, out, lse, g, sq, sk, bias_g, kv_valid, scale, stream);
    case 32: return launch<T, 32>(q, k, v, bias, out, lse, g, sq, sk, bias_g, kv_valid, scale, stream);
    case 64: return launch<T, 64>(q, k, v, bias, out, lse, g, sq, sk, bias_g, kv_valid, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch. bias may be null (then bias_g
// is ignored). is_bf16: 1 = bf16, 0 = fp32. A bf16 q, k, v or out that is
// not 16-byte aligned is refused (cudaErrorMisalignedAddress): the
// tensor-core route reads them with 16-byte copies.
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
                   reinterpret_cast<std::uintptr_t>(out)) & 15u))
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
