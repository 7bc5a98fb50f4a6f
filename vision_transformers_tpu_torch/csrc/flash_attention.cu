// Split-head attention with an optional additive bias.
//
// Replaces the TPU kernel vision_transformers_tpu/ops/flash_attention.py::
// _attn_kernel (:75), reached through _flash_fwd (:136) and flash_attention
// (:2472).
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
// memory. The design streams K/V tiles with an online softmax so the scores
// stay in shared memory; the products are fp32 FMAs on the CUDA cores, not
// yet the tensor cores, which is where the gap to the bound lies.
// Grid: x = G groups, y = ceil(Sq / 32) query tiles; 128 threads per block.
#include "attention_tile.cuh"

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
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, void* lse, int g, int sq, int sk, int bias_g,
           int kv_valid, float scale, cudaStream_t stream) {
  const dim3 grid(g, (sq + vtt::kBlockQ - 1) / vtt::kBlockQ);
  flash_fwd_kernel<T, D><<<grid, vtt::kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(lse), sq, sk, bias_g,
      kv_valid, scale);
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
// is ignored). is_bf16: 1 = bf16, 0 = fp32.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* bias, void* out, void* lse, int g, int sq,
                        int sk, int d, int bias_g, int kv_valid, float scale,
                        int is_bf16, void* stream) {
  if (g < 1 || sq < 1 || sk < 1 || kv_valid < 1 || kv_valid > sk ||
      (bias != nullptr && (bias_g < 1 || g % bias_g != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? dispatch_d<__nv_bfloat16>(q, k, v, bias, out, lse, g, sq, sk, d, bias_g, kv_valid, scale, st)
      : dispatch_d<float>(q, k, v, bias, out, lse, g, sq, sk, d, bias_g, kv_valid, scale, st);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
