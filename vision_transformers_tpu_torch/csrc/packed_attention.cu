// Self attention read in place from the packed QKV projection.
//
// Replaces the TPU kernel vision_transformers_tpu/ops/flash_attention.py::
// _packed_fwd_kernel (:796), reached through packed_flash_attention (:1186).
//
// qkv: (B, S, 3·H·dh) with columns [q | k | v]; head h's q is at column
// h·dh, its k at H·dh + h·dh, its v at 2·H·dh + h·dh, every row 3·H·dh
// elements apart. No head-split copy is made. Writes out (B, S, H·dh) in the
// input dtype and lse (B, S, H) fp32. Keys >= kv_valid are masked.
//
// What bounds it on the H100 (ViT-B/16 @224, B = 32, S = 197, H = 12,
// dh = 64, bf16): 4·B·H·S²·dh = 3.8 GFLOP, 3.9 µs at 989 TFLOP/s on the
// tensor cores, against 38.7 MB of qkv read plus out written, 11.6 µs at
// 3.35 TB/s. So the bound is memory: the kernel must read qkv once and keep
// the S×S scores on chip. This design keeps them on chip (a 32×32 fp32 tile
// in shared memory at a time) but computes with fp32 FMAs on the CUDA cores,
// far below the tensor-core rate, so it is compute-limited in practice; each
// block re-reads its group's K/V (L2-resident: 2·S·dh elements per group).
// Grid: x = B·H groups, y = ceil(S / 32) query tiles; 128 threads per block.
#include "attention_tile.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
packed_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                  float* __restrict__ lse, int s, int heads, int kv_valid,
                  float scale) {
  const long long g = blockIdx.x;  // b·H + h
  const long long b = g / heads, h = g % heads;
  const long long hd = static_cast<long long>(heads) * D;
  const T* q = qkv + b * s * 3 * hd + h * D;
  vtt::attend_rows<T, D>(q, 3 * hd, q + hd, q + 2 * hd, 3 * hd,
                         nullptr, 0,
                         out + b * s * hd + h * D, hd,
                         lse + b * s * heads + h, heads,
                         s, s, kv_valid, scale);
}

template <typename T, int D>
int launch(const void* qkv, void* out, void* lse, int b, int s, int heads,
           int kv_valid, float scale, cudaStream_t stream) {
  const dim3 grid(b * heads, (s + vtt::kBlockQ - 1) / vtt::kBlockQ);
  packed_fwd_kernel<T, D><<<grid, vtt::kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out),
      static_cast<float*>(lse), s, heads, kv_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const void* qkv, void* out, void* lse, int b, int s,
                int heads, int dh, int kv_valid, float scale,
                cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(qkv, out, lse, b, s, heads, kv_valid, scale, stream);
    case 32: return launch<T, 32>(qkv, out, lse, b, s, heads, kv_valid, scale, stream);
    case 64: return launch<T, 64>(qkv, out, lse, b, s, heads, kv_valid, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch. is_bf16: 1 = bf16, 0 = fp32.
int packed_attention_fwd(const void* qkv, void* out, void* lse, int b, int s,
                         int heads, int dh, int kv_valid, float scale,
                         int is_bf16, void* stream) {
  if (b < 1 || s < 1 || heads < 1 || kv_valid < 1 || kv_valid > s)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? dispatch_dh<__nv_bfloat16>(qkv, out, lse, b, s, heads, dh, kv_valid, scale, st)
      : dispatch_dh<float>(qkv, out, lse, b, s, heads, dh, kv_valid, scale, st);
}

const char* packed_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
