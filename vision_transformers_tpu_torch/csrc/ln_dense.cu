// Fused LayerNorm + Dense (+ GELU): act((LN(x)·γ + β)·W + b) over rows.
//
// Replaces the TPU kernel vision_transformers_tpu/ops/fused_dense.py::
// _ln_dense_kernel (:72), reached through _ln_dense_fwd_pallas (:88) and
// ln_dense (:180).
//
// x: (R, D) in the compute dtype (bf16 or fp32); gamma, beta: fp32 (D,);
// W(k, n) at w[k·ldk + n·ldn], in the compute dtype ((D, N) row-major is
// ldk = N, ldn = 1); bias: fp32 (N,) or null. Per row: fp32 mean and
// variance, xn = (x − μ)·rsqrt(var + eps)·γ + β rounded to x's dtype, the
// product accumulated in fp32, + bias, the activation in fp32 (0 none,
// 1 tanh GELU, 2 erf GELU), one rounding to x's dtype into out (R, N).
//
// What bounds it on the H100 (ViT-B/16 at batch 32: R = 6304, D = 768,
// bf16): [ln_1 + QKV] N = 2304 is 2·R·D·N = 22.3 GFLOP, 22.6 µs at
// 989 TFLOP/s, against 42.3 MB of x, W and out, 12.6 µs at 3.35 TB/s;
// [ln_2 + fc1] N = 3072 is 29.7 GFLOP, 30.1 µs. So the bound is the
// operations, and what the fusion saves is the normalised rows' round trip
// through device memory. This design keeps them out of it: each block owns
// a 64-row × 64-column tile, computes its rows' statistics once
// (dense_tile.cuh::row_stats), normalises each 64 × 16 slice of x on its way
// into shared memory and streams W's column tile beside it. The products
// are fp32 FMAs on the CUDA cores, not yet the tensor cores, which is where
// the gap to the bound lies. No block holds all N columns: the grid is
// x = ceil(R / 64) row tiles, y = ceil(N / 64) column tiles, 128 threads.
#include "dense_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(vtt::kThreads)
ln_dense_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const T* __restrict__ w,
                long long ldk, long long ldn, const float* __restrict__ bias,
                T* __restrict__ out, int rows, int d, int n, float eps,
                int act) {
  __shared__ vtt::DenseSmem sm;
  const int m0 = blockIdx.x * vtt::kTileM, n0 = blockIdx.y * vtt::kTileN;
  vtt::row_stats<T>(x, rows, d, m0, eps, sm);  // dense_tile syncs before use
  vtt::dense_tile<T>(x, rows, d, gamma, beta, w, ldk, ldn, n, bias, act,
                     nullptr, out, m0, n0, sm);
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, const void* w,
           long long ldk, long long ldn, const void* bias, void* out, int rows,
           int d, int n, float eps, int act, cudaStream_t stream) {
  const dim3 grid((rows + vtt::kTileM - 1) / vtt::kTileM,
                  (n + vtt::kTileN - 1) / vtt::kTileN);
  ln_dense_kernel<T><<<grid, vtt::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(w), ldk, ldn,
      static_cast<const float*>(bias), static_cast<T*>(out), rows, d, n, eps,
      act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch. bias may be null.
// act: 0 none, 1 tanh GELU, 2 erf GELU. is_bf16: 1 = bf16, 0 = fp32.
int ln_dense_fwd(const void* x, const void* gamma, const void* beta,
                 const void* w, long long ldk, long long ldn, const void* bias,
                 void* out, int rows, int d, int n, float eps, int act,
                 int is_bf16, void* stream) {
  if (rows < 1 || d < 1 || n < 1 || act < 0 || act > 2 ||
      (n + vtt::kTileN - 1) / vtt::kTileN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(x, gamma, beta, w, ldk, ldn, bias, out, rows, d,
                              n, eps, act, st)
      : launch<float>(x, gamma, beta, w, ldk, ldn, bias, out, rows, d, n, eps,
                      act, st);
}

const char* ln_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
