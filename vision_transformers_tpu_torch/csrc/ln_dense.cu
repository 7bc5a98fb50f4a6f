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
// through device memory. Both routes keep them out of it: each block
// computes its rows' statistics once, normalises x's slices on their way
// into shared memory and streams W's column tile beside them. No block holds
// all N columns. Two entry points; ops/fused_dense.py::ln_dense_route picks
// one by a stated rule:
//   ln_dense_mma_fwd (bf16, D and N multiples of 8): ln_stats_kernel (a warp
//     per row, (μ, rstd) of every row into an fp32 scratch, 8 rows a block),
//     then ln_dense_mma_kernel on dense_mma_tile.cuh, mma.sync m16n8k16 on
//     the tensor cores, 128 × 128 output tiles; grid x = ceil(R / 128),
//     y = ceil(N / 128), 256 threads. x, W, out, gamma and beta must be
//     16-byte aligned (checked here).
//   ln_dense_fwd (fp32, and bf16 of other widths): ln_dense_kernel on
//     dense_tile.cuh, fp32 FMAs on the CUDA cores, 64 × 64 output tiles;
//     grid x = ceil(R / 64), y = ceil(N / 64), 128 threads.
#include <cstdint>

#include "dense_mma_tile.cuh"
#include "dense_tile.cuh"
#include "launch_log.cuh"

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

__global__ void __launch_bounds__(vtt::dense_mma::kThreads)
ln_stats_kernel(const __nv_bfloat16* __restrict__ x, int rows, int d,
                float eps, float* __restrict__ stats) {
  const int row = blockIdx.x * (vtt::dense_mma::kThreads / 32) +
                  (threadIdx.x >> 5);
  if (row < rows) vtt::dense_mma::row_stats(x, d, row, eps, stats);
}

// kWk: W's k contiguous (ldk = 1, torch's (out, in) weight); ldw is W's
// leading stride.
template <bool kWk>
__global__ void __launch_bounds__(vtt::dense_mma::kThreads, 2)
ln_dense_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const __nv_bfloat16* __restrict__ w, long long ldw,
                    const float* __restrict__ bias,
                    const float* __restrict__ stats,
                    __nv_bfloat16* __restrict__ out, int rows, int d, int n,
                    int act) {
  __shared__ vtt::dense_mma::Smem<kWk> sm;
  vtt::dense_mma::ln_dense_mma_tile<kWk>(
      x, gamma, beta, w, ldw, bias, stats, out, rows, d, n, act,
      blockIdx.x * vtt::dense_mma::kBM, blockIdx.y * vtt::dense_mma::kBN, sm);
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
  return vtt::launched("ln_dense_kernel");
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

// The tensor-core route, bf16 only: returns 0 or the cudaError_t of the
// launches. stats: fp32 scratch of 2·rows elements, 8-byte aligned (each
// row's μ and rstd, written by the first launch, read by the second). d and
// n must be multiples of 8 and W's leading stride (ldk when ldn = 1, ldn when
// ldk = 1) too (cudaErrorInvalidValue otherwise); x, W, out, gamma and beta
// must be 16-byte aligned (cudaErrorMisalignedAddress).
int ln_dense_mma_fwd(const void* x, const void* gamma, const void* beta,
                     const void* w, long long ldk, long long ldn,
                     const void* bias, void* out, void* stats, int rows,
                     int d, int n, float eps, int act, void* stream) {
  using vtt::dense_mma::kBM;
  using vtt::dense_mma::kBN;
  const long long ldw = ldn == 1 ? ldk : ldk == 1 ? ldn : 0;
  if (rows < 1 || d < 8 || n < 8 || d % 8 != 0 || n % 8 != 0 || ldw < 8 ||
      ldw % 8 != 0 || act < 0 || act > 2 || (n + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<std::uintptr_t>(x) |
       reinterpret_cast<std::uintptr_t>(w) |
       reinterpret_cast<std::uintptr_t>(out) |
       reinterpret_cast<std::uintptr_t>(gamma) |
       reinterpret_cast<std::uintptr_t>(beta)) & 15u ||
      reinterpret_cast<std::uintptr_t>(stats) & 7u)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((rows + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* g = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  const auto* bi = static_cast<const float*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* sts = static_cast<float*>(stats);
  constexpr int kRowsPerBlock = vtt::dense_mma::kThreads / 32;
  ln_stats_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock,
                    vtt::dense_mma::kThreads, 0, st>>>(xb, rows, d, eps, sts);
  const int rc = vtt::launched("ln_stats_kernel");
  if (rc != 0) return rc;
  if (ldn == 1)
    ln_dense_mma_kernel<false><<<grid, vtt::dense_mma::kThreads, 0, st>>>(
        xb, g, be, wb, ldw, bi, sts, o, rows, d, n, act);
  else
    ln_dense_mma_kernel<true><<<grid, vtt::dense_mma::kThreads, 0, st>>>(
        xb, g, be, wb, ldw, bi, sts, o, rows, d, n, act);
  return vtt::launched("ln_dense_mma_kernel");
}

const char* ln_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
