// Split-head attention with in-kernel probability dropout and a key-padding
// mask, forward and backward.
//
// Replaces the TPU kernels vision_transformers_tpu/ops/flash_attention.py::
// _drop_fwd_kernel (:491) and _drop_bwd_kernel (:525), reached through
// flash_dropout_attention (:716); at rate 0 the backward is also the
// bias-free backward of flash_attention (:2416-2422).
//
// q: (G, Sq, D), k/v: (G, Sk, D), contiguous, G = B·heads with heads fastest.
// kmask: null or fp32 (B, Sk), 0 to attend and -0.7·FLT_MAX to hide, added to
// the scores of batch g / heads after kv_valid. Sq != Sk is allowed. The
// forward writes out (G, Sq, D) and lse (G, Sq) fp32; the backward reads
// (q, k, v, do, out, lse) and writes dq, dk, dv in the input dtype, summed in
// fp32 and cast once. The dropout mask is a function of (seed, g, row,
// column) alone (philox.cuh), so the backward replays the forward's.
//
// What bounds them on the H100 (ViT-B/16 @512, G = 8·12, S = 1025, D = 64,
// bf16): forward 4·G·S²·D = 25.8 GFLOP, 26 µs at 989 TFLOP/s, against 50 MB
// moved, 15 µs; backward 10·G·S²·D = 64.6 GFLOP, 65 µs, against 101 MB
// moved, 30 µs. So both are bound by the operations, and the S×S scores
// (0.4 GB in fp32) must never reach device memory. The design streams tiles
// through shared memory (attention_tile.cuh, attention_bwd_tile.cuh); the
// products are fp32 FMAs on the CUDA cores, not yet the tensor cores, which
// is where the gap to the bound lies.
// Grids: x = G groups, y = ceil(Sq / 32) query tiles (forward, backward pass
// 1) or ceil(Sk / 32) key tiles (backward pass 2); 128 threads per block.
#include "attention_bwd_tile.cuh"

namespace {

struct Args {
  const void *q, *k, *v, *kmask, *dout, *out, *lse;
  void *dq, *dk, *dv, *delta;
  int g, heads, sq, sk, kv_valid;
  float scale;
  vtt::Dropout drop;
  cudaStream_t stream;
};

__device__ __forceinline__ const float* group_mask(const float* kmask,
                                                   int heads, int sk) {
  return kmask == nullptr
      ? nullptr
      : kmask + static_cast<long long>(blockIdx.x / heads) * sk;
}

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
drop_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ kmask,
                T* __restrict__ out, float* __restrict__ lse, int heads,
                int sq, int sk, int kv_valid, float scale, vtt::Dropout drop) {
  const long long g = blockIdx.x;
  vtt::attend_rows<T, D>(blockIdx.y * vtt::kBlockQ, q + g * sq * D, D,
                         k + g * sk * D, v + g * sk * D, D,
                         nullptr, 0, group_mask(kmask, heads, sk),
                         out + g * sq * D, D, lse + g * sq, 1,
                         sq, sk, kv_valid, scale, drop, blockIdx.x);
}

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
drop_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ kmask,
                   const T* __restrict__ dout, const T* __restrict__ out,
                   const float* __restrict__ lse, T* __restrict__ dq,
                   float* __restrict__ delta, int heads, int sq, int sk,
                   int kv_valid, float scale, vtt::Dropout drop) {
  const long long g = blockIdx.x;
  vtt::bwd_dq_rows<T, D>(q + g * sq * D, D, k + g * sk * D, v + g * sk * D, D,
                         dout + g * sq * D, out + g * sq * D, D,
                         lse + g * sq, 1, group_mask(kmask, heads, sk),
                         dq + g * sq * D, D, delta + g * sq,
                         sq, sk, kv_valid, scale, drop, blockIdx.x);
}

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
drop_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ kmask,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int heads, int sq, int sk,
                    int kv_valid, float scale, vtt::Dropout drop) {
  const long long g = blockIdx.x;
  vtt::bwd_dkv_rows<T, D>(q + g * sq * D, D, k + g * sk * D, v + g * sk * D, D,
                          dout + g * sq * D, D, lse + g * sq, 1,
                          delta + g * sq, group_mask(kmask, heads, sk),
                          dk + g * sk * D, dv + g * sk * D, D,
                          sq, sk, kv_valid, scale, drop, blockIdx.x);
}

template <typename T, int D>
int launch_fwd(const Args& a) {
  const dim3 grid(a.g, (a.sq + vtt::kBlockQ - 1) / vtt::kBlockQ);
  drop_fwd_kernel<T, D><<<grid, vtt::kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.kmask),
      static_cast<T*>(const_cast<void*>(a.out)),
      static_cast<float*>(const_cast<void*>(a.lse)), a.heads, a.sq, a.sk,
      a.kv_valid, a.scale, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const Args& a) {
  const dim3 grid_q(a.g, (a.sq + vtt::kBlockQ - 1) / vtt::kBlockQ);
  drop_bwd_dq_kernel<T, D><<<grid_q, vtt::kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.kmask),
      static_cast<const T*>(a.dout), static_cast<const T*>(a.out),
      static_cast<const float*>(a.lse), static_cast<T*>(a.dq),
      static_cast<float*>(a.delta), a.heads, a.sq, a.sk, a.kv_valid, a.scale,
      a.drop);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const dim3 grid_k(a.g, (a.sk + vtt::kBlockK - 1) / vtt::kBlockK);
  drop_bwd_dkv_kernel<T, D><<<grid_k, vtt::kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.kmask),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.heads, a.sq, a.sk, a.kv_valid, a.scale, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Args& a, int d, bool backward) {
  switch (d) {
    case 16: return backward ? launch_bwd<T, 16>(a) : launch_fwd<T, 16>(a);
    case 32: return backward ? launch_bwd<T, 32>(a) : launch_fwd<T, 32>(a);
    case 64: return backward ? launch_bwd<T, 64>(a) : launch_fwd<T, 64>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const Args& a, int d, int is_bf16, bool backward) {
  if (a.g < 1 || a.heads < 1 || a.g % a.heads != 0 || a.sq < 1 || a.sk < 1 ||
      a.kv_valid < 1 || a.kv_valid > a.sk)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(a, d, backward)
                 : dispatch_d<float>(a, d, backward);
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of a launch. kmask may be null.
// is_bf16: 1 = bf16, 0 = fp32. drop_thresh = min(int(rate·2^32), 2^32 − 1),
// 0 for no dropout; inv_keep = 1/(1 − rate); seed: the mask's 64-bit seed.
int dropout_attention_fwd(const void* q, const void* k, const void* v,
                          const void* kmask, void* out, void* lse, int g,
                          int heads, int sq, int sk, int d, int kv_valid,
                          float scale, int is_bf16, unsigned int drop_thresh,
                          float inv_keep, unsigned long long seed,
                          void* stream) {
  const Args a{q, k, v, kmask, nullptr, out, lse, nullptr, nullptr, nullptr,
               nullptr, g, heads, sq, sk, kv_valid, scale,
               vtt::make_dropout(drop_thresh, inv_keep, seed),
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, d, is_bf16, false);
}

// delta: fp32 scratch of G·Sq elements (δ = rowsum(do ⊙ out), written by the
// first pass and read by the second).
int dropout_attention_bwd(const void* q, const void* k, const void* v,
                          const void* kmask, const void* dout, const void* out,
                          const void* lse, void* dq, void* dk, void* dv,
                          void* delta, int g, int heads, int sq, int sk, int d,
                          int kv_valid, float scale, int is_bf16,
                          unsigned int drop_thresh, float inv_keep,
                          unsigned long long seed, void* stream) {
  const Args a{q, k, v, kmask, dout, out, lse, dq, dk, dv, delta, g, heads,
               sq, sk, kv_valid, scale,
               vtt::make_dropout(drop_thresh, inv_keep, seed),
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, d, is_bf16, true);
}

const char* dropout_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
