// Self attention read in place from the packed QKV projection, forward and
// backward, with in-kernel probability dropout.
//
// Replaces the TPU kernels vision_transformers_tpu/ops/flash_attention.py::
// _packed_fwd_kernel (:796) and _packed_bwd_kernel (:833), reached through
// packed_flash_attention (:1186).
//
// qkv: (B, S, 3·H·dh) with columns [q | k | v]; head h's q is at column
// h·dh, its k at H·dh + h·dh, its v at 2·H·dh + h·dh, every row 3·H·dh
// elements apart. No head-split copy is made. The forward writes out
// (B, S, H·dh) in the input dtype and lse (B, S, H) fp32; keys >= kv_valid
// are masked. The backward reads (qkv, do, out, lse) and writes dqkv in the
// same packed layout, every element of it, replaying the forward's dropout
// mask from the seed (philox.cuh).
//
// What bounds the forward on the H100 (ViT-B/16 @224, B = 32, S = 197,
// H = 12, dh = 64, bf16): 4·B·H·S²·dh = 3.8 GFLOP, 3.9 µs at 989 TFLOP/s on
// the tensor cores, against 38.7 MB of qkv read plus out written, 11.6 µs at
// 3.35 TB/s. The backward at the same shape: 10·B·H·S²·dh = 9.5 GFLOP,
// 9.6 µs, against qkv, do and out read and dqkv written, 77.5 MB plus the
// lse, 23 µs. So both are bound by memory: they must read their inputs once
// and keep the S×S scores on chip. This design keeps them on chip (32×32
// fp32 tiles in shared memory) but computes with fp32 FMAs on the CUDA
// cores, far below the tensor-core rate, so it is compute-limited in
// practice; each block re-reads its group's other operands (L2-resident).
// Forward grid: x = B·H groups, y = ceil(S / 32) query tiles. Backward: the
// two passes of attention_bwd_tile.cuh, each with the same grid (its y
// counts query tiles, then key tiles). 128 threads per block.
#include "attention_bwd_tile.cuh"

namespace {

// Row 0 of head h of image b in a packed (B, S, 3·H·D) tensor (q's column;
// k is H·D further, v 2·H·D) and in an unpacked (B, S, H·D) one.
template <typename T, int D>
struct PackedGroup {
  long long b, h, hd;
  int s, heads;
  __device__ PackedGroup(int s_, int heads_)
      : b(blockIdx.x / heads_), h(blockIdx.x % heads_),
        hd(static_cast<long long>(heads_) * D), s(s_), heads(heads_) {}
  __device__ long long packed() const { return b * s * 3 * hd + h * D; }
  __device__ long long unpacked() const { return b * s * hd + h * D; }
  __device__ long long lse() const { return b * s * heads + h; }
};

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
packed_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                  float* __restrict__ lse, int s, int heads, int kv_valid,
                  float scale, vtt::Dropout drop) {
  const PackedGroup<T, D> g(s, heads);
  const T* q = qkv + g.packed();
  vtt::attend_rows<T, D>(q, 3 * g.hd, q + g.hd, q + 2 * g.hd, 3 * g.hd,
                         nullptr, 0, nullptr,
                         out + g.unpacked(), g.hd,
                         lse + g.lse(), heads,
                         s, s, kv_valid, scale, drop, blockIdx.x);
}

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
packed_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                     const T* __restrict__ out, const float* __restrict__ lse,
                     T* __restrict__ dqkv, float* __restrict__ delta, int s,
                     int heads, int kv_valid, float scale, vtt::Dropout drop) {
  const PackedGroup<T, D> g(s, heads);
  const T* q = qkv + g.packed();
  vtt::bwd_dq_rows<T, D>(q, 3 * g.hd, q + g.hd, q + 2 * g.hd, 3 * g.hd,
                         dout + g.unpacked(), out + g.unpacked(), g.hd,
                         lse + g.lse(), heads, nullptr,
                         dqkv + g.packed(), 3 * g.hd,
                         delta + static_cast<long long>(blockIdx.x) * s,
                         s, s, kv_valid, scale, drop, blockIdx.x);
}

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
packed_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dqkv,
                      int s, int heads, int kv_valid, float scale,
                      vtt::Dropout drop) {
  const PackedGroup<T, D> g(s, heads);
  const T* q = qkv + g.packed();
  T* dq = dqkv + g.packed();
  vtt::bwd_dkv_rows<T, D>(q, 3 * g.hd, q + g.hd, q + 2 * g.hd, 3 * g.hd,
                          dout + g.unpacked(), g.hd,
                          lse + g.lse(), heads,
                          delta + static_cast<long long>(blockIdx.x) * s,
                          nullptr, dq + g.hd, dq + 2 * g.hd, 3 * g.hd,
                          s, s, kv_valid, scale, drop, blockIdx.x);
}

struct Args {
  const void* qkv;
  const void* dout;  // backward only
  const void* out;
  const void* lse;
  void* dqkv;        // backward only
  void* delta;       // backward only
  int b, s, heads, kv_valid;
  float scale;
  vtt::Dropout drop;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_fwd(const Args& a) {
  const dim3 grid(a.b * a.heads, (a.s + vtt::kBlockQ - 1) / vtt::kBlockQ);
  packed_fwd_kernel<T, D><<<grid, vtt::kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.qkv),
      static_cast<T*>(const_cast<void*>(a.out)),
      static_cast<float*>(const_cast<void*>(a.lse)), a.s, a.heads,
      a.kv_valid, a.scale, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const Args& a) {
  const dim3 grid(a.b * a.heads, (a.s + vtt::kBlockQ - 1) / vtt::kBlockQ);
  packed_bwd_dq_kernel<T, D><<<grid, vtt::kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const T*>(a.dout),
      static_cast<const T*>(a.out), static_cast<const float*>(a.lse),
      static_cast<T*>(a.dqkv), static_cast<float*>(a.delta), a.s, a.heads,
      a.kv_valid, a.scale, a.drop);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  packed_bwd_dkv_kernel<T, D><<<grid, vtt::kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.qkv), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dqkv), a.s, a.heads, a.kv_valid, a.scale, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const Args& a, int dh, bool backward) {
  switch (dh) {
    case 16: return backward ? launch_bwd<T, 16>(a) : launch_fwd<T, 16>(a);
    case 32: return backward ? launch_bwd<T, 32>(a) : launch_fwd<T, 32>(a);
    case 64: return backward ? launch_bwd<T, 64>(a) : launch_fwd<T, 64>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const Args& a, int dh, int is_bf16, bool backward) {
  if (a.b < 1 || a.s < 1 || a.heads < 1 || a.kv_valid < 1 || a.kv_valid > a.s)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? dispatch_dh<__nv_bfloat16>(a, dh, backward)
                 : dispatch_dh<float>(a, dh, backward);
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of a launch. is_bf16: 1 = bf16, 0 = fp32.
// drop_thresh = min(int(rate·2^32), 2^32 − 1), 0 for no dropout;
// inv_keep = 1/(1 − rate); seed: the mask's 64-bit seed.
int packed_attention_fwd(const void* qkv, void* out, void* lse, int b, int s,
                         int heads, int dh, int kv_valid, float scale,
                         int is_bf16, unsigned int drop_thresh, float inv_keep,
                         unsigned long long seed, void* stream) {
  const Args a{qkv, nullptr, out, lse, nullptr, nullptr, b, s, heads, kv_valid,
               scale, vtt::make_dropout(drop_thresh, inv_keep, seed),
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, dh, is_bf16, false);
}

// delta: fp32 scratch of B·H·S elements (δ = rowsum(do ⊙ out), written by
// the first pass and read by the second).
int packed_attention_bwd(const void* qkv, const void* dout, const void* out,
                         const void* lse, void* dqkv, void* delta, int b,
                         int s, int heads, int dh, int kv_valid, float scale,
                         int is_bf16, unsigned int drop_thresh, float inv_keep,
                         unsigned long long seed, void* stream) {
  const Args a{qkv, dout, out, lse, dqkv, delta, b, s, heads, kv_valid, scale,
               vtt::make_dropout(drop_thresh, inv_keep, seed),
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, dh, is_bf16, true);
}

const char* packed_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
