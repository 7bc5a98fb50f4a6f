// Split-head attention with in-kernel probability dropout and a key-padding
// mask, forward and backward.
//
// Replaces the TPU kernels vision_transformers_tpu/ops/flash_attention.py::
// _drop_fwd_kernel (:491) and _drop_bwd_kernel (:525), reached through
// flash_dropout_attention (:716); at rate 0 the backward is also the
// bias-free backward of flash_attention (:2416-2422). Rows 5 and 6 of
// PERF.md's kernel table.
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
// (0.4 GB in fp32) must never reach device memory. The dropout bits add
// integer work: one Philox 4x32-10 call per four probabilities.
//
// Forward (row 5), by dtype:
//   bf16: drop_fwd_mma_kernel on attend_rows_mma<D, AddFloat, true>
//     (attention_mma_tile.cuh): the products on the tensor cores, the key
//     mask staged per 64-key tile, the 64-key tiles past the last one
//     that holds an attended key skipped, the keep bits four per Philox
//     call shared by one shuffle. It rounds
//     the dropped probabilities to bf16 unnormalised and divides by the
//     undropped sum after P·V; _drop_fwd_kernel (and the plain version)
//     round them normalised, which a one-pass kernel cannot (one bf16 step
//     of the output apart). Grid: x = G, y = ceil(Sq / 128) (D 16, 32) or
//     ceil(Sq / 64) (D 64). Every bf16 pointer must be 16-byte aligned
//     (checked here).
//   fp32: drop_fwd_kernel on attend_rows (attention_tile.cuh), fp32 FMAs on
//     the CUDA cores in 32 × 32 tiles. Grid: x = G, y = ceil(Sq / 32).
// Backward (row 6), by dtype:
//   bf16: the tensor-core passes of attention_bwd_mma_tile.cuh — pass 1
//     (drop_bwd_dq_mma_kernel, grid x = G, y = ceil(Sq / 64)), pass 2
//     (drop_bwd_dkv_mma_kernel, grid x = G, y = ceil(Sk / 64), z = chunks
//     of the query loop) and, when chunks > 1, drop_bwd_dkv_sum_kernel,
//     which adds the chunks' fp32 partials in chunk order. Every bf16
//     pointer must be 16-byte aligned (checked here).
//   fp32: bwd_dq_rows / bwd_dkv_rows (attention_bwd_tile.cuh), fp32 FMAs,
//     grids x = G, y = ceil(Sq / 32) and ceil(Sk / 32).
// 128 threads per block throughout.
// Head dims: D 16, 32, 64 and 128 are instantiations of these kernels (D 128
// with its tile buffers in dynamic shared memory: TNT's outer attention). Any
// other D from 1 to 128 (TNT's inner attention, D 12; ViT-H/14's D 80 at S
// 577) runs in the next tile width, 16, 32, 64 or 128 (the 128 tile in
// dynamic shared memory), with the columns past D read as zeros and not
// written (the *_padded_kernel kernels, on attention_mma_tile.cuh's
// GroupPad layouts; a bf16 operand aligned as align_mask(D) says: 4 bytes for
// an even D below 64, the PaddedStrided grain in the 128 tile, 16 bytes for D
// 80); the fp32 partials of a split dk/dv pass then have rows D apart. A D
// above 128 (ViT-B/16's widths at 3 heads, D 256, at 448 px) takes the
// *_wide_kernel kernels (attention_wide_tile.cuh: D split across grid z,
// each block's scores summed over every chunk; the forward's skipped tiles
// and tile counts kept; the dk/dv pass never split, part unused).
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "attention_bwd_tile.cuh"
#include "attention_bwd_mma_tile.cuh"
#include "attention_mma_tile.cuh"
#include "attention_wide_tile.cuh"
#include "launch_log.cuh"

namespace {

struct Args {
  const void *q, *k, *v, *kmask, *dout, *out, *lse;
  void *dq, *dk, *dv, *delta, *part;
  int g, heads, sq, sk, d, kv_valid, chunks;
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

using bf16 = __nv_bfloat16;

// The key tiles the bf16 forward walked and the key tiles its blocks' rows
// hold, summed over its launches since the last read
// (dropout_attention_tile_counts).
__device__ unsigned long long tile_counts[2];

template <int D>
__global__ void __launch_bounds__(vtt::mma::kThreads)
drop_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const float* __restrict__ kmask, bf16* __restrict__ out,
                    float* __restrict__ lse, int heads, int sq, int sk,
                    int kv_valid, float scale, vtt::Dropout drop) {
  const long long g = blockIdx.x;
  vtt::mma::attend_rows_mma<D, vtt::mma::KeyMask::AddFloat, true>(
      blockIdx.y * vtt::mma::fwd_rows<D>(), q + g * sq * D, k + g * sk * D,
      v + g * sk * D, nullptr, out + g * sq * D, lse + g * sq, sq, sk,
      kv_valid, scale, group_mask(kmask, heads, sk), drop, blockIdx.x,
      tile_counts);
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

template <int D>
__global__ void __launch_bounds__(vtt::mma::kThreads)
drop_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const float* __restrict__ kmask,
                       const bf16* __restrict__ dout,
                       const bf16* __restrict__ out,
                       const float* __restrict__ lse, bf16* __restrict__ dq,
                       float* __restrict__ delta, int heads, int sq, int sk,
                       int kv_valid, float scale, vtt::Dropout drop) {
  const long long g = blockIdx.x;
  vtt::mma::bwd_dq_rows_mma<D>(
      blockIdx.y * vtt::mma::kRows, q + g * sq * D, k + g * sk * D,
      v + g * sk * D, dout + g * sq * D, out + g * sq * D, lse + g * sq,
      group_mask(kmask, heads, sk), dq + g * sq * D, delta + g * sq, sq, sk,
      kv_valid, scale, drop, blockIdx.x);
}

// part: null (write dk, dv) or fp32 [2][gridDim.z][G][Sk][D], dk's partials
// first; chunk z covers query tiles [z·per, min(nq, (z + 1)·per)).
template <int D>
__global__ void __launch_bounds__(vtt::mma::kThreads)
drop_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ kmask,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        float* __restrict__ part, int heads, int sq, int sk,
                        int kv_valid, float scale, vtt::Dropout drop,
                        int per) {
  const long long g = blockIdx.x;
  const int nq = (sq + vtt::mma::kCols - 1) / vtt::mma::kCols;
  const int t0 = blockIdx.z * per;
  const int t1 = min(nq, t0 + per);
  float *pk = nullptr, *pv = nullptr;
  if (part != nullptr) {
    const long long plane = static_cast<long long>(gridDim.x) * sk * D;
    pk = part + blockIdx.z * plane + g * sk * D;
    pv = part + (gridDim.z + blockIdx.z) * plane + g * sk * D;
  }
  vtt::mma::bwd_dkv_rows_mma<D>(
      blockIdx.y * vtt::mma::kRows, t0, t1, q + g * sq * D, k + g * sk * D,
      v + g * sk * D, dout + g * sq * D, lse + g * sq, delta + g * sq,
      group_mask(kmask, heads, sk), dk + g * sk * D, dv + g * sk * D, pk, pv,
      sq, sk, kv_valid, scale, drop, blockIdx.x);
}

// dk, dv = bf16(sum over the chunks of the partials), chunk 0 first.
__global__ void __launch_bounds__(256)
drop_bwd_dkv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, long long plane, int chunks) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < plane;
       i += static_cast<long long>(gridDim.x) * 256) {
    float sk_ = 0.f, sv = 0.f;
    for (int z = 0; z < chunks; ++z) {
      sk_ += part[z * plane + i];
      sv += part[(chunks + z) * plane + i];
    }
    dk[i] = __float2bfloat16(sk_);
    dv[i] = __float2bfloat16(sv);
  }
}

// ---- head dims other than 16, 32, 64 and 128: the tile of width D, the
// columns d .. D read as zeros and not written (Padded layout); rows d apart.

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
drop_fwd_padded_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ kmask, T* __restrict__ out,
                       float* __restrict__ lse, int heads, int sq, int sk,
                       int kv_valid, float scale, vtt::Dropout drop, int d) {
  const long long g = blockIdx.x;
  vtt::attend_rows<T, D, vtt::PlainLoads, true>(
      blockIdx.y * vtt::kBlockQ, q + g * sq * d, d, k + g * sk * d,
      v + g * sk * d, d, nullptr, 0, group_mask(kmask, heads, sk),
      out + g * sq * d, d, lse + g * sq, 1, sq, sk, kv_valid, scale, drop,
      blockIdx.x, d);
}

template <int D>
__global__ void __launch_bounds__(vtt::mma::kThreads)
drop_fwd_mma_padded_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const float* __restrict__ kmask,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int heads, int sq, int sk, int kv_valid,
                           float scale, vtt::Dropout drop, int d) {
  const long long g = blockIdx.x;
  vtt::mma::attend_rows_mma<D, vtt::mma::KeyMask::AddFloat, true,
                            vtt::mma::GroupPad<D>>(
      blockIdx.y * vtt::mma::fwd_rows<D>(), q + g * sq * d, k + g * sk * d,
      v + g * sk * d, nullptr, out + g * sq * d, lse + g * sq, sq, sk,
      kv_valid, scale, group_mask(kmask, heads, sk), drop, blockIdx.x,
      tile_counts, vtt::mma::group_pad<D>(d));
}

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
drop_bwd_dq_padded_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ kmask,
                          const T* __restrict__ dout,
                          const T* __restrict__ out,
                          const float* __restrict__ lse, T* __restrict__ dq,
                          float* __restrict__ delta, int heads, int sq,
                          int sk, int kv_valid, float scale,
                          vtt::Dropout drop, int d) {
  const long long g = blockIdx.x;
  vtt::bwd_dq_rows<T, D, true>(
      q + g * sq * d, d, k + g * sk * d, v + g * sk * d, d, dout + g * sq * d,
      out + g * sq * d, d, lse + g * sq, 1, group_mask(kmask, heads, sk),
      dq + g * sq * d, d, delta + g * sq, sq, sk, kv_valid, scale, drop,
      blockIdx.x, d);
}

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
drop_bwd_dkv_padded_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ kmask,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int heads,
                           int sq, int sk, int kv_valid, float scale,
                           vtt::Dropout drop, int d) {
  const long long g = blockIdx.x;
  vtt::bwd_dkv_rows<T, D, true>(
      q + g * sq * d, d, k + g * sk * d, v + g * sk * d, d, dout + g * sq * d,
      d, lse + g * sq, 1, delta + g * sq, group_mask(kmask, heads, sk),
      dk + g * sk * d, dv + g * sk * d, d, sq, sk, kv_valid, scale, drop,
      blockIdx.x, d);
}

template <int D>
__global__ void __launch_bounds__(vtt::mma::kThreads)
drop_bwd_dq_mma_padded_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const float* __restrict__ kmask,
                              const bf16* __restrict__ dout,
                              const bf16* __restrict__ out,
                              const float* __restrict__ lse,
                              bf16* __restrict__ dq,
                              float* __restrict__ delta, int heads, int sq,
                              int sk, int kv_valid, float scale,
                              vtt::Dropout drop, int d) {
  const long long g = blockIdx.x;
  vtt::mma::bwd_dq_rows_mma<D, vtt::mma::GroupPad<D>>(
      blockIdx.y * vtt::mma::kRows, q + g * sq * d, k + g * sk * d,
      v + g * sk * d, dout + g * sq * d, out + g * sq * d, lse + g * sq,
      group_mask(kmask, heads, sk), dq + g * sq * d, delta + g * sq, sq, sk,
      kv_valid, scale, drop, blockIdx.x, vtt::mma::group_pad<D>(d));
}

// part as drop_bwd_dkv_mma_kernel's, rows d apart.
template <int D>
__global__ void __launch_bounds__(vtt::mma::kThreads)
drop_bwd_dkv_mma_padded_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const float* __restrict__ kmask,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               float* __restrict__ part, int heads, int sq,
                               int sk, int kv_valid, float scale,
                               vtt::Dropout drop, int per, int d) {
  const long long g = blockIdx.x;
  const int nq = (sq + vtt::mma::kCols - 1) / vtt::mma::kCols;
  const int t0 = blockIdx.z * per;
  const int t1 = min(nq, t0 + per);
  float *pk = nullptr, *pv = nullptr;
  if (part != nullptr) {
    const long long plane = static_cast<long long>(gridDim.x) * sk * d;
    pk = part + blockIdx.z * plane + g * sk * d;
    pv = part + (gridDim.z + blockIdx.z) * plane + g * sk * d;
  }
  vtt::mma::bwd_dkv_rows_mma<D, vtt::mma::GroupPad<D>>(
      blockIdx.y * vtt::mma::kRows, t0, t1, q + g * sq * d, k + g * sk * d,
      v + g * sk * d, dout + g * sq * d, lse + g * sq, delta + g * sq,
      group_mask(kmask, heads, sk), dk + g * sk * d, dv + g * sk * d, pk, pv,
      sq, sk, kv_valid, scale, drop, blockIdx.x, vtt::mma::group_pad<D>(d));
}

// ---- head dims above 128: attention_wide_tile.cuh's split of d across grid
// z, contiguous (G, S, d) groups; the dk/dv pass is not split along its
// query loop (its grid has ceil(d / 64) times the blocks already).

__global__ void __launch_bounds__(vtt::mma::kThreads)
drop_fwd_mma_wide_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ kmask,
                         bf16* __restrict__ out, float* __restrict__ lse,
                         int heads, int sq, int sk, int kv_valid, float scale,
                         vtt::Dropout drop, int d) {
  const long long g = blockIdx.x;
  vtt::wide::attend_rows_wide_mma<vtt::mma::KeyMask::AddFloat, true>(
      blockIdx.y * vtt::wide::kRows, blockIdx.z, q + g * sq * d,
      k + g * sk * d, v + g * sk * d, nullptr, out + g * sq * d,
      lse + g * sq, sq, sk, kv_valid, scale, group_mask(kmask, heads, sk),
      drop, blockIdx.x, tile_counts, vtt::wide::Rows{d, d, d, 1});
}

__global__ void __launch_bounds__(vtt::kThreads)
drop_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ kmask, float* __restrict__ out,
                     float* __restrict__ lse, int heads, int sq, int sk,
                     int kv_valid, float scale, vtt::Dropout drop, int d) {
  const long long g = blockIdx.x;
  vtt::wide::attend_rows_wide<vtt::mma::KeyMask::AddFloat>(
      blockIdx.y * vtt::kBlockQ, blockIdx.z, q + g * sq * d, k + g * sk * d,
      v + g * sk * d, nullptr, group_mask(kmask, heads, sk),
      out + g * sq * d, lse + g * sq, sq, sk, kv_valid, scale, drop,
      blockIdx.x, vtt::wide::Rows{d, d, d, 1});
}

__global__ void __launch_bounds__(vtt::mma::kThreads)
drop_bwd_dq_mma_wide_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const float* __restrict__ kmask,
                            const bf16* __restrict__ dout,
                            const bf16* __restrict__ out,
                            const float* __restrict__ lse,
                            bf16* __restrict__ dq, float* __restrict__ delta,
                            int heads, int sq, int sk, int kv_valid,
                            float scale, vtt::Dropout drop, int d) {
  const long long g = blockIdx.x;
  vtt::wide::bwd_dq_rows_wide_mma<true, vtt::mma::ScaledDs>(
      blockIdx.y * vtt::wide::kRows, blockIdx.z, q + g * sq * d,
      k + g * sk * d, v + g * sk * d, dout + g * sq * d, out + g * sq * d,
      lse + g * sq, group_mask(kmask, heads, sk), dq + g * sq * d,
      delta + g * sq, sq, sk, kv_valid, scale, drop, blockIdx.x,
      vtt::wide::Rows{d, d, d, 1});
}

__global__ void __launch_bounds__(vtt::mma::kThreads)
drop_bwd_dkv_mma_wide_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const float* __restrict__ kmask,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int heads, int sq, int sk, int kv_valid,
                             float scale, vtt::Dropout drop, int d) {
  const long long g = blockIdx.x;
  vtt::wide::bwd_dkv_rows_wide_mma<true, vtt::mma::ScaledDs>(
      blockIdx.y * vtt::wide::kRows, blockIdx.z, q + g * sq * d,
      k + g * sk * d, v + g * sk * d, dout + g * sq * d, lse + g * sq,
      delta + g * sq, group_mask(kmask, heads, sk), dk + g * sk * d,
      dv + g * sk * d, sq, sk, kv_valid, scale, drop, blockIdx.x,
      vtt::wide::Rows{d, d, d, 1});
}

__global__ void __launch_bounds__(vtt::kThreads)
drop_bwd_dq_wide_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ kmask,
                        const float* __restrict__ dout,
                        const float* __restrict__ out,
                        const float* __restrict__ lse, float* __restrict__ dq,
                        float* __restrict__ delta, int heads, int sq, int sk,
                        int kv_valid, float scale, vtt::Dropout drop, int d) {
  const long long g = blockIdx.x;
  vtt::wide::bwd_dq_rows_wide<vtt::mma::ScaledDs>(
      blockIdx.y * vtt::kBlockQ, blockIdx.z, q + g * sq * d, k + g * sk * d,
      v + g * sk * d, dout + g * sq * d, out + g * sq * d, lse + g * sq,
      group_mask(kmask, heads, sk), dq + g * sq * d, delta + g * sq, sq, sk,
      kv_valid, scale, drop, blockIdx.x, vtt::wide::Rows{d, d, d, 1});
}

__global__ void __launch_bounds__(vtt::kThreads)
drop_bwd_dkv_wide_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ kmask,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int heads, int sq, int sk, int kv_valid, float scale,
                         vtt::Dropout drop, int d) {
  const long long g = blockIdx.x;
  vtt::wide::bwd_dkv_rows_wide<vtt::mma::ScaledDs>(
      blockIdx.y * vtt::kBlockK, blockIdx.z, q + g * sq * d, k + g * sk * d,
      v + g * sk * d, dout + g * sq * d, lse + g * sq, delta + g * sq,
      group_mask(kmask, heads, sk), dk + g * sk * d, dv + g * sk * d, sq, sk,
      kv_valid, scale, drop, blockIdx.x, vtt::wide::Rows{d, d, d, 1});
}

int launch_wide(const Args& a, bool backward, int is_bf16) {
  const int d = a.d;
  const auto* kmask = static_cast<const float*>(a.kmask);
  const auto* lse = static_cast<const float*>(a.lse);
  auto* delta = static_cast<float*>(a.delta);
  int rc;
  if (is_bf16) {
    const auto* q = static_cast<const bf16*>(a.q);
    const auto* k = static_cast<const bf16*>(a.k);
    const auto* v = static_cast<const bf16*>(a.v);
    const int nc = vtt::wide::chunks(d, vtt::wide::kW);
    const dim3 grid_q(a.g, (a.sq + vtt::wide::kRows - 1) / vtt::wide::kRows,
                      nc);
    if (!backward) {
      drop_fwd_mma_wide_kernel<<<grid_q, vtt::mma::kThreads, 0, a.stream>>>(
          q, k, v, kmask, static_cast<bf16*>(const_cast<void*>(a.out)),
          static_cast<float*>(const_cast<void*>(a.lse)), a.heads, a.sq, a.sk,
          a.kv_valid, a.scale, a.drop, d);
      return vtt::launched("drop_fwd_mma_wide_kernel");
    }
    const auto* dout = static_cast<const bf16*>(a.dout);
    drop_bwd_dq_mma_wide_kernel<<<grid_q, vtt::mma::kThreads, 0, a.stream>>>(
        q, k, v, kmask, dout, static_cast<const bf16*>(a.out), lse,
        static_cast<bf16*>(a.dq), delta, a.heads, a.sq, a.sk, a.kv_valid,
        a.scale, a.drop, d);
    rc = vtt::launched("drop_bwd_dq_mma_wide_kernel");
    if (rc != 0) return rc;
    const dim3 grid_k(a.g, (a.sk + vtt::wide::kRows - 1) / vtt::wide::kRows,
                      vtt::wide::chunks(d, vtt::wide::kWkv));
    drop_bwd_dkv_mma_wide_kernel<<<grid_k, vtt::mma::kThreads, 0,
                                   a.stream>>>(
        q, k, v, kmask, dout, lse, delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.heads, a.sq, a.sk, a.kv_valid, a.scale,
        a.drop, d);
    return vtt::launched("drop_bwd_dkv_mma_wide_kernel");
  }
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);
  const int nc = vtt::wide::chunks(d, vtt::wide::kFW);
  const dim3 grid_q(a.g, (a.sq + vtt::kBlockQ - 1) / vtt::kBlockQ, nc);
  if (!backward) {
    drop_fwd_wide_kernel<<<grid_q, vtt::kThreads, 0, a.stream>>>(
        q, k, v, kmask, static_cast<float*>(const_cast<void*>(a.out)),
        static_cast<float*>(const_cast<void*>(a.lse)), a.heads, a.sq, a.sk,
        a.kv_valid, a.scale, a.drop, d);
    return vtt::launched("drop_fwd_wide_kernel");
  }
  const auto* dout = static_cast<const float*>(a.dout);
  drop_bwd_dq_wide_kernel<<<grid_q, vtt::kThreads, 0, a.stream>>>(
      q, k, v, kmask, dout, static_cast<const float*>(a.out), lse,
      static_cast<float*>(a.dq), delta, a.heads, a.sq, a.sk, a.kv_valid,
      a.scale, a.drop, d);
  rc = vtt::launched("drop_bwd_dq_wide_kernel");
  if (rc != 0) return rc;
  const dim3 grid_k(a.g, (a.sk + vtt::kBlockK - 1) / vtt::kBlockK, nc);
  drop_bwd_dkv_wide_kernel<<<grid_k, vtt::kThreads, 0, a.stream>>>(
      q, k, v, kmask, dout, lse, delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.heads, a.sq, a.sk, a.kv_valid, a.scale,
      a.drop, d);
  return vtt::launched("drop_bwd_dkv_wide_kernel");
}

// kPad: the head dim a.d runs in the tile of width D (a.d < D).
template <int D, bool kPad>
int launch_bwd_mma(const Args& a) {
  using vtt::mma::kCols;
  using vtt::mma::kRows;
  using vtt::mma::kThreads;
  constexpr int smem = vtt::mma::mma_dyn_bytes<D>();
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const float* kmask = static_cast<const float*>(a.kmask);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  const dim3 grid_q(a.g, (a.sq + kRows - 1) / kRows);
  int rc;
  if constexpr (kPad) {
    rc = vtt::allow_dynamic_smem(drop_bwd_dq_mma_padded_kernel<D>, smem);
    if (rc != 0) return rc;
    drop_bwd_dq_mma_padded_kernel<D><<<grid_q, kThreads, smem, a.stream>>>(
        q, k, v, kmask, dout, static_cast<const bf16*>(a.out), lse,
        static_cast<bf16*>(a.dq), delta, a.heads, a.sq, a.sk, a.kv_valid,
        a.scale, a.drop, a.d);
    rc = vtt::launched("drop_bwd_dq_mma_padded_kernel");
  } else {
    rc = vtt::allow_dynamic_smem(drop_bwd_dq_mma_kernel<D>, smem);
    if (rc != 0) return rc;
    drop_bwd_dq_mma_kernel<D><<<grid_q, kThreads, smem, a.stream>>>(
        q, k, v, kmask, dout, static_cast<const bf16*>(a.out), lse,
        static_cast<bf16*>(a.dq), delta, a.heads, a.sq, a.sk, a.kv_valid,
        a.scale, a.drop);
    rc = vtt::launched("drop_bwd_dq_mma_kernel");
  }
  if (rc != 0) return rc;
  const int nq = (a.sq + kCols - 1) / kCols;
  const int chunks = a.part == nullptr ? 1 : std::min(a.chunks, nq);
  const int per = (nq + chunks - 1) / chunks;
  const int z = (nq + per - 1) / per;  // <= chunks: no empty chunk
  const dim3 grid_k(a.g, (a.sk + kRows - 1) / kRows, z);
  float* part = z > 1 ? static_cast<float*>(a.part) : nullptr;
  if constexpr (kPad) {
    rc = vtt::allow_dynamic_smem(drop_bwd_dkv_mma_padded_kernel<D>, smem);
    if (rc != 0) return rc;
    drop_bwd_dkv_mma_padded_kernel<D><<<grid_k, kThreads, smem, a.stream>>>(
        q, k, v, kmask, dout, lse, delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), part, a.heads, a.sq, a.sk, a.kv_valid,
        a.scale, a.drop, per, a.d);
    rc = vtt::launched("drop_bwd_dkv_mma_padded_kernel");
  } else {
    rc = vtt::allow_dynamic_smem(drop_bwd_dkv_mma_kernel<D>, smem);
    if (rc != 0) return rc;
    drop_bwd_dkv_mma_kernel<D><<<grid_k, kThreads, smem, a.stream>>>(
        q, k, v, kmask, dout, lse, delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), part, a.heads, a.sq, a.sk, a.kv_valid,
        a.scale, a.drop, per);
    rc = vtt::launched("drop_bwd_dkv_mma_kernel");
  }
  if (rc != 0 || z == 1) return rc;
  const long long plane = static_cast<long long>(a.g) * a.sk * a.d;
  const int blocks = static_cast<int>(std::min(4096ll, (plane + 255) / 256));
  drop_bwd_dkv_sum_kernel<<<blocks, 256, 0, a.stream>>>(
      static_cast<const float*>(a.part), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), plane, z);
  return vtt::launched("drop_bwd_dkv_sum_kernel");
}

template <typename T, int D, bool kPad>
int launch_fwd(const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float* kmask = static_cast<const float*>(a.kmask);
  T* out = static_cast<T*>(const_cast<void*>(a.out));
  float* lse = static_cast<float*>(const_cast<void*>(a.lse));
  if constexpr (std::is_same_v<T, bf16>) {
    constexpr int rows = vtt::mma::fwd_rows<D>();
    const dim3 grid(a.g, (a.sq + rows - 1) / rows);
    if constexpr (kPad) {
      constexpr int smem = vtt::mma::mma_dyn_bytes<D>();
      const int rc =
          vtt::allow_dynamic_smem(drop_fwd_mma_padded_kernel<D>, smem);
      if (rc != 0) return rc;
      drop_fwd_mma_padded_kernel<D><<<grid, vtt::mma::kThreads, smem,
                                      a.stream>>>(
          q, k, v, kmask, out, lse, a.heads, a.sq, a.sk, a.kv_valid, a.scale,
          a.drop, a.d);
      return vtt::launched("drop_fwd_mma_padded_kernel");
    } else {
      constexpr int smem = vtt::mma::mma_dyn_bytes<D>();
      const int rc = vtt::allow_dynamic_smem(drop_fwd_mma_kernel<D>, smem);
      if (rc != 0) return rc;
      drop_fwd_mma_kernel<D><<<grid, vtt::mma::kThreads, smem, a.stream>>>(
          q, k, v, kmask, out, lse, a.heads, a.sq, a.sk, a.kv_valid, a.scale,
          a.drop);
      return vtt::launched("drop_fwd_mma_kernel");
    }
  } else {
    const dim3 grid(a.g, (a.sq + vtt::kBlockQ - 1) / vtt::kBlockQ);
    if constexpr (kPad) {
      constexpr int smem = vtt::attend_dyn_bytes<D>();
      const int rc = vtt::allow_dynamic_smem(drop_fwd_padded_kernel<T, D>,
                                             smem);
      if (rc != 0) return rc;
      drop_fwd_padded_kernel<T, D><<<grid, vtt::kThreads, smem, a.stream>>>(
          q, k, v, kmask, out, lse, a.heads, a.sq, a.sk, a.kv_valid, a.scale,
          a.drop, a.d);
      return vtt::launched("drop_fwd_padded_kernel");
    } else {
      constexpr int smem = vtt::attend_dyn_bytes<D>();
      const int rc = vtt::allow_dynamic_smem(drop_fwd_kernel<T, D>, smem);
      if (rc != 0) return rc;
      drop_fwd_kernel<T, D><<<grid, vtt::kThreads, smem, a.stream>>>(
          q, k, v, kmask, out, lse, a.heads, a.sq, a.sk, a.kv_valid, a.scale,
          a.drop);
      return vtt::launched("drop_fwd_kernel");
    }
  }
}

template <typename T, int D, bool kPad>
int launch_bwd(const Args& a) {
  if constexpr (std::is_same_v<T, bf16>) {
    return launch_bwd_mma<D, kPad>(a);
  } else {
    const T* q = static_cast<const T*>(a.q);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const T* dout = static_cast<const T*>(a.dout);
    const float* kmask = static_cast<const float*>(a.kmask);
    const float* lse = static_cast<const float*>(a.lse);
    float* delta = static_cast<float*>(a.delta);
    constexpr int smem = vtt::bwd_dyn_bytes<D>();
    const dim3 grid_q(a.g, (a.sq + vtt::kBlockQ - 1) / vtt::kBlockQ);
    int rc;
    if constexpr (kPad) {
      rc = vtt::allow_dynamic_smem(drop_bwd_dq_padded_kernel<T, D>, smem);
      if (rc != 0) return rc;
      drop_bwd_dq_padded_kernel<T, D><<<grid_q, vtt::kThreads, smem,
                                        a.stream>>>(
          q, k, v, kmask, dout, static_cast<const T*>(a.out), lse,
          static_cast<T*>(a.dq), delta, a.heads, a.sq, a.sk, a.kv_valid,
          a.scale, a.drop, a.d);
      rc = vtt::launched("drop_bwd_dq_padded_kernel");
    } else {
      rc = vtt::allow_dynamic_smem(drop_bwd_dq_kernel<T, D>, smem);
      if (rc != 0) return rc;
      drop_bwd_dq_kernel<T, D><<<grid_q, vtt::kThreads, smem, a.stream>>>(
          q, k, v, kmask, dout, static_cast<const T*>(a.out), lse,
          static_cast<T*>(a.dq), delta, a.heads, a.sq, a.sk, a.kv_valid,
          a.scale, a.drop);
      rc = vtt::launched("drop_bwd_dq_kernel");
    }
    if (rc != 0) return rc;
    const dim3 grid_k(a.g, (a.sk + vtt::kBlockK - 1) / vtt::kBlockK);
    if constexpr (kPad) {
      rc = vtt::allow_dynamic_smem(drop_bwd_dkv_padded_kernel<T, D>, smem);
      if (rc != 0) return rc;
      drop_bwd_dkv_padded_kernel<T, D><<<grid_k, vtt::kThreads, smem,
                                         a.stream>>>(
          q, k, v, kmask, dout, lse, delta, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), a.heads, a.sq, a.sk, a.kv_valid, a.scale,
          a.drop, a.d);
      return vtt::launched("drop_bwd_dkv_padded_kernel");
    } else {
      rc = vtt::allow_dynamic_smem(drop_bwd_dkv_kernel<T, D>, smem);
      if (rc != 0) return rc;
      drop_bwd_dkv_kernel<T, D><<<grid_k, vtt::kThreads, smem, a.stream>>>(
          q, k, v, kmask, dout, lse, delta, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), a.heads, a.sq, a.sk, a.kv_valid, a.scale,
          a.drop);
      return vtt::launched("drop_bwd_dkv_kernel");
    }
  }
}

template <typename T, int D, bool kPad>
int launch_dir(const Args& a, bool backward) {
  return backward ? launch_bwd<T, D, kPad>(a) : launch_fwd<T, D, kPad>(a);
}

template <typename T>
int dispatch_d(const Args& a, bool backward) {
  switch (a.d) {
    case 16: return launch_dir<T, 16, false>(a, backward);
    case 32: return launch_dir<T, 32, false>(a, backward);
    case 64: return launch_dir<T, 64, false>(a, backward);
    case 128: return launch_dir<T, 128, false>(a, backward);
    default:
      if (a.d < 1) return static_cast<int>(cudaErrorInvalidValue);
      if (a.d > 128)
        return launch_wide(a, backward, std::is_same_v<T, bf16>);
      return a.d < 16   ? launch_dir<T, 16, true>(a, backward)
             : a.d < 32 ? launch_dir<T, 32, true>(a, backward)
             : a.d < 64 ? launch_dir<T, 64, true>(a, backward)
                        : launch_dir<T, 128, true>(a, backward);
  }
}

int dispatch(const Args& a, int is_bf16, bool backward) {
  if (a.g < 1 || a.heads < 1 || a.g % a.heads != 0 || a.sq < 1 || a.sk < 1 ||
      a.kv_valid < 1 || a.kv_valid > a.sk ||
      (backward && is_bf16 && a.part != nullptr && a.chunks < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto addr = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  // the tensor-core kernels read bf16 operands with copies of
  // align_mask(d)'s width (the forward's q, k, v, out; the backward's also
  // do, dq, dk, dv; unused ones are null here)
  if (is_bf16 &&
      ((addr(a.q) | addr(a.k) | addr(a.v) | addr(a.dout) | addr(a.out) |
        addr(a.dq) | addr(a.dk) | addr(a.dv)) & vtt::mma::align_mask(a.d)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(a, backward)
                 : dispatch_d<float>(a, backward);
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of a launch. kmask may be null; its
// values must be 0 or -0.7·FLT_MAX (what _key_mask_add makes; the bf16
// forward skips the tiles past the last one that holds a key < kv_valid
// whose value is 0). is_bf16: 1 = bf16, 0 = fp32. drop_thresh =
// min(int(rate·2^32), 2^32 − 1), 0 for no dropout; inv_keep = 1/(1 − rate);
// seed: the mask's 64-bit seed. d >= 1.
// A bf16 q, k, v or out off its copies' grain (attention_mma_tile.cuh's
// align_mask(d)) is refused (cudaErrorMisalignedAddress).
int dropout_attention_fwd(const void* q, const void* k, const void* v,
                          const void* kmask, void* out, void* lse, int g,
                          int heads, int sq, int sk, int d, int kv_valid,
                          float scale, int is_bf16, unsigned int drop_thresh,
                          float inv_keep, unsigned long long seed,
                          void* stream) {
  const Args a{q, k, v, kmask, nullptr, out, lse, nullptr, nullptr, nullptr,
               nullptr, nullptr, g, heads, sq, sk, d, kv_valid, 1, scale,
               vtt::make_dropout(drop_thresh, inv_keep, seed),
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, is_bf16, false);
}

// delta: fp32 scratch of G·Sq elements (δ = rowsum(do ⊙ out), written by the
// first pass and read by the second). bf16 only: part, null or fp32 scratch
// of 2·chunks·G·Sk·d elements, splits the dk/dv pass's query loop into
// `chunks` ranges (1 = no split, part may be null; d > 128 never splits). A bf16 q, k, v, do, out,
// dq, dk or dv that is not 16-byte aligned is refused
// (cudaErrorMisalignedAddress).
int dropout_attention_bwd(const void* q, const void* k, const void* v,
                          const void* kmask, const void* dout, const void* out,
                          const void* lse, void* dq, void* dk, void* dv,
                          void* delta, void* part, int g, int heads, int sq,
                          int sk, int d, int kv_valid, int chunks, float scale,
                          int is_bf16, unsigned int drop_thresh,
                          float inv_keep, unsigned long long seed,
                          void* stream) {
  const Args a{q, k, v, kmask, dout, out, lse, dq, dk, dv, delta,
               chunks > 1 ? part : nullptr, g, heads, sq, sk, d, kv_valid,
               chunks, scale,
               vtt::make_dropout(drop_thresh, inv_keep, seed),
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, is_bf16, true);
}

// Copies the two tile counts of the bf16 forward into counts, and zeroes
// them. Returns 0 or the cudaError_t of the copies.
int dropout_attention_tile_counts(unsigned long long* counts) {
  const unsigned long long zero[2] = {0ull, 0ull};
  cudaError_t e = cudaMemcpyFromSymbol(counts, tile_counts, sizeof zero);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(tile_counts, zero, sizeof zero);
  return static_cast<int>(e);
}

const char* dropout_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
