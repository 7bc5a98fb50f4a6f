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
// and keep the S×S scores on chip. Two forward routes, by dtype:
//   bf16: packed_fwd_mma_kernel on attention_mma_tile.cuh's attend_rows_mma
//     with the Strided layout (q, k and v rows 3·H·dh apart, out rows H·dh
//     apart, lse H apart), so the tensor-core tile of rows 2, 3 and 5 reads
//     the projection and writes out and lse in place; <D, NoMask, false> at
//     rate 0, <D, NoMask, true> (dropout_keep4's bits, one Philox call per
//     four probabilities) at rate > 0. Grid: x = B·H groups, y = ceil(S /
//     128) (dh 16, 32) or ceil(S / 64) (dh 64); 128 threads. At S 197 the
//     last 64-key tile holds 5 live keys, computed and masked by index. The
//     qkv and out pointers must be 16-byte aligned (checked here): K and V
//     stream by 16-byte cp.async.
//   fp32: packed_fwd_kernel on attend_rows (attention_tile.cuh), fp32 FMAs
//     on the CUDA cores, 32 × 32 tiles in shared memory; grid x = B·H,
//     y = ceil(S / 32), 128 threads; each block re-reads its group's other
//     operands (L2-resident).
// Two backward routes, by dtype; both replay either forward route's mask,
// the keep bit of (b·H + h, row, column) from philox.cuh:
//   bf16: packed_bwd_dq_mma_kernel, then packed_bwd_dkv_mma_kernel, on
//     attention_bwd_mma_tile.cuh's two passes with the Strided layout (q, k,
//     v and dq, dk, dv rows 3·H·dh apart, do and out H·dh, lse H), so the
//     tensor-core backward of row 6 reads the projection and writes dqkv in
//     place; <D, false> at rate 0 (no dropout code), <D, true> at rate > 0.
//     pd and ds are rounded to bf16 before their products, as
//     _packed_bwd_kernel does (:875-879). Grids x = B·H, y = ceil(S / 64)
//     query rows (pass 1) or keys (pass 2), 128 threads. The dk/dv pass is
//     not split along its query loop (row 6's dkv_chunks): the main path's
//     grids fill the card (ViT-B at batch 32: 384 groups × 4 key tiles =
//     1536 blocks; vit_tiny at batch 64: 512). The qkv, do, out and dqkv
//     pointers must be 16-byte aligned (checked here).
//   fp32: the two passes of attention_bwd_tile.cuh on the CUDA cores, each
//     with the forward's fp32 grid (its y counts query tiles, then key
//     tiles).
// Head dims: dh 16, 32 and 64 are instantiations of these kernels. Any other
// dh from 1 to 128 (ViT-H/14's 80 at S 257, TNT's 12, 128) runs in the next
// tile width, 16, 32, 64 or 128 (D 128 with its tile buffers in dynamic
// shared memory), with the columns past dh read as zeros and not written:
// the *_padded_kernel kernels, on attention_mma_tile.cuh's PaddedStrided
// layout in bf16 (q, k and v still read in place at row stride 3·H·dh; K/V
// tiles by 16-byte cp.async for dh a multiple of 8, 4-byte for an even dh,
// 2-byte loads for an odd one: the widest copy every head offset h·dh keeps
// aligned) and the fp32 tiles' kPad in fp32. The in-kernel dropout draws the
// same keep bits at every dh: f(seed, b·H + h, row, column). Zero-padding
// dh 80 into the 128 tile spends 37.5% of the tile's products on zeros.
// A dh above 128 (ViT-B/16's widths at 3 heads: 256) takes the *_wide_kernel
// kernels of attention_wide_tile.cuh: grid z splits dh into output chunks
// (bf16: 128 columns a forward or dq block, 64 a dk/dv block; fp32: 64),
// each block summing the scores over every chunk of q and k (or do and v)
// itself; q, k, v read and dqkv written in place as above, head h's chunk j
// at column h·dh + j·W of its section.
#include <cstdint>
#include <type_traits>

#include "attention_bwd_mma_tile.cuh"
#include "attention_bwd_tile.cuh"
#include "attention_mma_tile.cuh"
#include "attention_wide_tile.cuh"
#include "launch_log.cuh"

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
  vtt::attend_rows<T, D>(blockIdx.y * vtt::kBlockQ, q, 3 * g.hd, q + g.hd,
                         q + 2 * g.hd, 3 * g.hd,
                         nullptr, 0, nullptr,
                         out + g.unpacked(), g.hd,
                         lse + g.lse(), heads,
                         s, s, kv_valid, scale, drop, blockIdx.x);
}

// rate 0 (kDrop false) and rate > 0 (kDrop true); both take drop, the first
// ignores it.
template <int D, bool kDrop>
__global__ void __launch_bounds__(vtt::mma::kThreads)
packed_fwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int s, int heads, int kv_valid,
                      float scale, vtt::Dropout drop) {
  const PackedGroup<__nv_bfloat16, D> g(s, heads);
  const __nv_bfloat16* q = qkv + g.packed();
  vtt::mma::attend_rows_mma<D, vtt::mma::KeyMask::NoMask, kDrop,
                            vtt::mma::Strided>(
      blockIdx.y * vtt::mma::fwd_rows<D>(), q, q + g.hd, q + 2 * g.hd,
      nullptr, out + g.unpacked(), lse + g.lse(), s, s, kv_valid, scale,
      nullptr, drop, blockIdx.x, nullptr,
      vtt::mma::Strided{static_cast<int>(3 * g.hd), static_cast<int>(g.hd),
                        heads});
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

// rate 0 (kDrop false) and rate > 0 (kDrop true), as the forward; delta:
// B·H·S fp32, S per group.
template <int D, bool kDrop>
__global__ void __launch_bounds__(vtt::mma::kThreads)
packed_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const __nv_bfloat16* __restrict__ dout,
                         const __nv_bfloat16* __restrict__ out,
                         const float* __restrict__ lse,
                         __nv_bfloat16* __restrict__ dqkv,
                         float* __restrict__ delta, int s, int heads,
                         int kv_valid, float scale, vtt::Dropout drop) {
  const PackedGroup<__nv_bfloat16, D> g(s, heads);
  const __nv_bfloat16* q = qkv + g.packed();
  vtt::mma::bwd_dq_rows_mma<D, vtt::mma::Strided, kDrop>(
      blockIdx.y * vtt::mma::kRows, q, q + g.hd, q + 2 * g.hd,
      dout + g.unpacked(), out + g.unpacked(), lse + g.lse(), nullptr,
      dqkv + g.packed(), delta + static_cast<long long>(blockIdx.x) * s, s,
      s, kv_valid, scale, drop, blockIdx.x,
      vtt::mma::Strided{static_cast<int>(3 * g.hd), static_cast<int>(g.hd),
                        heads});
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(vtt::mma::kThreads)
packed_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dqkv, int s, int heads,
                          int kv_valid, float scale, vtt::Dropout drop) {
  const PackedGroup<__nv_bfloat16, D> g(s, heads);
  const __nv_bfloat16* q = qkv + g.packed();
  __nv_bfloat16* dq = dqkv + g.packed();
  vtt::mma::bwd_dkv_rows_mma<D, vtt::mma::Strided, kDrop>(
      blockIdx.y * vtt::mma::kRows, 0, (s + vtt::mma::kCols - 1) /
      vtt::mma::kCols, q, q + g.hd, q + 2 * g.hd, dout + g.unpacked(),
      lse + g.lse(), delta + static_cast<long long>(blockIdx.x) * s, nullptr,
      dq + g.hd, dq + 2 * g.hd, nullptr, nullptr, s, s, kv_valid, scale,
      drop, blockIdx.x,
      vtt::mma::Strided{static_cast<int>(3 * g.hd), static_cast<int>(g.hd),
                        heads});
}

// ---- head dims other than 16, 32 and 64: the tile of width D (16, 32, 64 or
// 128), the columns d .. D read as zeros and not written; d runtime.

// Row 0 of head h of image b, as PackedGroup, at a head width d known at run
// time.
struct PackedGroupD {
  long long b, h, hd, d;
  int s, heads;
  __device__ PackedGroupD(int s_, int heads_, int d_)
      : b(blockIdx.x / heads_), h(blockIdx.x % heads_),
        hd(static_cast<long long>(heads_) * d_), d(d_), s(s_),
        heads(heads_) {}
  __device__ long long packed() const { return b * s * 3 * hd + h * d; }
  __device__ long long unpacked() const { return b * s * hd + h * d; }
  __device__ long long lse() const { return b * s * heads + h; }
  // q, k, v rows 3·H·d apart, do and out H·d, lse H
  template <int D>
  __device__ vtt::mma::PaddedStrided<D> layout() const {
    return vtt::mma::PaddedStrided<D>{static_cast<int>(d),
                                      static_cast<int>(3 * hd),
                                      static_cast<int>(hd), heads};
  }
  // the same rows for attention_wide_tile.cuh (dh > 128)
  __device__ vtt::wide::Rows wide() const {
    return vtt::wide::Rows{static_cast<int>(d), 3 * hd, hd, heads};
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
packed_fwd_padded_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                         float* __restrict__ lse, int s, int heads,
                         int kv_valid, float scale, vtt::Dropout drop,
                         int d) {
  const PackedGroupD g(s, heads, d);
  const T* q = qkv + g.packed();
  vtt::attend_rows<T, D, vtt::PlainLoads, true>(
      blockIdx.y * vtt::kBlockQ, q, 3 * g.hd, q + g.hd, q + 2 * g.hd,
      3 * g.hd, nullptr, 0, nullptr, out + g.unpacked(), g.hd, lse + g.lse(),
      heads, s, s, kv_valid, scale, drop, blockIdx.x, d);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(vtt::mma::kThreads)
packed_fwd_mma_padded_kernel(const __nv_bfloat16* __restrict__ qkv,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int s, int heads,
                             int kv_valid, float scale, vtt::Dropout drop,
                             int d) {
  const PackedGroupD g(s, heads, d);
  const __nv_bfloat16* q = qkv + g.packed();
  vtt::mma::attend_rows_mma<D, vtt::mma::KeyMask::NoMask, kDrop,
                            vtt::mma::PaddedStrided<D>>(
      blockIdx.y * vtt::mma::fwd_rows<D>(), q, q + g.hd, q + 2 * g.hd,
      nullptr, out + g.unpacked(), lse + g.lse(), s, s, kv_valid, scale,
      nullptr, drop, blockIdx.x, nullptr, g.layout<D>());
}

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
packed_bwd_dq_padded_kernel(const T* __restrict__ qkv,
                            const T* __restrict__ dout,
                            const T* __restrict__ out,
                            const float* __restrict__ lse,
                            T* __restrict__ dqkv, float* __restrict__ delta,
                            int s, int heads, int kv_valid, float scale,
                            vtt::Dropout drop, int d) {
  const PackedGroupD g(s, heads, d);
  const T* q = qkv + g.packed();
  vtt::bwd_dq_rows<T, D, true>(
      q, 3 * g.hd, q + g.hd, q + 2 * g.hd, 3 * g.hd, dout + g.unpacked(),
      out + g.unpacked(), g.hd, lse + g.lse(), heads, nullptr,
      dqkv + g.packed(), 3 * g.hd,
      delta + static_cast<long long>(blockIdx.x) * s, s, s, kv_valid, scale,
      drop, blockIdx.x, d);
}

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
packed_bwd_dkv_padded_kernel(const T* __restrict__ qkv,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dqkv, int s, int heads,
                             int kv_valid, float scale, vtt::Dropout drop,
                             int d) {
  const PackedGroupD g(s, heads, d);
  const T* q = qkv + g.packed();
  T* dq = dqkv + g.packed();
  vtt::bwd_dkv_rows<T, D, true>(
      q, 3 * g.hd, q + g.hd, q + 2 * g.hd, 3 * g.hd, dout + g.unpacked(),
      g.hd, lse + g.lse(), heads,
      delta + static_cast<long long>(blockIdx.x) * s, nullptr, dq + g.hd,
      dq + 2 * g.hd, 3 * g.hd, s, s, kv_valid, scale, drop, blockIdx.x, d);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(vtt::mma::kThreads)
packed_bwd_dq_mma_padded_kernel(const __nv_bfloat16* __restrict__ qkv,
                                const __nv_bfloat16* __restrict__ dout,
                                const __nv_bfloat16* __restrict__ out,
                                const float* __restrict__ lse,
                                __nv_bfloat16* __restrict__ dqkv,
                                float* __restrict__ delta, int s, int heads,
                                int kv_valid, float scale, vtt::Dropout drop,
                                int d) {
  const PackedGroupD g(s, heads, d);
  const __nv_bfloat16* q = qkv + g.packed();
  vtt::mma::bwd_dq_rows_mma<D, vtt::mma::PaddedStrided<D>, kDrop>(
      blockIdx.y * vtt::mma::kRows, q, q + g.hd, q + 2 * g.hd,
      dout + g.unpacked(), out + g.unpacked(), lse + g.lse(), nullptr,
      dqkv + g.packed(), delta + static_cast<long long>(blockIdx.x) * s, s,
      s, kv_valid, scale, drop, blockIdx.x, g.layout<D>());
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(vtt::mma::kThreads)
packed_bwd_dkv_mma_padded_kernel(const __nv_bfloat16* __restrict__ qkv,
                                 const __nv_bfloat16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 __nv_bfloat16* __restrict__ dqkv, int s,
                                 int heads, int kv_valid, float scale,
                                 vtt::Dropout drop, int d) {
  const PackedGroupD g(s, heads, d);
  const __nv_bfloat16* q = qkv + g.packed();
  __nv_bfloat16* dq = dqkv + g.packed();
  vtt::mma::bwd_dkv_rows_mma<D, vtt::mma::PaddedStrided<D>, kDrop>(
      blockIdx.y * vtt::mma::kRows, 0, (s + vtt::mma::kCols - 1) /
      vtt::mma::kCols, q, q + g.hd, q + 2 * g.hd, dout + g.unpacked(),
      lse + g.lse(), delta + static_cast<long long>(blockIdx.x) * s, nullptr,
      dq + g.hd, dq + 2 * g.hd, nullptr, nullptr, s, s, kv_valid, scale,
      drop, blockIdx.x, g.layout<D>());
}

// ---- head dims above 128: attention_wide_tile.cuh's split of dh across
// grid z (bf16: 128 columns a forward or dq block, 64 a dk/dv block; fp32:
// 64), q, k and v still read in place.

template <bool kDrop>
__global__ void __launch_bounds__(vtt::mma::kThreads)
packed_fwd_mma_wide_kernel(const __nv_bfloat16* __restrict__ qkv,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int s, int heads,
                           int kv_valid, float scale, vtt::Dropout drop,
                           int d) {
  const PackedGroupD g(s, heads, d);
  const __nv_bfloat16* q = qkv + g.packed();
  vtt::wide::attend_rows_wide_mma<vtt::mma::KeyMask::NoMask, kDrop>(
      blockIdx.y * vtt::wide::kRows, blockIdx.z, q, q + g.hd, q + 2 * g.hd,
      nullptr, out + g.unpacked(), lse + g.lse(), s, s, kv_valid, scale,
      nullptr, drop, blockIdx.x, nullptr, g.wide());
}

__global__ void __launch_bounds__(vtt::kThreads)
packed_fwd_wide_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                       float* __restrict__ lse, int s, int heads,
                       int kv_valid, float scale, vtt::Dropout drop, int d) {
  const PackedGroupD g(s, heads, d);
  const float* q = qkv + g.packed();
  vtt::wide::attend_rows_wide<vtt::mma::KeyMask::NoMask>(
      blockIdx.y * vtt::kBlockQ, blockIdx.z, q, q + g.hd, q + 2 * g.hd,
      nullptr, nullptr, out + g.unpacked(), lse + g.lse(), s, s, kv_valid,
      scale, drop, blockIdx.x, g.wide());
}

template <bool kDrop>
__global__ void __launch_bounds__(vtt::mma::kThreads)
packed_bwd_dq_mma_wide_kernel(const __nv_bfloat16* __restrict__ qkv,
                              const __nv_bfloat16* __restrict__ dout,
                              const __nv_bfloat16* __restrict__ out,
                              const float* __restrict__ lse,
                              __nv_bfloat16* __restrict__ dqkv,
                              float* __restrict__ delta, int s, int heads,
                              int kv_valid, float scale, vtt::Dropout drop,
                              int d) {
  const PackedGroupD g(s, heads, d);
  const __nv_bfloat16* q = qkv + g.packed();
  vtt::wide::bwd_dq_rows_wide_mma<kDrop, vtt::mma::ScaledDs>(
      blockIdx.y * vtt::wide::kRows, blockIdx.z, q, q + g.hd, q + 2 * g.hd,
      dout + g.unpacked(), out + g.unpacked(), lse + g.lse(), nullptr,
      dqkv + g.packed(), delta + static_cast<long long>(blockIdx.x) * s, s,
      s, kv_valid, scale, drop, blockIdx.x, g.wide());
}

template <bool kDrop>
__global__ void __launch_bounds__(vtt::mma::kThreads)
packed_bwd_dkv_mma_wide_kernel(const __nv_bfloat16* __restrict__ qkv,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dqkv, int s,
                               int heads, int kv_valid, float scale,
                               vtt::Dropout drop, int d) {
  const PackedGroupD g(s, heads, d);
  const __nv_bfloat16* q = qkv + g.packed();
  __nv_bfloat16* dq = dqkv + g.packed();
  vtt::wide::bwd_dkv_rows_wide_mma<kDrop, vtt::mma::ScaledDs>(
      blockIdx.y * vtt::wide::kRows, blockIdx.z, q, q + g.hd, q + 2 * g.hd,
      dout + g.unpacked(), lse + g.lse(),
      delta + static_cast<long long>(blockIdx.x) * s, nullptr, dq + g.hd,
      dq + 2 * g.hd, s, s, kv_valid, scale, drop, blockIdx.x, g.wide());
}

__global__ void __launch_bounds__(vtt::kThreads)
packed_bwd_dq_wide_kernel(const float* __restrict__ qkv,
                          const float* __restrict__ dout,
                          const float* __restrict__ out,
                          const float* __restrict__ lse,
                          float* __restrict__ dqkv, float* __restrict__ delta,
                          int s, int heads, int kv_valid, float scale,
                          vtt::Dropout drop, int d) {
  const PackedGroupD g(s, heads, d);
  const float* q = qkv + g.packed();
  vtt::wide::bwd_dq_rows_wide<vtt::mma::ScaledDs>(
      blockIdx.y * vtt::kBlockQ, blockIdx.z, q, q + g.hd, q + 2 * g.hd,
      dout + g.unpacked(), out + g.unpacked(), lse + g.lse(), nullptr,
      dqkv + g.packed(), delta + static_cast<long long>(blockIdx.x) * s, s,
      s, kv_valid, scale, drop, blockIdx.x, g.wide());
}

__global__ void __launch_bounds__(vtt::kThreads)
packed_bwd_dkv_wide_kernel(const float* __restrict__ qkv,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dqkv, int s, int heads,
                           int kv_valid, float scale, vtt::Dropout drop,
                           int d) {
  const PackedGroupD g(s, heads, d);
  const float* q = qkv + g.packed();
  float* dq = dqkv + g.packed();
  vtt::wide::bwd_dkv_rows_wide<vtt::mma::ScaledDs>(
      blockIdx.y * vtt::kBlockK, blockIdx.z, q, q + g.hd, q + 2 * g.hd,
      dout + g.unpacked(), lse + g.lse(),
      delta + static_cast<long long>(blockIdx.x) * s, nullptr, dq + g.hd,
      dq + 2 * g.hd, s, s, kv_valid, scale, drop, blockIdx.x, g.wide());
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
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    constexpr int rows = vtt::mma::fwd_rows<D>();
    const dim3 grid(a.b * a.heads, (a.s + rows - 1) / rows);
    const auto* qkv = static_cast<const T*>(a.qkv);
    auto* out = static_cast<T*>(const_cast<void*>(a.out));
    auto* lse = static_cast<float*>(const_cast<void*>(a.lse));
    if (a.drop.thresh != 0u)
      packed_fwd_mma_kernel<D, true><<<grid, vtt::mma::kThreads, 0,
                                       a.stream>>>(
          qkv, out, lse, a.s, a.heads, a.kv_valid, a.scale, a.drop);
    else
      packed_fwd_mma_kernel<D, false><<<grid, vtt::mma::kThreads, 0,
                                        a.stream>>>(
          qkv, out, lse, a.s, a.heads, a.kv_valid, a.scale, a.drop);
    return vtt::launched("packed_fwd_mma_kernel");
  } else {
    const dim3 grid(a.b * a.heads, (a.s + vtt::kBlockQ - 1) / vtt::kBlockQ);
    packed_fwd_kernel<T, D><<<grid, vtt::kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.qkv),
        static_cast<T*>(const_cast<void*>(a.out)),
        static_cast<float*>(const_cast<void*>(a.lse)), a.s, a.heads,
        a.kv_valid, a.scale, a.drop);
    return vtt::launched("packed_fwd_kernel");
  }
}

template <int D, bool kDrop>
int launch_bwd_mma(const Args& a) {
  using bf16 = __nv_bfloat16;
  const dim3 grid(a.b * a.heads,
                  (a.s + vtt::mma::kRows - 1) / vtt::mma::kRows);
  const auto* qkv = static_cast<const bf16*>(a.qkv);
  const auto* dout = static_cast<const bf16*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse);
  auto* dqkv = static_cast<bf16*>(a.dqkv);
  auto* delta = static_cast<float*>(a.delta);
  packed_bwd_dq_mma_kernel<D, kDrop><<<grid, vtt::mma::kThreads, 0,
                                       a.stream>>>(
      qkv, dout, static_cast<const bf16*>(a.out), lse, dqkv, delta, a.s,
      a.heads, a.kv_valid, a.scale, a.drop);
  int rc = vtt::launched("packed_bwd_dq_mma_kernel");
  if (rc != 0) return rc;
  packed_bwd_dkv_mma_kernel<D, kDrop><<<grid, vtt::mma::kThreads, 0,
                                        a.stream>>>(
      qkv, dout, lse, delta, dqkv, a.s, a.heads, a.kv_valid, a.scale,
      a.drop);
  return vtt::launched("packed_bwd_dkv_mma_kernel");
}

template <typename T, int D>
int launch_bwd(const Args& a) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return a.drop.thresh != 0u ? launch_bwd_mma<D, true>(a)
                               : launch_bwd_mma<D, false>(a);
  } else {
    const dim3 grid(a.b * a.heads, (a.s + vtt::kBlockQ - 1) / vtt::kBlockQ);
    packed_bwd_dq_kernel<T, D><<<grid, vtt::kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.qkv), static_cast<const T*>(a.dout),
        static_cast<const T*>(a.out), static_cast<const float*>(a.lse),
        static_cast<T*>(a.dqkv), static_cast<float*>(a.delta), a.s, a.heads,
        a.kv_valid, a.scale, a.drop);
    int rc = vtt::launched("packed_bwd_dq_kernel");
    if (rc != 0) return rc;
    packed_bwd_dkv_kernel<T, D><<<grid, vtt::kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.qkv), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dqkv), a.s, a.heads, a.kv_valid, a.scale, a.drop);
    return vtt::launched("packed_bwd_dkv_kernel");
  }
}

// The padded kernels: head width dh in the tile of width D (D 128 takes its
// tile buffers from dynamic shared memory).
template <typename T, int D>
int launch_fwd_padded(const Args& a, int dh) {
  const auto* qkv = static_cast<const T*>(a.qkv);
  auto* out = static_cast<T*>(const_cast<void*>(a.out));
  auto* lse = static_cast<float*>(const_cast<void*>(a.lse));
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    constexpr int rows = vtt::mma::fwd_rows<D>();
    constexpr int smem = vtt::mma::mma_dyn_bytes<D>();
    const dim3 grid(a.b * a.heads, (a.s + rows - 1) / rows);
    int rc;
    if (a.drop.thresh != 0u) {
      rc = vtt::allow_dynamic_smem(packed_fwd_mma_padded_kernel<D, true>,
                                   smem);
      if (rc != 0) return rc;
      packed_fwd_mma_padded_kernel<D, true><<<grid, vtt::mma::kThreads, smem,
                                              a.stream>>>(
          qkv, out, lse, a.s, a.heads, a.kv_valid, a.scale, a.drop, dh);
    } else {
      rc = vtt::allow_dynamic_smem(packed_fwd_mma_padded_kernel<D, false>,
                                   smem);
      if (rc != 0) return rc;
      packed_fwd_mma_padded_kernel<D, false><<<grid, vtt::mma::kThreads,
                                               smem, a.stream>>>(
          qkv, out, lse, a.s, a.heads, a.kv_valid, a.scale, a.drop, dh);
    }
    return vtt::launched("packed_fwd_mma_padded_kernel");
  } else {
    constexpr int smem = vtt::attend_dyn_bytes<D>();
    const int rc = vtt::allow_dynamic_smem(packed_fwd_padded_kernel<T, D>,
                                           smem);
    if (rc != 0) return rc;
    const dim3 grid(a.b * a.heads, (a.s + vtt::kBlockQ - 1) / vtt::kBlockQ);
    packed_fwd_padded_kernel<T, D><<<grid, vtt::kThreads, smem, a.stream>>>(
        qkv, out, lse, a.s, a.heads, a.kv_valid, a.scale, a.drop, dh);
    return vtt::launched("packed_fwd_padded_kernel");
  }
}

template <int D, bool kDrop>
int launch_bwd_mma_padded(const Args& a, int dh) {
  using bf16 = __nv_bfloat16;
  constexpr int smem = vtt::mma::mma_dyn_bytes<D>();
  const dim3 grid(a.b * a.heads,
                  (a.s + vtt::mma::kRows - 1) / vtt::mma::kRows);
  const auto* qkv = static_cast<const bf16*>(a.qkv);
  const auto* dout = static_cast<const bf16*>(a.dout);
  const auto* lse = static_cast<const float*>(a.lse);
  auto* dqkv = static_cast<bf16*>(a.dqkv);
  auto* delta = static_cast<float*>(a.delta);
  int rc = vtt::allow_dynamic_smem(packed_bwd_dq_mma_padded_kernel<D, kDrop>,
                                   smem);
  if (rc != 0) return rc;
  packed_bwd_dq_mma_padded_kernel<D, kDrop><<<grid, vtt::mma::kThreads, smem,
                                              a.stream>>>(
      qkv, dout, static_cast<const bf16*>(a.out), lse, dqkv, delta, a.s,
      a.heads, a.kv_valid, a.scale, a.drop, dh);
  rc = vtt::launched("packed_bwd_dq_mma_padded_kernel");
  if (rc != 0) return rc;
  rc = vtt::allow_dynamic_smem(packed_bwd_dkv_mma_padded_kernel<D, kDrop>,
                               smem);
  if (rc != 0) return rc;
  packed_bwd_dkv_mma_padded_kernel<D, kDrop><<<grid, vtt::mma::kThreads,
                                               smem, a.stream>>>(
      qkv, dout, lse, delta, dqkv, a.s, a.heads, a.kv_valid, a.scale, a.drop,
      dh);
  return vtt::launched("packed_bwd_dkv_mma_padded_kernel");
}

template <typename T, int D>
int launch_bwd_padded(const Args& a, int dh) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return a.drop.thresh != 0u ? launch_bwd_mma_padded<D, true>(a, dh)
                               : launch_bwd_mma_padded<D, false>(a, dh);
  } else {
    constexpr int smem = vtt::bwd_dyn_bytes<D>();
    const dim3 grid(a.b * a.heads, (a.s + vtt::kBlockQ - 1) / vtt::kBlockQ);
    int rc = vtt::allow_dynamic_smem(packed_bwd_dq_padded_kernel<T, D>, smem);
    if (rc != 0) return rc;
    packed_bwd_dq_padded_kernel<T, D><<<grid, vtt::kThreads, smem,
                                        a.stream>>>(
        static_cast<const T*>(a.qkv), static_cast<const T*>(a.dout),
        static_cast<const T*>(a.out), static_cast<const float*>(a.lse),
        static_cast<T*>(a.dqkv), static_cast<float*>(a.delta), a.s, a.heads,
        a.kv_valid, a.scale, a.drop, dh);
    rc = vtt::launched("packed_bwd_dq_padded_kernel");
    if (rc != 0) return rc;
    rc = vtt::allow_dynamic_smem(packed_bwd_dkv_padded_kernel<T, D>, smem);
    if (rc != 0) return rc;
    packed_bwd_dkv_padded_kernel<T, D><<<grid, vtt::kThreads, smem,
                                         a.stream>>>(
        static_cast<const T*>(a.qkv), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dqkv), a.s, a.heads, a.kv_valid, a.scale, a.drop,
        dh);
    return vtt::launched("packed_bwd_dkv_padded_kernel");
  }
}

template <typename T, int D>
int launch_padded(const Args& a, int dh, bool backward) {
  return backward ? launch_bwd_padded<T, D>(a, dh)
                  : launch_fwd_padded<T, D>(a, dh);
}

// The wide kernels (dh > 128): grid z the output chunks.
int launch_wide(const Args& a, int dh, bool backward, int is_bf16) {
  using bf16 = __nv_bfloat16;
  int rc;
  if (is_bf16) {
    const auto* qkv = static_cast<const bf16*>(a.qkv);
    const int rows = (a.s + vtt::wide::kRows - 1) / vtt::wide::kRows;
    const dim3 grid(a.b * a.heads, rows, vtt::wide::chunks(dh, vtt::wide::kW));
    if (!backward) {
      auto* out = static_cast<bf16*>(const_cast<void*>(a.out));
      auto* lse = static_cast<float*>(const_cast<void*>(a.lse));
      if (a.drop.thresh != 0u)
        packed_fwd_mma_wide_kernel<true><<<grid, vtt::mma::kThreads, 0,
                                           a.stream>>>(
            qkv, out, lse, a.s, a.heads, a.kv_valid, a.scale, a.drop, dh);
      else
        packed_fwd_mma_wide_kernel<false><<<grid, vtt::mma::kThreads, 0,
                                            a.stream>>>(
            qkv, out, lse, a.s, a.heads, a.kv_valid, a.scale, a.drop, dh);
      return vtt::launched("packed_fwd_mma_wide_kernel");
    }
    const auto* dout = static_cast<const bf16*>(a.dout);
    const auto* out = static_cast<const bf16*>(a.out);
    const auto* lse = static_cast<const float*>(a.lse);
    auto* dqkv = static_cast<bf16*>(a.dqkv);
    auto* delta = static_cast<float*>(a.delta);
    const dim3 grid_k(a.b * a.heads, rows,
                      vtt::wide::chunks(dh, vtt::wide::kWkv));
    if (a.drop.thresh != 0u)
      packed_bwd_dq_mma_wide_kernel<true><<<grid, vtt::mma::kThreads, 0,
                                            a.stream>>>(
          qkv, dout, out, lse, dqkv, delta, a.s, a.heads, a.kv_valid,
          a.scale, a.drop, dh);
    else
      packed_bwd_dq_mma_wide_kernel<false><<<grid, vtt::mma::kThreads, 0,
                                             a.stream>>>(
          qkv, dout, out, lse, dqkv, delta, a.s, a.heads, a.kv_valid,
          a.scale, a.drop, dh);
    rc = vtt::launched("packed_bwd_dq_mma_wide_kernel");
    if (rc != 0) return rc;
    if (a.drop.thresh != 0u)
      packed_bwd_dkv_mma_wide_kernel<true><<<grid_k, vtt::mma::kThreads, 0,
                                             a.stream>>>(
          qkv, dout, lse, delta, dqkv, a.s, a.heads, a.kv_valid, a.scale,
          a.drop, dh);
    else
      packed_bwd_dkv_mma_wide_kernel<false><<<grid_k, vtt::mma::kThreads, 0,
                                              a.stream>>>(
          qkv, dout, lse, delta, dqkv, a.s, a.heads, a.kv_valid, a.scale,
          a.drop, dh);
    return vtt::launched("packed_bwd_dkv_mma_wide_kernel");
  }
  const auto* qkv = static_cast<const float*>(a.qkv);
  const dim3 grid(a.b * a.heads, (a.s + vtt::kBlockQ - 1) / vtt::kBlockQ,
                  vtt::wide::chunks(dh, vtt::wide::kFW));
  if (!backward) {
    packed_fwd_wide_kernel<<<grid, vtt::kThreads, 0, a.stream>>>(
        qkv, static_cast<float*>(const_cast<void*>(a.out)),
        static_cast<float*>(const_cast<void*>(a.lse)), a.s, a.heads,
        a.kv_valid, a.scale, a.drop, dh);
    return vtt::launched("packed_fwd_wide_kernel");
  }
  const auto* lse = static_cast<const float*>(a.lse);
  auto* delta = static_cast<float*>(a.delta);
  packed_bwd_dq_wide_kernel<<<grid, vtt::kThreads, 0, a.stream>>>(
      qkv, static_cast<const float*>(a.dout), static_cast<const float*>(a.out),
      lse, static_cast<float*>(a.dqkv), delta, a.s, a.heads, a.kv_valid,
      a.scale, a.drop, dh);
  rc = vtt::launched("packed_bwd_dq_wide_kernel");
  if (rc != 0) return rc;
  packed_bwd_dkv_wide_kernel<<<grid, vtt::kThreads, 0, a.stream>>>(
      qkv, static_cast<const float*>(a.dout), lse, delta,
      static_cast<float*>(a.dqkv), a.s, a.heads, a.kv_valid, a.scale, a.drop,
      dh);
  return vtt::launched("packed_bwd_dkv_wide_kernel");
}

template <typename T>
int dispatch_dh(const Args& a, int dh, bool backward) {
  switch (dh) {
    case 16: return backward ? launch_bwd<T, 16>(a) : launch_fwd<T, 16>(a);
    case 32: return backward ? launch_bwd<T, 32>(a) : launch_fwd<T, 32>(a);
    case 64: return backward ? launch_bwd<T, 64>(a) : launch_fwd<T, 64>(a);
    default:
      if (dh < 1) return static_cast<int>(cudaErrorInvalidValue);
      if (dh > 128)
        return launch_wide(a, dh, backward, std::is_same_v<T, __nv_bfloat16>);
      return dh < 16   ? launch_padded<T, 16>(a, dh, backward)
             : dh < 32 ? launch_padded<T, 32>(a, dh, backward)
             : dh < 64 ? launch_padded<T, 64>(a, dh, backward)
                       : launch_padded<T, 128>(a, dh, backward);
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
// dh >= 1. drop_thresh = min(int(rate·2^32), 2^32 − 1), 0 for no dropout;
// inv_keep = 1/(1 − rate); seed: the mask's 64-bit seed. The forward refuses
// a bf16 qkv or out that is not 16-byte aligned for dh a multiple of 8
// (4-byte for another even dh; cudaErrorMisalignedAddress): the tensor-core
// route reads K and V with copies of that width.
int packed_attention_fwd(const void* qkv, void* out, void* lse, int b, int s,
                         int heads, int dh, int kv_valid, float scale,
                         int is_bf16, unsigned int drop_thresh, float inv_keep,
                         unsigned long long seed, void* stream) {
  if (is_bf16 && ((reinterpret_cast<std::uintptr_t>(qkv) |
                   reinterpret_cast<std::uintptr_t>(out)) &
                  vtt::mma::strided_align_mask(dh)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{qkv, nullptr, out, lse, nullptr, nullptr, b, s, heads, kv_valid,
               scale, vtt::make_dropout(drop_thresh, inv_keep, seed),
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, dh, is_bf16, false);
}

// delta: fp32 scratch of B·H·S elements (δ = rowsum(do ⊙ out), written by
// the first pass and read by the second). A bf16 qkv, do, out or dqkv that
// is not aligned as the forward's operands is refused
// (cudaErrorMisalignedAddress).
int packed_attention_bwd(const void* qkv, const void* dout, const void* out,
                         const void* lse, void* dqkv, void* delta, int b,
                         int s, int heads, int dh, int kv_valid, float scale,
                         int is_bf16, unsigned int drop_thresh, float inv_keep,
                         unsigned long long seed, void* stream) {
  if (is_bf16 && ((reinterpret_cast<std::uintptr_t>(qkv) |
                   reinterpret_cast<std::uintptr_t>(dout) |
                   reinterpret_cast<std::uintptr_t>(out) |
                   reinterpret_cast<std::uintptr_t>(dqkv)) &
                  vtt::mma::strided_align_mask(dh)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{qkv, dout, out, lse, dqkv, delta, b, s, heads, kv_valid, scale,
               vtt::make_dropout(drop_thresh, inv_keep, seed),
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, dh, is_bf16, true);
}

const char* packed_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
