// Streaming split-head attention with a runtime key-padding mask.
//
// Replaces the TPU kernel vision_transformers_tpu/ops/flash_attention.py::
// _large_kernel (:229), launched by _flash_fwd_large (:276) and reached
// through _flash_fwd (:143-147) for any kv_mask and for bias-free
// Sq·Sk > 1.5 M: the DETR encoder's self attention and decoder's cross
// attention (key padding of each image), a ViT at 576 px or a ViT detection
// backbone at COCO size.
//
// q: (G, Sq, D), k/v: (G, Sk, D), contiguous, G = B·H with heads fastest.
// kmask: null or uint8 (n, Sk), nonzero = attend, n dividing G: group g
// reads row g / (G / n). No bias. Writes out (G, Sq, D) in the input dtype
// and lse (G, Sq) fp32.
//
// Numerics are the TPU kernel's: the score times the scale is REPLACED by
// DEFAULT_MASK_VALUE = -0.7·FLT_MAX where the key is >= kv_valid or masked,
// before the running max; the running max starts at DEFAULT_MASK_VALUE, not
// -inf; denom = max(l, 1e-30); lse = m + log(denom). Keys past Sk (the ragged
// last tile) take no part at all. So a row whose keys are all masked is the
// uniform average over its Sk keys (mha_reference's answer); the TPU kernel,
// whose zero-padded block keys count too, gives Σv / Sk_padded there.
//
// What bounds it on the H100 (the DETR-R50 encoder at the 896 × 1344 bucket,
// batch 4: G = 32, S = 4704, D = 32, bf16): 4·G·S²·D = 90.6 GFLOP, 0.092 ms
// at 989 TFLOP/s, against 38.5 MB of q/k/v read and out/lse written, 0.0115
// ms at 3.35 TB/s: the operations. One image's (8, 4704, 4704) fp32 scores
// would be 708 MB, so they never leave the block: keys stream through shared
// memory in tiles of 32 with an online softmax, each lane reading its own
// key's mask byte beside the tile. The products are fp32 FMAs on the CUDA
// cores (attention_tile.cuh's layout), not yet the tensor cores, which is
// where the gap to the bound lies.
// Grid: x = G groups, y = ceil(Sq / 32) query tiles; 128 threads per block.
#include "attention_tile.cuh"

namespace {

using vtt::kBlockK;
using vtt::kBlockQ;
using vtt::kMaskValue;
using vtt::kRowsPerWarp;
using vtt::kThreads;
using vtt::kWarps;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_large_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v,
                   const unsigned char* __restrict__ kmask,
                   T* __restrict__ out, float* __restrict__ lse,
                   int groups_per_row, int sq, int sk, int kv_valid,
                   float scale) {
  static_assert(D == 16 || D == 32 || D == 64, "head dim must be 16, 32 or 64");
  __shared__ float qs[kBlockQ][D];
  __shared__ float ks[kBlockK][D + 1];  // +1: lane-strided reads hit 32 banks
  __shared__ float vs[kBlockK][D];
  __shared__ float ps[kBlockQ][kBlockK + 1];
  __shared__ float alpha_s[kBlockQ];
  __shared__ float l_s[kBlockQ];

  const long long g = blockIdx.x;
  const T* qg = q + g * sq * D;
  const T* kg = k + g * sk * D;
  const T* vg = v + g * sk * D;
  const unsigned char* mrow =
      kmask == nullptr ? nullptr : kmask + (g / groups_per_row) * sk;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.y * kBlockQ;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, qi = q0 + r;
    qs[r][c] = qi < sq ? vtt::to_f32(qg[static_cast<long long>(qi) * D + c])
                       : 0.f;
  }

  // softmax state of rows warp + kWarps·r, replicated across the warp's lanes
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = kMaskValue;
    l_run[r] = 0.f;
  }

  // output accumulator: column od of rows orow + kOutStride·i
  constexpr int kOutStride = kThreads / D;
  constexpr int kOutRows = kBlockQ / kOutStride;
  const int od = tid % D;
  const int orow = tid / D;
  float acc[kOutRows];
#pragma unroll
  for (int i = 0; i < kOutRows; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done (and qs is loaded)
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, kj = k0 + r;
      const bool in = kj < sk;
      const long long off = static_cast<long long>(kj) * D + c;
      ks[r][c] = in ? vtt::to_f32(kg[off]) : 0.f;
      vs[r][c] = in ? vtt::to_f32(vg[off]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 16
    for (int c = 0; c < D; ++c) {
      const float kc = ks[lane][c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(qs[warp + kWarps * r][c], kc, s[r]);
    }

    // lane j's key: in the sequence, and attended (kv_valid and the mask)
    const int kj = k0 + lane;
    const bool key_in = kj < sk;
    const bool attend = key_in && kj < kv_valid &&
                        (mrow == nullptr || mrow[kj] != 0);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      const float x = attend ? s[r] * scale : kMaskValue;
      // keys past Sk stay out of the max and the sum
      const float m_new =
          fmaxf(m_run[r], vtt::warp_max(key_in ? x : -CUDART_INF_F));
      const float p = key_in ? expf(x - m_new) : 0.f;
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * alpha + vtt::warp_sum(p);
      m_run[r] = m_new;
      ps[row][lane] = p;
      if (lane == 0) alpha_s[row] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kOutRows; ++i) {
      const int row = orow + kOutStride * i;
      float a = acc[i] * alpha_s[row];
#pragma unroll 8
      for (int j = 0; j < kBlockK; ++j) a = fmaf(ps[row][j], vs[j][od], a);
      acc[i] = a;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      const int qi = q0 + row;
      const float denom = fmaxf(l_run[r], 1e-30f);
      l_s[row] = denom;
      if (qi < sq) lse[g * sq + qi] = m_run[r] + logf(denom);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kOutRows; ++i) {
    const int row = orow + kOutStride * i;
    const int qi = q0 + row;
    if (qi < sq)
      out[g * sq * D + static_cast<long long>(qi) * D + od] =
          vtt::from_f32<T>(acc[i] / l_s[row]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kmask,
           void* out, void* lse, int g, int mask_rows, int sq, int sk,
           int kv_valid, float scale, cudaStream_t stream) {
  const dim3 grid(g, (sq + kBlockQ - 1) / kBlockQ);
  flash_large_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(kmask),
      static_cast<T*>(out), static_cast<float*>(lse),
      kmask == nullptr ? 1 : g / mask_rows, sq, sk, kv_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* kmask,
               void* out, void* lse, int g, int mask_rows, int sq, int sk,
               int d, int kv_valid, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, kmask, out, lse, g, mask_rows, sq, sk, kv_valid, scale, stream);
    case 32: return launch<T, 32>(q, k, v, kmask, out, lse, g, mask_rows, sq, sk, kv_valid, scale, stream);
    case 64: return launch<T, 64>(q, k, v, kmask, out, lse, g, mask_rows, sq, sk, kv_valid, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch. kmask may be null (then
// mask_rows is ignored); else mask_rows must divide g. is_bf16: 1 = bf16,
// 0 = fp32. sq / 32 query tiles must fit the grid's y dimension.
int flash_attention_large_fwd(const void* q, const void* k, const void* v,
                              const void* kmask, void* out, void* lse, int g,
                              int mask_rows, int sq, int sk, int d,
                              int kv_valid, float scale, int is_bf16,
                              void* stream) {
  if (g < 1 || sq < 1 || sk < 1 || kv_valid < 1 || kv_valid > sk ||
      (sq + kBlockQ - 1) / kBlockQ > 65535 ||
      (kmask != nullptr && (mask_rows < 1 || g % mask_rows != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? dispatch_d<__nv_bfloat16>(q, k, v, kmask, out, lse, g, mask_rows, sq, sk, d, kv_valid, scale, st)
      : dispatch_d<float>(q, k, v, kmask, out, lse, g, mask_rows, sq, sk, d, kv_valid, scale, st);
}

const char* flash_attention_large_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
