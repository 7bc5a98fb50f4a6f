// Shared body of ln_dense.cu and fused_block.cu: one 64 × 64 tile of
//
//   out = epilogue(prologue(A) · W)
//
// computed by one block of 128 threads with fp32 FMAs on the CUDA cores.
//
// - Prologue: A is read as it is (the out-projection of the fused block), or
//   LayerNormed on its way into shared memory (ln_dense, the fused block's
//   QKV projection): (a − μ)·rstd·γ + β with the row statistics of
//   row_stats, rounded to the input dtype as the TPU kernels round xn
//   before their matmul. The normalised rows never go to device memory.
// - W(k, n) is read through two strides, w[k·ldk + n·ldn]: ldn = 1 is the
//   JAX package's (in, out) layout, ldk = 1 torch's (out, in) Linear
//   weight, so a model hands its weight over without a transposed copy.
// - Epilogue, in fp32: + bias[n] (optional), the activation (none, tanh
//   GELU, erf GELU), + resid[m, n] (optional, read in fp32 from the input
//   dtype), then one rounding to the output dtype.
//
// The K loop stages a 64 × 16 slice of A and a 16 × 64 slice of W in shared
// memory as fp32 per step; thread (ty, tx) owns rows 8·ty .. 8·ty + 7 and
// columns 4·tx .. 4·tx + 3 of the tile (32 accumulators in registers) and
// reads its operands as float4 broadcasts. Rows past `rows`, columns past
// `ncols` and k past `kdim` are zero-filled and never stored. Tensor cores
// (mma.sync / wgmma) and TMA are not used yet.
#pragma once

#include "attention_tile.cuh"

namespace vtt {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kTilePad = 4;  // shared rows 68 floats apart: 16-byte aligned,
                             // at most 2-way bank conflicts on the stores

enum Activation { kActNone = 0, kActGeluTanh = 1, kActGeluErf = 2 };

struct __align__(16) DenseSmem {
  float a[kTileK][kTileM + kTilePad];
  float w[kTileK][kTileN + kTilePad];
  float mu[kTileM];
  float rstd[kTileM];
};

// LayerNorm statistics of rows [m0, m0 + kTileM) of x (row stride d) into
// sm.mu / sm.rstd: fp32 mean, then the fp32 mean of squared deviations (two
// passes, as the TPU kernels compute them), rstd = rsqrt(var + eps); one
// warp per row.
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ x, int rows,
                                          int d, int m0, float eps,
                                          DenseSmem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kTileM; r += kWarps) {
    const int row = m0 + r;
    float mu = 0.f, rstd = 0.f;
    if (row < rows) {
      const T* xr = x + static_cast<long long>(row) * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s += to_f32(xr[c]);
      mu = warp_sum(s) / d;
      float v = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float t = to_f32(xr[c]) - mu;
        v = fmaf(t, t, v);
      }
      rstd = rsqrtf(warp_sum(v) / d + eps);
    }
    if (lane == 0) {
      sm.mu[r] = mu;
      sm.rstd[r] = rstd;
    }
  }
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == kActGeluTanh) {
    const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * y * (1.f + tanhf(k0 * (y + 0.044715f * y * y * y)));
  }
  if (act == kActGeluErf)
    return 0.5f * y * (1.f + erff(y * 0.7071067811865476f));  // 1/sqrt(2)
  return y;
}

// One tile at (m0, n0). a: rows × kdim, row stride kdim. gamma/beta (fp32,
// kdim each) both null for no LayerNorm; with them the caller has run
// row_stats for this m0 and synchronised. bias (fp32, ncols) and resid
// (rows × ncols, row stride ncols) may be null. out: rows × ncols. Loads:
// how A is read (attention_tile.cuh's PlainLoads, or L2Loads where the
// launch wrote it); W, the bias and resid are read plainly.
template <typename T, class Loads = PlainLoads>
__device__ __forceinline__ void dense_tile(
    const T* __restrict__ a, int rows, int kdim,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const T* __restrict__ w, long long ldk, long long ldn, int ncols,
    const float* __restrict__ bias, int act, const T* __restrict__ resid,
    T* __restrict__ out, int m0, int n0, DenseSmem& sm) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += kTileK) {
    __syncthreads();  // the previous step's readers are done
    for (int idx = tid; idx < kTileM * kTileK; idx += kThreads) {
      const int r = idx / kTileK, c = idx % kTileK;
      const int row = m0 + r, k = k0 + c;
      float v = 0.f;
      if (row < rows && k < kdim) {
        if constexpr (Loads::kThroughL2)
          v = to_f32(__ldcg(a + static_cast<long long>(row) * kdim + k));
        else
          v = to_f32(a[static_cast<long long>(row) * kdim + k]);
        if (gamma != nullptr)
          v = to_f32(from_f32<T>((v - sm.mu[r]) * sm.rstd[r] * gamma[k] +
                                 beta[k]));
      }
      sm.a[c][r] = v;
    }
    for (int idx = tid; idx < kTileK * kTileN; idx += kThreads) {
      int kk, c;
      if (ldn == 1) {  // rows of W contiguous: neighbours along n
        kk = idx / kTileN;
        c = idx % kTileN;
      } else {         // columns of W contiguous: neighbours along k
        c = idx / kTileK;
        kk = idx % kTileK;
      }
      const int k = k0 + kk, n = n0 + c;
      sm.w[kk][c] = (k < kdim && n < ncols) ? to_f32(w[k * ldk + n * ldn])
                                            : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[kk][ty * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sm.a[kk][ty * 8 + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.w[kk][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= ncols) continue;
      float y = acc[i][j];
      if (bias != nullptr) y += bias[n];
      y = activate(y, act);
      const long long o = static_cast<long long>(m) * ncols + n;
      if (resid != nullptr) y += to_f32(resid[o]);
      out[o] = from_f32<T>(y);
    }
  }
}

}  // namespace vtt
