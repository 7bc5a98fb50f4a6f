// Backward of bias-free, mask-free split-head attention at small S.
//
// Replaces the TPU kernel vision_transformers_tpu/ops/flash_attention.py::
// _bwd_kernel (:362), launched by _flash_bwd_pallas (:399) and taken by
// _flash_attention_bwd (:2416-2425) under USE_PALLAS_BWD for Sq·Sk < 512²+1:
// the DETR decoder's self attention (100 × 100) in a train step at dropout 0,
// or ViT-B/16's split-head attention at S = 197.
//
// q, do, out: (G, Sq, D); k, v: (G, Sk, D); lse: (G, Sq) fp32; contiguous,
// bf16 or fp32. Writes dq (G, Sq, D), dk and dv (G, Sk, D) in the input dtype:
//
//   s  = q·kᵀ·scale, keys >= kv_valid set to -0.7·FLT_MAX
//   p  = exp(s − lse),  δ = rowsum(do ⊙ out) (fp32),  dp = do·vᵀ
//   ds = p ⊙ (dp − δ),  dq = ds·k·scale,  dv = pᵀ·do,  dk = dsᵀ·q·scale
//
// (the TPU kernel's formulas, :373-397, there with ds and pᵀ rounded to the
// input dtype before their products; here they stay fp32).
//
// One thread block owns one group and every output of it, in one launch and
// without atomics, so two runs give equal bits. It keeps the group's K and V
// resident in shared memory as fp32 and works in two phases, the TPU
// kernel's two orientations:
//   1. per tile of 32 query rows: δ and lse of the rows into shared memory,
//      then s and dp against every key tile, ds into a shared tile, and dq of
//      the rows accumulated in registers and written;
//   2. per tile of 32 keys: sᵀ and dpᵀ against every query tile (q and do
//      streamed from device memory, L2-resident at these sizes), pᵀ and dsᵀ
//      into shared tiles, dk and dv of the keys accumulated and written.
// That is 7 tile products where the mathematics needs 5, as on the TPU. The
// whole group's K and V must fit the block's shared memory
// (flash_attention.py::flash_bwd_smem_bytes, the same formula as here): the
// route takes this kernel only then, as _BWD_SCORE_BUDGET bounds it on the
// TPU; outside it the backward is dropout_attention_bwd at rate 0.
//
// What bounds it on the H100 (ViT-B/16 @224, batch 32: G = 384, S = 197,
// D = 64, bf16): 10·G·S²·D = 9.5 GFLOP, 9.6 µs at 989 TFLOP/s, against
// 8·G·S·D·2 + G·S·4 = 77.8 MB moved, 23 µs at 3.35 TB/s: the bytes. At the
// DETR decoder shape (G = 16, S = 100, D = 32) the card is barely occupied:
// 16 blocks on 132 SMs. The products are fp32 FMAs on the CUDA cores.
// Grid: x = G groups; 128 threads per block; dynamic shared memory.
#include "attention_tile.cuh"

namespace {

using vtt::kBlockK;
using vtt::kBlockQ;
using vtt::kMaskValue;
using vtt::kRowsPerWarp;
using vtt::kThreads;
using vtt::kWarps;

constexpr int kTile = kBlockK + 1;  // row stride of the 32 × 32 score tiles

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// fp32 words of shared memory for one group; keep in step with
// flash_attention.py::flash_bwd_smem_bytes.
__host__ __device__ inline long long smem_floats(int sq, int sk, int d) {
  const long long dp = d + 1;
  return 2LL * round_up(sk, kBlockK) * dp + 2LL * round_up(sq, kBlockQ) +
         2LL * kBlockQ * dp + 2LL * kBlockK * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ out,
                 const float* __restrict__ lse, const T* __restrict__ dout,
                 T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                 int sq, int sk, int kv_valid, float scale) {
  static_assert(D == 16 || D == 32 || D == 64, "head dim must be 16, 32 or 64");
  constexpr int DP = D + 1;  // odd row stride: lane-strided reads hit 32 banks
  extern __shared__ float smem[];
  const int sk_pad = round_up(sk, kBlockK);
  const int sq_pad = round_up(sq, kBlockQ);
  float* ks = smem;                 // [sk_pad][DP], resident
  float* vs = ks + sk_pad * DP;     // [sk_pad][DP], resident
  float* lse_s = vs + sk_pad * DP;  // [sq_pad]
  float* delta_s = lse_s + sq_pad;  // [sq_pad]
  float* qs = delta_s + sq_pad;     // [kBlockQ][DP], streamed
  float* dos = qs + kBlockQ * DP;   // [kBlockQ][DP], streamed
  float* t1 = dos + kBlockQ * DP;   // [32][kTile]
  float* t2 = t1 + kBlockQ * kTile;  // [32][kTile]

  const long long g = blockIdx.x;
  q += g * sq * D;
  out += g * sq * D;
  dout += g * sq * D;
  dq += g * sq * D;
  lse += g * sq;
  k += g * sk * D;
  v += g * sk * D;
  dk += g * sk * D;
  dv += g * sk * D;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kOutStride = kThreads / D;
  constexpr int kOutRows = kBlockQ / kOutStride;
  const int od = tid % D;
  const int orow = tid / D;

  for (int idx = tid; idx < sk_pad * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const bool in = r < sk;
    ks[r * DP + c] = in ? vtt::to_f32(k[r * D + c]) : 0.f;
    vs[r * DP + c] = in ? vtt::to_f32(v[r * D + c]) : 0.f;
  }

  // stage rows [q0, q0 + 32) of q and do as fp32, zeros past Sq
  auto load_rows = [&](int q0) {
    for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, qi = q0 + r;
      const bool in = qi < sq;
      qs[r * DP + c] = in ? vtt::to_f32(q[qi * D + c]) : 0.f;
      dos[r * DP + c] = in ? vtt::to_f32(dout[qi * D + c]) : 0.f;
    }
  };

  // ---- phase 1: dq, one query tile at a time ------------------------------
  for (int q0 = 0; q0 < sq; q0 += kBlockQ) {
    __syncthreads();  // K/V staged; the previous tile's readers are done
    load_rows(q0);
    __syncthreads();

    // δ and lse of rows warp + kWarps·r, replicated across the warp's lanes
    float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + kWarps * r;
      const int qi = q0 + row;
      float part = 0.f;
      if (qi < sq)
        for (int c = lane; c < D; c += 32)
          part = fmaf(dos[row * DP + c], vtt::to_f32(out[qi * D + c]), part);
      delta_r[r] = vtt::warp_sum(part);
      lse_r[r] = qi < sq ? lse[qi] : 0.f;
      if (lane == 0) {
        delta_s[q0 + row] = delta_r[r];
        lse_s[q0 + row] = lse_r[r];
      }
    }

    float acc[kOutRows];
#pragma unroll
    for (int i = 0; i < kOutRows; ++i) acc[i] = 0.f;

    for (int k0 = 0; k0 < sk; k0 += kBlockK) {
      float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
      const float* kr = ks + (k0 + lane) * DP;
      const float* vr = vs + (k0 + lane) * DP;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        const float kc = kr[c], vc = vr[c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int row = warp + kWarps * r;
          s[r] = fmaf(qs[row * DP + c], kc, s[r]);
          dp[r] = fmaf(dos[row * DP + c], vc, dp[r]);
        }
      }
      const int kj = k0 + lane;
      const bool key_in = kj < sk;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = warp + kWarps * r;
        const bool row_in = q0 + row < sq;
        const float x = kj < kv_valid ? s[r] * scale : kMaskValue;
        const float p = (key_in && row_in) ? expf(x - lse_r[r]) : 0.f;
        t1[row * kTile + lane] = p * (dp[r] - delta_r[r]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kOutRows; ++i) {
        const int row = orow + kOutStride * i;
        float a = acc[i];
#pragma unroll 8
        for (int j = 0; j < kBlockK; ++j)
          a = fmaf(t1[row * kTile + j], ks[(k0 + j) * DP + od], a);
        acc[i] = a;
      }
      __syncthreads();  // t1 is rewritten by the next key tile
    }
#pragma unroll
    for (int i = 0; i < kOutRows; ++i) {
      const int qi = q0 + orow + kOutStride * i;
      if (qi < sq) dq[qi * D + od] = vtt::from_f32<T>(acc[i] * scale);
    }
  }

  // ---- phase 2: dk and dv, one key tile at a time --------------------------
  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    float acc_k[kOutRows], acc_v[kOutRows];
#pragma unroll
    for (int i = 0; i < kOutRows; ++i) acc_k[i] = acc_v[i] = 0.f;

    for (int q0 = 0; q0 < sq; q0 += kBlockQ) {
      __syncthreads();  // the previous tile's readers are done
      load_rows(q0);
      __syncthreads();

      // transposed scores: key warp + kWarps·r against query row `lane`
      float st[kRowsPerWarp], dpt[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) st[r] = dpt[r] = 0.f;
      const float* qr = qs + lane * DP;
      const float* dr = dos + lane * DP;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        const float qc = qr[c], dc = dr[c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int key = k0 + warp + kWarps * r;
          st[r] = fmaf(ks[key * DP + c], qc, st[r]);
          dpt[r] = fmaf(vs[key * DP + c], dc, dpt[r]);
        }
      }
      const int qi = q0 + lane;
      const bool row_in = qi < sq;
      const float lse_i = row_in ? lse_s[qi] : 0.f;
      const float delta_i = row_in ? delta_s[qi] : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int key = warp + kWarps * r;
        const int kj = k0 + key;
        const float x = kj < kv_valid ? st[r] * scale : kMaskValue;
        const float p = (row_in && kj < sk) ? expf(x - lse_i) : 0.f;
        t1[key * kTile + lane] = p;
        t2[key * kTile + lane] = p * (dpt[r] - delta_i);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kOutRows; ++i) {
        const int key = orow + kOutStride * i;
        float ak = acc_k[i], av = acc_v[i];
#pragma unroll 8
        for (int j = 0; j < kBlockQ; ++j) {
          av = fmaf(t1[key * kTile + j], dos[j * DP + od], av);
          ak = fmaf(t2[key * kTile + j], qs[j * DP + od], ak);
        }
        acc_k[i] = ak;
        acc_v[i] = av;
      }
    }
#pragma unroll
    for (int i = 0; i < kOutRows; ++i) {
      const int kj = k0 + orow + kOutStride * i;
      if (kj < sk) {
        dk[kj * D + od] = vtt::from_f32<T>(acc_k[i] * scale);
        dv[kj * D + od] = vtt::from_f32<T>(acc_v[i]);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           int g, int sq, int sk, int kv_valid, float scale, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_kernel<T, D><<<g, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
      kv_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* out,
               const void* lse, const void* dout, void* dq, void* dk, void* dv,
               int g, int sq, int sk, int d, int kv_valid, float scale,
               size_t smem, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, dout, dq, dk, dv, g, sq, sk, kv_valid, scale, smem, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, dout, dq, dk, dv, g, sq, sk, kv_valid, scale, smem, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, dout, dq, dk, dv, g, sq, sk, kv_valid, scale, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch; cudaErrorInvalidValue when the
// group does not fit one block's 227 KB of shared memory. is_bf16: 1 = bf16,
// 0 = fp32.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* out, const void* lse, const void* dout,
                        void* dq, void* dk, void* dv, int g, int sq, int sk,
                        int d, int kv_valid, float scale, int is_bf16,
                        void* stream) {
  const size_t smem = static_cast<size_t>(smem_floats(sq, sk, d)) * 4;
  if (g < 1 || sq < 1 || sk < 1 || kv_valid < 1 || kv_valid > sk ||
      smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? dispatch_d<__nv_bfloat16>(q, k, v, out, lse, dout, dq, dk, dv, g, sq, sk, d, kv_valid, scale, smem, st)
      : dispatch_d<float>(q, k, v, out, lse, dout, dq, dk, dv, g, sq, sk, d, kv_valid, scale, smem, st);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
