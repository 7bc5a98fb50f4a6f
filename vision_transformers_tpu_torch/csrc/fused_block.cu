// Fused attention sub-block of a pre-LN encoder layer, in one launch:
//
//   out = x + out_proj(attention(qkv_proj(LN(x))))
//
// Replaces the TPU kernel vision_transformers_tpu/ops/flash_attention.py::
// _fused_block_kernel (:1028), reached through _fused_block_fwd_pallas
// (:1074) and fused_attention_block (:1137).
//
// x: (B, S, H·dh) in the compute dtype (bf16 or fp32); gamma, beta, bqkv,
// bout: fp32 rows (H·dh, 3·H·dh, H·dh); Wqkv(k, n) at wqkv[k·ldk1 + n·ldn1]
// and Wout(k, n) at wout[k·ldk3 + n·ldn3], in the compute dtype (the JAX
// package's (in, out) layout has ldn = 1, torch's (out, in) ldk = 1). The
// arithmetic is the TPU kernel's: fp32 LayerNorm statistics, xn·γ + β
// rounded to x's dtype; qkv = xn·Wqkv accumulated in fp32, + bqkv, rounded;
// per head fp32 scores q·kᵀ·scale, softmax with the max taken first, the
// output divided by the row sum and rounded; out = attn·Wout in fp32,
// + bout, + x read in fp32, one rounding. No mask, no dropout. (The TPU
// kernel rounds the unnormalised exp to the compute dtype before P·V; this
// kernel keeps it fp32, as the other attention kernels of the port do; the
// plain version beside the wrapper rounds it as the TPU kernel does.)
//
// What bounds it on the H100 (ViT-B/16 @224, B = 32, S = 197, H = 12,
// dh = 64, bf16): 2·B·S·HD·4·HD + 4·B·S²·HD = 33.6 GFLOP, 33.9 µs at
// 989 TFLOP/s, against 24.1 MB of x and the weights read and out written,
// 7.2 µs at 3.35 TB/s: the operations. The TPU kernel keeps Wqkv and Wout
// resident in VMEM and runs one grid step per image. Here the weights alone
// (3.5 MB + 1.2 MB in bf16) are far beyond a block's 227 KB of shared
// memory, and one block per image would fill B of the 132 SMs (one at
// bucket 1). So the intermediates go through device memory (L2-resident at
// these sizes): qkv (B, S, 3·H·dh) and the attention output (B, S, H·dh), in
// a workspace the wrapper allocates. The three phases are separated inside
// the one launch by grid-wide barriers (a cooperative launch; the grid is
// as many blocks as can be resident at once, each walking the work of a
// phase in strides):
//   1. LayerNorm + QKV projection over 64 × 64 output tiles
//      (dense_tile.cuh, statistics per tile, xn never stored);
//   2. attention over (image, head, 32-query tile) items
//      (attention_tile.cuh::attend_rows: keys streamed in 32-wide tiles with
//      an online softmax, the S × S scores never stored);
//   3. out-projection + bias + residual over 64 × 64 tiles.
// Every product is fp32 FMAs on the CUDA cores, not yet the tensor cores,
// which is where the gap to the bound lies. 128 threads per block.
#include <cooperative_groups.h>

#include <algorithm>

#include "dense_tile.cuh"

namespace {

namespace cg = cooperative_groups;

struct Params {
  const void* x;
  const float *gamma, *beta, *bqkv, *bout;
  const void *wqkv, *wout;
  long long ldk1, ldn1, ldk3, ldn3;
  void *qkv, *attn, *out;  // workspace (B·S·3HD, B·S·HD) and the output
  int b, s, heads;
  float scale, eps;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
fused_block_kernel(Params p) {
  __shared__ vtt::DenseSmem sm;
  cg::grid_group grid = cg::this_grid();
  const T* x = static_cast<const T*>(p.x);
  T* qkv = static_cast<T*>(p.qkv);
  T* attn = static_cast<T*>(p.attn);
  const int rows = p.b * p.s, hd = p.heads * D;
  const int m_tiles = cdiv(rows, vtt::kTileM);

  // 1. qkv = round(LN(x)·Wqkv + bqkv)
  const int n1 = cdiv(3 * hd, vtt::kTileN);
  for (int t = blockIdx.x; t < m_tiles * n1; t += gridDim.x) {
    const int m0 = (t / n1) * vtt::kTileM, n0 = (t % n1) * vtt::kTileN;
    __syncthreads();  // the previous tile's statistics are read no more
    vtt::row_stats<T>(x, rows, hd, m0, p.eps, sm);
    vtt::dense_tile<T>(x, rows, hd, p.gamma, p.beta,
                       static_cast<const T*>(p.wqkv), p.ldk1, p.ldn1, 3 * hd,
                       p.bqkv, vtt::kActNone, nullptr, qkv, m0, n0, sm);
  }
  grid.sync();

  // 2. per (image, head, query tile): softmax(q·kᵀ·scale)·v into attn
  const int q_tiles = cdiv(p.s, vtt::kBlockQ);
  const long long row3 = 3LL * hd;
  for (int t = blockIdx.x; t < p.b * p.heads * q_tiles; t += gridDim.x) {
    const int img = t / (p.heads * q_tiles);
    const int h = (t / q_tiles) % p.heads;
    const int q0 = (t % q_tiles) * vtt::kBlockQ;
    const T* q = qkv + img * p.s * row3 + h * D;
    __syncthreads();  // the previous item's shared tiles are read no more
    T* o = attn + static_cast<long long>(img) * p.s * hd + h * D;
    vtt::attend_rows<T, D>(q0, q, row3, q + hd, q + 2 * hd, row3, nullptr, 0,
                           nullptr, o, hd, nullptr, 0, p.s, p.s, p.s, p.scale,
                           vtt::make_dropout(0u, 1.f, 0ull), 0u);
  }
  grid.sync();

  // 3. out = round(attn·Wout + bout + x)
  const int n3 = cdiv(hd, vtt::kTileN);
  for (int t = blockIdx.x; t < m_tiles * n3; t += gridDim.x) {
    const int m0 = (t / n3) * vtt::kTileM, n0 = (t % n3) * vtt::kTileN;
    vtt::dense_tile<T>(attn, rows, hd, nullptr, nullptr,
                       static_cast<const T*>(p.wout), p.ldk3, p.ldn3, hd,
                       p.bout, vtt::kActNone, x, static_cast<T*>(p.out), m0,
                       n0, sm);
  }
}

template <typename T, int D>
int launch(Params p, cudaStream_t stream) {
  void* fn = reinterpret_cast<void*>(fused_block_kernel<T, D>);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                       vtt::kThreads, 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // every block must be resident at once for the grid barriers; more than
  // the largest phase's work would only wait at them
  const int rows = p.b * p.s, hd = p.heads * D;
  const int work =
      std::max(cdiv(rows, vtt::kTileM) * cdiv(3 * hd, vtt::kTileN),
               p.b * p.heads * cdiv(p.s, vtt::kBlockQ));
  const int blocks = std::min(per_sm * sms, work);
  void* args[] = {&p};
  rc = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(vtt::kThreads),
                                   args, 0, stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const Params& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch. qkv_ws: B·S·3·H·dh and
// attn_ws: B·S·H·dh elements of the compute dtype, overwritten.
// is_bf16: 1 = bf16, 0 = fp32.
int fused_block_fwd(const void* x, const void* gamma, const void* beta,
                    const void* wqkv, long long ldk1, long long ldn1,
                    const void* bqkv, const void* wout, long long ldk3,
                    long long ldn3, const void* bout, void* qkv_ws,
                    void* attn_ws, void* out, int b, int s, int heads, int dh,
                    float scale, float eps, int is_bf16, void* stream) {
  if (b < 1 || s < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, static_cast<const float*>(gamma),
                 static_cast<const float*>(beta),
                 static_cast<const float*>(bqkv),
                 static_cast<const float*>(bout), wqkv, wout, ldk1, ldn1,
                 ldk3, ldn3, qkv_ws, attn_ws, out, b, s, heads, scale, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_dh<__nv_bfloat16>(p, dh, st)
                 : dispatch_dh<float>(p, dh, st);
}

const char* fused_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
