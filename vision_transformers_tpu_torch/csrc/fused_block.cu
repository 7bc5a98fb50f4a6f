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
// + bout, + x read in fp32, one rounding. No mask, no dropout. The bf16
// route rounds the unnormalised exp to bf16 before P·V, where the TPU kernel
// and the plain version beside the wrapper round it; the fp32 route keeps it
// fp32, which in fp32 is the same.
//
// What bounds it on the H100 (ViT-B/16 @224, B = 32, S = 197, H = 12,
// dh = 64, bf16; the same at any H, dh 256 included, since neither count
// depends on the split of HD into heads): 2·B·S·HD·4·HD + 4·B·S²·HD = 33.6
// GFLOP, 33.9 µs at 989 TFLOP/s, against 24.1 MB of x and the weights read
// and out written, 7.2 µs at 3.35 TB/s: the operations. The TPU kernel
// keeps Wqkv and Wout resident in VMEM and runs one grid step per image.
// Here the weights alone (3.5 MB + 1.2 MB in bf16) are far beyond a block's
// 227 KB of shared memory, and one block per image would fill B of the 132
// SMs (one at bucket 1). So the intermediates go through device memory (L2-resident at
// these sizes): qkv (B, S, 3·H·dh) and the attention output (B, S, H·dh), in
// a workspace the wrapper allocates. The phases are separated inside the one
// launch by grid-wide barriers (a cooperative launch; the grid is as many
// blocks as can be resident at once, each walking the work of a phase in
// strides). Two routes; ops/flash_attention.py::fused_block_route picks one
// by a stated rule, before any launch:
//
// fused_block_mma_fwd (bf16, both weights in one layout, their leading
// strides and H·dh multiples of 8): every product on the tensor cores
// (mma.sync.m16n8k16, bf16 in, fp32 accumulators), 256 threads:
//   0. (μ, rstd) of the B·S rows into an fp32 scratch, 8 bytes a row
//      (dense_mma::row_stats, a warp per row);
//   1. LayerNorm + QKV over 128 × 128 tiles of (B·S, 3·H·dh):
//      dense_mma::ln_dense_mma_tile, row 14's tile, reading the statistics;
//   2. attention over (image, head, query tile[, output chunk]) items, two
//      a block: each 128-thread half runs one item, q, k and v read in place
//      from the QKV workspace (rows 3·H·dh apart), out at H·dh, its lse into
//      an fp32 scratch nothing reads; the halves meet at named barriers 1
//      and 2, not at the block's. By head dim (the Tile below):
//        dh 16, 32, 64: fused_block_mma_kernel, attend_rows_mma<dh, NoMask,
//          false, Strided, HalfBlock>, __launch_bounds__(256, 2);
//        any other dh up to 128: fused_block_mma_padded_kernel, the same
//          body in the next tile D (16, 32, 64, 128) on the PaddedStrided
//          rows, as row 1 reads the packed projection: columns past dh read
//          as zeros and never written, K/V copied at the widest grain dh
//          allows (16-byte cp.async.cg for dh a multiple of 8, 4-byte
//          cp.async for an even dh, __ldcg for an odd one), Q through L2;
//          at D 128 one block an SM (the body holds 223-255 registers in
//          rows 1-7, more than two 256-thread blocks an SM leave);
//        dh above 128: fused_block_mma_wide_kernel,
//          attention_wide_tile.cuh's attend_rows_wide_mma under HalfBlock,
//          items (image, head, 64 queries, 128-column output chunk), each
//          half summing the scores over every 128-column chunk of q and k
//          itself, nothing exchanged between blocks, lse from chunk 0 only;
//          one block an SM;
//   3. out-projection + bout + x over 128 × 128 tiles:
//      dense_mma::dense_residual_mma_tile, the same products with the
//      attention output streamed by cp.async as A, the residual added in
//      fp32 before one rounding.
//   The phases never overlap, so one dynamic shared buffer is their union:
//   the dense tiles' 38-41 KB or two attention halves' K/V buffers (4·64·(D
//   + 8) bf16 each, 73.7 KB at D 64, 139 KB at D 128; 2·64·136 bf16 each, 70
//   KB, for the wide tile). The cooperative grid is what the occupancy query
//   of each instantiation gives, asked once per device. What a phase reads
//   of an earlier one's output it reads through L2 (ld.global.cg or
//   cp.async.cg), or by a 4-byte cp.async.ca that no stale L1 line can
//   serve (no phase before the attention reads the workspace), never by the
//   non-coherent path, which PTX allows only for data the launch never
//   writes. fused_block_mma_phases runs chosen phases as ordinary launches
//   of their own (fused_block_mma_phase_kernel, the same tiles and register
//   bounds), for measurement only.
//
// fused_block_fwd (fp32, and bf16 the rule sends elsewhere): fp32 FMAs on
// the CUDA cores, 128 threads:
//   1. LayerNorm + QKV projection over 64 × 64 output tiles
//      (dense_tile.cuh, statistics per tile, xn never stored);
//   2. attention over (image, head, 32-query tile) items
//      (attention_tile.cuh::attend_rows: keys streamed in 32-wide tiles with
//      an online softmax, the S × S scores never stored): fused_block_kernel
//      at dh 16, 32 and 64; fused_block_padded_kernel at any other dh up to
//      128 in the next tile (kPad; at D 128 the tiles in 49 KB of dynamic
//      shared memory); fused_block_wide_kernel above 128
//      (attention_wide_tile.cuh::attend_rows_wide, items with a 64-column
//      output chunk, lse into an unread scratch from chunk 0);
//   3. out-projection + bias + residual over 64 × 64 tiles.
//   Phase 2 reads q, k and v of the QKV workspace, and phase 3 the attention
//   output as A, with __ldcg (ld.global.cg, the tiles' L2Loads policy): other
//   blocks of this launch wrote them before the grid barrier, and the
//   non-coherent path (ld.global.nc), which a const __restrict__ pointer lets
//   nvcc take, is defined only for data the launch never writes. x, the
//   weights and the biases, which no phase writes, are read plainly.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "attention_wide_tile.cuh"
#include "dense_mma_tile.cuh"
#include "dense_tile.cuh"
#include "launch_log.cuh"

namespace {

namespace cg = cooperative_groups;
namespace wide = vtt::wide;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The attention phase's tile, by head dim: Exact (dh 16, 32 or 64, the tile
// of width dh), Padded (any other dh up to 128 in the next tile, 16, 32, 64
// or 128, the columns past dh read as zeros and never written), Wide (dh
// above 128: attention_wide_tile.cuh, dh split into output chunks).
enum class Tile { Exact, Padded, Wide };

// ---- the CUDA-core route (fp32, and bf16 the rule sends here) ---------------

struct Params {
  const void* x;
  const float *gamma, *beta, *bqkv, *bout;
  const void *wqkv, *wout;
  long long ldk1, ldn1, ldk3, ldn3;
  void *qkv, *attn, *out;  // workspace (B·S·3HD, B·S·HD) and the output
  float* lse;  // Wide: the attention's lse (B·S·H), unread; else null
  int b, s, heads, dh;
  float scale, eps;
};

// The attention items: (image, head, 32-query tile[, 64-column chunk]).
template <Tile K>
__host__ __device__ inline int core_chunks(int dh) {
  return K == Tile::Wide ? wide::chunks(dh, wide::kFW) : 1;
}

template <Tile K>
__host__ __device__ inline int core_items(const Params& p) {
  return p.b * p.heads * cdiv(p.s, vtt::kBlockQ) * core_chunks<K>(p.dh);
}

// The block's three phases on the CUDA cores, each a loop of the grid's
// blocks over its work items, a grid barrier between them. D: the tile
// (Exact, Padded); unused for Wide.
template <typename T, Tile K, int D>
__device__ __forceinline__ void core_block(const Params& p,
                                           vtt::DenseSmem& sm) {
  cg::grid_group grid = cg::this_grid();
  const T* x = static_cast<const T*>(p.x);
  T* qkv = static_cast<T*>(p.qkv);
  T* attn = static_cast<T*>(p.attn);
  const int rows = p.b * p.s, hd = p.heads * p.dh;
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

  // 2. per (image, head, query tile[, output chunk]): softmax(q·kᵀ·scale)·v
  // into attn
  const int q_tiles = cdiv(p.s, vtt::kBlockQ), nc = core_chunks<K>(p.dh);
  const long long row3 = 3LL * hd;
  for (int t = blockIdx.x; t < core_items<K>(p); t += gridDim.x) {
    const int c = t % nc, u = t / nc;
    const int img = u / (p.heads * q_tiles);
    const int h = (u / q_tiles) % p.heads;
    const int q0 = (u % q_tiles) * vtt::kBlockQ;
    const T* q = qkv + img * p.s * row3 + h * p.dh;
    __syncthreads();  // the previous item's shared tiles are read no more
    T* o = attn + static_cast<long long>(img) * p.s * hd + h * p.dh;
    if constexpr (K == Tile::Wide)
      wide::attend_rows_wide<vtt::mma::KeyMask::NoMask, T, vtt::L2Loads>(
          q0, c, q, q + hd, q + 2 * hd, nullptr, nullptr, o,
          p.lse + static_cast<long long>(img) * p.s * p.heads + h, p.s, p.s,
          p.s, p.scale, vtt::make_dropout(0u, 1.f, 0ull), 0u,
          wide::Rows{p.dh, row3, hd, p.heads});
    else
      vtt::attend_rows<T, D, vtt::L2Loads, K == Tile::Padded>(
          q0, q, row3, q + hd, q + 2 * hd, row3, nullptr, 0, nullptr, o, hd,
          nullptr, 0, p.s, p.s, p.s, p.scale,
          vtt::make_dropout(0u, 1.f, 0ull), 0u, p.dh);
  }
  grid.sync();

  // 3. out = round(attn·Wout + bout + x)
  const int n3 = cdiv(hd, vtt::kTileN);
  for (int t = blockIdx.x; t < m_tiles * n3; t += gridDim.x) {
    const int m0 = (t / n3) * vtt::kTileM, n0 = (t % n3) * vtt::kTileN;
    vtt::dense_tile<T, vtt::L2Loads>(
        attn, rows, hd, nullptr, nullptr, static_cast<const T*>(p.wout),
        p.ldk3, p.ldn3, hd, p.bout, vtt::kActNone, x, static_cast<T*>(p.out),
        m0, n0, sm);
  }
}

// dh 16, 32, 64
template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
fused_block_kernel(Params p) {
  __shared__ vtt::DenseSmem sm;
  core_block<T, Tile::Exact, D>(p, sm);
}

// any other dh up to 128 in the tile D (D 128: the attention's tiles in
// attend_dyn_bytes<128>() of dynamic shared memory)
template <typename T, int D>
__global__ void __launch_bounds__(vtt::kThreads)
fused_block_padded_kernel(Params p) {
  __shared__ vtt::DenseSmem sm;
  core_block<T, Tile::Padded, D>(p, sm);
}

// dh above 128
template <typename T>
__global__ void __launch_bounds__(vtt::kThreads)
fused_block_wide_kernel(Params p) {
  __shared__ vtt::DenseSmem sm;
  core_block<T, Tile::Wide, 0>(p, sm);
}

template <typename T, Tile K, int D>
int launch(Params p, cudaStream_t stream) {
  void* fn;
  if constexpr (K == Tile::Exact)
    fn = reinterpret_cast<void*>(fused_block_kernel<T, D>);
  else if constexpr (K == Tile::Padded)
    fn = reinterpret_cast<void*>(fused_block_padded_kernel<T, D>);
  else
    fn = reinterpret_cast<void*>(fused_block_wide_kernel<T>);
  constexpr int smem = K == Tile::Padded ? vtt::attend_dyn_bytes<D>() : 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t rc = static_cast<cudaError_t>(vtt::allow_dynamic_smem(
      static_cast<const void*>(fn), smem));
  if (rc == cudaSuccess) rc = cudaGetDevice(&device);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                       vtt::kThreads, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // every block must be resident at once for the grid barriers; more than
  // the largest phase's work would only wait at them
  const int rows = p.b * p.s, hd = p.heads * p.dh;
  const int work =
      std::max(cdiv(rows, vtt::kTileM) * cdiv(3 * hd, vtt::kTileN),
               core_items<K>(p));
  const int blocks = std::min(per_sm * sms, work);
  void* args[] = {&p};
  rc = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(vtt::kThreads),
                                   args, smem, stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if constexpr (K == Tile::Exact)
    return vtt::launched("fused_block_kernel");
  else if constexpr (K == Tile::Padded)
    return vtt::launched("fused_block_padded_kernel");
  else
    return vtt::launched("fused_block_wide_kernel");
}

template <typename T>
int dispatch_dh(const Params& p, cudaStream_t stream) {
  switch (p.dh) {
    case 16: return launch<T, Tile::Exact, 16>(p, stream);
    case 32: return launch<T, Tile::Exact, 32>(p, stream);
    case 64: return launch<T, Tile::Exact, 64>(p, stream);
    default:
      if (p.dh < 1 || (p.dh > 128 && p.lse == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
      if (p.dh > 128) return launch<T, Tile::Wide, 0>(p, stream);
      return p.dh < 16   ? launch<T, Tile::Padded, 16>(p, stream)
             : p.dh < 32 ? launch<T, Tile::Padded, 32>(p, stream)
             : p.dh < 64 ? launch<T, Tile::Padded, 64>(p, stream)
                         : launch<T, Tile::Padded, 128>(p, stream);
  }
}

// ---- the tensor-core route (bf16) ------------------------------------------

namespace dm = vtt::dense_mma;
namespace mm = vtt::mma;
using bf16 = __nv_bfloat16;

struct MmaParams {
  const bf16* x;
  const float *gamma, *beta, *bqkv, *bout;
  const bf16 *wqkv, *wout;
  long long ldw1, ldw3;  // the weights' leading strides
  bf16 *qkv, *attn, *out;
  float *stats, *lse;  // (μ, rstd) per row; the attention's lse, unread
  int b, s, heads, dh;
  float scale, eps;
};

// The attention phase's tile on the tensor cores: D its width (Exact,
// Padded; unused for Wide). Each 128-thread half of a block runs one item,
// (image, head, kRows query rows[, 128-column output chunk]), in kHalfBytes
// of K/V buffers of its own. The 128 tile and the wide one hold 223-255
// registers a thread in rows 1-7, beyond the 128 that two 256-thread blocks
// an SM leave: their kernels are built for one block an SM (kMinBlocks).
template <Tile K, int D>
struct MmaTile {
  static constexpr bool kWide = K == Tile::Wide;
  static constexpr int kRows = kWide ? wide::kRows : mm::fwd_rows<D>();
  static constexpr int kHalfBytes =
      kWide ? 2 * wide::kKeys * (wide::kW + 8) * 2
            : 4 * mm::kCols * (D + 8) * 2;
  static constexpr int kMinBlocks = kWide || D == 128 ? 1 : 2;
  __host__ __device__ static int chunks(int dh) {
    return kWide ? wide::chunks(dh, wide::kW) : 1;
  }
  __host__ __device__ static int items(const MmaParams& p) {
    return p.b * p.heads * cdiv(p.s, kRows) * chunks(p.dh);
  }
};

// The dynamic shared memory: the union of the phases' buffers.
template <Tile K, int D, bool kWk>
constexpr int mma_smem_bytes() {
  return static_cast<int>(std::max(
      {sizeof(dm::Smem<kWk>), sizeof(dm::PlainSmem<kWk>),
       static_cast<std::size_t>(2 * MmaTile<K, D>::kHalfBytes)}));
}

// The work items of phase p: rows of 8 (a warp each), 128 × 128 tiles,
// pairs of attention items, 128 × 128 tiles.
template <Tile K, int D>
int phase_work(const MmaParams& p, int phase) {
  const int rows = p.b * p.s, hd = p.heads * p.dh;
  const int m_tiles = cdiv(rows, dm::kBM);
  switch (phase) {
    case 0: return cdiv(rows, dm::kThreads / 32);
    case 1: return m_tiles * cdiv(3 * hd, dm::kBN);
    case 2: return cdiv(MmaTile<K, D>::items(p), 2);
    default: return m_tiles * cdiv(hd, dm::kBN);
  }
}

// The phases, each a loop of the grid's blocks over its work items. They
// read what an earlier phase wrote only through L2 (the statistics and q by
// ld.global.cg, k, v and the attention output by cp.async, .cg at 16
// bytes), never by the non-coherent path, which PTX allows only for data the
// launch never writes.

// 0. each row's (μ, rstd)
__device__ __forceinline__ void stats_phase(const MmaParams& p) {
  constexpr int kWarps = dm::kThreads / 32;
  const int rows = p.b * p.s;
  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < rows;
       r += gridDim.x * kWarps)
    dm::row_stats(p.x, p.heads * p.dh, r, p.eps, p.stats);
}

// 1. qkv = round(LN(x)·Wqkv + bqkv)
template <bool kWk>
__device__ __forceinline__ void qkv_phase(const MmaParams& p,
                                          unsigned char* smem) {
  auto& sm = *reinterpret_cast<dm::Smem<kWk>*>(smem);
  const int rows = p.b * p.s, hd = p.heads * p.dh;
  const int n_tiles = cdiv(3 * hd, dm::kBN);
  const int tiles = cdiv(rows, dm::kBM) * n_tiles;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    __syncthreads();  // the previous tile's buffers are read no more
    dm::ln_dense_mma_tile<kWk>(p.x, p.gamma, p.beta, p.wqkv, p.ldw1, p.bqkv,
                               p.stats, p.qkv, rows, hd, 3 * hd,
                               vtt::kActNone, (t / n_tiles) * dm::kBM,
                               (t % n_tiles) * dm::kBN, sm);
  }
}

// 2. per (image, head, query tile[, output chunk]): softmax(q·kᵀ·scale)·v
// into attn, one item per 128-thread half: attend_rows_mma on Strided rows
// (Exact) or PaddedStrided ones (Padded), attend_rows_wide_mma (Wide)
template <Tile K, int D>
__device__ __forceinline__ void attention_phase(const MmaParams& p,
                                                unsigned char* smem) {
  using A = MmaTile<K, D>;
  const int hd = p.heads * p.dh, q_tiles = cdiv(p.s, A::kRows);
  const int nc = A::chunks(p.dh);
  const int half = threadIdx.x / mm::kThreads;
  const mm::HalfBlock blk{reinterpret_cast<bf16*>(smem) +
                          half * (A::kHalfBytes / 2)};
  for (int t = 2 * blockIdx.x + half; t < A::items(p); t += 2 * gridDim.x) {
    const int c = t % nc, u = t / nc;
    const int img = u / (p.heads * q_tiles);
    const int h = (u / q_tiles) % p.heads;
    const int q0 = (u % q_tiles) * A::kRows;
    const bf16* q = p.qkv + static_cast<long long>(img) * p.s * 3 * hd +
                    h * p.dh;
    bf16* o = p.attn + static_cast<long long>(img) * p.s * hd + h * p.dh;
    float* lse = p.lse + static_cast<long long>(img) * p.s * p.heads + h;
    if constexpr (K == Tile::Exact)
      mm::attend_rows_mma<D, mm::KeyMask::NoMask, false, mm::Strided,
                          mm::HalfBlock>(
          q0, q, q + hd, q + 2 * hd, nullptr, o, lse, p.s, p.s, p.s, p.scale,
          nullptr, vtt::Dropout{}, 0u, nullptr,
          mm::Strided{3 * hd, hd, p.heads}, blk);
    else if constexpr (K == Tile::Padded)
      mm::attend_rows_mma<D, mm::KeyMask::NoMask, false, mm::PaddedStrided<D>,
                          mm::HalfBlock>(
          q0, q, q + hd, q + 2 * hd, nullptr, o, lse, p.s, p.s, p.s, p.scale,
          nullptr, vtt::Dropout{}, 0u, nullptr,
          mm::PaddedStrided<D>{p.dh, 3 * hd, hd, p.heads}, blk);
    else
      wide::attend_rows_wide_mma<mm::KeyMask::NoMask, false, mm::HalfBlock>(
          q0, c, q, q + hd, q + 2 * hd, nullptr, o, lse, p.s, p.s, p.s,
          p.scale, nullptr, vtt::Dropout{}, 0u, nullptr,
          wide::Rows{p.dh, 3LL * hd, hd, p.heads}, blk);
  }
}

// 3. out = round(attn·Wout + bout + x)
template <bool kWk>
__device__ __forceinline__ void out_phase(const MmaParams& p,
                                          unsigned char* smem) {
  auto& sm = *reinterpret_cast<dm::PlainSmem<kWk>*>(smem);
  const int rows = p.b * p.s, hd = p.heads * p.dh;
  const int n_tiles = cdiv(hd, dm::kBN);
  const int tiles = cdiv(rows, dm::kBM) * n_tiles;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    __syncthreads();  // the previous tile's (or phase's) buffers are free
    dm::dense_residual_mma_tile<kWk>(p.attn, p.wout, p.ldw3, p.bout, p.x,
                                     p.out, rows, hd, hd,
                                     (t / n_tiles) * dm::kBM,
                                     (t % n_tiles) * dm::kBN, sm);
  }
}

// The four phases, each waiting at a grid barrier for the one before it.
template <Tile K, int D, bool kWk>
__device__ __forceinline__ void block_phases(const MmaParams& p,
                                             unsigned char* smem) {
  cg::grid_group grid = cg::this_grid();
  stats_phase(p);
  grid.sync();
  qkv_phase<kWk>(p, smem);
  grid.sync();
  attention_phase<K, D>(p, smem);
  grid.sync();
  out_phase<kWk>(p, smem);
}

// The block in one cooperative launch, by the attention's tile: dh 16, 32
// and 64; any other dh up to 128 (Padded); dh above 128 (Wide). kWk: both
// weights k-contiguous (torch's (out, in), ldk = 1).
template <int D, bool kWk>
__global__ void __launch_bounds__(dm::kThreads, 2)
fused_block_mma_kernel(MmaParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  block_phases<Tile::Exact, D, kWk>(p, smem);
}

template <int D, bool kWk>
__global__ void __launch_bounds__(dm::kThreads,
                                  MmaTile<Tile::Padded, D>::kMinBlocks)
fused_block_mma_padded_kernel(MmaParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  block_phases<Tile::Padded, D, kWk>(p, smem);
}

template <bool kWk>
__global__ void __launch_bounds__(dm::kThreads, 1)
fused_block_mma_wide_kernel(MmaParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  block_phases<Tile::Wide, 0, kWk>(p, smem);
}

// One phase alone, an ordinary launch of a block per work item: for
// measurement only (fused_block_mma_phases), never on the model's path. The
// same tiles and register bounds as the cooperative kernel's.
template <Tile K, int D, bool kWk>
__global__ void __launch_bounds__(dm::kThreads, MmaTile<K, D>::kMinBlocks)
fused_block_mma_phase_kernel(MmaParams p, int phase) {
  extern __shared__ __align__(16) unsigned char smem[];
  switch (phase) {
    case 0: stats_phase(p); break;
    case 1: qkv_phase<kWk>(p, smem); break;
    case 2: attention_phase<K, D>(p, smem); break;
    default: out_phase<kWk>(p, smem); break;
  }
}

template <Tile K, int D, bool kWk>
void* mma_kernel() {
  if constexpr (K == Tile::Exact)
    return reinterpret_cast<void*>(fused_block_mma_kernel<D, kWk>);
  else if constexpr (K == Tile::Padded)
    return reinterpret_cast<void*>(fused_block_mma_padded_kernel<D, kWk>);
  else
    return reinterpret_cast<void*>(fused_block_mma_wide_kernel<kWk>);
}

// The blocks of the cooperative launch that fit on the card at once, per
// device, found at its first launch there by the occupancy query for this
// instantiation (the shared memory attributes of both kernels are set once
// with it): the served forward is paced by the host, so a launch makes no
// runtime query. 0 or the cudaError_t.
template <Tile K, int D, bool kWk>
int resident_blocks(int* blocks) {
  constexpr int smem = mma_smem_bytes<K, D, kWk>();
  constexpr int kDevices = 64;
  static int resident[kDevices] = {};
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[device] == 0) {
    void* fn = mma_kernel<K, D, kWk>();
    int sms = 0, per_sm = 0;
    for (void* f : {fn, reinterpret_cast<void*>(
                            fused_block_mma_phase_kernel<K, D, kWk>)})
      if (rc == cudaSuccess)
        rc = cudaFuncSetAttribute(
            f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                         dm::kThreads, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[device] = per_sm * sms;
  }
  *blocks = resident[device];
  return 0;
}

template <Tile K, int D, bool kWk>
int launch_mma(const MmaParams& p, cudaStream_t stream) {
  int blocks = 0;
  const int rc = resident_blocks<K, D, kWk>(&blocks);
  if (rc != 0) return rc;
  // every block must be resident at once for the grid barriers; more than
  // the largest phase's work would only wait at them
  int work = 0;
  for (int phase = 0; phase < 4; ++phase)
    work = std::max(work, phase_work<K, D>(p, phase));
  MmaParams q = p;
  void* args[] = {&q};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      mma_kernel<K, D, kWk>(), dim3(std::min(blocks, work)),
      dim3(dm::kThreads), args, mma_smem_bytes<K, D, kWk>(), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (K == Tile::Exact)
    return vtt::launched("fused_block_mma_kernel");
  else if constexpr (K == Tile::Padded)
    return vtt::launched("fused_block_mma_padded_kernel");
  else
    return vtt::launched("fused_block_mma_wide_kernel");
}

// The phases whose bits are set in `phases`, one ordinary launch each, in
// order on the stream.
template <Tile K, int D, bool kWk>
int launch_phases(const MmaParams& p, int phases, cudaStream_t stream) {
  int blocks = 0;
  const int rc = resident_blocks<K, D, kWk>(&blocks);  // sets the attributes
  if (rc != 0) return rc;
  for (int phase = 0; phase < 4; ++phase) {
    if (((phases >> phase) & 1) == 0) continue;
    fused_block_mma_phase_kernel<K, D, kWk>
        <<<phase_work<K, D>(p, phase), dm::kThreads,
           mma_smem_bytes<K, D, kWk>(), stream>>>(p, phase);
    const int rc = vtt::launched("fused_block_mma_phase_kernel");
    if (rc != 0) return rc;
  }
  return 0;
}

// phases < 0: the block's cooperative launch; else the phases' own launches.
template <Tile K, int D>
int dispatch_mma(const MmaParams& p, bool k_contiguous, int phases,
                 cudaStream_t stream) {
  if (phases < 0)
    return k_contiguous ? launch_mma<K, D, true>(p, stream)
                        : launch_mma<K, D, false>(p, stream);
  return k_contiguous ? launch_phases<K, D, true>(p, phases, stream)
                      : launch_phases<K, D, false>(p, phases, stream);
}

// Checks the operands of the tensor-core route and launches it (phases as
// dispatch_mma's).
int run_mma(const void* x, const void* gamma, const void* beta,
            const void* wqkv, long long ldk1, long long ldn1,
            const void* bqkv, const void* wout, long long ldk3,
            long long ldn3, const void* bout, void* qkv_ws, void* attn_ws,
            void* out, void* stats, void* lse_ws, int b, int s, int heads,
            int dh, float scale, float eps, int phases, void* stream) {
  const bool k_contiguous = ldk1 == 1 && ldk3 == 1;
  const long long ldw1 = k_contiguous ? ldn1 : ldk1;
  const long long ldw3 = k_contiguous ? ldn3 : ldk3;
  if (b < 1 || s < 1 || heads < 1 || dh < 1 || (heads * dh) % 8 != 0 ||
      !(k_contiguous || (ldn1 == 1 && ldn3 == 1)) || ldw1 < 8 ||
      ldw1 % 8 != 0 || ldw3 < 8 || ldw3 % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto addr = [](const void* ptr) {
    return reinterpret_cast<std::uintptr_t>(ptr);
  };
  if ((addr(x) | addr(wqkv) | addr(wout) | addr(gamma) | addr(beta) |
       addr(qkv_ws) | addr(attn_ws) | addr(out)) & 15u ||
      addr(stats) & 7u || addr(lse_ws) & 3u)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const MmaParams p{static_cast<const bf16*>(x),
                    static_cast<const float*>(gamma),
                    static_cast<const float*>(beta),
                    static_cast<const float*>(bqkv),
                    static_cast<const float*>(bout),
                    static_cast<const bf16*>(wqkv),
                    static_cast<const bf16*>(wout), ldw1, ldw3,
                    static_cast<bf16*>(qkv_ws), static_cast<bf16*>(attn_ws),
                    static_cast<bf16*>(out), static_cast<float*>(stats),
                    static_cast<float*>(lse_ws), b, s, heads, dh, scale,
                    eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return dispatch_mma<Tile::Exact, 16>(p, k_contiguous, phases, st);
    case 32: return dispatch_mma<Tile::Exact, 32>(p, k_contiguous, phases, st);
    case 64: return dispatch_mma<Tile::Exact, 64>(p, k_contiguous, phases, st);
    default:
      if (dh > 128)
        return dispatch_mma<Tile::Wide, 0>(p, k_contiguous, phases, st);
      return dh < 16
                 ? dispatch_mma<Tile::Padded, 16>(p, k_contiguous, phases, st)
             : dh < 32
                 ? dispatch_mma<Tile::Padded, 32>(p, k_contiguous, phases, st)
             : dh < 64
                 ? dispatch_mma<Tile::Padded, 64>(p, k_contiguous, phases, st)
                 : dispatch_mma<Tile::Padded, 128>(p, k_contiguous, phases,
                                                   st);
  }
}

}  // namespace

extern "C" {

// Returns 0 or the cudaError_t of the launch. qkv_ws: B·S·3·H·dh and
// attn_ws: B·S·H·dh elements of the compute dtype, overwritten; lse_ws: fp32
// scratch of B·S·H elements at dh above 128 (cudaErrorInvalidValue if
// null there), unread, else ignored. dh >= 1. is_bf16: 1 = bf16, 0 = fp32.
int fused_block_fwd(const void* x, const void* gamma, const void* beta,
                    const void* wqkv, long long ldk1, long long ldn1,
                    const void* bqkv, const void* wout, long long ldk3,
                    long long ldn3, const void* bout, void* qkv_ws,
                    void* attn_ws, void* out, void* lse_ws, int b, int s,
                    int heads, int dh, float scale, float eps, int is_bf16,
                    void* stream) {
  if (b < 1 || s < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, static_cast<const float*>(gamma),
                 static_cast<const float*>(beta),
                 static_cast<const float*>(bqkv),
                 static_cast<const float*>(bout), wqkv, wout, ldk1, ldn1,
                 ldk3, ldn3, qkv_ws, attn_ws, out,
                 static_cast<float*>(lse_ws), b, s, heads, dh, scale, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_dh<__nv_bfloat16>(p, st)
                 : dispatch_dh<float>(p, st);
}

// The tensor-core route, bf16 only: returns 0 or the cudaError_t of the
// launch. Both weights in one layout: (in, out), ldn = 1, or torch's
// (out, in), ldk = 1; their leading strides and H·dh multiples of 8
// (cudaErrorInvalidValue otherwise); dh >= 1. stats: fp32 scratch of 2·B·S
// elements, 8-byte aligned; lse_ws: fp32 scratch of B·S·H elements. x, the weights,
// gamma, beta, both workspaces and out must be 16-byte aligned
// (cudaErrorMisalignedAddress).
int fused_block_mma_fwd(const void* x, const void* gamma, const void* beta,
                        const void* wqkv, long long ldk1, long long ldn1,
                        const void* bqkv, const void* wout, long long ldk3,
                        long long ldn3, const void* bout, void* qkv_ws,
                        void* attn_ws, void* out, void* stats, void* lse_ws,
                        int b, int s, int heads, int dh, float scale,
                        float eps, void* stream) {
  return run_mma(x, gamma, beta, wqkv, ldk1, ldn1, bqkv, wout, ldk3, ldn3,
                 bout, qkv_ws, attn_ws, out, stats, lse_ws, b, s, heads, dh,
                 scale, eps, -1, stream);
}

// For measurement only: the phases of fused_block_mma_fwd whose bits are
// set in `phases` (1 .. 15; bit 0 the row statistics, 1 LayerNorm + QKV,
// 2 the attention, 3 the out-projection), each as one ordinary launch, in
// order. With all four the output is the block's, bit for bit; with fewer
// it is not. Arguments and checks as fused_block_mma_fwd's.
int fused_block_mma_phases(const void* x, const void* gamma, const void* beta,
                           const void* wqkv, long long ldk1, long long ldn1,
                           const void* bqkv, const void* wout, long long ldk3,
                           long long ldn3, const void* bout, void* qkv_ws,
                           void* attn_ws, void* out, void* stats,
                           void* lse_ws, int b, int s, int heads, int dh,
                           float scale, float eps, int phases, void* stream) {
  if (phases < 1 || phases > 15)
    return static_cast<int>(cudaErrorInvalidValue);
  return run_mma(x, gamma, beta, wqkv, ldk1, ldn1, bqkv, wout, ldk3, ldn3,
                 bout, qkv_ws, attn_ws, out, stats, lse_ws, b, s, heads, dh,
                 scale, eps, phases, stream);
}

const char* fused_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
