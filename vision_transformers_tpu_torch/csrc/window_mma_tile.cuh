// Tensor-core bodies of the bf16 window attention: the per-window forward,
// the forward that walks a run of windows, and the backward the window
// kernels share.
//
// Replace, for bf16 inputs, five TPU kernels of vision_transformers_tpu/ops/
// flash_attention.py (rows of PERF.md's kernel table):
//   - row 9, _window_pack_kernel (:1295), through window_attention.cu's
//     window_packed_mma_kernel: window_attend_mma;
//   - row 10, _window_pack_bwd_kernel (:1466), through
//     window_attention_bwd.cu's window_bwd_mma_kernel: window_bwd_rows_mma
//     (query rows), then window_bwd_keys_mma (key rows);
//   - row 11, _window_batched_kernel (:1708), through window_attention.cu's
//     window_batched_mma_kernel, row 12, _window_fused_flat_kernel (:1997),
//     and row 13, _window_fused_kernel (:2056), through
//     window_fused_attention.cu's window_fused_flat_mma_kernel and
//     window_fused_slab_mma_kernel: window_run_mma, which walks a run of
//     windows with window_attend_mma, the copies of the next window in
//     flight while the current one computes.
// fp32 inputs keep window_tile.cuh.
//
// What bounds them on the H100: bytes (window_attention.cu,
// window_attention_bwd.cu: at Swin-T's and SwinV2-T's stage 1 the products
// take 2-5 µs at the bf16 peak, the bytes 23-49 µs). The CUDA-core tiles
// run the products as fp32 FMAs, one thread a row, and in bf16 walk the
// keys twice (m and l first, then the rounded p); these run every product
// as mma.sync.m16n8k16 and keep the whole score row on chip, so nothing is
// recomputed and the time left is the copies.
//
// Design. A window holds N <= 128 tokens, so one (window, head)'s N × N
// scores fit in the accumulators of its warps and nothing streams:
//   - a block takes `wpb` windows of one head; each window's ceil(N / 16)
//     query tiles of 16 rows take one warp each (window_mma_geometry: 4
//     windows of 1 warp at N <= 16, 2 of 2 at N <= 32, else 1 of 3-8). The
//     windows of a block share nothing: each meets at its own named barrier
//     (1 + w), and the warps of a window past G (a ragged last block) leave
//     at once;
//   - the window's Q, K and V rows (the backward's also dO) go to shared
//     memory as bf16 by 16-byte cp.async, in rows padded to D + 8 elements
//     (attention_mma_tile.cuh's conflict-free ldmatrix stride). Rows >= N are
//     zero-filled (source size 0): in the partitioned tensor they belong to
//     the next window or lie past the end of qkv, and 0 · garbage can be NaN;
//   - the bias row g mod nW' of the head, N·N bf16 values that start at an
//     odd element where N·N is odd (N 49), is copied element by element
//     (2-byte loads, consecutive lanes on consecutive elements) into a tile
//     of row stride NK + 8, and read back in the accumulator layout as bf16
//     pairs (an even column, an even stride: 4-byte aligned, no conflicts);
//   - S = Q·Kᵀ over NK keys, NK the least of 16, 32, 64 and 128 that holds N
//     (a template parameter, so N 16 does not pay for 64): NK / 2 fp32
//     accumulators a lane, 32 at N <= 64. A row lives in the four lanes of a
//     quad, so its max and sum are exact after two __shfl_xor_sync each:
//     one pass, no online rescaling, no recompute.
//   - Occupancy (ptxas -v, printed by chip_smoke.py; no kernel spills): the
//     forward 40-78 registers at NK <= 64 (64 at D 32, NK 64, the Swin
//     shapes: 24 KB of shared memory a window, 8 blocks of 128 threads an
//     SM) and 127-128 at NK 128; the backward 64-128 at NK <= 64 (96 at
//     D 32, NK 64: 47 KB a window, 4 blocks of 128 threads an SM, by shared
//     memory) and 207-222 at NK 128 (178 KB at D 64: one block of 256).
//
// Runs of windows (rows 11-13, window_run_mma). A block belongs to one
// head and walks `run` steps of wpb windows (the geometry above); each
// window slot of the block double-buffers its Q, K and V tiles, so the
// cp.async group of step s + 1 is in flight while the slot's warps compute
// step s (one named barrier a step: it both publishes step s's copies and
// tells the slot that step s − 1's buffer, which the prefetch reuses, is
// read). A bias shared by all windows (nW' = 1) is staged once per block,
// as bf16, into one tile every slot reads: the point of row 11's kernel;
// a per-window bias (nW' > 1) is copied per window, its N·N values whole by
// 16-byte cp.async in the group of its Q, K and V (so it is in flight with
// them), and read back as it lies (FlatBias; a bias tile of the packed
// layout would need 2-byte copies, which the warps would wait for). Rows
// 12 and 13 read the un-rolled NHWC map through a row table: each window's
// N flat rows, computed once a token (row 12's strip arithmetic with its
// 64-bit divisions, row 13's rolled rows of one window row) into shared
// memory, then read by the copies and by the output store (RowTable). The
// run is chosen on the host (window_run_launch, window_run_plan.cuh) from
// G·H against what the card holds at once: the SMs times the blocks an SM
// takes at this kernel's registers and shared memory (the occupancy API),
// so one wave of blocks covers the work, at most kMaxRun steps a block;
// past that, more blocks. Row 13's blocks each keep to one window row.
//
// Head dims 1, 2, 4 and 8 (a Swin at 4× its heads: dh 8) run in the 16
// tile: the window's rows staged with their DH elements and 16 − DH zeros
// (window_stage_rows_narrow, copies of the widest grain the offsets keep),
// so the scores are those of the DH columns, and only DH columns of out, dq,
// dk and dv written (window_store_narrow). Every body takes DH as a template
// parameter whose default is the tile width, so the kernels of dh 16, 32 and
// 64 keep their code. Rows 11 and 10 take any other dh up to 64 the same
// way with DH 0 and the dh a runtime argument (the padded kernels, in the
// tile window_tile(dh): copies of window_grain_bytes by window_stage_cols,
// stores of the columns below dh by window_store_cols). Above 64 they take
// window_chunk_tile.cuh's chunks.
//
// Numerics, as _window_pack_kernel and window_attention_reference: s =
// acc·scale + bias in fp32, two roundings (never an FMA: the plain version
// multiplies, then adds), the bias held in bf16 and widened at the add;
// keys >= N replaced by -inf BY INDEX before the max (the models' masks, -100
// and -1e9, stay ordinary values); p = exp(s − m) / l, an IEEE division;
// the forward rounds p to bf16 as P·V's A fragments and divides nothing
// after P·V. The scale is applied to the fp32 product: folding it into a
// bf16 q would round q·(1/√32) and be another function.
//
// Backward (per (window, head), from qkv and the bias alone, no statistic
// of the forward): p in fp32 as above; dP = dO·Vᵀ; δ = rowsum(p ⊙ dP) from
// the fp32 p and dP; ds = p ⊙ (dP − δ). bf16(p), bf16(ds·scale) and, when
// the bias gradient is wanted, bf16(ds) (before the scale) go to three
// shared tiles of row stride NK + 8 (the last one the bias tile, each lane
// overwriting exactly the elements it read); dQ = bf16(ds·scale)·K from the
// same rounded values in registers. After the window's barrier, warp t owns
// key tile t: dK = bf16(ds·scale)ᵀ·Q and dV = bf16(p)ᵀ·dO with the tiles
// read transposed by ldmatrix.trans as A fragments, Q and dO as P·V reads
// V. So every product sees the values _window_pack_bwd_kernel rounds once
// (its ds_c and probs_c). Query rows >= N get p = ds = 0 explicitly, so
// they add nothing to dK and dV, whatever dO holds; keys >= N have p = 0
// and get no row. ds_out is copied from its tile as rows of N, consecutive
// lanes on consecutive elements (a row of N 49 starts at an odd element).
// Every output element has one owner and every sum a fixed order: no
// atomics, reruns bit-equal.
#pragma once

#include <algorithm>
#include <mutex>
#include <type_traits>
#include <vector>

#include "attention_mma_tile.cuh"
#include "launch_log.cuh"
#include "window_run_plan.cuh"

namespace vtt {
namespace mma {

constexpr int kWinMmaMaxThreads = 256;  // 8 query tiles of N 128

// Keys of a window's tiles: the least of 16, 32, 64 and 128 that holds n.
__host__ __device__ constexpr int window_keys(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
}

// The tile width a head dim d up to 64 runs in: the least of 16, 32 and 64
// that holds it (d 1, 2, 4 and 8 in the 16 tile; rows 10 and 11 at any other
// d in the padded kernels; above 64 window_chunk_tile.cuh).
__host__ __device__ constexpr int window_tile(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : 64;
}

// The bytes a row of d bf16 values is copied by: the largest power of two,
// at most 16, that divides 2·d (ops/flash_attention.py's window_grain), since
// every offset of a row (its row, section and head) is a multiple of d
// elements: 16 for d a multiple of 8, 8 for d 12 or 20, 2 for an odd d.
__host__ __device__ constexpr int window_grain_bytes(int d) {
  return ((2 * d) & -(2 * d)) < 16 ? ((2 * d) & -(2 * d)) : 16;
}

// Query tiles (= warps) a window takes, windows a block takes, threads.
struct WindowGeometry {
  int mt, wpb, threads;
};

inline WindowGeometry window_mma_geometry(int n) {
  const int mt = (n + 15) / 16;
  const int wpb = mt >= 4 ? 1 : 4 / mt;
  return {mt, wpb, 32 * mt * wpb};
}

// bf16 elements of shared memory a window takes: `rows` matrices of NK
// rows of D + 8, then `tiles` score tiles of NK rows of NK + 8.
template <int D, int NK>
__host__ __device__ constexpr int window_smem_elems(int rows, int tiles) {
  return rows * NK * (D + 8) + tiles * NK * (NK + 8);
}

// The warps of window w of the block meet (named barrier 1 + w; barrier 0
// is __syncthreads').
__device__ __forceinline__ void window_sync(int w, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + w), "r"(threads) : "memory");
}

// Where row r of a window lies, in elements from the matrix's base pointer:
// rows `stride` apart (the partitioned tensor; rows 9 and 10), or a row
// table's entries times the stride (row 12's flat rows of the map).
struct RowStride {
  long long stride;
  __device__ __forceinline__ long long operator()(int r) const {
    return r * stride;
  }
};

struct RowTable {
  const long long* table;  // shared memory, one entry a token
  long long stride;
  __device__ __forceinline__ long long operator()(int r) const {
    return table[r] * stride;
  }
};

// Rows [0, n) of an (n, D) bf16 matrix whose row r lies at g + rows(r) into
// shared memory of row stride D + 8, rows [n, NK) zero-filled, by the
// `count` threads numbered tid; the caller commits.
template <int D, int NK, class Rows>
__device__ __forceinline__ void window_stage_rows(bf16* s, const bf16* g,
                                                  int n, const Rows& rows,
                                                  int tid, int count) {
  constexpr int C = D / 8;  // 16-byte chunks a row
  for (int idx = tid; idx < NK * C; idx += count) {
    const int r = idx / C, c = idx % C;
    const bool in = r < n;
    cp_async_16(s + r * (D + 8) + c * 8, g + rows(in ? r : 0) + c * 8, in);
  }
}

// 8 bytes global → shared, zero-filled when !pred (window rows of dh 4).
__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 8 : 0));
}

// Columns [c0, c0 + C) of rows [0, n) of a bf16 matrix of head dim dh whose
// row r lies at g + rows(r), into shared memory of row stride C + 8, columns
// >= dh and rows [n, NK) zero-filled, by the `count` threads numbered tid, in
// pieces of E elements, the grain: 16-byte cp.async at E 8, 8-byte at 4,
// 4-byte at 2 (zero pieces with source size 0), plain 2-byte loads and
// stores at 1, which the caller's barrier publishes as it does the copies.
// dh is a multiple of E and c0 of C, so a piece lies wholly in or past the
// row. The caller commits.
template <int E, int C, int NK, class Rows>
__device__ __forceinline__ void window_stage_cols_by(bf16* s, const bf16* g,
                                                     int n, const Rows& rows,
                                                     int c0, int dh, int tid,
                                                     int count) {
  constexpr int P = C / E;  // pieces a row
  for (int idx = tid; idx < NK * P; idx += count) {
    const int r = idx / P, c = (idx % P) * E;
    const bool in = r < n && c0 + c < dh;
    bf16* dst = s + r * (C + 8) + c;
    const bf16* src = g + (in ? rows(r) + c0 + c : 0);
    if constexpr (E == 8) {
      cp_async_16(dst, src, in);
    } else if constexpr (E == 4) {
      cp_async_8(dst, src, in);
    } else if constexpr (E == 2) {
      cp_async_4(dst, src, in);
    } else {
      *reinterpret_cast<unsigned short*>(dst) =
          in ? *reinterpret_cast<const unsigned short*>(src) : 0;
    }
  }
}

// The same at the grain of a runtime head dim dh (window_grain_bytes): the
// rows of the padded tiles (c0 = 0, C the tile) and the chunks of
// window_chunk_tile.cuh.
template <int C, int NK, class Rows>
__device__ __forceinline__ void window_stage_cols(bf16* s, const bf16* g,
                                                  int n, const Rows& rows,
                                                  int c0, int dh, int tid,
                                                  int count) {
  switch (window_grain_bytes(dh)) {
    case 16:
      window_stage_cols_by<8, C, NK>(s, g, n, rows, c0, dh, tid, count);
      break;
    case 8:
      window_stage_cols_by<4, C, NK>(s, g, n, rows, c0, dh, tid, count);
      break;
    case 4:
      window_stage_cols_by<2, C, NK>(s, g, n, rows, c0, dh, tid, count);
      break;
    default:
      window_stage_cols_by<1, C, NK>(s, g, n, rows, c0, dh, tid, count);
  }
}

// window_stage_rows for a head dim DH of 1, 2, 4 or 8 in the tile of width
// 16: each row's DH elements and 16 − DH zeros, by pieces of the widest
// grain every offset keeps (rows, sections and head offsets are multiples of
// DH elements): 16-byte cp.async at DH 8, 8-byte at 4, 4-byte at 2 (zero
// pieces with source size 0), plain 2-byte loads and stores at 1, which the
// caller's barrier publishes as it does the copies.
template <int DH, int NK, class Rows>
__device__ __forceinline__ void window_stage_rows_narrow(
    bf16* s, const bf16* g, int n, const Rows& rows, int tid, int count) {
  static_assert(DH == 1 || DH == 2 || DH == 4 || DH == 8,
                "narrow head dims are 1, 2, 4 and 8");
  constexpr int D = 16;
  if constexpr (DH == 1) {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(g);
    unsigned short* su = reinterpret_cast<unsigned short*>(s);
    for (int idx = tid; idx < NK * D; idx += count) {
      const int r = idx / D, c = idx % D;
      su[r * (D + 8) + c] = r < n && c == 0 ? u[rows(r)] : 0;
    }
  } else {
    constexpr int E = DH;      // elements a piece
    constexpr int C = D / E;   // pieces a row, the first one DH's
    for (int idx = tid; idx < NK * C; idx += count) {
      const int r = idx / C, c = idx % C;
      const bool in = r < n && c == 0;
      bf16* dst = s + r * (D + 8) + c * E;
      const bf16* src = g + rows(in ? r : 0);
      if constexpr (DH == 8)
        cp_async_16(dst, src, in);
      else if constexpr (DH == 4)
        cp_async_8(dst, src, in);
      else
        cp_async_4(dst, src, in);
    }
  }
}

// window_stage_rows at head dim DH: the tile's own width, (DH < D = 16) the
// narrow copies, or (DH 0, the padded kernels) the runtime head dim dh.
template <int D, int NK, int DH, class Rows>
__device__ __forceinline__ void window_stage_rows_as(bf16* s, const bf16* g,
                                                     int n, const Rows& rows,
                                                     int tid, int count,
                                                     int dh = DH) {
  if constexpr (DH == D)
    window_stage_rows<D, NK>(s, g, n, rows, tid, count);
  else if constexpr (DH == 0)
    window_stage_cols<D, NK>(s, g, n, rows, 0, dh, tid, count);
  else
    window_stage_rows_narrow<DH, NK>(s, g, n, rows, tid, count);
}

// The same with rows `stride` elements apart.
template <int D, int NK, int DH = D>
__device__ __forceinline__ void window_stage(bf16* s, const bf16* g, int n,
                                             long long stride, int tid,
                                             int count, int dh = DH) {
  window_stage_rows_as<D, NK, DH>(s, g, n, RowStride{stride}, tid, count, dh);
}

// Columns col, col + 1 (col even, in the first 8) of a window row of DH
// elements (1, 2, 4 or 8) at p, rounded to bf16: both where col < DH, or
// column 0 alone at DH 1.
template <int DH>
__device__ __forceinline__ void window_store_narrow(bf16* p, int col,
                                                   float x0, float x1) {
  if constexpr (DH == 1) {
    if (col == 0) p[0] = __float2bfloat16_rn(x0);
  } else {
    if (col < DH)
      *reinterpret_cast<__nv_bfloat162*>(p + col) =
          __floats2bfloat162_rn(x0, x1);
  }
}

// Columns col, col + 1 (col even) of a row of dh elements at p, rounded to
// bf16, those below dh: a pair by one 4-byte store at an even dh (the row's
// offsets keep 4 bytes), else one by one.
__device__ __forceinline__ void window_store_cols(bf16* p, int col, int dh,
                                                  float x0, float x1) {
  if ((dh & 1) == 0) {
    if (col < dh)
      *reinterpret_cast<__nv_bfloat162*>(p + col) =
          __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < dh) p[col] = __float2bfloat16_rn(x0);
    if (col + 1 < dh) p[col + 1] = __float2bfloat16_rn(x1);
  }
}

// The bias rows [0, n) × [0, n) of one (window, head), n·n consecutive
// bf16 values, into shared memory of row stride NK + 8: warp t of the
// window's mt takes rows t, t + mt, ..., its lanes consecutive columns.
template <int NK>
__device__ __forceinline__ void window_stage_bias(bf16* s,
                                                  const bf16* __restrict__ b,
                                                  int n, int t, int mt,
                                                  int lane) {
  for (int r = t; r < n; r += mt)
    for (int c = lane; c < n; c += 32) s[r * (NK + 8) + c] = b[r * n + c];
}

// The A fragments (16 rows × D) of rows a[0 .. 16) of a shared-memory
// matrix of row stride D + 8, by ldmatrix.x4.
template <int D>
__device__ __forceinline__ void load_a_smem(uint32_t (&f)[D / 16][4],
                                            const bf16* a, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(f[kk], a + (lane & 15) * (D + 8) + kk * 16 + (lane >> 4) * 8);
}

// The A fragment of the transpose of a 16 × 16 block of a shared-memory
// tile of row stride NK + 8 whose rows are the k index: block rows
// [k0, k0 + 16), columns [m0, m0 + 16), by ldmatrix.x4.trans.
template <int NK>
__device__ __forceinline__ void load_at_smem(uint32_t (&f)[4], const bf16* t,
                                             int k0, int m0, int lane) {
  ldsm_x4_t(f, t + (k0 + (lane & 7) + ((lane >> 4) << 3)) * (NK + 8) + m0
                   + ((lane >> 3) & 1) * 8);
}

// Where window_probs reads the bias pair (r, kj), (r, kj + 1), kj even:
// a tile of row stride NK + 8 (or no bias: null), read as one aligned bf16
// pair; or the window's N·N values as they lie in device memory, row r at
// r·n, copied whole (rows 11 and 12's own bias rows): two 2-byte reads,
// since a row of odd N starts at an odd element.
template <int NK>
struct TileBias {
  const bf16* s;
  __device__ __forceinline__ bool present() const { return s != nullptr; }
  __device__ __forceinline__ float2 pair(int r, int kj) const {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(s + r * (NK + 8) + kj));
  }
};

struct FlatBias {
  const bf16* s;
  int n;
  __device__ __forceinline__ bool present() const { return true; }
  __device__ __forceinline__ float2 pair(int r, int kj) const {
    const bf16* p = s + r * n + kj;
    return make_float2(__bfloat162float(p[0]), __bfloat162float(p[1]));
  }
};

// s: this lane's accumulators of Q·Kᵀ for rows r0 and r0 + 8 of the window
// (columns n8·8 + 2·tq + {0, 1}) → p = exp(s·scale + bias − m) / l in fp32,
// keys >= n at exactly 0. bias: TileBias or FlatBias. Rows >= n are left as
// computed (the scores of zero queries); the caller decides.
template <int NK, class Bias>
__device__ __forceinline__ void window_probs_with(float (&s)[NK / 8][4],
                                                  const Bias& bias, int r0,
                                                  int n, int tq, float scale) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i, kj = n8 * 8 + 2 * tq;
      float2 b = make_float2(0.f, 0.f);
      if (bias.present() && r < n) b = bias.pair(r, kj);
      float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
      if (kj < n) x0 = __fadd_rn(__fmul_rn(s[n8][2 * i], scale), b.x);
      if (kj + 1 < n) x1 = __fadd_rn(__fmul_rn(s[n8][2 * i + 1], scale), b.y);
      s[n8][2 * i] = x0;
      s[n8][2 * i + 1] = x1;
      mx[i] = fmaxf(mx[i], fmaxf(x0, x1));
    }
  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    l[i] = 0.f;
  }
#pragma unroll
  for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[n8][e] - mx[e >> 1]);  // key 0 < n: m finite
      s[n8][e] = p;
      l[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n8][e] = s[n8][e] / l[e >> 1];
}

// The same with the bias tile bs (row stride NK + 8) or null.
template <int NK>
__device__ __forceinline__ void window_probs(float (&s)[NK / 8][4],
                                             const bf16* bs, int r0, int n,
                                             int tq, float scale) {
  window_probs_with<NK>(s, TileBias<NK>{bs}, r0, n, tq, scale);
}

// Query tile t (rows 16·t .. 16·t + 15) of one (window, head): out rows
// r < n in bf16 at o + rows(r). qs, ks, vs: the window's Q, K, V tiles (row
// stride D + 8, rows >= n zero, columns past the head dim zero); bias:
// TileBias or FlatBias. DH: the head dim, or 0 for the runtime dh of the
// padded kernels (any dh up to the tile D; only its columns are stored).
template <int D, int NK, int DH = D, class Rows, class Bias>
__device__ __forceinline__ void window_attend_mma_rows(
    const bf16* qs, const bf16* ks, const bf16* vs, const Bias& bias, int n,
    int t, float scale, bf16* __restrict__ o, const Rows& rows, int lane,
    int dh = DH) {
  static_assert(D == 16 || D == 32 || D == 64, "tile width must be 16, 32 or 64");
  static_assert(DH == D || DH == 0 || (D == 16 && DH < 16),
                "a head dim below 16 runs in the 16 tile");
  constexpr int S = D + 8;
  const int tq = lane & 3;
  const int r0 = t * 16 + (lane >> 2);

  uint32_t qf[D / 16][4];
  load_a_smem<D>(qf, qs + t * 16 * S, lane);
  float s[NK / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n8][e] = 0.f;
  mma_abt<D, NK / 8>(s, qf, ks, lane);
  window_probs_with<NK>(s, bias, r0, n, tq, scale);

  float acc[D / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n8][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[4];
    acc_to_a(a, s[2 * kk], s[2 * kk + 1]);  // p rounded to bf16 here
    mma_ab<D>(acc, a, vs + kk * 16 * S, lane);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= n) continue;
    if constexpr (DH == D) {
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
        *reinterpret_cast<__nv_bfloat162*>(o + rows(r) + n8 * 8 + 2 * tq) =
            __floats2bfloat162_rn(acc[n8][2 * i], acc[n8][2 * i + 1]);
    } else if constexpr (DH == 0) {
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
        window_store_cols(o + rows(r), n8 * 8 + 2 * tq, dh, acc[n8][2 * i],
                          acc[n8][2 * i + 1]);
    } else {
      window_store_narrow<DH>(o + rows(r), 2 * tq, acc[0][2 * i],
                              acc[0][2 * i + 1]);
    }
  }
}

// The same with out rows o_stride elements apart and the bias tile bs (row
// stride NK + 8) or null.
template <int D, int NK, int DH = D>
__device__ __forceinline__ void window_attend_mma(
    const bf16* qs, const bf16* ks, const bf16* vs, const bf16* bs, int n,
    int t, float scale, bf16* __restrict__ o, long long o_stride, int lane) {
  window_attend_mma_rows<D, NK, DH>(qs, ks, vs, TileBias<NK>{bs}, n, t, scale,
                                    o, RowStride{o_stride}, lane);
}

// The backward's score gradient of query tile rows r0, r0 + 8 from this
// lane's fp32 p (window_probs) and dP = dO·Vᵀ: δ = rowsum(p ⊙ dP) over the
// quad, ds = p ⊙ (dP − δ) (0 on query rows >= n, whose p is zeroed too, so
// they add nothing to dK and dV); bf16(p) to pt, bf16(ds·scale) to dt and,
// where xs is not null, bf16(ds) to xs (row stride NK + 8); dp left holding
// ds·scale in fp32, whose bf16 rounding is what dt holds.
template <int NK>
__device__ __forceinline__ void window_bwd_ds(float (&p)[NK / 8][4],
                                              float (&dp)[NK / 8][4],
                                              bf16* xs, bf16* pt, bf16* dt,
                                              int r0, int n, int tq,
                                              float scale) {
  constexpr int SB = NK + 8;
  const bool live[2] = {r0 < n, r0 + 8 < n};
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!live[e >> 1]) p[n8][e] = 0.f;  // padded query rows add nothing
      delta[e >> 1] += p[n8][e] * dp[n8][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
  }
#pragma unroll
  for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int off = (r0 + 8 * i) * SB + n8 * 8 + 2 * tq;
      float ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        ds[c] = live[i] ? p[n8][2 * i + c] * (dp[n8][2 * i + c] - delta[i])
                        : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(pt + off) =
          __floats2bfloat162_rn(p[n8][2 * i], p[n8][2 * i + 1]);
      if (xs != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(xs + off) =
            __floats2bfloat162_rn(ds[0], ds[1]);
      dp[n8][2 * i] = ds[0] * scale;
      dp[n8][2 * i + 1] = ds[1] * scale;
      *reinterpret_cast<__nv_bfloat162*>(dt + off) =
          __floats2bfloat162_rn(dp[n8][2 * i], dp[n8][2 * i + 1]);
    }
}

// The backward's query tile t of one (window, head): p, ds and dq. qs, ks,
// vs, dos: the window's Q, K, V, dO tiles (row stride D + 8, rows >= n
// zero); bs: its bias tile or null; xs: null, or the tile for bf16(ds)
// (the bias tile itself where there is one: each lane writes exactly the
// elements it read); pt, dt: bf16(p) and bf16(ds·scale) (row stride
// NK + 8), every element of rows 16·t .. 16·t + 15 written. dq rows < n in
// bf16 at row stride dq_stride. DH as in window_attend_mma_rows.
template <int D, int NK, int DH = D>
__device__ __forceinline__ void window_bwd_rows_mma(
    const bf16* qs, const bf16* ks, const bf16* vs, const bf16* dos,
    const bf16* bs, bf16* xs, bf16* pt, bf16* dt, int n, int t, float scale,
    bf16* __restrict__ dq, long long dq_stride, int lane, int dh = DH) {
  static_assert(D == 16 || D == 32 || D == 64, "tile width must be 16, 32 or 64");
  static_assert(DH == D || DH == 0 || (D == 16 && DH < 16),
                "a head dim below 16 runs in the 16 tile");
  constexpr int S = D + 8;
  const int tq = lane & 3;
  const int r0 = t * 16 + (lane >> 2);

  float p[NK / 8][4];
  {
    uint32_t qf[D / 16][4];
    load_a_smem<D>(qf, qs + t * 16 * S, lane);
#pragma unroll
    for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n8][e] = 0.f;
    mma_abt<D, NK / 8>(p, qf, ks, lane);
  }
  window_probs<NK>(p, bs, r0, n, tq, scale);
  float dp[NK / 8][4];
  {
    uint32_t df[D / 16][4];
    load_a_smem<D>(df, dos + t * 16 * S, lane);
#pragma unroll
    for (int n8 = 0; n8 < NK / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n8][e] = 0.f;
    mma_abt<D, NK / 8>(dp, df, vs, lane);
  }
  window_bwd_ds<NK>(p, dp, xs, pt, dt, r0, n, tq, scale);
  const bool live[2] = {r0 < n, r0 + 8 < n};

  float acc[D / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n8][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[4];
    acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);  // the bits dt holds
    mma_ab<D>(acc, a, ks + kk * 16 * S, lane);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    if constexpr (DH == D) {
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
        *reinterpret_cast<__nv_bfloat162*>(dq + (r0 + 8 * i) * dq_stride
                                           + n8 * 8 + 2 * tq) =
            __floats2bfloat162_rn(acc[n8][2 * i], acc[n8][2 * i + 1]);
    } else if constexpr (DH == 0) {
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
        window_store_cols(dq + (r0 + 8 * i) * dq_stride, n8 * 8 + 2 * tq, dh,
                          acc[n8][2 * i], acc[n8][2 * i + 1]);
    } else {
      window_store_narrow<DH>(dq + (r0 + 8 * i) * dq_stride, 2 * tq,
                              acc[0][2 * i], acc[0][2 * i + 1]);
    }
  }
}

// The backward's key tile t (keys 16·t .. 16·t + 15) of one (window, head),
// after every query tile's window_bwd_rows_mma: dk = bf16(ds·scale)ᵀ·Q and
// dv = bf16(p)ᵀ·dO over the mt query tiles, rows < n in bf16 at row stride
// stride. DH as in window_attend_mma_rows.
template <int D, int NK, int DH = D>
__device__ __forceinline__ void window_bwd_keys_mma(
    const bf16* qs, const bf16* dos, const bf16* pt, const bf16* dt, int n,
    int t, int mt, bf16* __restrict__ dk, bf16* __restrict__ dv,
    long long stride, int lane, int dh = DH) {
  constexpr int S = D + 8;
  const int tq = lane & 3;
  const int j0 = t * 16 + (lane >> 2);
  float ak[D / 8][4], av[D / 8][4];
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n8][e] = av[n8][e] = 0.f;
  for (int kk = 0; kk < mt; ++kk) {
    uint32_t a[4];
    load_at_smem<NK>(a, dt, kk * 16, t * 16, lane);
    mma_ab<D>(ak, a, qs + kk * 16 * S, lane);
    load_at_smem<NK>(a, pt, kk * 16, t * 16, lane);
    mma_ab<D>(av, a, dos + kk * 16 * S, lane);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = j0 + 8 * i;
    if (j >= n) continue;
    if constexpr (DH == D) {
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8) {
        const long long off = j * stride + n8 * 8 + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(dk + off) =
            __floats2bfloat162_rn(ak[n8][2 * i], ak[n8][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) =
            __floats2bfloat162_rn(av[n8][2 * i], av[n8][2 * i + 1]);
      }
    } else if constexpr (DH == 0) {
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8) {
        window_store_cols(dk + j * stride, n8 * 8 + 2 * tq, dh, ak[n8][2 * i],
                          ak[n8][2 * i + 1]);
        window_store_cols(dv + j * stride, n8 * 8 + 2 * tq, dh, av[n8][2 * i],
                          av[n8][2 * i + 1]);
      }
    } else {
      window_store_narrow<DH>(dk + j * stride, 2 * tq, ak[0][2 * i],
                              ak[0][2 * i + 1]);
      window_store_narrow<DH>(dv + j * stride, 2 * tq, av[0][2 * i],
                              av[0][2 * i + 1]);
    }
  }
}

// Windows of the partitioned (G, N, ·) tensor: window g, token i → row
// g·N + i, so a window's rows are consecutive and need no table.
struct PackedWindows {
  static constexpr bool kTable = false;
  int n;
  __device__ __forceinline__ long long operator()(long long g, int i) const {
    return g * n + i;
  }
};

// bf16 elements of one buffer of a window slot: Q, K and V (row stride
// D + 8) and, with a per-window bias, room for the window's N·N bias values
// copied whole from the 16-byte boundary at or before their start (up to 7
// values before them) plus the NK − 1 values window_probs may read past a
// row's end for keys >= N.
template <int D, int NK>
__host__ __device__ constexpr int window_run_buffer_elems(bool own_bias) {
  return 3 * NK * (D + 8) + (own_bias ? NK * NK + NK + 8 : 0);
}

// Elements of the block's shared memory before the row tables: the shared
// bias tile (nW' = 1, row stride NK + 8), then wpb slots of two buffers.
template <int D, int NK>
__host__ __device__ constexpr int window_run_elems(int wpb, bool shared_bias,
                                                   bool own_bias) {
  return (shared_bias ? NK * (NK + 8) : 0) +
         wpb * 2 * window_run_buffer_elems<D, NK>(own_bias);
}

// 16 bytes global → shared of which the first `bytes` (0-16) are read and
// the rest zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async_16_part(void* dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

// Where window g's own bias row (g mod nW' of head h, N·N values) starts in
// the (nW', H, N, N) bias, and where the 16-byte chunk holding its first
// value starts (the tensor's start is 16-byte aligned).
struct OwnBias {
  long long off, first;
  __device__ __forceinline__ OwnBias(long long g, int bias_windows, int heads,
                                     int h, int n)
      : off(((g % bias_windows) * heads + h) * n * n), first(off & ~7LL) {}
  __device__ __forceinline__ int head() const {
    return static_cast<int>(off - first);
  }
};

// Window gw of the slot whose buffer is `qs` (Q, K, V, then its own bias
// values) for window_run_mma: its rows into `rows` first (table maps), then
// Q, K, V and, with a per-window bias (bias non-null, `total` values), the
// window's bias row as whole 16-byte chunks, as one cp.async group. DH as
// in window_attend_mma_rows.
template <int D, int NK, int DH = D, class Windows>
__device__ __forceinline__ void window_run_load(
    const Windows& wins, bf16* qs, long long* rows, const bf16* col,
    long long sec, long long gw, int n, int w, int t, int mt, int lane,
    const bf16* bias, long long total, const OwnBias& own, int dh = DH) {
  constexpr int S = D + 8;
  const int tid = t * 32 + lane, count = mt * 32;
  if constexpr (Windows::kTable) {
    if (tid < n) rows[tid] = wins(gw, tid);  // count >= 2n threads
    window_sync(w, count);
    const RowTable in{rows, 3 * sec};
    window_stage_rows_as<D, NK, DH>(qs, col, n, in, tid, count);
    window_stage_rows_as<D, NK, DH>(qs + NK * S, col + sec, n, in, tid,
                                    count);
    window_stage_rows_as<D, NK, DH>(qs + 2 * NK * S, col + 2 * sec, n, in,
                                    tid, count);
  } else {
    const bf16* src = col + wins(gw, 0) * 3 * sec;
    window_stage<D, NK, DH>(qs, src, n, 3 * sec, tid, count, dh);
    window_stage<D, NK, DH>(qs + NK * S, src + sec, n, 3 * sec, tid, count,
                            dh);
    window_stage<D, NK, DH>(qs + 2 * NK * S, src + 2 * sec, n, 3 * sec, tid,
                            count, dh);
  }
  if (bias != nullptr) {  // chunks past the tensor's end read nothing
    bf16* bs = qs + 3 * NK * S;
    const int chunks = (own.head() + n * n + 7) / 8;
    for (int c = tid; c < chunks; c += count) {
      const long long e = own.first + 8LL * c, left = total - e;
      const int bytes = left >= 8 ? 16 : left > 0 ? static_cast<int>(2 * left)
                                                  : 0;
      cp_async_16_part(bs + 8 * c, bytes > 0 ? bias + e : bias, bytes);
    }
  }
  cp_async_commit();
}

// Windows of head blockIdx.y, `run` steps of wpb windows from window
// `first` on (window slot w takes first + w, first + w + wpb, ...), those
// below `end`: out = softmax(q·kᵀ·scale + bias)·v for each, as
// window_attend_mma computes it. `wins` names each token's flat row (q at
// column h·D of a row of 3·sec elements, k at sec + h·D, v at 2·sec + h·D;
// out at h·D of a row of sec); a Windows policy with kTable keeps the rows
// of the window in flight in a shared-memory table. bias: null or
// (nW', H, N, N) bf16, window g reading row g mod nW'. DH as in
// window_attend_mma_rows (0: the runtime dh, row 11's padded kernels on the
// partitioned tensor).
template <int D, int NK, int DH = D, class Windows>
__device__ __forceinline__ void window_run_mma(
    const Windows& wins, const bf16* __restrict__ qkv,
    const bf16* __restrict__ bias, bf16* __restrict__ out, long long first,
    long long end, int n, int heads, long long sec, int bias_windows,
    float scale, int mt, int wpb, int run, int dh = DH) {
  constexpr int S = D + 8, SB = NK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp / mt, t = warp % mt;  // window slot, query tile
  const int count = mt * 32;
  const int h = blockIdx.y;
  const bool shared_bias = bias != nullptr && bias_windows == 1;
  const bool own_bias = bias != nullptr && bias_windows > 1;
  const int elems = window_run_buffer_elems<D, NK>(own_bias);
  bf16* sb = reinterpret_cast<bf16*>(smem_raw);  // the shared bias tile
  bf16* slot = sb + (shared_bias ? NK * SB : 0) + w * 2 * elems;
  long long* table = reinterpret_cast<long long*>(
      sb + window_run_elems<D, NK>(wpb, shared_bias, own_bias)) + w * 2 * NK;
  const bf16* col = qkv + h * dh;
  const long long own = first + w;  // the slot's first window
  const bf16* own_rows = own_bias ? bias : nullptr;
  const long long total = static_cast<long long>(bias_windows) * heads * n * n;
  const int nwp = own_bias ? bias_windows : 1;  // OwnBias's modulus, not 0

  if (shared_bias)  // once, by every warp of the block
    window_stage_bias<NK>(sb, bias + static_cast<long long>(h) * n * n, n,
                          warp, mt * wpb, lane);
  if (own < end)
    window_run_load<D, NK, DH>(wins, slot, table, col, sec, own, n, w, t, mt,
                           lane, own_rows, total,
                           OwnBias(own, nwp, heads, h, n), dh);
  __syncthreads();  // the shared bias tile
  for (int s = 0; s < run; ++s) {
    const long long gw = own + static_cast<long long>(s) * wpb;
    if (gw >= end) break;  // the same for every warp of the slot
    // this step's group is the only one in flight: the next is issued below
    cp_async_wait<0>();
    // buffer s & 1 is complete for the slot, and the slot has finished step
    // s − 1, whose buffer (and row table) the prefetch below overwrites
    window_sync(w, count);
    const int b = s & 1;
    if (s + 1 < run && gw + wpb < end)
      window_run_load<D, NK, DH>(wins, slot + (b ^ 1) * elems,
                             table + (b ^ 1) * NK, col, sec, gw + wpb, n, w,
                             t, mt, lane, own_rows, total,
                             OwnBias(gw + wpb, nwp, heads, h, n), dh);
    const bf16* qs = slot + b * elems;
    const auto attend = [&](const auto& bias_at) {
      if constexpr (Windows::kTable)
        window_attend_mma_rows<D, NK, DH>(qs, qs + NK * S, qs + 2 * NK * S,
                                          bias_at, n, t, scale, out + h * dh,
                                          RowTable{table + b * NK, sec},
                                          lane, dh);
      else
        window_attend_mma_rows<D, NK, DH>(qs, qs + NK * S, qs + 2 * NK * S,
                                          bias_at, n, t, scale,
                                          out + wins(gw, 0) * sec + h * dh,
                                          RowStride{sec}, lane, dh);
    };
    if (own_bias)
      attend(FlatBias{qs + 3 * NK * S +
                          OwnBias(gw, nwp, heads, h, n).head(),
                      n});
    else
      attend(TileBias<NK>{shared_bias ? sb : nullptr});
  }
}

// f(std::integral_constant<int, NK>()) for the key tiles NK that hold n:
// the one dispatch from N to the window kernels' templates.
template <class F>
inline int with_window_keys(int n, F&& f) {
  switch (window_keys(n)) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    default: return f(std::integral_constant<int, 128>());
  }
}

// The current card's SMs and the blocks an SM takes of `kernel` at
// `threads` and `smem` bytes, its attributes set first (as much dynamic
// shared memory as any of its shapes takes, the SM's memory carved out as
// shared). Asked of the runtime once per (kernel, device, threads, smem),
// then read from a table: the attribute and occupancy calls cost host time
// on every launch otherwise, and the window paths wait on the host.
inline cudaError_t run_occupancy(const void* kernel, int threads, size_t smem,
                                 int* sms, int* blocks) {
  struct Seen {
    const void* kernel;
    int dev, threads;
    size_t smem;
    int sms, blocks;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t most = smem;  // lowering the limit would fail a larger shape seen
  for (const Seen& o : seen) {
    if (o.kernel != kernel || o.dev != dev) continue;
    if (o.threads == threads && o.smem == smem) {
      *sms = o.sms;
      *blocks = o.blocks;
      return cudaSuccess;
    }
    most = std::max(most, o.smem);
  }
  Seen s{kernel, dev, threads, smem, 0, 0};
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.blocks, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (s.blocks < 1) return cudaErrorInvalidConfiguration;
  seen.push_back(s);
  *sms = s.sms;
  *blocks = s.blocks;
  return cudaSuccess;
}

// Launches a window_run_mma kernel of head dim D (`name` for the launch log;
// its tile window_tile(D) wide) on g windows
// of n tokens and `heads` heads (row_windows: 0, or the windows of a row no
// block may cross; bias_windows 0: no bias; table: the kernel keeps a row
// table a window slot) with `args`, then the shape's mt, wpb and run. The
// run and the blocks: window_run_plan (window_run_plan.cuh) against the
// blocks the card holds at once, its SMs times the blocks an SM takes at
// this kernel's registers and shared memory. Grid: x = the head's blocks,
// y = H.
template <int D, int NK, class... Params, class... Args>
inline int window_run_launch(void (*kernel)(Params...), const char* name,
                             long long g, int row_windows, int n, int heads,
                             int bias_windows, bool table, const void* bias,
                             cudaStream_t stream, Args... args) {
  // a per-window bias row is copied by 16-byte cp.async from the tensor's
  // 16-byte chunks
  if (bias_windows > 1 && reinterpret_cast<uintptr_t>(bias) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const WindowGeometry geo = window_mma_geometry(n);
  constexpr int T = window_tile(D);
  const size_t smem =
      window_run_elems<T, NK>(geo.wpb, bias_windows == 1, bias_windows > 1) *
          sizeof(bf16) +
      (table ? geo.wpb * 2 * NK * sizeof(long long) : 0);
  int sms = 0, blocks_per_sm = 0;
  const cudaError_t err =
      run_occupancy(reinterpret_cast<const void*>(kernel), geo.threads, smem,
                    &sms, &blocks_per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RunPlan plan =
      window_run_plan(g, row_windows, geo.wpb, heads,
                      static_cast<long long>(blocks_per_sm) * sms);
  kernel<<<dim3(static_cast<unsigned>(plan.blocks), heads), geo.threads,
           smem, stream>>>(args..., geo.mt, geo.wpb, plan.run);
  return launched(name);
}

}  // namespace mma
}  // namespace vtt
