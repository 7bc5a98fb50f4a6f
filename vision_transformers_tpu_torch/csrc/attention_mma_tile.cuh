// Tensor-core building blocks of the bf16 attention kernels, and the bf16
// split-head forward body on them.
//
// attend_rows_mma replaces, for bf16 inputs, four TPU kernels of
// vision_transformers_tpu/ops/flash_attention.py (rows of PERF.md's kernel
// table), by its compile-time parameters, a key-mask policy, a dropout flag
// and a row layout:
//   - row 2, _attn_kernel (:75), through flash_attention.cu:
//     <D, NoMask, false>, with an optional fp32 bias;
//   - row 3, _large_kernel (:229), through flash_attention_large.cu:
//     <D, ReplaceByte, false>, a uint8 keep byte per key;
//   - row 5, _drop_fwd_kernel (:491), through dropout_attention.cu:
//     <D, AddFloat, true>, an fp32 value per key and dropout;
//   - row 1, _packed_fwd_kernel (:796), through packed_attention.cu:
//     <D, NoMask, kDrop, Strided>, q, k and v read in place from the packed
//     (B, S, 3·H·dh) projection, out and lse written in place;
//   - row 8's attention phase, _fused_block_kernel (:1028), through
//     fused_block.cu: <D, NoMask, false, Strided, HalfBlock> at dh 16, 32
//     and 64, <D, NoMask, false, PaddedStrided<D>, HalfBlock> at any other
//     dh up to 128 in the next tile, each 128-thread half of a 256-thread
//     block on its own rows, q, k and v read in place from the block's QKV
//     workspace.
// fp32 inputs keep attend_rows (attention_tile.cuh) and flash_large_kernel.
//
// What bounds it on the H100: at ViT-B/16 @512 (G 96, S 1025, D 64) the
// kernel does 4·G·S²·D = 25.8 GFLOP against 50 MB of q/k/v/out, 26 µs of
// bf16 tensor-core work against 15 µs of memory, so the bound is the
// products, and the S×S scores must never leave the SM (at the DETR-R50
// encoder, G 32, S 4704, D 32: 90.6 GFLOP, 92 µs, against 38.5 MB). The
// CUDA-core tiles run the products as fp32 FMAs (about 1% of the bf16
// peak). This design is FlashAttention-2's shape on mma.sync:
//
//   - 128 threads, 4 warps; at D 16 and 32 each warp owns 32 of the block's
//     128 query rows, two m16 A tiles, so each K or V fragment read from
//     shared memory feeds two products (at 16 rows a warp the ldmatrix reads,
//     128 bytes a clock per SM, take about as long as the products they
//     feed); at D 64 16 of 64 rows, for the registers (fwd_m). Q is read
//     once from device memory straight into registers as the m16n8k16 A
//     fragments (4 bytes per load, no shared memory).
//   - K and V stream through shared memory in tiles of 64 keys, bf16,
//     double-buffered with 16-byte cp.async: the next tile loads while this
//     one computes. Rows are padded from D to D + 8 elements, so the eight
//     16-byte rows one ldmatrix phase reads fall in eight distinct 4-bank
//     groups (row stride 144, 80 or 48 bytes at D 64, 32, 16): no conflicts.
//   - S = Q·Kᵀ with mma.sync.m16n8k16 (bf16 in, fp32 accumulators), K read
//     by ldmatrix.x4 (two n8 tiles of keys per instruction).
//   - Softmax on the accumulator fragments, one online-softmax step per
//     tile, or per 32-key half of it with two A tiles a warp (so 2 × 4 score
//     tiles are live, not 2 × 8): a thread holds rows g and g + 8
//     (g = lane / 4) of each A tile at columns 2·(lane % 4) + {0, 1} of
//     each n8 tile; the row max comes from the four lanes that share a row
//     (__shfl_xor_sync 1, 2). The row sum is kept per lane and reduced once
//     at the end.
//   - P·V: the unnormalised probabilities, rounded to bf16, are the A
//     fragments of P·V directly (two adjacent n8 accumulator tiles are one
//     k16 A fragment); V is read with ldmatrix.x4.trans.
//   - Epilogue: out = acc / l in bf16, lse = m + log(l) (natural log, fp32);
//     ReplaceByte takes _large_kernel's denominator max(l, 1e-30).
//   - Key mask (ReplaceByte, AddFloat): the mask of the next tile is read
//     with plain loads beside its cp.async (a mask row starts at any byte),
//     held in registers while this tile computes and stored to shared
//     memory after it: 64 keep bits from two warp ballots, or 64 fp32
//     values. The score is masked by its key's index after the product.
//   - Skipped tiles (ReplaceByte, AddFloat): at block start every thread
//     scans the mask row for the last 64-key tile that holds a key <
//     kv_valid the mask attends (one warp max and one integer atomicMax in
//     shared memory per warp), and the K/V loop walks tiles 0 .. that one,
//     in order. The key-padding masks of the repo hide the end of a row:
//     the DETR C5 masks pad the right of each row of the 56 × 84 grid and
//     the bottom rows, and only the bottom padding fills whole tiles (8-12
//     of 74 per image), all of them past the last live tile. A hidden tile
//     inside a row is walked and adds nothing. The kernel adds the tiles it
//     walked and the tiles its rows hold to two device counters, which the
//     C entry points' *_tile_counts read (chip_smoke.py reports the share).
//   - Dropout (kDrop): the keep bits of philox.cuh's dropout_keep4, one
//     Philox call per four probabilities: lane tq draws row[tq & 1]'s block
//     of columns 4·(tq / 2) .. +3 of an n8 tile, and one __shfl_xor_sync
//     with lane ^ 1 gives each lane both rows' bits (as bwd_dq_rows_mma).
//   - Occupancy (ptxas -v, printed by chip_smoke.py) at D 64, 32 and 16: row
//     2 148, 141 and 110 registers, 36-12 KB of shared memory, 3, 3 and 4
//     blocks of 128 threads an SM; row 3 128 (asked for at D 64, 32 bytes of
//     stack), 156 and 111 registers, 37-12 KB, 4, 3 and 4 blocks; row 5 128
//     (16 bytes of stack), 164 and 126 registers, 37-13 KB, 4, 3 and 4; row
//     1 144, 142 and 123 registers at rate 0 and 165, 187 and 139 with
//     dropout, 36-12 KB, 3, 3 and 4 blocks at rate 0 and 3, 2 and 3 with
//     dropout.
//
// Numerics (the contract of attention_tile.cuh): fp32 scores·scale, then
// (NoMask) the fp32 bias; keys >= kv_valid REPLACED by -0.7·FLT_MAX; then
// (ReplaceByte) keys whose byte is 0 replaced too, or (AddFloat) the key's
// value added, which must be 0 or -0.7·FLT_MAX (ops/flash_attention.py's
// _key_mask_add makes no other). Keys past Sk (the cp.async zero-filled
// tail, whose scores are 0, not -inf) are masked by index after the product
// and get probability exactly 0. The max is taken before any exp, in natural
// units; exp(x - m) is exp2f((x - m)·log2 e), so a hidden score gives
// (-0.7·FLT_MAX - m)·log2 e = -inf there and probability 0, never NaN. Key 0
// is always valid (kv_valid >= 1), so m is finite from the first tile on; a
// key hidden both by kv_valid and by an AddFloat mask scores -inf, which the
// max ignores. The running max starts at -inf, not at _large_kernel's
// -0.7·FLT_MAX: every walked tile holds a key < Sk, whose score is >=
// -0.7·FLT_MAX under replacement, so the two give the same m after the first
// step. Dropout zeroes the probabilities (and scales the kept ones by
// 1/(1 − rate)) on their way into P·V only: the running max, the sum l and
// lse are of the undropped softmax, as in _drop_fwd_kernel.
//
// Where the kernel rounds: the probabilities are rounded to bf16 before P·V,
// unnormalised (the division by l is after P·V). Row 3 rounds where its TPU
// kernel does: _large_kernel, and flash_attention_large_reference, round the
// unnormalised P too. _attn_kernel and _drop_fwd_kernel, and the plain
// versions of rows 2 and 5, round the normalised P (row 5: dropped and
// scaled). A one-pass streaming kernel does not know l before P·V, so rows 2
// and 5 round p (row 5: p·(1/(1 − rate))) unnormalised and divide at the
// end: within one bf16 step of their plain versions, not bit-equal.
//
// Other head dims up to 128 (above it attention_wide_tile.cuh): D 128 is an
// instantiation of its own (one A tile a warp, its K/V buffers, 68 KB, in
// dynamic shared memory). A head dim d not 16, 32, 64 or 128 runs in the
// next tile (16, 32, 64 or 128) under the Padded layout: (G, S, d) groups
// whose columns d .. D are read as zeros (cp.async's source size 0), so the
// scores and lse are those of the d columns, and only d columns are written.
// Its rows are 2·d bytes apart, not always on a 16-byte boundary: K/V tiles
// come by 4-byte cp.async for an even d and by plain 2-byte loads for an odd
// one, Q and the outputs by 2-byte loads and stores; in the 128 tile (d
// 65-127) rows 2-6 take PaddedStrided at rows d apart (GroupPad). Row 1 (the
// packed projection) at any d but 16, 32 and 64 takes PaddedStrided too:
// Strided's row strides with d <= D columns, K/V tiles by the widest copy
// the offsets allow (16 bytes for d a multiple of 8, 4 for an even d, 2 for
// an odd one), Q by 4-byte loads for an even d. The other layouts keep their
// code (if constexpr).
//
// Contract of the caller: bf16 operands with D in {16, 32, 64, 128}, in
// contiguous (G, S, D) groups (Contiguous) or at row strides that are
// multiples of 8 elements (Strided), every base pointer 16-byte aligned (the
// C entry points check this and refuse the launch otherwise), kv_valid >= 1;
// or Padded (G, S, d) groups, 1 <= d < D, base pointers 4-byte aligned for
// an even d; or PaddedStrided rows, 1 <= d <= D, base pointers and strides
// aligned to strided_align_mask(d).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "attention_tile.cuh"

namespace vtt {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // rows a backward block owns: 16 per warp
constexpr int kCols = 64;      // rows of a streamed tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; when !pred nothing is read and 16 zero bytes
// are written (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global → shared, zero-filled when !pred (the Padded layout's rows).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a·b for one m16n8k16 tile, bf16 in, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats → one register of two bf16 (lo in the low half), rounded to
// nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Accumulator tiles n = 2·kk and 2·kk + 1 (16 rows × 16 columns), rounded
// to bf16, as the A fragment of a product whose k step kk they are.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows [row0, row0 + kCols) of an (n, D) bf16 matrix whose rows lie
// `stride` elements apart (a multiple of 8) into shared memory with row
// stride D + 8; rows >= n are zero-filled. One cp.async group's worth, by
// the kThreads threads numbered tid; the caller commits.
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int row0,
                                          int n, int stride, unsigned tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < kCols * kChunks / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const int gr = row0 + r;
    const bool in = gr < n;
    cp_async_16(s + r * (D + 8) + c * 8,
                g + static_cast<long long>(in ? gr : 0) * stride + c * 8, in);
  }
}

// The same, by a block of kThreads threads.
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int row0,
                                          int n, int stride = D) {
  load_tile<D>(s, g, row0, n, stride, threadIdx.x);
}

// load_tile for the Padded layout: rows of d < D elements, d apart, columns
// d .. D zero-filled. An even d by 4-byte cp.async (a row starts on a 4-byte
// boundary); an odd one by plain loads and stores, which the caller's barrier
// publishes as it does the copies.
template <int D>
__device__ __forceinline__ void load_tile_padded(bf16* s, const bf16* g,
                                                 int row0, int n, int d,
                                                 unsigned tid) {
  if ((d & 1) == 0) {
    constexpr int kWords = D / 2;  // 4-byte words per row
#pragma unroll
    for (int i = 0; i < kCols * kWords / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kWords, c = 2 * (idx % kWords);
      const int gr = row0 + r;
      const bool in = gr < n && c < d;
      cp_async_4(s + r * (D + 8) + c,
                 g + (in ? static_cast<long long>(gr) * d + c : 0ll), in);
    }
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(g);
    unsigned short* su = reinterpret_cast<unsigned short*>(s);
#pragma unroll 4
    for (int i = 0; i < kCols * D / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / D, c = idx % D;
      const int gr = row0 + r;
      su[r * (D + 8) + c] =
          gr < n && c < d ? u[static_cast<long long>(gr) * d + c] : 0;
    }
  }
}

// load_tile for the PaddedStrided layout: rows of d <= D elements, `stride`
// elements apart, columns d .. D zero-filled. The copy grain is the widest
// that d's row and head offsets keep aligned: 16-byte cp.async for d a
// multiple of 8 (16-byte chunks wholly in or out of the row), 4-byte for an
// even d, plain 2-byte loads and stores for an odd one (the caller's
// barrier publishes them, as the copies). kL2: the 2-byte loads through L2
// (__ldcg), for rows written earlier in the same launch (row 8's HalfBlock).
template <int D, bool kL2 = false>
__device__ __forceinline__ void load_tile_strided_padded(
    bf16* s, const bf16* g, int row0, int n, int d, int stride,
    unsigned tid) {
  if ((d & 7) == 0) {
    constexpr int kChunks = D / 8;
#pragma unroll
    for (int i = 0; i < kCols * kChunks / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kChunks, c = idx % kChunks;
      const int gr = row0 + r;
      const bool in = gr < n && c * 8 < d;
      cp_async_16(s + r * (D + 8) + c * 8,
                  g + (in ? static_cast<long long>(gr) * stride + c * 8
                          : 0ll), in);
    }
  } else if ((d & 1) == 0) {
    constexpr int kWords = D / 2;
#pragma unroll 8
    for (int i = 0; i < kCols * kWords / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kWords, c = 2 * (idx % kWords);
      const int gr = row0 + r;
      const bool in = gr < n && c < d;
      cp_async_4(s + r * (D + 8) + c,
                 g + (in ? static_cast<long long>(gr) * stride + c : 0ll),
                 in);
    }
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(g);
    unsigned short* su = reinterpret_cast<unsigned short*>(s);
#pragma unroll 4
    for (int i = 0; i < kCols * D / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / D, c = idx % D;
      const int gr = row0 + r;
      if constexpr (kL2)
        su[r * (D + 8) + c] =
            gr < n && c < d ? __ldcg(u + static_cast<long long>(gr) * stride
                                     + c)
                            : 0;
      else
        su[r * (D + 8) + c] =
            gr < n && c < d ? u[static_cast<long long>(gr) * stride + c] : 0;
    }
  }
}

// load_a_frags for the PaddedStrided layout: rows `stride` apart, columns
// >= d zero; 4-byte loads for an even d (a fragment's column pair is then
// wholly in or out of the row), 2-byte ones for an odd d. kL2: through L2
// (__ldcg), as load_tile_strided_padded's.
template <int D, bool kL2 = false>
__device__ __forceinline__ void load_a_frags_strided_padded(
    uint32_t (&f)[D / 16][4], const bf16* p, const int (&row)[2], int n,
    int d, int stride) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  const int tq = threadIdx.x & 3;
  const bool even = (d & 1) == 0;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row[j & 1];
      const int c = kk * 16 + (j >> 1) * 8 + 2 * tq;
      uint32_t w = 0u;
      if (r < n && c < d) {
        const long long b = static_cast<long long>(r) * stride + c;
        if constexpr (kL2) {
          if (even) {
            w = __ldcg(reinterpret_cast<const uint32_t*>(p + b));
          } else {
            w = __ldcg(u + b);
            if (c + 1 < d) w |= static_cast<uint32_t>(__ldcg(u + b + 1)) << 16;
          }
        } else if (even) {
          w = *reinterpret_cast<const uint32_t*>(p + b);
        } else {
          w = u[b];
          if (c + 1 < d) w |= static_cast<uint32_t>(u[b + 1]) << 16;
        }
      }
      f[kk][j] = w;
    }
}

// load_a_frags for the Padded layout: rows d apart, columns >= d zero, by
// 2-byte loads.
template <int D>
__device__ __forceinline__ void load_a_frags_padded(uint32_t (&f)[D / 16][4],
                                                    const bf16* p,
                                                    const int (&row)[2],
                                                    int n, int d) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row[j & 1];
      const int c = kk * 16 + (j >> 1) * 8 + 2 * tq;
      uint32_t lo = 0u, hi = 0u;
      if (r < n) {
        const long long b = static_cast<long long>(r) * d + c;
        if (c < d) lo = u[b];
        if (c + 1 < d) hi = u[b + 1];
      }
      f[kk][j] = lo | (hi << 16);
    }
}

// Columns c, c + 1 of a bf16 row under the Padded layout: those < d written,
// one element at a time.
__device__ __forceinline__ void store_pair_padded(bf16* p, int c, int d,
                                                  float x0, float x1) {
  if (c < d) p[c] = __float2bfloat16_rn(x0);
  if (c + 1 < d) p[c + 1] = __float2bfloat16_rn(x1);
}

// The A fragments (16 rows × D) of rows row[0] = r, row[1] = r + 8 of an
// (n, D) bf16 matrix whose rows lie `stride` elements apart, read from
// device memory; rows >= n are zero. kL2: read through L2 (ld.global.cg),
// for a matrix written earlier in the same launch, where the non-coherent
// path the compiler may pick for a read-only pointer is not allowed.
template <int D, bool kL2 = false>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const bf16* p, const int (&row)[2],
                                             int n, int stride = D) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row[j & 1];
      const int c = kk * 16 + (j >> 1) * 8 + 2 * tq;
      // the address formed only for r < n: formed for every row, it cost
      // rows 2, 5 and 6 registers
      if constexpr (kL2)
        f[kk][j] = r < n ? __ldcg(reinterpret_cast<const uint32_t*>(
                               p + static_cast<long long>(r) * stride + c))
                         : 0u;
      else
        f[kk][j] = r < n ? *reinterpret_cast<const uint32_t*>(
                               p + static_cast<long long>(r) * stride + c)
                         : 0u;
    }
}

// acc[m][n] += A[m]·Bᵀ over D, for kM A tiles of 16 rows against the rows
// b[0 .. 8·kTiles) (row stride D + 8): B rows 16·np .. 16·np + 15 give
// accumulator tiles 2·np, 2·np + 1, each B fragment read once (ldmatrix.x4)
// for all kM A tiles. S = Q·Kᵀ (B = K) and dP = dO·Vᵀ (B = V), and their
// transposes in the dk/dv pass.
template <int D, int kTiles, int kM>
__device__ __forceinline__ void mma_abt(float (&acc)[kM][kTiles][4],
                                        const uint32_t (&a)[kM][D / 16][4],
                                        const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < kTiles / 2; ++np) {
      uint32_t f[4];
      ldsm_x4(f, b + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * (D + 8)
                     + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        mma_bf16(acc[m][2 * np], a[m][kk], f[0], f[1]);
        mma_bf16(acc[m][2 * np + 1], a[m][kk], f[2], f[3]);
      }
    }
}

template <int D, int kTiles>
__device__ __forceinline__ void mma_abt(float (&acc)[kTiles][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const bf16* b, int lane) {
  mma_abt<D, kTiles, 1>(reinterpret_cast<float (&)[1][kTiles][4]>(acc),
                        reinterpret_cast<const uint32_t (&)[1][D / 16][4]>(a),
                        b, lane);
}

// acc[m] += A[m]·B for one k16 step: kM A tiles (16 × 16) from registers, B
// the 16 rows b[0 .. 16) (row stride D + 8) read transposed, once for all
// kM; acc[m] holds D / 8 n8 tiles.
template <int D, int kM>
__device__ __forceinline__ void mma_ab(float (&acc)[kM][D / 8][4],
                                       const uint32_t (&a)[kM][4],
                                       const bf16* b, int lane) {
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t f[4];
    ldsm_x4_t(f, b + ((lane & 7) + ((lane >> 3) & 1) * 8) * (D + 8) + np * 16
                     + (lane >> 4) * 8);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      mma_bf16(acc[m][2 * np], a[m], f[0], f[1]);
      mma_bf16(acc[m][2 * np + 1], a[m], f[2], f[3]);
    }
  }
}

template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4],
                                       const uint32_t (&a)[4], const bf16* b,
                                       int lane) {
  mma_ab<D, 1>(reinterpret_cast<float (&)[1][D / 8][4]>(acc),
               reinterpret_cast<const uint32_t (&)[1][4]>(a), b, lane);
}

// The forward's tile: each warp owns fwd_m<D>() × 16 query rows, so every K
// and V fragment read from shared memory feeds that many products. Two at
// D 16 and 32; one at D 64, where two A tiles' output accumulators and Q
// fragments alone (2 · (32 + 16) registers) with the scores leave too few
// registers for more than two blocks an SM (and at D 128).
template <int D>
__host__ __device__ constexpr int fwd_m() { return D >= 64 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int fwd_rows() { return 64 * fwd_m<D>(); }

// Where the forward's rows lie: q, k and v rows qkv() elements apart, out
// rows o() apart, lse entries lse() apart. Contiguous (rows 2, 3, 5): (G, S,
// D) groups, the strides compile-time constants, so that these
// instantiations keep the code they had before the layout was a parameter.
// Strided (row 1): rows of the packed (B, S, 3·H·dh) projection, 3·H·dh
// apart, out rows H·dh apart in (B, S, H·dh), lse H apart in (B, S, H).
template <int D>
struct Contiguous {
  __device__ static constexpr int qkv() { return D; }
  __device__ static constexpr int o() { return D; }
  __device__ static constexpr int lse() { return 1; }
};

struct Strided {
  int qkv_stride, o_stride, lse_stride;
  __device__ int qkv() const { return qkv_stride; }
  __device__ int o() const { return o_stride; }
  __device__ int lse() const { return lse_stride; }
};

// Padded (rows 2, 5 and 6 at a head dim d < D, not 16 or 32): contiguous
// (G, S, d) groups in the tile of width D, the columns d .. D zeros.
template <int D>
struct Padded {
  int d;
  __device__ int qkv() const { return d; }
  __device__ int o() const { return d; }
  __device__ static constexpr int lse() { return 1; }
};

// PaddedStrided (rows 1 and 7 at a head dim other than 16, 32 and 64): the
// rows of Strided (q, k and v qkv_stride apart in the packed projection, do
// and out o_stride apart, lse lse_stride apart), d <= D columns of each in
// the tile of width D, the columns d .. D zeros.
template <int D>
struct PaddedStrided {
  int d, qkv_stride, o_stride, lse_stride;
  __device__ int qkv() const { return qkv_stride; }
  __device__ int o() const { return o_stride; }
  __device__ int lse() const { return lse_stride; }
};

// Padded and PaddedStrided: columns d .. D zero, only d columns written.
template <class Layout>
struct IsPadded : std::false_type {};
template <int D>
struct IsPadded<Padded<D>> : std::true_type {};
template <int D>
struct IsPadded<PaddedStrided<D>> : std::true_type {};

template <class Layout>
struct IsPaddedStrided : std::false_type {};
template <int D>
struct IsPaddedStrided<PaddedStrided<D>> : std::true_type {};

// K/V-tile and Q-fragment loads by layout: PaddedStrided's (the grain by
// d), Padded's, or the 16-byte ones. kL2: PaddedStrided's plain loads
// through L2 (HalfBlock); the copies are cp.async either way.
template <int D, class Layout, bool kL2 = false>
__device__ __forceinline__ void load_tile_as(const Layout& lay, bf16* s,
                                             const bf16* g, int row0, int n,
                                             int stride, unsigned tid) {
  if constexpr (IsPaddedStrided<Layout>::value)
    load_tile_strided_padded<D, kL2>(s, g, row0, n, lay.d, stride, tid);
  else if constexpr (IsPadded<Layout>::value)
    load_tile_padded<D>(s, g, row0, n, lay.d, tid);
  else
    load_tile<D>(s, g, row0, n, stride, tid);
}

template <int D, class Layout>
__device__ __forceinline__ void load_a_frags_as(const Layout& lay,
                                                uint32_t (&f)[D / 16][4],
                                                const bf16* p,
                                                const int (&row)[2], int n,
                                                int stride) {
  if constexpr (IsPaddedStrided<Layout>::value)
    load_a_frags_strided_padded<D>(f, p, row, n, lay.d, stride);
  else if constexpr (IsPadded<Layout>::value)
    load_a_frags_padded<D>(f, p, row, n, lay.d);
  else
    load_a_frags<D>(f, p, row, n, stride);
}

// The low address bits a bf16 operand's base pointer must have clear under
// PaddedStrided: every row offset (and rows 1 and 7's head offset h·d) is a
// multiple of the grain load_tile_strided_padded takes, 16 bytes for d a
// multiple of 8, 4 for an even d, 2 for an odd one; so is the base's.
__host__ __device__ constexpr unsigned strided_align_mask(int d) {
  return (d & 7) == 0 ? 15u : (d & 1) ? 0u : 3u;
}

// The same for rows 2-6: 16 bytes for the 16-byte copies of D 16, 32, 64
// and 128, 4 for the Padded layout's 4-byte copies (an even d below 64),
// none for an odd d (2-byte loads), and the 128 tile's (GroupPad) grain.
__host__ __device__ constexpr unsigned align_mask(int d) {
  return d == 16 || d == 32 || d == 64 || d == 128 ? 15u
         : d > 64 ? strided_align_mask(d) : (d & 1) ? 0u : 3u;
}

// The layout of rows 2-6's contiguous (G, S, d) groups at a head dim d in
// the tile of width D: Padded below 128, PaddedStrided with rows d apart in
// the 128 tile (d 65-127), whose 16-byte K/V copies (d a multiple of 8) and
// 4-byte Q loads (an even d) Padded lacks: there its 4-byte copies and
// 2-byte loads took 255 registers, spilled, and ran D 80 slower than the
// exact D 128 tile on the same shape.
template <int D>
using GroupPad = std::conditional_t<D == 128, PaddedStrided<D>, Padded<D>>;

template <int D>
__device__ __forceinline__ GroupPad<D> group_pad(int d) {
  if constexpr (D == 128)
    return PaddedStrided<D>{d, d, d, 1};
  else
    return Padded<D>{d};
}

// The bf16 bytes of one K/V buffer of a tile of kCols rows at width D
// (row stride D + 8); D 128 keeps its K/V buffers (4 of them, 68 KB) and the
// backward its Q/dO or K/V ones in dynamic shared memory.
template <int D>
__host__ __device__ constexpr int tile_bytes() { return kCols * (D + 8) * 2; }
template <int D>
__host__ __device__ constexpr int mma_dyn_bytes() { return D > 64 ? 4 * tile_bytes<D>() : 0; }

// Which threads run the forward's tile, how they meet, and where its K/V
// buffers lie. WholeBlock (rows 1, 2, 3, 5): a block of kThreads threads,
// __syncthreads(), buffers declared in the function, so that these
// instantiations keep the code they had before this was a parameter.
// HalfBlock (row 8, fused_block.cu): one 128-thread half of a 256-thread
// block, numbered from 0 within the half, meeting at named barrier 1 + half
// (barrier 0 is __syncthreads'), its buffers 4·64·(D + 8) bf16 of the
// caller's shared memory (K's two, then V's two), at any tile D. NoMask
// only. Its q, k and v were written earlier in the same launch: k and v
// come by cp.async (.cg at 16 bytes; PaddedStrided's 4-byte copies are .ca,
// which no stale line can serve: no phase before the attention reads the
// workspace) or, for an odd d, by __ldcg, q through L2 (kL2Loads), never by
// the non-coherent path.
struct WholeBlock {
  static constexpr bool kOwnSmem = true;
  static constexpr bool kL2Loads = false;
  __device__ static unsigned tid() { return threadIdx.x; }
  __device__ static void sync() { __syncthreads(); }
  __device__ bf16* kv() const { return nullptr; }
};

struct HalfBlock {
  static constexpr bool kOwnSmem = false;
  static constexpr bool kL2Loads = true;
  bf16* kv_smem;
  __device__ static unsigned tid() { return threadIdx.x & (kThreads - 1); }
  __device__ static void sync() {
    asm volatile("bar.sync %0, %1;\n"
                 :: "r"(1 + static_cast<int>(threadIdx.x / kThreads)),
                    "n"(kThreads)
                 : "memory");
  }
  __device__ bf16* kv() const { return kv_smem; }
};

// How the forward hides keys besides kv_valid (the mask is one row per
// group, the same for each of its query rows).
enum class KeyMask {
  NoMask,       // row 2: keys >= kv_valid REPLACED by kMaskValue
  ReplaceByte,  // row 3: uint8 per key, 0 = hide; a key >= kv_valid or
                // hidden has its score REPLACED by kMaskValue
  AddFloat,     // row 5: keys >= kv_valid replaced, then the fp32 value of
                // the key (0 or kMaskValue) ADDED
};

// Whether the mask row attends key kj: a nonzero byte (ReplaceByte), a
// value other than kMaskValue (AddFloat, whose values are 0 or kMaskValue).
template <KeyMask P>
__device__ __forceinline__ bool attended(const void* mrow, int kj) {
  if constexpr (P == KeyMask::ReplaceByte)
    return static_cast<const unsigned char*>(mrow)[kj] != 0;
  else
    return static_cast<const float*>(mrow)[kj] != kMaskValue;
}

// The last 64-key tile of keys [0, n) that holds a key the mask row
// attends, or -1 if none. Thread i scans keys i + 128·j; one warp max and
// one shared-memory atomicMax per warp (an integer max: the order of the
// atomics does not matter). A block barrier; returns the tile on every
// thread.
template <KeyMask P>
__device__ __forceinline__ int last_live_tile(int* last, const void* mrow,
                                              int n) {
  if (threadIdx.x == 0) *last = -1;
  __syncthreads();
  int t = -1;
#pragma unroll 8
  for (int kj = threadIdx.x; kj < n; kj += kThreads)
    if (attended<P>(mrow, kj)) t = kj / kCols;
  t = __reduce_max_sync(0xffffffffu, t);
  if ((threadIdx.x & 31) == 0) atomicMax(last, t);
  __syncthreads();
  return *last;
}

// The mask of key tile t, read into registers so that the loads' latency
// hides behind a tile's products: ReplaceByte, warp 0, the keep flags of
// keys t·64 + 32·i + lane (0 for keys >= kv_valid); AddFloat, threads < 64,
// the value of key t·64 + threadIdx.x (0 past Sk). kmask may be null.
template <KeyMask P>
__device__ __forceinline__ void fetch_tile_mask(int (&raw)[2], float& add,
                                                const void* kmask, int t,
                                                int sk, int kv_valid) {
  const int lane = threadIdx.x & 31;
  if constexpr (P == KeyMask::ReplaceByte) {
    if (threadIdx.x < 32)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kj = t * kCols + 32 * i + lane;
        raw[i] = kj >= kv_valid ? 0
                 : kmask != nullptr
                     ? static_cast<const unsigned char*>(kmask)[kj] : 1;
      }
  } else {
    const int kj = t * kCols + threadIdx.x;
    add = kmask != nullptr && threadIdx.x < kCols && kj < sk
              ? static_cast<const float*>(kmask)[kj] : 0.f;
  }
}

// What fetch_tile_mask read, into one buffer's shared memory: 64 keep bits
// from two warp ballots, or 64 values.
template <KeyMask P>
__device__ __forceinline__ void store_tile_mask(uint32_t* keep, float* add_s,
                                                const int (&raw)[2],
                                                float add) {
  if constexpr (P == KeyMask::ReplaceByte) {
    if (threadIdx.x < 32) {
      const uint32_t w0 = __ballot_sync(0xffffffffu, raw[0] != 0);
      const uint32_t w1 = __ballot_sync(0xffffffffu, raw[1] != 0);
      if (threadIdx.x == 0) {
        keep[0] = w0;
        keep[1] = w1;
      }
    }
  } else {
    if (threadIdx.x < kCols) add_s[threadIdx.x] = add;
  }
}

// Rows [q0, q0 + fwd_rows<D>()) of one group: out (bf16) and lse (fp32, one
// per row), at lay's strides, as q, k and v are read. bias: this group's fp32 (Sq, Sk) slice, or null
// (NoMask only). kmask: this group's mask row (uint8 for ReplaceByte, fp32
// for AddFloat), or null. kDrop: dropout by drop's keep bits of
// (rng_group, row, column), at drop.thresh != 0. tile_counts (masked
// policies; may be null): thread 0 adds the key tiles this block walks to
// [0] and the key tiles of its rows to [1]. blk: the threads that run it
// (WholeBlock or HalfBlock).
template <int D, KeyMask kMask = KeyMask::NoMask, bool kDrop = false,
          class Layout = Contiguous<D>, class Block = WholeBlock>
__device__ __forceinline__ void attend_rows_mma(
    int q0, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    bf16* __restrict__ o, float* __restrict__ lse, int sq, int sk,
    int kv_valid, float scale, const void* __restrict__ kmask = nullptr,
    Dropout drop = Dropout{}, uint32_t rng_group = 0u,
    unsigned long long* tile_counts = nullptr, Layout lay = Layout{},
    Block blk = Block{}) {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "head dim must be 16, 32, 64 or 128");
  constexpr bool kMasked = kMask != KeyMask::NoMask;
  constexpr bool kPad = IsPadded<Layout>::value;
  static_assert(Block::kOwnSmem || !kMasked,
                "a half block runs the unmasked tile only");
  constexpr int S = D + 8;
  constexpr int M = fwd_m<D>();
  // keys per online-softmax step: the whole tile for one A tile a warp, half
  // of it for two (so that 2 × 4 score tiles are live, not 2 × 8)
  constexpr int kSub = M == 1 ? kCols : kCols / 2;
  // the block's own K/V buffers: static up to D 64, dynamic at D 128
  constexpr bool kOwn = Block::kOwnSmem && D <= 64;
  __shared__ __align__(16) bf16 ks_own[kOwn ? 2 : 1][kOwn ? kCols * S : 8];
  __shared__ __align__(16) bf16 vs_own[kOwn ? 2 : 1][kOwn ? kCols * S : 8];
  bf16* kv_ext = nullptr;
  if constexpr (!kOwn)
    kv_ext = Block::kOwnSmem ? reinterpret_cast<bf16*>(dyn_smem()) : blk.kv();
  bf16 (*ks)[kCols * S] = reinterpret_cast<bf16 (*)[kCols * S]>(
      kOwn ? &ks_own[0][0] : kv_ext);
  bf16 (*vs)[kCols * S] = reinterpret_cast<bf16 (*)[kCols * S]>(
      kOwn ? &vs_own[0][0] : kv_ext + 2 * kCols * S);
  // the mask of the two buffered tiles: 64 keep bits (ReplaceByte) or 64
  // values (AddFloat)
  __shared__ uint32_t keep_s[2][kMask == KeyMask::ReplaceByte ? 2 : 1];
  __shared__ float add_s[2][kMask == KeyMask::AddFloat ? kCols : 1];

  const unsigned tid = blk.tid();  // unsigned, as threadIdx.x: the same code
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tq = lane & 3;
  // this lane's rows: row[m][0] and row[m][1] = row[m][0] + 8 of A tile m
  int row[M][2];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    row[m][0] = q0 + (warp * M + m) * 16 + (lane >> 2);
    row[m][1] = row[m][0] + 8;
  }

  load_tile_as<D, Layout, Block::kL2Loads>(lay, ks[0], k, 0, sk, lay.qkv(),
                                          tid);
  load_tile_as<D, Layout, Block::kL2Loads>(lay, vs[0], v, 0, sk, lay.qkv(),
                                          tid);
  cp_async_commit();
  // The key tiles walked: all of them, or (masked policies) tiles 0 .. the
  // last one that holds a key < kv_valid the mask attends. Skipping the
  // tiles past it is exact: an attended key is seen by then, so a hidden
  // key's exp2 argument is (-0.7·FLT_MAX - m)·log2 e = -inf, its
  // probability +0 and its tile adds nothing. A row with no such tile
  // skips nothing, so a fully masked row stays the uniform average over its
  // Sk keys.
  int tiles = (sk + kCols - 1) / kCols;
  int raw[2] = {0, 0};  // the next tile's mask (fetch_tile_mask)
  float add = 0.f;
  if constexpr (kMasked) {
    __shared__ int last_s;
    const int last = kmask == nullptr
                         ? (kv_valid - 1) / kCols  // key 0 is attended
                         : last_live_tile<kMask>(&last_s, kmask, kv_valid);
    if (last >= 0) tiles = last + 1;
    if (tile_counts != nullptr && threadIdx.x == 0) {
      atomicAdd(&tile_counts[0], static_cast<unsigned long long>(tiles));
      atomicAdd(&tile_counts[1],
                static_cast<unsigned long long>((sk + kCols - 1) / kCols));
    }
    fetch_tile_mask<kMask>(raw, add, kmask, 0, sk, kv_valid);
    store_tile_mask<kMask>(keep_s[0], add_s[0], raw, add);  // seen after
  }                                                         // the 1st barrier
  uint32_t qf[M][D / 16][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
    if constexpr (IsPaddedStrided<Layout>::value)
      load_a_frags_strided_padded<D, Block::kL2Loads>(qf[m], q, row[m], sq,
                                                      lay.d, lay.qkv());
    else if constexpr (kPad)
      load_a_frags_padded<D>(qf[m], q, row[m], sq, lay.qkv());
    else
      load_a_frags<D, Block::kL2Loads>(qf[m], q, row[m], sq, lay.qkv());

  float acc[M][D / 8][4];
  float mr[M][2], l[M][2];  // running max; this lane's share of the row sums
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    mr[m][0] = mr[m][1] = -CUDART_INF_F;
    l[m][0] = l[m][1] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_tile_as<D, Layout, Block::kL2Loads>(lay, ks[buf ^ 1], k,
                                              (t + 1) * kCols, sk, lay.qkv(),
                                              tid);
      load_tile_as<D, Layout, Block::kL2Loads>(lay, vs[buf ^ 1], v,
                                              (t + 1) * kCols, sk, lay.qkv(),
                                              tid);
      cp_async_commit();
      if constexpr (kMasked)
        fetch_tile_mask<kMask>(raw, add, kmask, t + 1, sk, kv_valid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    blk.sync();
    // ReplaceByte: the tile's keep bits shifted by this lane's column
    // offset 2·tq, so that column cc + 2·tq is bit cc of kw[cc / 32] with
    // cc (< 32 within its word, 2·tq + (cc % 32) < 32) known at compile time
    uint32_t kw[2] = {0u, 0u};
    if constexpr (kMask == KeyMask::ReplaceByte) {
      kw[0] = keep_s[buf][0] >> (2 * tq);
      kw[1] = keep_s[buf][1] >> (2 * tq);
    }

#pragma unroll
    for (int h = 0; h < kCols / kSub; ++h) {
      float s[M][kSub / 8][4];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[m][n][e] = 0.f;
      mma_abt<D, kSub / 8, M>(s, qf, ks[buf] + h * kSub * S, lane);

      const int k0 = t * kCols + h * kSub;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float mx[2] = {mr[m][0], mr[m][1]};
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cc = h * kSub + n * 8 + (e & 1);  // in the tile, - 2·tq
            const int kj = k0 + n * 8 + 2 * tq + (e & 1);
            const int r = row[m][e >> 1];
            float x = s[m][n][e] * scale;
            if (bias != nullptr && kj < sk && r < sq)
              x += bias[static_cast<long long>(r) * sk + kj];
            if constexpr (kMask == KeyMask::ReplaceByte) {
              if (((kw[cc >> 5] >> (cc & 31)) & 1u) == 0u) x = kMaskValue;
            } else {
              if (kj >= kv_valid) x = kMaskValue;
              if constexpr (kMask == KeyMask::AddFloat)
                if (kmask != nullptr) x += add_s[buf][cc + 2 * tq];
            }
            s[m][n][e] = x;
            if (kj < sk) mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          // the first step: exp2(-inf) = 0; a step past Sk keeps m (kj < sk
          // never held there) and alpha = 1
          alpha[i] = exp2f((mr[m][i] - mx[i]) * kLog2e);
          mr[m][i] = mx[i];
          l[m][i] *= alpha[i];
        }
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + n * 8 + 2 * tq + (e & 1);
            const float p =
                kj < sk ? exp2f((s[m][n][e] - mr[m][e >> 1]) * kLog2e) : 0.f;
            s[m][n][e] = p;
            l[m][e >> 1] += p;  // the undropped sum normalises, and is lse's
          }
        if constexpr (kDrop) {
          // only P·V's A fragment is dropped. This lane draws row[m][tq & 1]'s
          // keep bits of columns k0 + n·8 + 4·(tq / 2) .. +3, and its
          // neighbour (lane ^ 1) the other row's, so bit
          // 4·i + 2·(tq & 1) + (e & 1) is element e's (i = e / 2)
          if (drop.thresh != 0u)
#pragma unroll
            for (int n = 0; n < kSub / 8; ++n) {
              uint32_t keep =
                  dropout_keep4(drop, rng_group,
                                (tq & 1) ? row[m][1] : row[m][0],
                                (k0 + n * 8 + (tq >> 1) * 4) >> 2)
                  << (4 * (tq & 1));
              keep |= __shfl_xor_sync(0xffffffffu, keep, 1);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (((keep >> (4 * (e >> 1) + 2 * (tq & 1) + (e & 1))) & 1u) ==
                    0u)
                  s[m][n][e] = 0.f;
                else
                  s[m][n][e] *= drop.inv_keep;
            }
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[m][n][0] *= alpha[0];
          acc[m][n][1] *= alpha[0];
          acc[m][n][2] *= alpha[1];
          acc[m][n][3] *= alpha[1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t a[M][4];
#pragma unroll
        for (int m = 0; m < M; ++m)
          acc_to_a(a[m], s[m][2 * kk], s[m][2 * kk + 1]);
        mma_ab<D, M>(acc, a, vs[buf] + (h * kSub + kk * 16) * S, lane);
      }
    }
    if constexpr (kMasked)
      if (t + 1 < tiles)
        store_tile_mask<kMask>(keep_s[buf ^ 1], add_s[buf ^ 1], raw, add);
    blk.sync();  // every warp is done with this buffer
  }

#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[m][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      // _large_kernel's denominator (l >= 1 here: the max key gives 1)
      if constexpr (kMask == KeyMask::ReplaceByte) li = fmaxf(li, 1e-30f);
      const int r = row[m][i];
      if (r >= sq) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        if constexpr (kPad)
          store_pair_padded(o + static_cast<long long>(r) * lay.o(),
                            n * 8 + 2 * tq, lay.d, acc[m][n][2 * i] / li,
                            acc[m][n][2 * i + 1] / li);
        else
          *reinterpret_cast<__nv_bfloat162*>(
              o + static_cast<long long>(r) * lay.o() + n * 8 + 2 * tq) =
              __floats2bfloat162_rn(acc[m][n][2 * i] / li,
                                    acc[m][n][2 * i + 1] / li);
      if (tq == 0) lse[r * lay.lse()] = mr[m][i] + logf(li);
    }
}

}  // namespace mma
}  // namespace vtt
