// Tensor-core building blocks of the bf16 attention kernels, and the bf16
// split-head forward body on them.
//
// attend_rows_mma replaces, for bf16 inputs, the TPU kernel
// vision_transformers_tpu/ops/flash_attention.py::_attn_kernel (:75), through
// flash_attention.cu (row 2 of PERF.md's kernel table). fp32 inputs keep
// attend_rows (attention_tile.cuh), and so do rows 1, 3, 5, 7 and 8.
//
// What bounds it on the H100: at ViT-B/16 @512 (G 96, S 1025, D 64) the
// kernel does 4·G·S²·D = 25.8 GFLOP against 50 MB of q/k/v/out, 26 µs of
// bf16 tensor-core work against 15 µs of memory, so the bound is the
// products, and the S×S scores must never leave the SM. attend_rows runs the
// products as fp32 FMAs on the CUDA cores (about 1% of the bf16 peak). This
// design is FlashAttention-2's shape on mma.sync:
//
//   - 128 threads, 4 warps; at D 16 and 32 each warp owns 32 of the block's
//     128 query rows, two m16 A tiles, so each K or V fragment read from
//     shared memory feeds two products (at 16 rows a warp the ldmatrix reads,
//     128 bytes a clock per SM, take about as long as the products they
//     feed); at D 64 16 of 64 rows, for the registers (fwd_m). Q is read
//     once from device memory straight into registers as the m16n8k16 A
//     fragments (4 bytes per load, no shared memory).
//   - K and V stream through shared memory in tiles of 64 keys, bf16,
//     double-buffered with 16-byte cp.async: tile t+1 loads while tile t
//     computes. Rows are padded from D to D + 8 elements, so the eight
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
//   - Epilogue: out = acc / l in bf16, lse = m + log(l) (natural log, fp32).
//   - Occupancy (ptxas -v, printed by chip_smoke.py): 148, 141 and 110
//     registers at D 64, 32 and 16, no spills, 12-36 KB of shared memory: 3,
//     3 and 4 blocks of 128 threads an SM.
//
// Numerics (the contract of attention_tile.cuh): fp32 scores·scale, then the
// fp32 bias, then keys >= kv_valid REPLACED by -0.7·FLT_MAX; keys past Sk
// (the cp.async zero-filled tail, whose scores are 0, not -inf) are masked by
// index after the product and get probability exactly 0. The max is taken
// before any exp, in natural units; exp(x - m) is exp2f((x - m)·log2 e), so
// a masked score gives (-0.7·FLT_MAX - m)·log2 e = -inf there and
// probability 0, never NaN. Key 0 is always valid
// (kv_valid >= 1), so m is finite from the first tile on. As _attn_kernel
// does, the probabilities are rounded to the value dtype before P·V; the
// kernel rounds them before the normalisation (the division by l is after
// P·V), the plain version after it.
//
// Contract of the caller: bf16 operands, contiguous (G, S, D) groups with D
// in {16, 32, 64}, every base pointer 16-byte aligned (the C entry points
// check this and refuse the launch otherwise).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

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

// Rows [row0, row0 + kCols) of a (n, D) bf16 matrix into shared memory with
// row stride D + 8; rows >= n are zero-filled. One cp.async group's worth;
// the caller commits.
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int row0,
                                          int n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < kCols * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const int gr = row0 + r;
    const bool in = gr < n;
    cp_async_16(s + r * (D + 8) + c * 8,
                g + static_cast<long long>(in ? gr : 0) * D + c * 8, in);
  }
}

// The A fragments (16 rows × D) of rows row[0] = r, row[1] = r + 8 of a
// (n, D) bf16 matrix, read from device memory; rows >= n are zero.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const bf16* p, const int (&row)[2],
                                             int n) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row[j & 1];
      const int c = kk * 16 + (j >> 1) * 8 + 2 * tq;
      f[kk][j] = r < n ? *reinterpret_cast<const uint32_t*>(
                             p + static_cast<long long>(r) * D + c)
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
// registers for more than two blocks an SM.
template <int D>
__host__ __device__ constexpr int fwd_m() { return D == 64 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int fwd_rows() { return 64 * fwd_m<D>(); }

// Rows [q0, q0 + fwd_rows<D>()) of one group: out (bf16, row stride D) and
// lse (fp32, one per row). bias: this group's fp32 (Sq, Sk) slice, or null.
template <int D>
__device__ __forceinline__ void attend_rows_mma(
    int q0, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    bf16* __restrict__ o, float* __restrict__ lse, int sq, int sk,
    int kv_valid, float scale) {
  static_assert(D == 16 || D == 32 || D == 64, "head dim must be 16, 32 or 64");
  constexpr int S = D + 8;
  constexpr int M = fwd_m<D>();
  // keys per online-softmax step: the whole tile for one A tile a warp, half
  // of it for two (so that 2 × 4 score tiles are live, not 2 × 8)
  constexpr int kSub = M == 1 ? kCols : kCols / 2;
  __shared__ __align__(16) bf16 ks[2][kCols * S];
  __shared__ __align__(16) bf16 vs[2][kCols * S];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  // this lane's rows: row[m][0] and row[m][1] = row[m][0] + 8 of A tile m
  int row[M][2];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    row[m][0] = q0 + (warp * M + m) * 16 + (lane >> 2);
    row[m][1] = row[m][0] + 8;
  }

  load_tile<D>(ks[0], k, 0, sk);
  load_tile<D>(vs[0], v, 0, sk);
  cp_async_commit();
  uint32_t qf[M][D / 16][4];
#pragma unroll
  for (int m = 0; m < M; ++m) load_a_frags<D>(qf[m], q, row[m], sq);

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

  const int tiles = (sk + kCols - 1) / kCols;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_tile<D>(ks[buf ^ 1], k, (t + 1) * kCols, sk);
      load_tile<D>(vs[buf ^ 1], v, (t + 1) * kCols, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

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
            const int kj = k0 + n * 8 + 2 * tq + (e & 1);
            const int r = row[m][e >> 1];
            float x = s[m][n][e] * scale;
            if (bias != nullptr && kj < sk && r < sq)
              x += bias[static_cast<long long>(r) * sk + kj];
            if (kj >= kv_valid) x = kMaskValue;
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
            l[m][e >> 1] += p;
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
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[m][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int r = row[m][i];
      if (r >= sq) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(
            o + static_cast<long long>(r) * D + n * 8 + 2 * tq) =
            __floats2bfloat162_rn(acc[m][n][2 * i] / li,
                                  acc[m][n][2 * i + 1] / li);
      if (tq == 0) lse[r] = mr[m][i] + logf(li);
    }
}

}  // namespace mma
}  // namespace vtt
