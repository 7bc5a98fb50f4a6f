// Backward of the split-head attention with an additive bias, for bf16
// inputs, on the tensor cores: dq, dk, dv and the bias gradient dbias.
//
// It replaces no TPU kernel. The JAX package computes this case in jnp
// (vision_transformers_tpu/ops/flash_attention.py:2427-2466, "always used for
// the biased case — dbias needs the full ds"), in fp32, and so does the plain
// version (ops/flash_attention.py::flash_attention_bias_bwd_reference): it
// writes the (G·H, Sq, Sk) fp32 scores, probabilities, dP and dS to device
// memory and runs four fp32 products. This kernel computes the same function
// without them: SwinV2's windows above 128 tokens (Swin's split-head path)
// reach it through flash_attention's backward, row 16 of PERF.md's kernel
// table.
//
// q: (G, Sq, D), k/v: (G, Sk, D), do and out like q, lse (G, Sq) fp32 from
// the forward, contiguous, G = B·heads. bias: fp32 (bias_g, Sq, Sk), the
// grouped bias the forward added (group g reads plane g % bias_g); keys >=
// kv_valid masked after it. Writes dq, dk, dv in bf16 and dbias (bias_g, Sq,
// Sk) in fp32: dbias[r] = Σ over the groups g ≡ r (mod bias_g) of ds[g].
//
// Arithmetic (the plain version's, at its precision; only the order of the
// sums differs):
//   s  = q·kᵀ·scale + bias, keys >= kv_valid → -0.7·FLT_MAX
//   p  = exp(s − lse), dp = do·vᵀ, δ = rowsum(do ⊙ out), ds = p ⊙ (dp − δ)
//   dv = pᵀ·do, dq = ds·k·scale, dk = dsᵀ·q·scale, dbias = Σ_g ds
// q·kᵀ and do·vᵀ take the bf16 inputs on the tensor cores with fp32
// accumulators (the products the plain version takes of the same values
// upcast). p, dp, δ, ds and dbias stay fp32. Where p or ds is the A operand
// of a product it enters as two bf16 terms, hi = bf16(x), lo = bf16(x − hi),
// each product taken as hi·B + lo·B into one fp32 accumulator: about 16 bits
// of the operand, against the 8 of a single rounding (which the bias-free
// row-6 backward takes, as its TPU kernel does; not this function's
// numerics). dq and dk are scaled in fp32 before their one rounding.
//
// What bounds it at SwinV2-B @256 w16 (22 calls a train step at N 256, dh
// 32; 4.03 G score elements): q, k, v, do, out, dq, dk and dv are about
// 1.0 GB each in bf16 over a step, 2.4 ms at 3.35 TB/s; the work the
// mathematics needs, 10 · 4.03 G · 32 = 1.29 TFLOP, is 1.3 ms at 989 TFLOP/s.
// So the bound is the bytes, and the S×S tensors (16 GB each in fp32 a step)
// must never reach device memory. What the design pays above that: every
// score is recomputed in both passes (S and dP twice) and the split doubles
// the four second products, 20·Sq·Sk·D operations on mma.sync instead of
// 10; and two exponentials per score element. The bias is read from L2 once
// per group in each pass.
//
// Three launches, each output with one owner, sums in a fixed order, no
// float atomics: two runs give equal bits.
//   bias_bwd_dq_mma_kernel: one block per (bias plane r, `rows` query rows,
//     chunk of the groups g ≡ r mod bias_g). Its rows' fp32 dbias sums live
//     in shared memory for the whole chunk, each element added to by the one
//     lane that holds it in the accumulators (float2 column pairs, rows w
//     floats apart with w ≡ 8 mod 32: no bank conflicts); its bias is the
//     same for every group of the chunk and is read through L1 and L2 at the
//     top of each step, ahead of the wait for K and V. It walks its groups
//     and, in each, every 64-key tile (K/V double-buffered by cp.async
//     across the group boundaries), writes δ and dq of its rows, and at the
//     end its chunk's fp32 dbias partial. 2·rows/16 warps: warp w holds
//     query rows 16·(w mod rows/16) and one 32-key half of each tile; at a
//     group's end the second half's warps hand their fp32 dq to the first's
//     through the tile buffer just used.
//   bias_bwd_dkv_mma_kernel: one block of 4 warps per (group, 64 keys), keys
//     as the M dimension (Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, then Pᵀ and dSᵀ are the A
//     fragments of dV and dK), Q, dO, lse, δ and the 64 × 64 fp32 bias tile
//     double-buffered by cp.async over the query tiles.
//   bias_bwd_sum_kernel (when the dq pass has more than one chunk): adds the
//     chunks' partials in chunk order into dbias. With one chunk the dq
//     pass writes dbias itself.
// The chunks, rows and the dq pass's shared memory come from the shape, in
// one place (ops/flash_attention.py's bias_bwd_plan): rows the most of 64,
// 48, 32, 16 whose shared memory fits 227 KB (dbias rows of Sk fp32 sums and
// the K/V ring; at SwinV2-B's N 256 and dh 32, 86 KB: two blocks of 8 warps
// an SM), chunks so that the dq grid has about eight waves of the 132 SMs.
// This file only checks the plan: a dq_smem below what its rows need, or past
// 227 KB, is refused (cudaErrorInvalidValue). Sk past what 16 rows fit (2536
// at D 128, 3304 at D 32) has no plan, and its caller keeps the plain version
// there, not yet a kernel.
//
// Head dims: D 16, 32, 64 and 128 are instantiations; any other D up to 128
// runs in the next tile under attention_mma_tile.cuh's GroupPad layouts, the
// columns past D read as zeros and not written (rows 4 and 6 do the same). A
// bf16 operand must be aligned as align_mask(d) says (checked here).
#include <algorithm>
#include <cstdint>

#include "attention_mma_tile.cuh"
#include "launch_log.cuh"

namespace {

using bf16 = __nv_bfloat16;
using vtt::mma::kCols;
using vtt::mma::kLog2e;

constexpr int kSmemLimit = 232448;  // shared memory a block may ask for
constexpr int kBiasStride = kCols + 4;  // floats per row of a dk/dv bias tile

// x, y → hi = bf16(x, y) and lo = bf16(x − hi, y − hi), two bf16 words whose
// sum holds about 16 bits of each value.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = vtt::mma::pack_bf16(x - hf.x, y - hf.y);
}

// acc_to_a for an fp32 operand kept to about 16 bits: accumulator tiles c0,
// c1 (16 × 16) as the A fragments hi and lo of one k step.
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float (&c0)[4],
                                               const float (&c1)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}

// acc += (hi + lo)·B for one k16 step: B the 16 rows b[0 .. 16) (row stride
// D + 8) read transposed, each fragment once for both terms.
template <int D>
__device__ __forceinline__ void mma_ab_split(float (&acc)[D / 8][4],
                                             const uint32_t (&hi)[4],
                                             const uint32_t (&lo)[4],
                                             const bf16* b, int lane) {
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t f[4];
    vtt::mma::ldsm_x4_t(f, b + ((lane & 7) + ((lane >> 3) & 1) * 8) * (D + 8)
                               + np * 16 + (lane >> 4) * 8);
    vtt::mma::mma_bf16(acc[2 * np], hi, f[0], f[1]);
    vtt::mma::mma_bf16(acc[2 * np], lo, f[0], f[1]);
    vtt::mma::mma_bf16(acc[2 * np + 1], hi, f[2], f[3]);
    vtt::mma::mma_bf16(acc[2 * np + 1], lo, f[2], f[3]);
  }
}

// Floats per query row of the dq pass's dbias sums: Sk rounded up to even
// (float2 column pairs), then to 8 mod 32, so that the eight rows of a warp's
// float2 accesses fill the 32 banks twice (the plan's bias_bwd_row_floats;
// used here to lay the sums out and to check the plan's dq_smem).
__host__ __device__ constexpr int row_floats(int sk) {
  const int w = 2 * ((sk + 1) / 2);
  return w + ((8 - w % 32) + 32) % 32;
}

template <int D>
constexpr int ring_bytes() { return 4 * kCols * (D + 8) * 2; }

template <int D>
constexpr int dkv_smem_bytes() {
  return ring_bytes<D>() + 2 * kCols * kBiasStride * 4 + 4 * kCols * 4;
}

// The layout of a group's rows in the tile of width D: Contiguous<D> at the
// tile's own width, GroupPad<D> below it.
template <int D, bool kPad>
using Lay = std::conditional_t<kPad, vtt::mma::GroupPad<D>,
                               vtt::mma::Contiguous<D>>;

template <int D, bool kPad>
__device__ __forceinline__ Lay<D, kPad> layout(int d) {
  if constexpr (kPad)
    return vtt::mma::group_pad<D>(d);
  else
    return vtt::mma::Contiguous<D>{};
}

// Columns c, c + 1 of row p (rows `stride` apart) in bf16: both (Contiguous)
// or those < d (GroupPad).
template <bool kPad>
__device__ __forceinline__ void store_pair(bf16* p, long long off, int c,
                                           int d, float x0, float x1) {
  if constexpr (kPad)
    vtt::mma::store_pair_padded(p + off, c, d, x0, x1);
  else
    *reinterpret_cast<__nv_bfloat162*>(p + off + c) =
        __floats2bfloat162_rn(x0, x1);
}

// δ = rowsum(do ⊙ out) of row r (< sq), the four lanes of the row each
// taking a quarter of its columns and meeting by shuffles.
template <int D, bool kPad, class Layout>
__device__ __forceinline__ float row_delta(const bf16* dout, const bf16* out,
                                           int r, int sq, int tq,
                                           const Layout& lay) {
  float part = 0.f;
  if (r < sq) {
    if constexpr (kPad) {
      const long long base = static_cast<long long>(r) * lay.o();
      for (int c = tq; c < lay.d; c += 4)
        part = fmaf(__bfloat162float(dout[base + c]),
                    __bfloat162float(out[base + c]), part);
    } else {
      const long long base = static_cast<long long>(r) * D + tq * (D / 4);
#pragma unroll
      for (int c = 0; c < D / 4; c += 2) {
        const float2 d2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + base + c));
        const float2 o2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(out + base + c));
        part = fmaf(d2.x, o2.x, part);
        part = fmaf(d2.y, o2.y, part);
      }
    }
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

// Pass 1. blockIdx.x = r + bias_g·chunk, blockIdx.y = query tile of `rows`
// = blockDim.x / 4 rows. Shared memory: rows × w fp32 dbias sums, then the
// K/V ring (two stages of K then V, 64 × (D + 8) bf16 each). vec: Sk even
// and the bias 8-byte aligned (its column pairs read as float2).
template <int D, bool kPad>
__global__ void __launch_bounds__(256, D <= 32 ? 2 : 1)
bias_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const bf16* __restrict__ out,
                       const float* __restrict__ lse,
                       const float* __restrict__ bias, bf16* __restrict__ dq,
                       float* __restrict__ delta, float* __restrict__ part,
                       int groups, int bias_g, int sq, int sk, int kv_valid,
                       float scale, int per, int vec, int d) {
  using vtt::mma::kThreads;
  constexpr int S = D + 8;
  constexpr int kTile = kCols * S;
  const auto lay = layout<D, kPad>(d);
  const int dd = kPad ? d : D;  // elements per row in device memory
  const int row_warps = blockDim.x >> 6;
  const int rows = row_warps * 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rw = warp % row_warps;
  const int half = warp / row_warps;  // keys 32·half .. of each tile
  const int tq = lane & 3;
  const int r_plane = blockIdx.x % bias_g;
  const int chunk = blockIdx.x / bias_g;
  const int q0 = blockIdx.y * rows;
  const int n_per = groups / bias_g;
  const int j0 = chunk * per;
  const int j1 = min(j0 + per, n_per);
  const int nk = (sk + kCols - 1) / kCols;
  const int steps = (j1 - j0) * nk;
  const int w = row_floats(sk);
  float* sums = reinterpret_cast<float*>(vtt::dyn_smem());
  bf16* ring = reinterpret_cast<bf16*>(sums + rows * w);
  const float* bp = bias + static_cast<long long>(r_plane) * sq * sk;

  // K/V of step s (group j0 + s / nk, key tile s % nk) into a stage, by
  // the block's threads as 256 tile-loader slots (K 0-127, V 128-255)
  auto load_step = [&](int s, int stage) {
    const long long g =
        r_plane + static_cast<long long>(bias_g) * (j0 + s / nk);
    const int t = s % nk;
    bf16* ks = ring + stage * 2 * kTile;
    for (unsigned u = threadIdx.x; u < 2 * kThreads; u += blockDim.x) {
      const bool is_k = u < kThreads;
      vtt::mma::load_tile_as<D>(lay, is_k ? ks : ks + kTile,
                                (is_k ? k : v) + g * sk * dd, t * kCols, sk,
                                lay.qkv(), u % kThreads);
    }
  };
  if (steps > 0) {
    load_step(0, 0);
    vtt::mma::cp_async_commit();
  }
  for (int idx = threadIdx.x; idx < rows * w / 4; idx += blockDim.x)
    reinterpret_cast<float4*>(sums)[idx] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int row[2] = {q0 + rw * 16 + (lane >> 2),
                      q0 + rw * 16 + (lane >> 2) + 8};
  uint32_t qf[D / 16][4], df[D / 16][4];
  float lse_r[2], delta_r[2];
  float acc[D / 8][4];

  for (int s = 0; s < steps; ++s) {
    const int stage = s & 1;
    const int t = s % nk;
    const long long g =
        r_plane + static_cast<long long>(bias_g) * (j0 + s / nk);
    const int k0 = t * kCols + half * 32;
    // this lane's bias pairs of the step (the same for every group of the
    // chunk, read through L2 and L1), issued before the wait for K and V
    float2 bias_r[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = k0 + n * 8 + 2 * tq;
        float2 b2 = make_float2(0.f, 0.f);
        if (row[i] < sq && c < sk) {
          const float* src = bp + static_cast<long long>(row[i]) * sk + c;
          if (vec) {
            b2 = *reinterpret_cast<const float2*>(src);
          } else {
            b2.x = src[0];
            if (c + 1 < sk) b2.y = src[1];
          }
        }
        bias_r[i][n] = b2;
      }
    if (t == 0) {  // a group starts: its Q and dO rows, δ, lse
      vtt::mma::load_a_frags_as<D>(lay, qf, q + g * sq * dd, row, sq,
                                   lay.qkv());
      vtt::mma::load_a_frags_as<D>(lay, df, dout + g * sq * dd, row, sq,
                                   lay.o());
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        delta_r[i] = row_delta<D, kPad>(dout + g * sq * dd, out + g * sq * dd,
                                        row[i], sq, tq, lay);
        lse_r[i] = row[i] < sq ? lse[g * sq + row[i]] * kLog2e : 0.f;
        if (half == 0 && tq == 0 && row[i] < sq)
          delta[g * sq + row[i]] = delta_r[i];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
    if (s + 1 < steps) {
      load_step(s + 1, stage ^ 1);
      vtt::mma::cp_async_commit();
      vtt::mma::cp_async_wait<1>();
    } else {
      vtt::mma::cp_async_wait<0>();
    }
    __syncthreads();

    const bf16* ks = ring + stage * 2 * kTile;
    const bf16* vs = ks + kTile;
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
    vtt::mma::mma_abt<D, 4>(sc, qf, ks + half * 32 * S, lane);
    vtt::mma::mma_abt<D, 4>(dp, df, vs + half * 32 * S, lane);

#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = k0 + n * 8 + 2 * tq;  // this lane's column pair
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int e = 2 * i + e1;
          const int kj = c + e1;
          // two roundings, as the forward and the plain version take them
          float x = __fadd_rn(__fmul_rn(sc[n][e], scale),
                              e1 ? bias_r[i][n].y : bias_r[i][n].x);
          if (kj >= kv_valid) x = vtt::kMaskValue;
          const float p = (kj < sk && row[i] < sq)
                              ? exp2f(fmaf(x, kLog2e, -lse_r[i])) : 0.f;
          sc[n][e] = p * (dp[n][e] - delta_r[i]);
        }
        // dbias: this element pair's sum, owned by this lane
        if (c < sk) {
          float2* cell = reinterpret_cast<float2*>(
              sums + (row[i] - q0) * w + c);
          float2 sum = *cell;
          sum.x += sc[n][2 * i];
          sum.y += sc[n][2 * i + 1];
          *cell = sum;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t hi[4], lo[4];
      acc_to_a_split(hi, lo, sc[2 * kk], sc[2 * kk + 1]);
      mma_ab_split<D>(acc, hi, lo, ks + (half * 32 + kk * 16) * S, lane);
    }
    __syncthreads();  // every warp is done with this stage

    if (t == nk - 1) {  // the group ends: dq of its rows
      float* xch = reinterpret_cast<float*>(ring + stage * 2 * kTile);
      const int lr = rw * 16 + (lane >> 2);
      if (half == 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<float2*>(xch + (lr + 8 * i) * S + n * 8 +
                                       2 * tq) =
                make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      }
      __syncthreads();
      if (half == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (row[i] >= sq) continue;
          const long long off = (g * sq + row[i]) * static_cast<long long>(dd);
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            const float2 o = *reinterpret_cast<const float2*>(
                xch + (lr + 8 * i) * S + n * 8 + 2 * tq);
            store_pair<kPad>(dq, off, n * 8 + 2 * tq, d,
                             (acc[n][2 * i] + o.x) * scale,
                             (acc[n][2 * i + 1] + o.y) * scale);
          }
        }
      }
      __syncthreads();  // the stage is free for the next prefetch
    }
  }

  // this chunk's dbias partial (or dbias itself with one chunk)
  float* pp = part + (static_cast<long long>(chunk) * bias_g + r_plane) *
                         static_cast<long long>(sq) * sk;
  for (int idx = threadIdx.x; idx < rows * sk; idx += blockDim.x) {
    const int i = idx / sk, c = idx % sk;
    if (q0 + i < sq)
      pp[static_cast<long long>(q0 + i) * sk + c] = sums[i * w + c];
  }
}

// Query tile t of the dk/dv pass: Q and dO rows, lse·log2 e and δ, and the
// bias tile bias[t·64 .., k0 .. k0 + 64) (rows kBiasStride floats apart;
// 16-byte copies when Sk is a multiple of 4 and the plane 16-byte aligned,
// else 4-byte ones). Rows >= Sq and keys >= Sk are zero. The caller commits.
template <int D, class Layout>
__device__ __forceinline__ void load_dkv_tile(
    bf16* qs, bf16* dos, float* bs, float* lse_s, float* delta_s,
    const bf16* q, const bf16* dout, const float* lse, const float* delta,
    const float* bp, int t, int k0, int sq, int sk, bool vec,
    const Layout& lay) {
  using vtt::mma::kThreads;
  vtt::mma::load_tile_as<D>(lay, qs, q, t * kCols, sq, lay.qkv(),
                            threadIdx.x);
  vtt::mma::load_tile_as<D>(lay, dos, dout, t * kCols, sq, lay.o(),
                            threadIdx.x);
  if (vec) {
#pragma unroll
    for (int it = 0; it < kCols * (kCols / 4) / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int qq = idx / (kCols / 4), cc = 4 * (idx % (kCols / 4));
      const int qi = t * kCols + qq;
      const bool in = qi < sq && k0 + cc < sk;
      vtt::mma::cp_async_16(
          bs + qq * kBiasStride + cc,
          bp + (in ? static_cast<long long>(qi) * sk + k0 + cc : 0ll), in);
    }
  } else {
#pragma unroll 8
    for (int it = 0; it < kCols * kCols / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int qq = idx / kCols, cc = idx % kCols;
      const int qi = t * kCols + qq;
      const bool in = qi < sq && k0 + cc < sk;
      vtt::mma::cp_async_4(
          bs + qq * kBiasStride + cc,
          bp + (in ? static_cast<long long>(qi) * sk + k0 + cc : 0ll), in);
    }
  }
  if (threadIdx.x < kCols) {
    const int qi = t * kCols + threadIdx.x;
    lse_s[threadIdx.x] = qi < sq ? lse[qi] * kLog2e : 0.f;
    delta_s[threadIdx.x] = qi < sq ? delta[qi] : 0.f;
  }
}

// Pass 2. blockIdx.x = group, blockIdx.y = 64-key tile; 128 threads.
// Shared memory: Q, Q, dO, dO tiles (64 × (D + 8) bf16), two bias tiles (64
// × kBiasStride fp32), lse and δ of two query tiles. At D <= 32 four blocks
// an SM (128 registers, 32 bytes spilled at D 32): 5% faster at SwinV2-B's
// shapes than three blocks at 168 registers.
template <int D, bool kPad>
__global__ void __launch_bounds__(vtt::mma::kThreads, D <= 32 ? 4 : 1)
bias_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        int bias_g, int sq, int sk, int kv_valid, float scale,
                        int vec, int d) {
  constexpr int S = D + 8;
  constexpr int kTile = kCols * S;
  const auto lay = layout<D, kPad>(d);
  const int dd = kPad ? d : D;
  const long long g = blockIdx.x;
  const int k0 = blockIdx.y * kCols;
  bf16* qs = reinterpret_cast<bf16*>(vtt::dyn_smem());  // [2][kTile]
  bf16* dos = qs + 2 * kTile;                            // [2][kTile]
  float* bs = reinterpret_cast<float*>(dos + 2 * kTile);  // [2][64 × stride]
  float* lse_s = bs + 2 * kCols * kBiasStride;            // [2][64]
  float* delta_s = lse_s + 2 * kCols;                     // [2][64]

  const bf16* qg = q + g * sq * dd;
  const bf16* dog = dout + g * sq * dd;
  const float* lg = lse + g * sq;
  const float* dlg = delta + g * sq;
  const float* bp = bias + (g % bias_g) * static_cast<long long>(sq) * sk;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;
  const int tq = lane & 3;
  const int key[2] = {k0 + warp * 16 + gr, k0 + warp * 16 + gr + 8};
  const int nq = (sq + kCols - 1) / kCols;

  load_dkv_tile<D>(qs, dos, bs, lse_s, delta_s, qg, dog, lg, dlg, bp, 0, k0,
                   sq, sk, vec != 0, lay);
  vtt::mma::cp_async_commit();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  vtt::mma::load_a_frags_as<D>(lay, kf, k + g * sk * dd, key, sk, lay.qkv());
  vtt::mma::load_a_frags_as<D>(lay, vf, v + g * sk * dd, key, sk, lay.qkv());

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int t = 0; t < nq; ++t) {
    const int buf = t & 1;
    if (t + 1 < nq) {
      const int nb = buf ^ 1;
      load_dkv_tile<D>(qs + nb * kTile, dos + nb * kTile,
                       bs + nb * kCols * kBiasStride, lse_s + nb * kCols,
                       delta_s + nb * kCols, qg, dog, lg, dlg, bp, t + 1, k0,
                       sq, sk, vec != 0, lay);
      vtt::mma::cp_async_commit();
      vtt::mma::cp_async_wait<1>();
    } else {
      vtt::mma::cp_async_wait<0>();
    }
    __syncthreads();

    const bf16* qb = qs + buf * kTile;
    const bf16* dob = dos + buf * kTile;
    const float* bb = bs + buf * kCols * kBiasStride;
    const float* lb = lse_s + buf * kCols;
    const float* db = delta_s + buf * kCols;
    const int q0 = t * kCols;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // query columns 32·h .. 32·h + 31
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      vtt::mma::mma_abt<D, 4>(st, kf, qb + h * 32 * S, lane);
      vtt::mma::mma_abt<D, 4>(dpt, vf, dob + h * 32 * S, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c0 = h * 32 + n * 8 + 2 * tq;  // this lane's two columns
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = c0 + (e & 1);
          float x = __fadd_rn(__fmul_rn(st[n][e], scale),
                              bb[c * kBiasStride + warp * 16 + gr + 8 * i]);
          if (key[i] >= kv_valid) x = vtt::kMaskValue;
          const float p = (key[i] < sk && q0 + c < sq)
                              ? exp2f(fmaf(x, kLog2e, -lb[c])) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - db[c]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int r0 = (h * 32 + kk * 16) * S;
        uint32_t hi[4], lo[4];
        acc_to_a_split(hi, lo, st[2 * kk], st[2 * kk + 1]);
        mma_ab_split<D>(acc_v, hi, lo, dob + r0, lane);
        acc_to_a_split(hi, lo, dpt[2 * kk], dpt[2 * kk + 1]);
        mma_ab_split<D>(acc_k, hi, lo, qb + r0, lane);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= sk) continue;
    const long long off = (g * sk + key[i]) * static_cast<long long>(dd);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      store_pair<kPad>(dk, off, n * 8 + 2 * tq, d, acc_k[n][2 * i] * scale,
                       acc_k[n][2 * i + 1] * scale);
      store_pair<kPad>(dv, off, n * 8 + 2 * tq, d, acc_v[n][2 * i],
                       acc_v[n][2 * i + 1]);
    }
  }
}

// dbias = Σ_c part[c] in chunk order; plane = bias_g·Sq·Sk.
__global__ void bias_bwd_sum_kernel(const float* __restrict__ part,
                                    float* __restrict__ dbias,
                                    long long plane, int chunks) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < plane; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int c = 1; c < chunks; ++c) s += part[c * plane + i];
    dbias[i] = s;
  }
}

struct Args {
  const bf16 *q, *k, *v, *dout, *out;
  const float *lse, *bias;
  bf16 *dq, *dk, *dv;
  float *dbias, *delta, *part;
  int groups, bias_g, sq, sk, d, kv_valid, rows, chunks, dq_smem;
  float scale;
  cudaStream_t stream;
};

template <int D, bool kPad>
int launch(const Args& a) {
  const int n_per = a.groups / a.bias_g;
  const int per = (n_per + a.chunks - 1) / a.chunks;
  if ((n_per + per - 1) / per != a.chunks)  // no empty chunk
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.dq_smem < a.rows * row_floats(a.sk) * 4 + ring_bytes<D>() ||
      a.dq_smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = a.chunks > 1 ? a.part : a.dbias;
  const auto addr = reinterpret_cast<std::uintptr_t>(a.bias);
  int rc = vtt::allow_dynamic_smem(bias_bwd_dq_mma_kernel<D, kPad>,
                                   kSmemLimit);
  if (rc != 0) return rc;
  const dim3 grid_q(a.bias_g * a.chunks, (a.sq + a.rows - 1) / a.rows);
  bias_bwd_dq_mma_kernel<D, kPad><<<grid_q, 4 * a.rows, a.dq_smem,
                                    a.stream>>>(
      a.q, a.k, a.v, a.dout, a.out, a.lse, a.bias, a.dq, a.delta, part,
      a.groups, a.bias_g, a.sq, a.sk, a.kv_valid, a.scale, per,
      static_cast<int>(a.sk % 2 == 0 && (addr & 7u) == 0), a.d);
  rc = vtt::launched("bias_bwd_dq_mma_kernel");
  if (rc != 0) return rc;

  constexpr int dkv_smem = dkv_smem_bytes<D>();
  rc = vtt::allow_dynamic_smem(bias_bwd_dkv_mma_kernel<D, kPad>, dkv_smem);
  if (rc != 0) return rc;
  const bool vec = a.sk % 4 == 0 && (addr & 15u) == 0;
  const dim3 grid_k(a.groups, (a.sk + kCols - 1) / kCols);
  bias_bwd_dkv_mma_kernel<D, kPad><<<grid_k, vtt::mma::kThreads, dkv_smem,
                                     a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, a.dk, a.dv, a.bias_g,
      a.sq, a.sk, a.kv_valid, a.scale, static_cast<int>(vec), a.d);
  rc = vtt::launched("bias_bwd_dkv_mma_kernel");
  if (rc != 0 || a.chunks == 1) return rc;

  const long long plane = static_cast<long long>(a.bias_g) * a.sq * a.sk;
  const int blocks = static_cast<int>(std::min(4096ll, (plane + 255) / 256));
  bias_bwd_sum_kernel<<<blocks, 256, 0, a.stream>>>(a.part, a.dbias, plane,
                                                    a.chunks);
  return vtt::launched("bias_bwd_sum_kernel");
}

}  // namespace

extern "C" {

// q, k, v, dout, out: bf16 (G, Sq|Sk, d); lse: fp32 (G, Sq); bias: fp32
// (bias_g, Sq, Sk), bias_g dividing G. Writes dq, dk, dv (bf16, like q, k,
// v) and dbias (fp32, like bias). delta: fp32 scratch of G·Sq; part: null
// when chunks is 1, else fp32 scratch of chunks·bias_g·Sq·Sk. rows: 16, 32,
// 48 or 64 query rows a dq block; chunks: the groups of a bias plane split
// into that many equal ranges, none empty; dq_smem: a dq block's shared bytes
// (the plan's smem_bytes). 1 <= d <= 128, 1 <= kv_valid <= Sk. Returns 0 or
// a cudaError_t: cudaErrorInvalidValue for arguments out of range (a dq_smem
// below what the rows need or past 227 KB among them),
// cudaErrorMisalignedAddress for a bf16 operand off align_mask(d).
int flash_attention_bias_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* out,
                             const void* lse, const void* bias, void* dq,
                             void* dk, void* dv, void* dbias, void* delta,
                             void* part, int groups, int bias_g, int sq,
                             int sk, int d, int kv_valid, int rows, int chunks,
                             int dq_smem, float scale, void* stream) {
  if (groups < 1 || bias_g < 1 || groups % bias_g != 0 || sq < 1 || sk < 1 ||
      d < 1 || d > 128 || kv_valid < 1 || kv_valid > sk ||
      (rows != 16 && rows != 32 && rows != 48 && rows != 64) || chunks < 1 ||
      (chunks > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto addr = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  if ((addr(q) | addr(k) | addr(v) | addr(dout) | addr(out) | addr(dq) |
       addr(dk) | addr(dv)) & vtt::mma::align_mask(d))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
               static_cast<const bf16*>(out), static_cast<const float*>(lse),
               static_cast<const float*>(bias), static_cast<bf16*>(dq),
               static_cast<bf16*>(dk), static_cast<bf16*>(dv),
               static_cast<float*>(dbias), static_cast<float*>(delta),
               static_cast<float*>(part), groups, bias_g, sq, sk, d,
               kv_valid, rows, chunks, dq_smem, scale,
               static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return launch<16, false>(a);
    case 32: return launch<32, false>(a);
    case 64: return launch<64, false>(a);
    case 128: return launch<128, false>(a);
    default:
      return d < 16   ? launch<16, true>(a)
             : d < 32 ? launch<32, true>(a)
             : d < 64 ? launch<64, true>(a)
                      : launch<128, true>(a);
  }
}

const char* flash_attention_bias_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
