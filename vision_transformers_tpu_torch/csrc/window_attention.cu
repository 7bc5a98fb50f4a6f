// Window attention on the partitioned projection: the packed and the batched
// kernel.
//
// Replace the TPU kernels vision_transformers_tpu/ops/flash_attention.py::
// _window_pack_kernel (:1295, reached through _window_pack_fwd_pallas :1370
// and window_packed_attention :1661) and _window_batched_kernel (:1708,
// through _window_batched_fwd_pallas :1732 and window_batched_attention
// :1806).
//
// qkv: (G, N, 3·H·D), G = batch·n_win with windows fastest, columns
// [q | k | v]; head h's q of token (g, i) is at row g·N + i, column h·D, its
// k one section (H·D) further, its v two. bias: null or (nW', H, N, N) in the
// compute dtype; window g adds row g mod nW' (nW' = 1: shared by all windows;
// nW' = n_win: per-window shift or pad masks; nW' need not divide the block).
// out: (G, N, H·D). No head-split or transposed copy is made.
//
// What bounds them on the H100 (Swin-T @224 stage 1, batch 32: G = 2048,
// N = 49, H = 3, D = 32, bf16): 4·G·H·N²·D = 1.9 GFLOP, 1.9 µs at 989 TFLOP/s,
// against 57.8 MB of qkv read and 19.3 MB of out written, 23 µs at
// 3.35 TB/s: bytes. So each must read qkv once and write out once and keep
// every score on chip; see window_tile.cuh for how on the CUDA cores (one
// thread per query row, K/V in shared memory, fp32 FMAs, which is where the
// gap to the bound lies) and window_mma_tile.cuh for how on the tensor
// cores.
//
// window_packed_kernel (fp32), the TPU's "pack P windows into one MXU
// product": here the unit to fill is the block's threads, so a block takes
// as many windows of one head as fill its warps with query rows (N = 49: 5
// windows, 245 of 256 threads; N = 64: 4; N = 16: 16). Each window reads its
// own bias row (g mod nW') straight from device memory (1.2 MB at SwinV2-T
// stage 1, L2 resident). Grid: x = ceil(G / P), y = H; a ragged last block
// is bounds-checked.
//
// window_packed_mma_kernel (bf16), the same function on the tensor cores
// (window_mma_tile.cuh): a block takes wpb windows of one head, a warp per
// 16 query rows of a window, the window's q, k, v and bias row staged in
// shared memory; the launch shape comes from N alone (window_mma_geometry),
// and the C entry's p and threads, the CUDA-core plan, are only checked.
// Grid: x = ceil(G / wpb), y = H.
//
// window_batched_kernel (fp32), the TPU's per-head batched product for a
// bias shared by all windows: a block belongs to one head, stages that
// head's (N, N) bias in shared memory once (row stride N + 1, so rows fall
// in distinct banks) and reuses it over `passes` groups of P windows. Grid:
// x = ceil(G / (P·passes)), y = H. A per-window bias (nW' > 1) is read from
// device memory as in the packed kernel.
//
// window_batched_mma_kernel (bf16), the same function on the tensor cores
// (window_mma_tile.cuh's window_run_mma): a block belongs to one head,
// stages a shared bias once as bf16 and walks a run of windows, each
// window's q, k and v double-buffered so the copies of the next overlap the
// products of the current one; a per-window bias is staged beside each
// window's q, k, v. The launch shape (windows a step, run, grid) comes from
// N, G·H and the card (window_run_launch); the C entry's p, threads and
// passes, the CUDA-core plan, are only checked.
//
// Row 11 at every other head dim its JAX plan admits (that plan has no
// head-dim term; ops/flash_attention.py's window_batched_plan keeps its VMEM
// budget as the route rule): in bf16 window_batched_mma_padded_kernel<T, NK>
// runs dh up to 64 in the tile T of window_tile(dh) (16, 32 or 64), the
// columns past dh read as zeros by copies of the grain the offsets keep
// (window_stage_cols) and never stored, the dh a runtime argument. Above 64
// window_batched_mma_chunked_kernel<NK> takes the head dim in 64-column
// chunks (window_chunk_tile.cuh). In fp32 window_batched_chunked_kernel: the
// window's scores in shared memory, one thread a query row, K and then V in
// 32-column chunks (kWinCols).
#include "window_chunk_tile.cuh"
#include "window_mma_tile.cuh"
#include "window_tile.cuh"

namespace {

using vtt::kWinMaxThreads;

template <typename T, int D>
__global__ void __launch_bounds__(kWinMaxThreads)
window_packed_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                     T* __restrict__ out, long long g, int n, int heads,
                     int bias_windows, float scale, int p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + p * n * D;

  const int h = blockIdx.y;
  const long long hd = static_cast<long long>(heads) * D;
  const long long w0 = static_cast<long long>(blockIdx.x) * p;
  const int count = static_cast<int>(min(static_cast<long long>(p), g - w0));
  const vtt::PackedRows map{n};

  vtt::stage_kv<T, D>(qkv, map, w0, count, n, h * D, hd, 3 * hd, ks, vs);
  __syncthreads();

  const int w = threadIdx.x / n, i = threadIdx.x % n;
  if (w >= count) return;
  const long long gw = w0 + w;
  const long long row = map(gw, i);
  const T* b_row = bias == nullptr
      ? nullptr
      : bias + (((gw % bias_windows) * heads + h) * n + i) * n;
  vtt::attend_row<T, D, T>(qkv + row * 3 * hd + h * D, ks + w * n * D,
                           vs + w * n * D, b_row, n, scale,
                           out + row * hd + h * D);
}

// D: the head dim, in the tile of width T = window_tile(D) (16 for D 1-8).
template <int D, int NK>
__global__ void __launch_bounds__(vtt::mma::kWinMmaMaxThreads)
window_packed_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out, long long g, int n,
                         int heads, int bias_windows, float scale, int mt,
                         int wpb) {
  using vtt::mma::bf16;
  constexpr int T = vtt::mma::window_tile(D);
  constexpr int S = T + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp / mt, t = warp % mt;  // window of the block, query tile
  const long long gw = static_cast<long long>(blockIdx.x) * wpb + w;
  if (gw >= g) return;  // a ragged last block: this window's warps only
  bf16* qs = reinterpret_cast<bf16*>(smem_raw)
             + w * vtt::mma::window_smem_elems<T, NK>(3, 1);
  bf16* ks = qs + NK * S;
  bf16* vs = ks + NK * S;
  bf16* bs = vs + NK * S;  // (NK, NK + 8): the window's bias row

  const int h = blockIdx.y;
  const long long hd = static_cast<long long>(heads) * D;
  const bf16* src = qkv + gw * n * 3 * hd + h * D;  // q of token 0
  const int tid = t * 32 + lane, count = mt * 32;
  vtt::mma::window_stage<T, NK, D>(qs, src, n, 3 * hd, tid, count);
  vtt::mma::window_stage<T, NK, D>(ks, src + hd, n, 3 * hd, tid, count);
  vtt::mma::window_stage<T, NK, D>(vs, src + 2 * hd, n, 3 * hd, tid, count);
  vtt::mma::cp_async_commit();
  if (bias != nullptr)
    vtt::mma::window_stage_bias<NK>(
        bs, bias + ((gw % bias_windows) * heads + h) * n * n, n, t, mt, lane);
  vtt::mma::cp_async_wait<0>();
  vtt::mma::window_sync(w, count);
  vtt::mma::window_attend_mma<T, NK, D>(
      qs, ks, vs, bias == nullptr ? nullptr : bs, n, t, scale,
      out + gw * n * hd + h * D, hd, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWinMaxThreads)
window_batched_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                      T* __restrict__ out, long long g, int n, int heads,
                      int bias_windows, float scale, int p, int passes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + p * n * D;
  float* bs = vs + p * n * D;  // (N, N + 1): the head's shared bias

  const int h = blockIdx.y;
  const long long hd = static_cast<long long>(heads) * D;
  const long long base = static_cast<long long>(blockIdx.x) * p * passes;
  const bool shared_bias = bias != nullptr && bias_windows == 1;
  const vtt::PackedRows map{n};

  if (shared_bias) {
    const T* bh = bias + static_cast<long long>(h) * n * n;
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
      bs[(idx / n) * (n + 1) + idx % n] = vtt::to_f32(bh[idx]);
  }

  const int w = threadIdx.x / n, i = threadIdx.x % n;
  for (int pass = 0; pass < passes; ++pass) {
    const long long w0 = base + static_cast<long long>(pass) * p;
    if (w0 >= g) break;  // the same for every thread of the block
    const int count = static_cast<int>(min(static_cast<long long>(p), g - w0));
    __syncthreads();  // the previous pass has read ks/vs; bs is staged
    vtt::stage_kv<T, D>(qkv, map, w0, count, n, h * D, hd, 3 * hd, ks, vs);
    __syncthreads();
    if (w >= count) continue;
    const long long gw = w0 + w;
    const long long row = map(gw, i);
    const T* q_row = qkv + row * 3 * hd + h * D;
    T* o_row = out + row * hd + h * D;
    if (shared_bias) {
      vtt::attend_row<T, D, float>(q_row, ks + w * n * D, vs + w * n * D,
                                   bs + i * (n + 1), n, scale, o_row);
    } else {
      const T* b_row = bias == nullptr
          ? nullptr
          : bias + (((gw % bias_windows) * heads + h) * n + i) * n;
      vtt::attend_row<T, D, T>(q_row, ks + w * n * D, vs + w * n * D, b_row,
                               n, scale, o_row);
    }
  }
}

template <int D, int NK>
__global__ void __launch_bounds__(vtt::mma::kWinMmaMaxThreads)
window_batched_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const __nv_bfloat16* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, long long g, int n,
                          int heads, int bias_windows, float scale, int mt,
                          int wpb, int run) {
  vtt::mma::window_run_mma<vtt::mma::window_tile(D), NK, D>(
      vtt::mma::PackedWindows{n}, qkv, bias, out,
      static_cast<long long>(blockIdx.x) * wpb * run, g, n, heads,
      static_cast<long long>(heads) * D, bias_windows, scale, mt, wpb, run);
}

// Row 11 at a head dim dh outside WINDOW_HEAD_DIMS, dh <= D, in the tile D.
template <int D, int NK>
__global__ void __launch_bounds__(vtt::mma::kWinMmaMaxThreads)
window_batched_mma_padded_kernel(const __nv_bfloat16* __restrict__ qkv,
                                 const __nv_bfloat16* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ out, long long g,
                                 int n, int heads, int bias_windows,
                                 float scale, int dh, int mt, int wpb,
                                 int run) {
  vtt::mma::window_run_mma<D, NK, 0>(
      vtt::mma::PackedWindows{n}, qkv, bias, out,
      static_cast<long long>(blockIdx.x) * wpb * run, g, n, heads,
      static_cast<long long>(heads) * dh, bias_windows, scale, mt, wpb, run,
      dh);
}

// Row 11 above head dim 64: 64-column chunks.
template <int NK>
__global__ void __launch_bounds__(vtt::mma::kWinMmaMaxThreads)
window_batched_mma_chunked_kernel(const __nv_bfloat16* __restrict__ qkv,
                                  const __nv_bfloat16* __restrict__ bias,
                                  __nv_bfloat16* __restrict__ out, long long g,
                                  int n, int heads, int dh, int bias_windows,
                                  float scale, int mt, int wpb, int run) {
  vtt::mma::window_run_chunked_mma<NK>(
      qkv, bias, out, static_cast<long long>(blockIdx.x) * wpb * run, g, n,
      heads, dh, bias_windows, scale, mt, wpb, run);
}

// Row 11 in fp32 at a head dim outside WINDOW_HEAD_DIMS: a block takes
// `passes` groups of p windows of one head, one thread a query row. Its
// scores accumulate in a shared (P·N, N|1) tile over 32-column chunks of K,
// then each row's softmax in place, then out chunk by chunk over V.
__global__ void __launch_bounds__(kWinMaxThreads)
window_batched_chunked_kernel(const float* __restrict__ qkv,
                              const float* __restrict__ bias,
                              float* __restrict__ out, long long g, int n,
                              int heads, int dh, int bias_windows, float scale,
                              int p, int passes) {
  using vtt::kWinCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = n | 1;  // odd row stride: a warp's rows in distinct banks
  float* xs = reinterpret_cast<float*>(smem_raw);  // (P·N, kWinCols)
  float* st = xs + p * n * kWinCols;               // (P·N, ld)
  const int h = blockIdx.y;
  const long long hd = static_cast<long long>(heads) * dh;
  const long long base = static_cast<long long>(blockIdx.x) * p * passes;
  const int w = threadIdx.x / n, i = threadIdx.x % n;
  float* srow = st + threadIdx.x * ld;
  const float* xw = xs + w * n * kWinCols;
  for (int pass = 0; pass < passes; ++pass) {
    const long long w0 = base + static_cast<long long>(pass) * p;
    if (w0 >= g) break;  // the same for every thread of the block
    const int count = static_cast<int>(min(static_cast<long long>(p), g - w0));
    const bool active = w < count;
    const float* q0 = qkv + w0 * n * 3 * hd + h * dh;  // q of the 1st token
    const long long row = w0 * n + threadIdx.x;       // this thread's token
    for (int c0 = 0; c0 < dh; c0 += kWinCols) {
      __syncthreads();  // xs has been read
      vtt::stage_chunk(q0 + hd, 3 * hd, count * n, c0, dh, xs);  // K
      __syncthreads();
      if (!active) continue;
      float q[kWinCols];
      vtt::load_chunk(qkv + row * 3 * hd + h * dh, c0, dh, q);
      for (int j = 0; j < n; ++j)
        srow[j] = (c0 == 0 ? 0.f : srow[j]) +
                  vtt::dot_row<kWinCols>(q, xw + j * kWinCols);
    }
    if (active) {  // p = softmax(s·scale + bias), max before any exp
      const float* b_row = bias == nullptr
          ? nullptr
          : bias + (((w0 + w) % bias_windows) * heads + h) * n * n + i * n;
      float m = -CUDART_INF_F;
      for (int j = 0; j < n; ++j) {
        float x = srow[j] * scale;
        if (b_row != nullptr) x += b_row[j];
        srow[j] = x;
        m = fmaxf(m, x);
      }
      float l = 0.f;
      for (int j = 0; j < n; ++j) {
        const float e = expf(srow[j] - m);
        srow[j] = e;
        l += e;
      }
      for (int j = 0; j < n; ++j) srow[j] /= l;
    }
    for (int c0 = 0; c0 < dh; c0 += kWinCols) {
      __syncthreads();
      vtt::stage_chunk(q0 + 2 * hd, 3 * hd, count * n, c0, dh, xs);  // V
      __syncthreads();
      if (!active) continue;
      float acc[kWinCols];
#pragma unroll
      for (int c = 0; c < kWinCols; ++c) acc[c] = 0.f;
      for (int j = 0; j < n; ++j)
        vtt::axpy_row<kWinCols>(srow[j], xw + j * kWinCols, acc);
      vtt::store_chunk(out + row * hd + h * dh, c0, dh, acc);
    }
  }
}

template <typename T, int D>
int launch_packed(const void* qkv, const void* bias, void* out, int g, int n,
                  int heads, int bias_windows, float scale, int p, int threads,
                  cudaStream_t stream) {
  const size_t smem = vtt::window_kv_bytes(p, n, D);
  auto kernel = window_packed_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g + p - 1) / p, heads);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(bias),
      static_cast<T*>(out), g, n, heads, bias_windows, scale, p);
  return vtt::launched("window_packed_kernel");
}

template <int D, int NK>
int launch_packed_mma(const void* qkv, const void* bias, void* out, int g,
                      int n, int heads, int bias_windows, float scale,
                      cudaStream_t stream) {
  const vtt::mma::WindowGeometry geo = vtt::mma::window_mma_geometry(n);
  const size_t smem = static_cast<size_t>(geo.wpb) *
                      vtt::mma::window_smem_elems<vtt::mma::window_tile(D),
                                                  NK>(3, 1) *
                      sizeof(__nv_bfloat16);
  auto kernel = window_packed_mma_kernel<D, NK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g + geo.wpb - 1) / geo.wpb, heads);
  kernel<<<grid, geo.threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), g, n, heads, bias_windows, scale,
      geo.mt, geo.wpb);
  return vtt::launched("window_packed_mma_kernel");
}

template <typename T, int D>
int launch_batched(const void* qkv, const void* bias, void* out, int g, int n,
                   int heads, int bias_windows, float scale, int p,
                   int threads, int passes, cudaStream_t stream) {
  const size_t smem = vtt::window_kv_bytes(p, n, D) +
                      static_cast<size_t>(n) * (n + 1) * sizeof(float);
  auto kernel = window_batched_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = p * passes;
  const dim3 grid((g + per_block - 1) / per_block, heads);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(bias),
      static_cast<T*>(out), g, n, heads, bias_windows, scale, p, passes);
  return vtt::launched("window_batched_kernel");
}

// Row 11 in bf16 at a head dim outside WINDOW_HEAD_DIMS: the padded tile
// of dh up to 64, else the chunks.
int launch_batched_other(const void* qkv, const void* bias, void* out, int g,
                         int n, int heads, int dh, int bw, float scale,
                         cudaStream_t st) {
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* b = static_cast<const __nv_bfloat16*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const long long gl = g;
  return vtt::mma::with_window_keys(n, [&](auto nk) {
    constexpr int NK = decltype(nk)::value;
    if (dh > 64) {
      const vtt::mma::WindowGeometry geo = vtt::mma::window_mma_geometry(n);
      const size_t smem =
          vtt::mma::window_chunk_elems<NK>(geo.wpb, bw == 1, bw > 1) *
          sizeof(__nv_bfloat16);
      auto kernel = window_batched_mma_chunked_kernel<NK>;
      int sms = 0, blocks = 0;
      const cudaError_t err = vtt::mma::run_occupancy(
          reinterpret_cast<const void*>(kernel), geo.threads, smem, &sms,
          &blocks);
      if (err != cudaSuccess) return static_cast<int>(err);
      const vtt::mma::RunPlan plan = vtt::mma::window_run_plan(
          gl, 0, geo.wpb, heads, static_cast<long long>(blocks) * sms);
      kernel<<<dim3(static_cast<unsigned>(plan.blocks), heads), geo.threads,
               smem, st>>>(q, b, o, gl, n, heads, dh, bw, scale, geo.mt,
                           geo.wpb, plan.run);
      return vtt::launched("window_batched_mma_chunked_kernel");
    }
    switch (vtt::mma::window_tile(dh)) {
#define VTT_PADDED(D)                                                        \
  case D:                                                                    \
    return vtt::mma::window_run_launch<D, NK>(                               \
        window_batched_mma_padded_kernel<D, NK>,                             \
        "window_batched_mma_padded_kernel", gl, 0, n, heads, bw, false, bias,  \
        st, q, b, o, gl, n, heads, bw, scale, dh);
      VTT_PADDED(16)
      VTT_PADDED(32)
      VTT_PADDED(64)
#undef VTT_PADDED
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

int launch_batched_chunked(const void* qkv, const void* bias, void* out, int g,
                           int n, int heads, int dh, int bias_windows,
                           float scale, int p, int threads, int passes,
                           cudaStream_t stream) {
  const int ld = n | 1;
  const size_t smem =
      static_cast<size_t>(p) * n * (vtt::kWinCols + ld) * sizeof(float);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      window_batched_chunked_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = p * passes;
  const dim3 grid((g + per_block - 1) / per_block, heads);
  window_batched_chunked_kernel<<<grid, threads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<float*>(out), g, n, heads, dh, bias_windows, scale, p,
      passes);
  return vtt::launched("window_batched_chunked_kernel");
}

bool args_ok(const void* bias, int g, int n, int heads, int bias_windows,
             int p, int threads) {
  return g >= 1 && heads >= 1 && heads <= 65535 &&
         vtt::window_launch_ok(n, p, threads) &&
         (bias == nullptr || bias_windows >= 1);
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of the launch. bias may be null (then
// bias_windows is ignored). is_bf16: 1 = bf16, 0 = fp32 (qkv, bias and out).
// Both forwards take the tensor cores in bf16 (window_packed_mma_kernel,
// window_batched_mma_kernel: their own launch shapes) and the CUDA cores in
// fp32 (window_packed_kernel, window_batched_kernel: the launch shape p,
// threads [, passes]) at dh 1, 2, 4, 8, 16, 32 and 64; the batched one at
// any other dh >= 1 too (window_batched_mma_padded_kernel,
// window_batched_mma_chunked_kernel; window_batched_chunked_kernel).

int window_packed_attention_fwd(const void* qkv, const void* bias, void* out,
                                int g, int n, int heads, int dh,
                                int bias_windows, float scale, int p,
                                int threads, int is_bf16, void* stream) {
  if (!args_ok(bias, g, n, heads, bias_windows, p, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VTT_PACKED(D)                                                     \
  (is_bf16 ? vtt::mma::with_window_keys(n, [&](auto nk) {                  \
               return launch_packed_mma<D, decltype(nk)::value>(             \
                   qkv, bias, out, g, n, heads, bias_windows, scale, st);    \
             })                                                              \
           : launch_packed<float, D>(qkv, bias, out, g, n, heads,            \
                                     bias_windows, scale, p, threads, st))
  switch (dh) {
    case 1: return VTT_PACKED(1);
    case 2: return VTT_PACKED(2);
    case 4: return VTT_PACKED(4);
    case 8: return VTT_PACKED(8);
    case 16: return VTT_PACKED(16);
    case 32: return VTT_PACKED(32);
    case 64: return VTT_PACKED(64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VTT_PACKED
}

int window_batched_attention_fwd(const void* qkv, const void* bias, void* out,
                                 int g, int n, int heads, int dh,
                                 int bias_windows, float scale, int p,
                                 int threads, int passes, int is_bf16,
                                 void* stream) {
  if (!args_ok(bias, g, n, heads, bias_windows, p, threads) || passes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bw = bias == nullptr ? 0 : bias_windows;
#define VTT_BATCHED(D)                                                      \
  (is_bf16 ? vtt::mma::with_window_keys(n, [&](auto nk) {                  \
               constexpr int NK = decltype(nk)::value;                       \
               return vtt::mma::window_run_launch<D, NK>(                    \
                   window_batched_mma_kernel<D, NK>,                         \
                   "window_batched_mma_kernel", g, 0, n, heads, bw, false,   \
                   bias, st, static_cast<const __nv_bfloat16*>(qkv),         \
                   static_cast<const __nv_bfloat16*>(bias),                  \
                   static_cast<__nv_bfloat16*>(out),                         \
                   static_cast<long long>(g), n, heads, bw, scale);          \
             })                                                              \
           : launch_batched<float, D>(qkv, bias, out, g, n, heads,            \
                                      bias_windows, scale, p, threads,        \
                                      passes, st))
  switch (dh) {
    case 1: return VTT_BATCHED(1);
    case 2: return VTT_BATCHED(2);
    case 4: return VTT_BATCHED(4);
    case 8: return VTT_BATCHED(8);
    case 16: return VTT_BATCHED(16);
    case 32: return VTT_BATCHED(32);
    case 64: return VTT_BATCHED(64);
    default: break;
  }
#undef VTT_BATCHED
  if (dh < 1) return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? launch_batched_other(qkv, bias, out, g, n, heads, dh, bw,
                                        scale, st)
                 : launch_batched_chunked(qkv, bias, out, g, n, heads, dh,
                                          bias_windows, scale, p, threads,
                                          passes, st);
}

const char* window_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
