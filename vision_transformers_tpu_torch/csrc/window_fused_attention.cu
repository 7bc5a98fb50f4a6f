// Shifted-window attention straight off the NHWC projection map: cyclic
// shift, window partition, attention, window reverse and un-shift in one
// pass. Two kernels, the slab and the flat one.
//
// Replace the TPU kernels vision_transformers_tpu/ops/flash_attention.py::
// _window_fused_kernel (:2056; the slab branch of _window_fused_fwd_pallas,
// :2235) and _window_fused_flat_kernel (:1997; its flat branch, :2209), both
// reached through fused_window_attention (:2354).
//
// qkv: (B, Hp, Wp, 3·sec), padded to window multiples but NOT rolled; q of
// head h at column h·D, k at sec + h·D, v at 2·sec + h·D, where sec >= H·D is
// the section stride (the TPU pads it to 128 lanes; here it is an argument
// and the port passes sec = H·D). bias: null or (nW', H, N, N) in the compute
// dtype, nW' = 1 or nr·nw (window R·nw + c of every image reads row
// R·nw + c). out: (B, Hp, Wp, sec) in the un-rolled coordinates.
//
// The result equals roll(−s) → partition → attention → reverse → roll(+s).
// Token (r, j) of window (R, c) of the rolled map is pixel
//   y = (R·wh + r + sh) mod Hp,  x = (c·ww + j + sw) mod Wp
// of the map as it lies in memory, and its output belongs at the same
// pixel: so both kernels only compute addresses, and no rolled, partitioned
// or reversed tensor exists. Every pixel belongs to exactly one window, so
// every element of out[..., :H·D] is written exactly once.
//
// What bounds them on the H100 (Swin-T @224, batch 32, bf16; shifted stage 1,
// 56×56, H = 3, D = 32): 77 MB of map read and written, 23 µs at 3.35 TB/s,
// against 1.9 GFLOP, 1.9 µs at 989 TFLOP/s: bytes, as for the kernels of
// window_attention.cu, and more so for the chain they replace, which moves
// the map five times. window_tile.cuh holds the CUDA-core body (one thread
// per query row, K/V in shared memory, fp32 FMAs), window_mma_tile.cuh the
// tensor-core one.
//
// window_fused_slab_kernel (fp32, window_tile.cuh): grid x = B·nr (image,
// window row), y = H. A block owns the wh rolled rows of its window row (the
// last window row wraps to the top of the image) and walks the nw windows of
// the row in passes of P.
//
// window_fused_slab_mma_kernel (bf16), the slab kernel on the tensor cores
// (window_mma_tile.cuh's window_run_mma, as row 12's): a block belongs to
// one head and to one window row of one image, which the TPU grid (B/bb,
// nr) gives a program, and walks a run of that row's windows, each window's
// q, k, v and own bias row double-buffered. No block crosses a window row
// (window_run_plan.cuh's row_block): where one wave of blocks needs it, a
// row is split into runs of a divisor of its steps. The slab's rolled-row
// arithmetic (SlabRows, two 32-bit modulos a token) fills the
// window's row table; the per-window bias (nW' = nr·nw at a shifted block)
// is copied whole by 16-byte cp.async with the window's q, k and v.
//
// window_fused_flat_kernel (fp32, window_tile.cuh): grid x = ceil(B·nr·nw /
// P), y = H, over the flat (B·Hp·Wp, 3·sec) view. A block takes P
// consecutive windows of the flat window order, wherever they lie (they may
// span window rows and images), and finds each token's flat row with the
// strip arithmetic of the TPU kernel (:2014-2028): a window's row r is a run
// of ww flat rows that splits in two where the column range wraps. Any map
// width; a ragged last block is bounds-checked.
//
// window_fused_flat_mma_kernel (bf16), the flat kernel on the tensor cores
// (window_mma_tile.cuh's window_run_mma): a block belongs to one head and
// walks a run of consecutive windows of the flat order, each window's q, k
// and v double-buffered so the copies of the next overlap the products of
// the current one. The strip arithmetic runs once a token, into a row table
// of the window in shared memory that the copies and the output store then
// read; the bias row (window g mod nW', nW' = nr·nw or 1) is staged per
// window, or once per block where nW' = 1.
//
// Both tensor-core kernels take their launch shape from N, the window
// count, H and the card (window_run_launch); the C entries' p and threads,
// the CUDA-core plan, are only checked.
#include "window_mma_tile.cuh"
#include "window_tile.cuh"

namespace {

using vtt::kWinMaxThreads;

struct MapGeom {
  int hp, wp, wh, ww, sh, sw, nr, nw;
};

// Flat view: window g = (b·nr + R)·nw + c, token i = r·ww + j → flat row.
struct FlatRows {
  static constexpr bool kTable = true;  // window_run_mma tabulates them
  MapGeom m;
  __device__ __forceinline__ long long operator()(long long g, int i) const {
    const int per_image = m.nr * m.nw;
    const long long b = g / per_image;
    const int w = static_cast<int>(g % per_image);
    const int R = w / m.nw, c = w % m.nw;
    const int r = i / m.ww, j = i % m.ww;
    const int gr = (R * m.wh + r + m.sh) % m.hp;  // rolled row → image row
    int x = c * m.ww + m.sw + j;                  // strip start + j ...
    if (x >= m.wp) x -= m.wp;                     // ... in its wrapped piece
    return (b * m.hp + gr) * m.wp + x;
  }
};

// One window row of one image: window c of the row, token i → flat row.
struct SlabRows {
  MapGeom m;
  long long image_row0;  // b·Hp
  int row0;              // R·wh + sh: the slab's first rolled row
  __device__ __forceinline__ long long operator()(long long c, int i) const {
    const int r = i / m.ww, j = i % m.ww;
    const int y = (row0 + r) % m.hp;
    const int x = (static_cast<int>(c) * m.ww + j + m.sw) % m.wp;
    return (image_row0 + y) * m.wp + x;
  }
};

// The windows of one window row for window_run_mma: window g of the flat
// order (the row's first is `first`), token i → flat row, by SlabRows.
struct SlabWindows {
  static constexpr bool kTable = true;  // window_run_mma tabulates them
  SlabRows rows;
  long long first;
  __device__ __forceinline__ long long operator()(long long g, int i) const {
    return rows(g - first, i);
  }
};

template <typename T>
__device__ __forceinline__ const T* bias_row(const T* bias, long long window,
                                             int bias_windows, int heads,
                                             int h, int n, int i) {
  if (bias == nullptr) return nullptr;
  return bias + (((window % bias_windows) * heads + h) * n + i) * n;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWinMaxThreads)
window_fused_slab_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                         T* __restrict__ out, MapGeom m, int heads,
                         long long sec, int bias_windows, float scale, int p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = m.wh * m.ww;
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + p * n * D;

  const int h = blockIdx.y;
  const long long b = blockIdx.x / m.nr;
  const int R = blockIdx.x % m.nr;
  const SlabRows map{m, b * m.hp, R * m.wh + m.sh};

  const int w = threadIdx.x / n, i = threadIdx.x % n;
  for (int c0 = 0; c0 < m.nw; c0 += p) {
    const int count = min(p, m.nw - c0);
    __syncthreads();  // the previous pass has read ks/vs
    vtt::stage_kv<T, D>(qkv, map, c0, count, n, h * D, sec, 3 * sec, ks, vs);
    __syncthreads();
    if (w >= count) continue;
    const long long row = map(c0 + w, i);
    vtt::attend_row<T, D, T>(
        qkv + row * 3 * sec + h * D, ks + w * n * D, vs + w * n * D,
        bias_row(bias, static_cast<long long>(R) * m.nw + c0 + w,
                 bias_windows, heads, h, n, i),
        n, scale, out + row * sec + h * D);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWinMaxThreads)
window_fused_flat_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                         T* __restrict__ out, MapGeom m, long long g,
                         int heads, long long sec, int bias_windows,
                         float scale, int p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = m.wh * m.ww;
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + p * n * D;

  const int h = blockIdx.y;
  const long long w0 = static_cast<long long>(blockIdx.x) * p;
  const int count = static_cast<int>(min(static_cast<long long>(p), g - w0));
  const FlatRows map{m};

  vtt::stage_kv<T, D>(qkv, map, w0, count, n, h * D, sec, 3 * sec, ks, vs);
  __syncthreads();

  const int w = threadIdx.x / n, i = threadIdx.x % n;
  if (w >= count) return;
  const long long row = map(w0 + w, i);
  // nW' is 1 or the windows of one image, so g mod nW' is the window's
  // index inside its image
  vtt::attend_row<T, D, T>(
      qkv + row * 3 * sec + h * D, ks + w * n * D, vs + w * n * D,
      bias_row(bias, w0 + w, bias_windows, heads, h, n, i), n, scale,
      out + row * sec + h * D);
}

// D: the head dim, in the tile of width window_tile(D) (16 for D 1-8).
template <int D, int NK>
__global__ void __launch_bounds__(vtt::mma::kWinMmaMaxThreads)
window_fused_flat_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const __nv_bfloat16* __restrict__ bias,
                             __nv_bfloat16* __restrict__ out, MapGeom m,
                             long long g, int heads, long long sec,
                             int bias_windows, float scale, int mt, int wpb,
                             int run) {
  // nW' is 1 or the windows of one image, so g mod nW' is the window's
  // index inside its image
  vtt::mma::window_run_mma<vtt::mma::window_tile(D), NK, D>(
      FlatRows{m}, qkv, bias, out,
      static_cast<long long>(blockIdx.x) * wpb * run, g, m.wh * m.ww, heads,
      sec, bias_windows, scale, mt, wpb, run);
}

template <int D, int NK>
__global__ void __launch_bounds__(vtt::mma::kWinMmaMaxThreads)
window_fused_slab_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const __nv_bfloat16* __restrict__ bias,
                             __nv_bfloat16* __restrict__ out, MapGeom m,
                             int heads, long long sec, int bias_windows,
                             float scale, int mt, int wpb, int run) {
  // the block's window row b·nr + R of the batch, and its run of the row;
  // the window's index inside its image, g mod nW', is R·nw + c
  const vtt::mma::RowBlock rb =
      vtt::mma::row_block(blockIdx.x, m.nw, wpb, run);
  const int b = rb.row / m.nr, R = rb.row % m.nr;
  const SlabWindows wins{
      SlabRows{m, static_cast<long long>(b) * m.hp, R * m.wh + m.sh},
      rb.end - m.nw};
  vtt::mma::window_run_mma<vtt::mma::window_tile(D), NK, D>(
      wins, qkv, bias, out, rb.first, rb.end, m.wh * m.ww, heads, sec,
      bias_windows, scale, mt, wpb, run);
}

template <typename T, int D>
int launch_slab(const void* qkv, const void* bias, void* out, int b,
                MapGeom m, int heads, int sec, int bias_windows, float scale,
                int p, int threads, cudaStream_t stream) {
  const size_t smem = vtt::window_kv_bytes(p, m.wh * m.ww, D);
  auto kernel = window_fused_slab_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * m.nr, heads);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(bias),
      static_cast<T*>(out), m, heads, sec, bias_windows, scale, p);
  return vtt::launched("window_fused_slab_kernel");
}

template <typename T, int D>
int launch_flat(const void* qkv, const void* bias, void* out, int b,
                MapGeom m, int heads, int sec, int bias_windows, float scale,
                int p, int threads, cudaStream_t stream) {
  const size_t smem = vtt::window_kv_bytes(p, m.wh * m.ww, D);
  const long long g = static_cast<long long>(b) * m.nr * m.nw;
  auto kernel = window_fused_flat_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((g + p - 1) / p), heads);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(bias),
      static_cast<T*>(out), m, g, heads, sec, bias_windows, scale, p);
  return vtt::launched("window_fused_flat_kernel");
}

// The geometry of the C entries' arguments, or false.
bool map_ok(int b, int hp, int wp, int wh, int ww, int sh, int sw,
            int heads, int dh, int sec) {
  return b >= 1 && wh >= 1 && ww >= 1 && hp >= wh && wp >= ww &&
         hp % wh == 0 && wp % ww == 0 && sh >= 0 && sh < hp && sw >= 0 &&
         sw < wp && heads >= 1 && heads <= 65535 && sec >= heads * dh;
}

int dispatch(bool slab, const void* qkv, const void* bias, void* out, int b,
             int hp, int wp, int wh, int ww, int sh, int sw, int heads, int dh,
             int sec, int bias_windows, float scale, int p, int threads,
             int is_bf16, void* stream) {
  if (!map_ok(b, hp, wp, wh, ww, sh, sw, heads, dh, sec) ||
      !vtt::window_launch_ok(wh * ww, p, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  const MapGeom m{hp, wp, wh, ww, sh, sw, hp / wh, wp / ww};
  if (bias != nullptr && bias_windows != 1 && bias_windows != m.nr * m.nw)
    return static_cast<int>(cudaErrorInvalidValue);
  if (slab && p > m.nw) p = m.nw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bw = bias == nullptr ? 0 : bias_windows;
  const long long g = static_cast<long long>(b) * m.nr * m.nw;
#define VTT_FUSED(D)                                                        \
  (!is_bf16 ? (slab ? launch_slab<float, D>(qkv, bias, out, b, m, heads,    \
                                            sec, bias_windows, scale, p,    \
                                            threads, st)                    \
                    : launch_flat<float, D>(qkv, bias, out, b, m, heads,    \
                                            sec, bias_windows, scale, p,    \
                                            threads, st))                   \
   : vtt::mma::with_window_keys(wh * ww, [&](auto nk) {                    \
       constexpr int NK = decltype(nk)::value;                              \
       const auto* q = static_cast<const __nv_bfloat16*>(qkv);              \
       const auto* bs = static_cast<const __nv_bfloat16*>(bias);            \
       auto* o = static_cast<__nv_bfloat16*>(out);                          \
       const long long sc = sec;                                            \
       return slab ? vtt::mma::window_run_launch<D, NK>(                    \
                         window_fused_slab_mma_kernel<D, NK>,               \
                         "window_fused_slab_mma_kernel", g, m.nw, wh * ww,  \
                         heads, bw, true, bias, st, q, bs, o, m, heads, sc, \
                         bw, scale)                                         \
                   : vtt::mma::window_run_launch<D, NK>(                    \
                         window_fused_flat_mma_kernel<D, NK>,               \
                         "window_fused_flat_mma_kernel", g, 0, wh * ww,     \
                         heads, bw, true, bias, st, q, bs, o, m, g, heads,  \
                         sc, bw, scale);                                    \
     }))
  switch (dh) {
    case 1: return VTT_FUSED(1);
    case 2: return VTT_FUSED(2);
    case 4: return VTT_FUSED(4);
    case 8: return VTT_FUSED(8);
    case 16: return VTT_FUSED(16);
    case 32: return VTT_FUSED(32);
    case 64: return VTT_FUSED(64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VTT_FUSED
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of the launch. bias may be null (then
// bias_windows is ignored). is_bf16: 1 = bf16, 0 = fp32 (qkv, bias and out).
// bf16 takes the tensor cores (window_fused_slab_mma_kernel,
// window_fused_flat_mma_kernel, each its own launch shape), fp32 the CUDA
// cores (the launch shape p, threads).

int window_fused_slab_attention_fwd(const void* qkv, const void* bias,
                                    void* out, int b, int hp, int wp, int wh,
                                    int ww, int sh, int sw, int heads, int dh,
                                    int sec, int bias_windows, float scale,
                                    int p, int threads, int is_bf16,
                                    void* stream) {
  return dispatch(true, qkv, bias, out, b, hp, wp, wh, ww, sh, sw, heads, dh,
                  sec, bias_windows, scale, p, threads, is_bf16, stream);
}

int window_fused_flat_attention_fwd(const void* qkv, const void* bias,
                                    void* out, int b, int hp, int wp, int wh,
                                    int ww, int sh, int sw, int heads, int dh,
                                    int sec, int bias_windows, float scale,
                                    int p, int threads, int is_bf16,
                                    void* stream) {
  return dispatch(false, qkv, bias, out, b, hp, wp, wh, ww, sh, sw, heads, dh,
                  sec, bias_windows, scale, p, threads, is_bf16, stream);
}

const char* window_fused_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
