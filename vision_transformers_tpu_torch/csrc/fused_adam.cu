// One Adam(W) step over all the fp32 parameter leaves of a step, in place,
// in one launch (more only past one launch's table of leaves).
//
// Replaces the TPU kernel vision_transformers_tpu/ops/fused_adam.py::
// _adam_kernel (:36, reached through _fused_leaf :63 from fused_adam_update
// :114). Per element, with the seven scalars the host computes once per step
// (c1 = 1/(1 − b1ᵗ), c2 = 1/(1 − b2ᵗ), neg_lr = −lr):
//   m' = b1·m + (1 − b1)·g          v' = b2·v + (1 − b2)·g²
//   p' = p + neg_lr·((m'·c1) / (√(v'·c2) + eps) + wd·p)
// written over p, m and v.
//
// What bounds it on the H100: four streams read and three written, 28 bytes
// and a dozen operations per element, so bytes by two orders of magnitude
// (a 2.36 M-element leaf, ViT-B/16's fc1: 66 MB, 19.7 µs at 3.35 TB/s;
// Swin-T's 28 M parameters 0.24 ms). And the host: the TPU kernel runs one
// launch per large leaf, which on this card costs a ctypes call and a launch
// per leaf, more than the step's bytes take. So:
//   - one launch takes every leaf (adam_plan.cuh's table, passed by value as
//     a __grid_constant__ parameter: no copy of it per thread). A block walks
//     chunks of kChunk elements of the virtual concatenation of the leaves,
//     grid-stride, and finds a chunk's leaf by a binary search over the
//     table's chunk prefix; a chunk never crosses a leaf;
//   - the grid is one full wave (the occupancy API's blocks an SM times the
//     SMs, asked once per device), or the chunks if fewer;
//   - each thread issues its loads of kUnroll float4s of each of the four
//     streams before any arithmetic (128 bytes in flight a thread). Plain
//     loads and stores: with the streaming hints (__ldcs / __stcs) the step
//     over Swin-T's and ViT-B/16's leaves took 1-2% longer on an H100, and
//     a leaf that L2 still held from the step before 37% longer
//     (adam_times.py); 4 float4s a stream took 110 registers and gained
//     nothing;
//   - a leaf whose four pointers are not all 16-byte aligned, and the last
//     n mod 4 elements of a leaf, take the scalar path in the same kernel.
// Each operation is rounded on its own (no fused multiply-add), in the order
// written above, so the plain version beside the wrapper computes the same
// bits.
#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>

#include "adam_plan.cuh"
#include "launch_log.cuh"

namespace {

using vtt::adam::kChunk;
using vtt::adam::kThreads;
using vtt::adam::kUnroll;

struct AdamScalars {
  float b1, b2, c1, c2, neg_lr, wd, eps;
};

__device__ __forceinline__ void adam_element(float& p, float& m, float& v,
                                             float g, const AdamScalars& s) {
  const float one_b1 = __fsub_rn(1.f, s.b1);
  const float one_b2 = __fsub_rn(1.f, s.b2);
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(one_b1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(one_b2, __fmul_rn(g, g)));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.c2)), s.eps);
  const float upd = __fadd_rn(__fdiv_rn(__fmul_rn(m, s.c1), denom),
                              __fmul_rn(s.wd, p));
  p = __fadd_rn(p, __fmul_rn(s.neg_lr, upd));
}

__device__ __forceinline__ void adam_vec(float4& p, float4& m, float4& v,
                                         const float4& g,
                                         const AdamScalars& s) {
  adam_element(p.x, m.x, v.x, g.x, s);
  adam_element(p.y, m.y, v.y, g.y, s);
  adam_element(p.z, m.z, v.z, g.z, s);
  adam_element(p.w, m.w, v.w, g.w, s);
}

__global__ void __launch_bounds__(kThreads)
adam_multi_kernel(const __grid_constant__ vtt::adam::Table t,
                  const AdamScalars s) {
  const int chunks = t.first_chunk[t.count];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const vtt::adam::Chunk ch = vtt::adam::chunk_of(t, c);
    float* __restrict__ p = t.p[ch.leaf];
    float* __restrict__ m = t.m[ch.leaf];
    float* __restrict__ v = t.v[ch.leaf];
    const float* __restrict__ g = t.g[ch.leaf];
    if (!t.aligned[ch.leaf]) {
      for (long long e = ch.begin + threadIdx.x; e < ch.end; e += kThreads)
        adam_element(p[e], m[e], v[e], g[e], s);
      continue;
    }
    // kChunk is a multiple of 4: the chunk's vectors are [begin/4, end/4)
    const long long v1 = ch.end / 4;
    float4 pp[kUnroll], mm[kUnroll], vv[kUnroll], gg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = ch.begin / 4 + threadIdx.x + u * kThreads;
      if (i < v1) {
        pp[u] = reinterpret_cast<const float4*>(p)[i];
        mm[u] = reinterpret_cast<const float4*>(m)[i];
        vv[u] = reinterpret_cast<const float4*>(v)[i];
        gg[u] = reinterpret_cast<const float4*>(g)[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = ch.begin / 4 + threadIdx.x + u * kThreads;
      if (i < v1) {
        adam_vec(pp[u], mm[u], vv[u], gg[u], s);
        reinterpret_cast<float4*>(p)[i] = pp[u];
        reinterpret_cast<float4*>(m)[i] = mm[u];
        reinterpret_cast<float4*>(v)[i] = vv[u];
      }
    }
    const long long e = 4 * v1 + threadIdx.x;  // the leaf's last n mod 4
    if (e < ch.end) adam_element(p[e], m[e], v[e], g[e], s);
  }
}

// One full wave of adam_multi_kernel on the current device: its blocks an
// SM (the occupancy API) times the SMs, asked once per device.
cudaError_t wave_blocks(int* blocks) {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static int seen[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (seen[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, adam_multi_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    seen[dev] = sms * per_sm;
  }
  *blocks = seen[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// `leaves`: five int64 a leaf, (p, m, v, g, n): p, m, v (updated in place)
// and g, n contiguous floats each, n >= 1. One launch of adam_multi_kernel
// per vtt::adam::kMaxLeaves leaves, in order, on `stream`. Returns 0 or the
// cudaError_t of the first launch that failed.
int adam_multi(const long long* leaves, int total, float b1, float b2,
               float c1, float c2, float neg_lr, float wd, float eps,
               void* stream) {
  if (leaves == nullptr || total < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int wave = 0;
  const cudaError_t err = wave_blocks(&wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  const AdamScalars s{b1, b2, c1, c2, neg_lr, wd, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static thread_local vtt::adam::Table t;  // 14 KB: kept off the stack
  for (int first = 0; first < total;) {
    const int count = vtt::adam::pack(leaves, total, first, &t);
    if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = std::min(wave, t.first_chunk[count]);
    adam_multi_kernel<<<blocks, kThreads, 0, st>>>(t, s);
    const int rc = vtt::launched("adam_multi_kernel");
    if (rc != 0) return rc;
    first += count;
  }
  return 0;
}

const char* fused_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
