// One Adam(W) step over one fp32 parameter leaf in a single pass, in place.
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
// (a 2.36 M-element leaf, ViT-B/16's fc1: 66 MB, 19.7 µs at 3.35 TB/s). The
// design is what a streaming pass needs and nothing else: a grid-stride loop
// over 16-byte vectors, every address touched once, a scalar tail for the
// last n mod 4 elements (and a scalar kernel for a leaf that is not 16-byte
// aligned). Each operation is rounded on its own (no fused multiply-add), in
// the order written above, so the plain version beside the wrapper computes
// the same bits.
#include <cuda_runtime.h>
#include "launch_log.cuh"

namespace {

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

__global__ void __launch_bounds__(256)
adam_vec_kernel(float* __restrict__ p, float* __restrict__ m,
                float* __restrict__ v, const float* __restrict__ g,
                long long n, AdamScalars s) {
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long long i = tid; i < n4; i += stride) {
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    const float4 gg = g4[i];
    adam_element(pp.x, mm.x, vv.x, gg.x, s);
    adam_element(pp.y, mm.y, vv.y, gg.y, s);
    adam_element(pp.z, mm.z, vv.z, gg.z, s);
    adam_element(pp.w, mm.w, vv.w, gg.w, s);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
  const long long i = 4 * n4 + tid;  // the ragged tail, at most 3 elements
  if (i < n) adam_element(p[i], m[i], v[i], g[i], s);
}

__global__ void __launch_bounds__(256)
adam_scalar_kernel(float* __restrict__ p, float* __restrict__ m,
                   float* __restrict__ v, const float* __restrict__ g,
                   long long n, AdamScalars s) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    adam_element(p[i], m[i], v[i], g[i], s);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// p, m, v (updated in place) and g: n contiguous floats each. `blocks` is the
// grid size (the wrapper passes a few blocks per SM). Returns 0 or the
// cudaError_t of the launch.
int fused_adam(void* p, void* m, void* v, const void* g, long long n,
               float b1, float b2, float c1, float c2, float neg_lr, float wd,
               float eps, int blocks, void* stream) {
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const AdamScalars s{b1, b2, c1, c2, neg_lr, wd, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* gf = static_cast<const float*>(g);
  if (aligned16(p) && aligned16(m) && aligned16(v) && aligned16(g)) {
    adam_vec_kernel<<<blocks, 256, 0, st>>>(pf, mf, vf, gf, n, s);
    return vtt::launched("adam_vec_kernel");
  }
  adam_scalar_kernel<<<blocks, 256, 0, st>>>(pf, mf, vf, gf, n, s);
  return vtt::launched("adam_scalar_kernel");
}

const char* fused_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
