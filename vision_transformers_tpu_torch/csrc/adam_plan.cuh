// The multi-tensor Adam launch's table and its chunks (csrc/fused_adam.cu).
//
// One launch updates up to kMaxLeaves leaves. Its table, passed by value as
// the kernel's parameter, holds each leaf's p, m, v and g pointers, its
// element count and the prefix of its chunks: leaf l owns chunks
// [first_chunk[l], first_chunk[l + 1]) of the virtual concatenation, each
// of kChunk elements but a leaf's last, so a chunk never crosses a leaf. A
// block takes a chunk and finds its leaf by a binary search over the
// prefix.
//
// Host-only C++ but for the VTT_HD functions, so the CPU tests compile this
// header with the system's C++ compiler and walk every chunk of a plan
// (tests/test_torch_host_plans.py).
#pragma once

#ifdef __CUDACC__
#define VTT_HD __host__ __device__
#else
#define VTT_HD
#endif

namespace vtt {
namespace adam {

constexpr int kThreads = 256;  // a block
constexpr int kUnroll = 2;     // float4s of each stream a thread loads at once
constexpr int kChunk = kThreads * kUnroll * 4;  // elements: one pass a block
// Leaves of one launch: 44 bytes each, 14 KB of the 32 764 bytes of
// parameters sm_90 takes (CUDA 12.1 and later); ViT-B/16's 152 leaves and
// Swin-T's 176 fit one launch.
constexpr int kMaxLeaves = 320;

struct Table {
  float* p[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  const float* g[kMaxLeaves];
  long long n[kMaxLeaves];
  int first_chunk[kMaxLeaves + 1];  // first_chunk[count]: the launch's chunks
  bool aligned[kMaxLeaves];         // all four pointers on 16-byte boundaries
  int count;
};

// Fills `t` from leaves [first, first + count) of `leaves`, five int64 a
// leaf (p, m, v, g, n), as many as one table holds. Returns the count, or 0
// if leaf `first` has n < 1 or the chunks overflow an int.
inline int pack(const long long* leaves, int total, int first, Table* t) {
  int count = 0;
  long long chunks = 0;
  t->first_chunk[0] = 0;
  for (int l = first; l < total && count < kMaxLeaves; ++l, ++count) {
    const long long* leaf = leaves + 5LL * l;
    const long long n = leaf[4];
    const long long more = (n + kChunk - 1) / kChunk;
    if (n < 1 || chunks + more > 0x7fffffffLL) break;
    t->p[count] = reinterpret_cast<float*>(leaf[0]);
    t->m[count] = reinterpret_cast<float*>(leaf[1]);
    t->v[count] = reinterpret_cast<float*>(leaf[2]);
    t->g[count] = reinterpret_cast<const float*>(leaf[3]);
    t->n[count] = n;
    t->aligned[count] =
        ((leaf[0] | leaf[1] | leaf[2] | leaf[3]) & 15) == 0;
    chunks += more;
    t->first_chunk[count + 1] = static_cast<int>(chunks);
  }
  t->count = count;
  return count;
}

// Chunk c of a table: its leaf and elements [begin, end) of that leaf.
struct Chunk {
  int leaf;
  long long begin, end;
};

VTT_HD inline Chunk chunk_of(const Table& t, int c) {
  int lo = 0, hi = t.count - 1;  // the last leaf whose first chunk <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.first_chunk[mid] <= c) lo = mid;
    else hi = mid - 1;
  }
  const long long begin =
      static_cast<long long>(c - t.first_chunk[lo]) * kChunk;
  const long long end = begin + kChunk < t.n[lo] ? begin + kChunk : t.n[lo];
  return {lo, begin, end};
}

}  // namespace adam
}  // namespace vtt
