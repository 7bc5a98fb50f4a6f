// Dropout masks for the attention kernels: Philox 4x32 with 10 rounds, the
// same function as ops/flash_attention.py::philox_4x32 (which the plain
// PyTorch versions use), so a kernel and its plain version drop the very
// same probabilities.
//
// The keep bit of probability (group g = batch·H + head, query row i, key
// column j) is word j % 4 of Philox(counter = (j / 4, i, g, 0), key = the
// 64-bit seed's low and high words), kept when the word, read unsigned, is
// >= thresh = min(int(rate·2^32), 2^32 − 1): the TPU kernels' rule
// (_dropout_keep). It depends on nothing else — not on a tile, a block or a
// launch shape — so a backward replays its forward's mask from the seed.
//
// dropout_keep computes the whole 4-word block for its own element and uses
// one word: three quarters of the generator's work is wasted. The fp32
// kernels and rows 1, 5 and 7 use it. dropout_keep4 returns all four keep
// bits of one block; the tensor-core backward (attention_bwd_mma_tile.cuh)
// shares them among the lanes that hold those four columns, one call per
// four probabilities. Both give the same bit for the same element.
#pragma once

#include <cstdint>

namespace vtt {

struct Dropout {
  uint32_t thresh;   // 0: dropout off, every probability kept
  float inv_keep;    // 1 / (1 − rate)
  uint32_t key0, key1;
};

__host__ __device__ inline Dropout make_dropout(uint32_t thresh,
                                                float inv_keep,
                                                unsigned long long seed) {
  Dropout d;
  d.thresh = thresh;
  d.inv_keep = inv_keep;
  d.key0 = static_cast<uint32_t>(seed & 0xFFFFFFFFull);
  d.key1 = static_cast<uint32_t>(seed >> 32);
  return d;
}

__device__ __forceinline__ uint4 philox_4x32_10(uint4 c, uint32_t k0,
                                                uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

__device__ __forceinline__ bool dropout_keep(const Dropout& d, uint32_t group,
                                             uint32_t row, uint32_t col) {
  const uint4 r = philox_4x32_10(make_uint4(col >> 2, row, group, 0u),
                                 d.key0, d.key1);
  const uint32_t lane = col & 3u;
  const uint32_t word = lane == 0 ? r.x : lane == 1 ? r.y : lane == 2 ? r.z : r.w;
  return word >= d.thresh;
}

// Keep bits of columns 4·quad .. 4·quad + 3 of one row: bit w is
// dropout_keep(d, group, row, 4·quad + w).
__device__ __forceinline__ uint32_t dropout_keep4(const Dropout& d,
                                                 uint32_t group, uint32_t row,
                                                 uint32_t quad) {
  const uint4 r = philox_4x32_10(make_uint4(quad, row, group, 0u), d.key0,
                                 d.key1);
  return (r.x >= d.thresh ? 1u : 0u) | (r.y >= d.thresh ? 2u : 0u) |
         (r.z >= d.thresh ? 4u : 0u) | (r.w >= d.thresh ? 8u : 0u);
}

}  // namespace vtt
