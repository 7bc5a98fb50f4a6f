// Fused CIFAR-style augmentation: random-crop(pad) + horizontal-flip +
// brightness jitter in ONE pass over the pixels.
//
// The port's own copy of vision_transformers_tpu/native/augment.cpp (the
// port imports nothing of the JAX package and builds this file itself). The
// reference does this as three separate PIL/tensor transforms per sample in
// DataLoader worker processes (utils/load_data.py:52,62); the numpy
// fallback in utils/load_data.py does three vectorized passes with
// intermediate allocations. Fusing them keeps the host input pipeline off
// the train step's critical path.
//
// Exposed as a plain C ABI for ctypes.
//
// in:   (n, h, w, c) uint8 source batch
// out:  (n, h, w, c) uint8 destination
// ys/xs: per-image crop offsets in the zero-padded (h+2p, w+2p) frame
// flips: per-image 0/1 horizontal flip
// factors: per-image brightness multipliers
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

void fused_augment(const uint8_t* in, uint8_t* out,
                   int64_t n, int64_t h, int64_t w, int64_t c,
                   int64_t pad,
                   const int32_t* ys, const int32_t* xs,
                   const uint8_t* flips, const float* factors) {
    const int64_t img_sz = h * w * c;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* src = in + i * img_sz;
        uint8_t* dst = out + i * img_sz;
        const int64_t oy = (int64_t)ys[i] - pad;  // crop origin in source coords
        const int64_t ox = (int64_t)xs[i] - pad;
        const bool flip = flips[i] != 0;
        const float f = factors[i];

        // precomputed brightness LUT: 256 entries per image
        uint8_t lut[256];
        for (int v = 0; v < 256; ++v) {
            float x = (float)v * f;
            lut[v] = (uint8_t)(x < 0.f ? 0.f : (x > 255.f ? 255.f : x + 0.0f));
        }

        for (int64_t y = 0; y < h; ++y) {
            const int64_t sy = y + oy;
            uint8_t* drow = dst + y * w * c;
            if (sy < 0 || sy >= h) {              // padded row -> zeros*f = 0
                std::memset(drow, 0, (size_t)(w * c));
                continue;
            }
            const uint8_t* srow = src + sy * w * c;
            for (int64_t x = 0; x < w; ++x) {
                const int64_t sx = (flip ? (w - 1 - x) : x) + ox;
                uint8_t* dpix = drow + x * c;
                if (sx < 0 || sx >= w) {
                    std::memset(dpix, 0, (size_t)c);
                } else {
                    const uint8_t* spix = srow + sx * c;
                    for (int64_t k = 0; k < c; ++k) dpix[k] = lut[spix[k]];
                }
            }
        }
    }
}

}  // extern "C"
