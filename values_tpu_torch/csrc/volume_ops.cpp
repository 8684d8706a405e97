// Native host-side volume ops for the input pipeline hot path.
//
// A copy of values_tpu/native/volume_ops.cpp. The reference delegates its
// loader hot path to batchgenerators' process pool (SURVEY.md §2.7); here
// the per-sample work (strided 3D crop, axis mirroring, additive Gaussian
// noise) is a small C++ library driven via ctypes from
// values_tpu_torch/data/native.py, which binds the mirror and the noise
// that augment=True uses, and the PNG reader's sequential unfilters
// (values_tpu_torch/core/image_io.py::read_png). The RNG is a dedicated xoshiro256++ stream per
// call: statistics match the numpy pipeline contract, not bitwise torch
// parity; the same flags as the JAX package's build give its bytes.
//
// Build (native.py does it at first use, into build/kernels/):
//   g++ -O3 -march=native -shared -fPIC volume_ops.cpp -o libvolume_ops.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>

namespace {

struct Xoshiro256 {
    uint64_t s[4];

    explicit Xoshiro256(uint64_t seed) {
        // splitmix64 seeding
        uint64_t x = seed;
        for (int i = 0; i < 4; ++i) {
            x += 0x9e3779b97f4a7c15ULL;
            uint64_t z = x;
            z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
            z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
            s[i] = z ^ (z >> 31);
        }
    }

    static inline uint64_t rotl(uint64_t v, int k) {
        return (v << k) | (v >> (64 - k));
    }

    inline uint64_t next() {
        uint64_t result = rotl(s[0] + s[3], 23) + s[0];
        uint64_t t = s[1] << 17;
        s[2] ^= s[0];
        s[3] ^= s[1];
        s[1] ^= s[2];
        s[0] ^= s[3];
        s[2] ^= t;
        s[3] = rotl(s[3], 45);
        return result;
    }

    inline double uniform() {  // [0, 1)
        return (next() >> 11) * 0x1.0p-53;
    }

    inline double normal() {  // Box-Muller (one of the pair)
        double u1 = uniform();
        double u2 = uniform();
        if (u1 < 1e-300) u1 = 1e-300;
        return std::sqrt(-2.0 * std::log(u1)) *
               std::cos(6.283185307179586 * u2);
    }
};

}  // namespace

extern "C" {

// Contiguous crop of a (d0, d1, d2) float32 volume: out[p^3].
void crop_f32(const float* src, int64_t d0, int64_t d1, int64_t d2,
              int64_t s0, int64_t s1, int64_t s2, int64_t p, float* out) {
    (void)d0;
    for (int64_t i = 0; i < p; ++i) {
        const float* plane = src + (s0 + i) * d1 * d2;
        for (int64_t j = 0; j < p; ++j) {
            const float* row = plane + (s1 + j) * d2 + s2;
            std::memcpy(out + (i * p + j) * p, row,
                        static_cast<size_t>(p) * sizeof(float));
        }
    }
}

// Same for int32 labels.
void crop_i32(const int32_t* src, int64_t d0, int64_t d1, int64_t d2,
              int64_t s0, int64_t s1, int64_t s2, int64_t p, int32_t* out) {
    (void)d0;
    for (int64_t i = 0; i < p; ++i) {
        const int32_t* plane = src + (s0 + i) * d1 * d2;
        for (int64_t j = 0; j < p; ++j) {
            const int32_t* row = plane + (s1 + j) * d2 + s2;
            std::memcpy(out + (i * p + j) * p, row,
                        static_cast<size_t>(p) * sizeof(int32_t));
        }
    }
}

// In-place axis mirroring of a p^3 cube; flips = bit0 axis0, bit1 axis1,
// bit2 axis2.
void mirror3d_f32(float* vol, int64_t p, int flips) {
    if (flips & 1) {
        for (int64_t i = 0; i < p / 2; ++i)
            for (int64_t j = 0; j < p; ++j)
                for (int64_t k = 0; k < p; ++k) {
                    float* a = vol + (i * p + j) * p + k;
                    float* b = vol + ((p - 1 - i) * p + j) * p + k;
                    float t = *a; *a = *b; *b = t;
                }
    }
    if (flips & 2) {
        for (int64_t i = 0; i < p; ++i)
            for (int64_t j = 0; j < p / 2; ++j)
                for (int64_t k = 0; k < p; ++k) {
                    float* a = vol + (i * p + j) * p + k;
                    float* b = vol + (i * p + (p - 1 - j)) * p + k;
                    float t = *a; *a = *b; *b = t;
                }
    }
    if (flips & 4) {
        for (int64_t i = 0; i < p; ++i)
            for (int64_t j = 0; j < p; ++j)
                for (int64_t k = 0; k < p / 2; ++k) {
                    float* a = vol + (i * p + j) * p + k;
                    float* b = vol + (i * p + j) * p + (p - 1 - k);
                    float t = *a; *a = *b; *b = t;
                }
    }
}

void mirror3d_i32(int32_t* vol, int64_t p, int flips) {
    mirror3d_f32(reinterpret_cast<float*>(vol), p, flips);  // same swaps
}

// Additive Gaussian noise, scale sigma, deterministic per seed.
void add_gaussian_noise_f32(float* data, int64_t n, float sigma,
                            uint64_t seed) {
    Xoshiro256 rng(seed);
    for (int64_t i = 0; i < n; ++i) {
        data[i] += sigma * static_cast<float>(rng.normal());
    }
}

// z-score normalization in place (two-pass, float64 accumulators).
void zscore_f32(float* data, int64_t n, double eps) {
    double sum = 0.0;
    for (int64_t i = 0; i < n; ++i) sum += data[i];
    double mean = sum / static_cast<double>(n);
    double var = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        double d = data[i] - mean;
        var += d * d;
    }
    double std = std::sqrt(var / static_cast<double>(n));
    float scale = static_cast<float>(1.0 / (std + eps));
    float m = static_cast<float>(mean);
    for (int64_t i = 0; i < n; ++i) data[i] = (data[i] - m) * scale;
}

// PNG unfiltering of one scanline in place (the PNG specification,
// section 9): type 3 Average, type 4 Paeth, both sequential along the row.
// cur holds n filtered bytes, prev the previous reconstructed row (zeros
// for the first row), bpp the bytes of one pixel (at least 1).
void png_unfilter_row(uint8_t* cur, const uint8_t* prev, int64_t n,
                      int64_t bpp, int type) {
    if (type == 3) {
        for (int64_t i = 0; i < n; ++i) {
            int a = i >= bpp ? cur[i - bpp] : 0;
            cur[i] = static_cast<uint8_t>(cur[i] + ((a + prev[i]) >> 1));
        }
        return;
    }
    for (int64_t i = 0; i < n; ++i) {
        int a = i >= bpp ? cur[i - bpp] : 0;
        int b = prev[i];
        int c = i >= bpp ? prev[i - bpp] : 0;
        int p = a + b - c;
        int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
        int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        cur[i] = static_cast<uint8_t>(cur[i] + pred);
    }
}

}  // extern "C"
