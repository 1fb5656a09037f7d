// GF(2^8) Reed-Solomon data path — the host-side (CPU) codec core.
//
// The CUDA kernel (ops/ec_cuda.py) is the batched card path; this native
// implementation serves a codec that runs on the host (a CPU codec, or
// `[block] batch_impl = "host"`; block/codec/ec.py).  Same field as
// ops/gf.py: polynomial x^8+x^4+x^3+x^2+1 (0x11d), Cauchy matrices.
//
// Exported C ABI (ctypes):
//   gf8_mul_table()                      -> const uint8_t* (256*256)
//   gf8_apply(mat, r, q, shards, out, s) out[i] = sum_j mat[i,j]*shards[j]
//
// Fast path: split-nibble multiplication (y = LO[c][x & 15] ^ HI[c][x>>4])
// — 16-entry tables fit a pshufb/vpshufb register, so SSSE3/AVX2 multiply
// 16/32 bytes per instruction (the ISA-L technique).  Wide shards also
// split across threads.  Scalar 256-byte-LUT fallback for other ISAs.

#include <cstdint>
#include <cstddef>
#include <cstring>
#include "parallel.h"

#if defined(__SSSE3__)
#include <immintrin.h>
#endif

namespace {

struct Tables {
    uint8_t mul[256][256];
    // split-nibble tables: mul[c][x] == lo[c][x & 15] ^ hi[c][x >> 4]
    // (GF multiply is linear over the XOR decomposition x = lo ^ (hi<<4))
    alignas(32) uint8_t lo[256][16];
    alignas(32) uint8_t hi[256][16];
    Tables() {
        uint8_t exp_[512];
        int log_[256] = {0};
        int x = 1;
        for (int i = 0; i < 255; i++) {
            exp_[i] = (uint8_t)x;
            log_[x] = i;
            x <<= 1;
            if (x & 0x100) x ^= 0x11d;
        }
        for (int i = 255; i < 510; i++) exp_[i] = exp_[i - 255];
        for (int a = 0; a < 256; a++) {
            for (int b = 0; b < 256; b++) {
                mul[a][b] = (a && b) ? exp_[log_[a] + log_[b]] : 0;
            }
            for (int n = 0; n < 16; n++) {
                lo[a][n] = mul[a][n];
                hi[a][n] = mul[a][n << 4];
            }
        }
    }
};

const Tables& tables() {
    static Tables t;
    return t;
}

// multiply-accumulate one coefficient over the byte range [b0, b1)
void mac_range(const Tables& t, uint8_t c, const uint8_t* src, uint8_t* dst,
               size_t b0, size_t b1) {
    if (c == 1) {
        size_t b = b0;
#if defined(__AVX2__)
        for (; b + 32 <= b1; b += 32) {
            __m256i d = _mm256_loadu_si256((const __m256i*)(dst + b));
            __m256i x = _mm256_loadu_si256((const __m256i*)(src + b));
            _mm256_storeu_si256((__m256i*)(dst + b), _mm256_xor_si256(d, x));
        }
#endif
        for (; b < b1; b++) dst[b] ^= src[b];
        return;
    }
    size_t b = b0;
#if defined(__AVX2__)
    const __m256i vlo = _mm256_broadcastsi128_si256(
        _mm_load_si128((const __m128i*)t.lo[c]));
    const __m256i vhi = _mm256_broadcastsi128_si256(
        _mm_load_si128((const __m128i*)t.hi[c]));
    const __m256i mask = _mm256_set1_epi8(0x0f);
    for (; b + 32 <= b1; b += 32) {
        __m256i x = _mm256_loadu_si256((const __m256i*)(src + b));
        __m256i l = _mm256_shuffle_epi8(vlo, _mm256_and_si256(x, mask));
        __m256i h = _mm256_shuffle_epi8(
            vhi, _mm256_and_si256(_mm256_srli_epi64(x, 4), mask));
        __m256i d = _mm256_loadu_si256((const __m256i*)(dst + b));
        _mm256_storeu_si256(
            (__m256i*)(dst + b),
            _mm256_xor_si256(d, _mm256_xor_si256(l, h)));
    }
#elif defined(__SSSE3__)
    const __m128i vlo = _mm_load_si128((const __m128i*)t.lo[c]);
    const __m128i vhi = _mm_load_si128((const __m128i*)t.hi[c]);
    const __m128i mask = _mm_set1_epi8(0x0f);
    for (; b + 16 <= b1; b += 16) {
        __m128i x = _mm_loadu_si128((const __m128i*)(src + b));
        __m128i l = _mm_shuffle_epi8(vlo, _mm_and_si128(x, mask));
        __m128i h = _mm_shuffle_epi8(
            vhi, _mm_and_si128(_mm_srli_epi64(x, 4), mask));
        __m128i d = _mm_loadu_si128((const __m128i*)(dst + b));
        _mm_storeu_si128((__m128i*)(dst + b),
                         _mm_xor_si128(d, _mm_xor_si128(l, h)));
    }
#endif
    const uint8_t* row = t.mul[c];
    for (; b < b1; b++) dst[b] ^= row[src[b]];
}

void apply_range(const Tables& t, const uint8_t* mat, int r, int q,
                 const uint8_t* shards, uint8_t* out, size_t s,
                 size_t b0, size_t b1) {
    // L1 cache blocking: with full rows, every MAC streams the whole
    // dst row through L1 (r*q row-sized passes of L2 traffic per
    // apply).  Processing a column chunk at a time keeps the q src
    // chunks + dst chunk L1-resident across the i,j loops: the q=8,
    // r=3, 128 KiB-shard encode drops from ~9 MB to ~2 MB of L2
    // traffic per 1 MiB block (measured 3.8 -> 6.5 GB/s single-core;
    // BLK swept 1-16 KiB, 4 KiB best).
    constexpr size_t BLK = 4096;
    for (size_t c0 = b0; c0 < b1; c0 += BLK) {
        size_t c1 = c0 + BLK < b1 ? c0 + BLK : b1;
        for (int i = 0; i < r; i++) {
            uint8_t* dst = out + (size_t)i * s;
            memset(dst + c0, 0, c1 - c0);
            for (int j = 0; j < q; j++) {
                uint8_t c = mat[(size_t)i * q + j];
                if (c == 0) continue;
                mac_range(t, c, shards + (size_t)j * s, dst, c0, c1);
            }
        }
    }
}

}  // namespace

extern "C" {

const uint8_t* gf8_mul_table() { return &tables().mul[0][0]; }

// out (r x s) = mat (r x q) * shards (q x s) over GF(2^8)
void gf8_apply(const uint8_t* mat, int r, int q,
               const uint8_t* shards, uint8_t* out, size_t s) {
    const Tables& t = tables();
    // wide shards split by column range across threads (each range is an
    // independent slice of every row); per-column work scales with r*q,
    // so the serial threshold does too
    garage_native::parallel_ranges(
        s, (size_t)r * (size_t)q, (size_t)1 << 19,
        [&](size_t b0, size_t b1) {
            apply_range(t, mat, r, q, shards, out, s, b0, b1);
        });
}

}  // extern "C"
