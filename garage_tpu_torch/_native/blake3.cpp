// Portable BLAKE3 (default hash mode) — host-side shard-integrity hashing.
//
// Written from the BLAKE3 specification (same construction as the Python
// oracle in ops/blake3_ref.py, which is validated against the official
// test vectors; the native/python pair are cross-checked in tests).
//
// Exported C ABI (ctypes):
//   blake3_hash(in, len, out32)
//   blake3_batch(in, n, each_len, out)   n inputs of each_len bytes

#include <cstdint>
#include <cstddef>
#include <cstring>
#include "parallel.h"

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr uint32_t IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};
constexpr int MSG_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};

constexpr uint32_t CHUNK_START = 1 << 0;
constexpr uint32_t CHUNK_END = 1 << 1;
constexpr uint32_t PARENT = 1 << 2;
constexpr uint32_t ROOT = 1 << 3;

constexpr size_t BLOCK_LEN = 64;
constexpr size_t CHUNK_LEN = 1024;

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

inline void g(uint32_t* st, int a, int b, int c, int d, uint32_t mx, uint32_t my) {
    st[a] = st[a] + st[b] + mx;
    st[d] = rotr(st[d] ^ st[a], 16);
    st[c] = st[c] + st[d];
    st[b] = rotr(st[b] ^ st[c], 12);
    st[a] = st[a] + st[b] + my;
    st[d] = rotr(st[d] ^ st[a], 8);
    st[c] = st[c] + st[d];
    st[b] = rotr(st[b] ^ st[c], 7);
}

void compress(const uint32_t cv[8], const uint32_t block[16], uint64_t counter,
              uint32_t block_len, uint32_t flags, uint32_t out[16]) {
    uint32_t st[16] = {
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        (uint32_t)counter, (uint32_t)(counter >> 32), block_len, flags,
    };
    uint32_t m[16];
    memcpy(m, block, sizeof(m));
    for (int r = 0; r < 7; r++) {
        g(st, 0, 4, 8, 12, m[0], m[1]);
        g(st, 1, 5, 9, 13, m[2], m[3]);
        g(st, 2, 6, 10, 14, m[4], m[5]);
        g(st, 3, 7, 11, 15, m[6], m[7]);
        g(st, 0, 5, 10, 15, m[8], m[9]);
        g(st, 1, 6, 11, 12, m[10], m[11]);
        g(st, 2, 7, 8, 13, m[12], m[13]);
        g(st, 3, 4, 9, 14, m[14], m[15]);
        if (r < 6) {
            uint32_t p[16];
            for (int i = 0; i < 16; i++) p[i] = m[MSG_PERM[i]];
            memcpy(m, p, sizeof(m));
        }
    }
    for (int i = 0; i < 8; i++) {
        out[i] = st[i] ^ st[i + 8];
        out[i + 8] = st[i + 8] ^ cv[i];
    }
}

void load_block(const uint8_t* p, size_t len, uint32_t out[16]) {
    uint8_t buf[BLOCK_LEN] = {0};
    memcpy(buf, p, len);
    for (int i = 0; i < 16; i++) {
        out[i] = (uint32_t)buf[4 * i] | ((uint32_t)buf[4 * i + 1] << 8) |
                 ((uint32_t)buf[4 * i + 2] << 16) | ((uint32_t)buf[4 * i + 3] << 24);
    }
}

// chunk -> (cv, last_block, last_len, base_flags); ROOT added by caller
struct ChunkOut {
    uint32_t cv[8];
    uint32_t last_block[16];
    uint32_t last_len;
    uint32_t flags;
};

ChunkOut chunk_state(const uint8_t* p, size_t len, uint64_t counter) {
    ChunkOut out;
    memcpy(out.cv, IV, sizeof(IV));
    size_t n_blocks = len == 0 ? 1 : (len + BLOCK_LEN - 1) / BLOCK_LEN;
    for (size_t i = 0; i + 1 < n_blocks; i++) {
        uint32_t block[16], res[16];
        load_block(p + i * BLOCK_LEN, BLOCK_LEN, block);
        uint32_t flags = (i == 0) ? CHUNK_START : 0;
        compress(out.cv, block, counter, BLOCK_LEN, flags, res);
        memcpy(out.cv, res, sizeof(out.cv));
    }
    size_t last_off = (n_blocks - 1) * BLOCK_LEN;
    out.last_len = (uint32_t)(len - last_off);
    load_block(p + last_off, out.last_len, out.last_block);
    out.flags = ((n_blocks == 1) ? CHUNK_START : 0) | CHUNK_END;
    return out;
}

#if defined(__AVX2__)
// --- 8-way chunk hashing: one AVX2 lane per chunk ---------------------------
// Chunks are independent until the parent fold, and every FULL chunk runs
// the identical 16-block schedule — so 8 of them execute in lockstep with
// the 32-bit state held as one __m256i per state word.

inline __m256i rotr_v(__m256i x, int n) {
    return _mm256_or_si256(_mm256_srli_epi32(x, n), _mm256_slli_epi32(x, 32 - n));
}

inline void g_v(__m256i* st, int a, int b, int c, int d, __m256i mx, __m256i my) {
    st[a] = _mm256_add_epi32(_mm256_add_epi32(st[a], st[b]), mx);
    st[d] = rotr_v(_mm256_xor_si256(st[d], st[a]), 16);
    st[c] = _mm256_add_epi32(st[c], st[d]);
    st[b] = rotr_v(_mm256_xor_si256(st[b], st[c]), 12);
    st[a] = _mm256_add_epi32(_mm256_add_epi32(st[a], st[b]), my);
    st[d] = rotr_v(_mm256_xor_si256(st[d], st[a]), 8);
    st[c] = _mm256_add_epi32(st[c], st[d]);
    st[b] = rotr_v(_mm256_xor_si256(st[b], st[c]), 7);
}

// hash 8 consecutive FULL chunks at p (stride CHUNK_LEN), chunk counters
// counter0..counter0+7; writes 8 CVs chunk-major into out_cvs (8*8 words)
void chunks8(const uint8_t* p, uint64_t counter0, uint32_t* out_cvs) {
    const __m256i byte_off = _mm256_setr_epi32(
        0, 1 * CHUNK_LEN, 2 * CHUNK_LEN, 3 * CHUNK_LEN,
        4 * CHUNK_LEN, 5 * CHUNK_LEN, 6 * CHUNK_LEN, 7 * CHUNK_LEN);
    __m256i cv[8];
    for (int w = 0; w < 8; w++) cv[w] = _mm256_set1_epi32((int)IV[w]);
    alignas(32) uint32_t clo[8], chi[8];
    for (int l = 0; l < 8; l++) {
        uint64_t c = counter0 + (uint64_t)l;
        clo[l] = (uint32_t)c;
        chi[l] = (uint32_t)(c >> 32);
    }
    const __m256i vclo = _mm256_load_si256((const __m256i*)clo);
    const __m256i vchi = _mm256_load_si256((const __m256i*)chi);
    const int blocks_per_chunk = (int)(CHUNK_LEN / BLOCK_LEN);
    for (int b = 0; b < blocks_per_chunk; b++) {
        __m256i m[16];
        const uint8_t* base = p + (size_t)b * BLOCK_LEN;
        for (int w = 0; w < 16; w++) {
            m[w] = _mm256_i32gather_epi32(
                (const int*)(base + 4 * w), byte_off, 1);
        }
        uint32_t flags = (b == 0 ? CHUNK_START : 0) |
                         (b == blocks_per_chunk - 1 ? CHUNK_END : 0);
        __m256i st[16];
        for (int w = 0; w < 8; w++) st[w] = cv[w];
        for (int w = 0; w < 4; w++) st[8 + w] = _mm256_set1_epi32((int)IV[w]);
        st[12] = vclo;
        st[13] = vchi;
        st[14] = _mm256_set1_epi32((int)BLOCK_LEN);
        st[15] = _mm256_set1_epi32((int)flags);
        for (int r = 0; r < 7; r++) {
            g_v(st, 0, 4, 8, 12, m[0], m[1]);
            g_v(st, 1, 5, 9, 13, m[2], m[3]);
            g_v(st, 2, 6, 10, 14, m[4], m[5]);
            g_v(st, 3, 7, 11, 15, m[6], m[7]);
            g_v(st, 0, 5, 10, 15, m[8], m[9]);
            g_v(st, 1, 6, 11, 12, m[10], m[11]);
            g_v(st, 2, 7, 8, 13, m[12], m[13]);
            g_v(st, 3, 4, 9, 14, m[14], m[15]);
            if (r < 6) {
                __m256i pmt[16];
                for (int i = 0; i < 16; i++) pmt[i] = m[MSG_PERM[i]];
                memcpy(m, pmt, sizeof(m));
            }
        }
        for (int w = 0; w < 8; w++)
            cv[w] = _mm256_xor_si256(st[w], st[w + 8]);
    }
    // transpose lanes out: out_cvs[l*8 + w] = lane l of cv[w]
    alignas(32) uint32_t tmp[8][8];
    for (int w = 0; w < 8; w++)
        _mm256_store_si256((__m256i*)tmp[w], cv[w]);
    for (int l = 0; l < 8; l++)
        for (int w = 0; w < 8; w++)
            out_cvs[l * 8 + w] = tmp[w][l];
}
#endif  // __AVX2__

void merge_tree(const uint32_t* cvs, size_t n, uint32_t out_pair[16]);

// reduce a group of chunk CVs to a single CV (non-root parent)
void reduce_group(const uint32_t* cvs, size_t n, uint32_t out_cv[8]) {
    if (n == 1) {
        memcpy(out_cv, cvs, 8 * sizeof(uint32_t));
        return;
    }
    uint32_t pair[16], res[16];
    merge_tree(cvs, n, pair);
    compress(IV, pair, 0, BLOCK_LEN, PARENT, res);
    memcpy(out_cv, res, 8 * sizeof(uint32_t));
}

// produce the final parent block (left_cv || right_cv) for n >= 2 CVs
void merge_tree(const uint32_t* cvs, size_t n, uint32_t out_pair[16]) {
    if (n == 2) {
        memcpy(out_pair, cvs, 16 * sizeof(uint32_t));
        return;
    }
    // left subtree = largest power of two < n
    size_t split = 1;
    while (split * 2 < n) split *= 2;
    reduce_group(cvs, split, out_pair);
    reduce_group(cvs + split * 8, n - split, out_pair + 8);
}

}  // namespace

extern "C" {

void blake3_hash(const uint8_t* in, size_t len, uint8_t out[32]) {
    size_t n_chunks = len == 0 ? 1 : (len + CHUNK_LEN - 1) / CHUNK_LEN;
    uint32_t root[16];
    if (n_chunks == 1) {
        ChunkOut c = chunk_state(in, len, 0);
        compress(c.cv, c.last_block, 0, c.last_len, c.flags | ROOT, root);
    } else {
        uint32_t* cvs = new uint32_t[n_chunks * 8];
        size_t i = 0;
#if defined(__AVX2__)
        // full chunks run 8 at a time, one AVX2 lane each
        size_t n_full = len / CHUNK_LEN;
        for (; i + 8 <= n_full; i += 8)
            chunks8(in + i * CHUNK_LEN, (uint64_t)i, cvs + i * 8);
#endif
        for (; i < n_chunks; i++) {
            size_t off = i * CHUNK_LEN;
            size_t clen = (off + CHUNK_LEN <= len) ? CHUNK_LEN : len - off;
            ChunkOut c = chunk_state(in + off, clen, (uint64_t)i);
            uint32_t res[16];
            compress(c.cv, c.last_block, (uint64_t)i, c.last_len, c.flags, res);
            memcpy(cvs + i * 8, res, 8 * sizeof(uint32_t));
        }
        uint32_t pair[16];
        merge_tree(cvs, n_chunks, pair);
        compress(IV, pair, 0, BLOCK_LEN, PARENT | ROOT, root);
        delete[] cvs;
    }
    for (int i = 0; i < 8; i++) {
        out[4 * i] = (uint8_t)root[i];
        out[4 * i + 1] = (uint8_t)(root[i] >> 8);
        out[4 * i + 2] = (uint8_t)(root[i] >> 16);
        out[4 * i + 3] = (uint8_t)(root[i] >> 24);
    }
}

void blake3_batch(const uint8_t* in, size_t n, size_t each_len, uint8_t* out) {
    // items are independent: split the batch across threads when there is
    // enough work to amortize spawn cost (~scrub batches are MBs)
    garage_native::parallel_ranges(
        n, each_len, (size_t)1 << 18,
        [=](size_t i0, size_t i1) {
            for (size_t i = i0; i < i1; i++)
                blake3_hash(in + i * each_len, each_len, out + i * 32);
        });
}

}  // extern "C"
