// The design of K2 that csrc/blake3.cu replaced (one thread block per row,
// a CV stack per thread, the PARENT levels between barriers), kept
// unchanged as the yardstick that tools/k2_compare.py and chip_smoke.py
// time the kernel against in the same run.  Not on any path of the port.
//
// K2: batched BLAKE3-256 for Hopper (sm_90a).
//
// Replaces: garage_tpu/ops/hash_tpu.py, _build.<locals>.hash_batch (jax.numpy,
// the second half of every fused encode dispatch).  Same function: the
// official BLAKE3 digest (32 bytes, default mode) of each of n equal-length
// rows of L bytes, for L a multiple of 64 up to 1024 (one chunk) or a
// power-of-two count of 1024-byte chunks.  The wrapper (ops/hash_cuda.py)
// rejects every other length, exactly as the reference does.
//
// What bounds it on this card: integer operations.  One 64-byte compression
// is 7 rounds x 8 G functions x 12 instructions (4 adds, a 3-input add being
// one IADD3; 4 XORs, each one LOP3; 4 rotates, each one SHF or PRMT) + 8
// output XORs = 680 int32 instructions.  The 456 XORs and rotates run only
// on the ALU pipe (64 lanes per SM); the 224 adds may also issue on the IMAD
// pipe (IMAD.IADD, another 64 lanes), so the floor is 456 ALU instructions
// per compression, ~7.1 per input byte, at 64 lanes x 132 SMs x the SM
// clock: longer than reading the bytes at 3.35 TB/s.
//
// What the design does about it:
//  - All state and message words stay in registers; the message schedule of
//    every round is spelled out with constant indices, so the permutation
//    costs no instructions, and rotates are single __funnelshift_r.
//  - Multi-chunk rows (the main path: 128 KiB shards = 128 chunks): one
//    thread block per row, one thread per chunk (threads loop over aligned
//    power-of-two groups of chunks when a row has more chunks than threads,
//    merging each group's complete subtree with a small CV stack).  Each
//    thread chains its chunk's 16 compressions (counter = chunk index,
//    CHUNK_START / CHUNK_END), puts the chunk CV in shared memory, and the
//    block reduces the CVs with log2 PARENT levels separated by barriers;
//    ROOT goes on the last compression.
//  - Rows of <= 1024 bytes: one thread per row, ROOT on its last block.
//  - Message words are 16-byte little-endian loads (row offsets are
//    multiples of 64; the wrapper requires a 16-byte aligned base).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kChunkStart = 1u << 0;
constexpr uint32_t kChunkEnd = 1u << 1;
constexpr uint32_t kParent = 1u << 2;
constexpr uint32_t kRoot = 1u << 3;
constexpr int kMaxThreads = 256;  // chunk threads per row
constexpr int kSmallThreads = 128;

__constant__ uint32_t kIV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                                0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};

__device__ __forceinline__ uint32_t rotr(uint32_t v, int n) {
  return __funnelshift_r(v, v, n);
}

#define G(a, b, c, d, mx, my)   \
  a = a + b + (mx);             \
  d = rotr(d ^ a, 16);          \
  c = c + d;                    \
  b = rotr(b ^ c, 12);          \
  a = a + b + (my);             \
  d = rotr(d ^ a, 8);           \
  c = c + d;                    \
  b = rotr(b ^ c, 7);

#define ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  G(v0, v4, v8, v12, m[s0], m[s1]);                                                  \
  G(v1, v5, v9, v13, m[s2], m[s3]);                                                  \
  G(v2, v6, v10, v14, m[s4], m[s5]);                                                 \
  G(v3, v7, v11, v15, m[s6], m[s7]);                                                 \
  G(v0, v5, v10, v15, m[s8], m[s9]);                                                 \
  G(v1, v6, v11, v12, m[s10], m[s11]);                                               \
  G(v2, v7, v8, v13, m[s12], m[s13]);                                                \
  G(v3, v4, v9, v14, m[s14], m[s15]);

// First 8 words of the compression output (the chaining value, or the
// digest when ROOT is set): cv is read, then overwritten.
__device__ __forceinline__ void compress(uint32_t cv[8], const uint32_t m[16],
                                         unsigned long long counter, uint32_t flags) {
  uint32_t v0 = cv[0], v1 = cv[1], v2 = cv[2], v3 = cv[3];
  uint32_t v4 = cv[4], v5 = cv[5], v6 = cv[6], v7 = cv[7];
  uint32_t v8 = kIV[0], v9 = kIV[1], v10 = kIV[2], v11 = kIV[3];
  uint32_t v12 = (uint32_t)counter, v13 = (uint32_t)(counter >> 32);
  uint32_t v14 = 64u, v15 = flags;  // every block is a full 64 bytes
  ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  ROUND(2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
  ROUND(3, 4, 10, 12, 13, 2, 7, 14, 6, 5, 9, 0, 11, 15, 8, 1)
  ROUND(10, 7, 12, 9, 14, 3, 13, 15, 4, 0, 11, 2, 5, 8, 1, 6)
  ROUND(12, 13, 9, 11, 15, 10, 14, 8, 7, 2, 5, 3, 0, 1, 6, 4)
  ROUND(9, 14, 11, 5, 8, 12, 15, 1, 13, 3, 0, 10, 2, 6, 4, 7)
  ROUND(11, 15, 5, 0, 1, 9, 8, 6, 14, 10, 2, 12, 3, 4, 7, 13)
  cv[0] = v0 ^ v8;
  cv[1] = v1 ^ v9;
  cv[2] = v2 ^ v10;
  cv[3] = v3 ^ v11;
  cv[4] = v4 ^ v12;
  cv[5] = v5 ^ v13;
  cv[6] = v6 ^ v14;
  cv[7] = v7 ^ v15;
}

__device__ __forceinline__ void load_block(const uint8_t* p, uint32_t m[16]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 w = __ldg(q + i);
    m[4 * i] = w.x;
    m[4 * i + 1] = w.y;
    m[4 * i + 2] = w.z;
    m[4 * i + 3] = w.w;
  }
}

__device__ __forceinline__ void set_iv(uint32_t cv[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = kIV[i];
}

__device__ __forceinline__ void store_digest(uint8_t* out, const uint32_t cv[8]) {
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(cv[0], cv[1], cv[2], cv[3]);
  o[1] = make_uint4(cv[4], cv[5], cv[6], cv[7]);
}

// PARENT compression of two child CVs (left || right) into out.
__device__ __forceinline__ void parent(const uint32_t l[8], const uint32_t r[8],
                                       uint32_t flags, uint32_t out[8]) {
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = l[i];
    m[8 + i] = r[i];
  }
  set_iv(out);
  compress(out, m, 0ull, kParent | flags);
}

// Rows of one chunk (L <= 1024): one thread per row.
__global__ void __launch_bounds__(kSmallThreads)
blake3_small_kernel(const uint8_t* __restrict__ x, long long L, long long n,
                    uint8_t* __restrict__ out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint8_t* p = x + row * L;
  const int nb = (int)(L / 64);
  uint32_t cv[8], m[16];
  set_iv(cv);
  for (int b = 0; b < nb; ++b) {
    load_block(p + 64 * b, m);
    uint32_t flags = (b == 0) ? kChunkStart : 0u;
    if (b == nb - 1) flags |= kChunkEnd | kRoot;
    compress(cv, m, 0ull, flags);
  }
  store_digest(out + row * 32, cv);
}

// Rows of a power-of-two count (>= 2) of whole chunks: one block per row.
__global__ void __launch_bounds__(kMaxThreads)
blake3_multi_kernel(const uint8_t* __restrict__ x, long long L, long long n_chunks,
                    uint8_t* __restrict__ out) {
  __shared__ uint32_t scv[kMaxThreads * 8];
  const int T = blockDim.x;                 // power of two, 2 <= T <= n_chunks
  const int tid = threadIdx.x;
  const long long per = n_chunks / T;       // chunks per thread, power of two
  const uint8_t* row = x + (long long)blockIdx.x * L;

  // Chain each chunk, merging this thread's aligned group of `per` chunks
  // (a complete subtree, never the root since T >= 2) with a CV stack.
  uint32_t stack[32][8];
  int depth = 0;
  uint32_t cv[8], m[16];
  for (long long c = 0; c < per; ++c) {
    const long long chunk = (long long)tid * per + c;
    const uint8_t* p = row + chunk * 1024;
    set_iv(cv);
    for (int b = 0; b < 16; ++b) {
      load_block(p + 64 * b, m);
      const uint32_t flags = (b == 0 ? kChunkStart : 0u) | (b == 15 ? kChunkEnd : 0u);
      compress(cv, m, (unsigned long long)chunk, flags);
    }
    for (long long done = c + 1; (done & 1) == 0; done >>= 1) {
      --depth;
      parent(stack[depth], cv, 0u, cv);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) stack[depth][i] = cv[i];
    ++depth;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) scv[tid * 8 + i] = stack[0][i];
  __syncthreads();

  for (int width = T >> 1; width >= 1; width >>= 1) {
    uint32_t o[8];
    const bool active = tid < width;
    if (active) parent(&scv[16 * tid], &scv[16 * tid + 8], width == 1 ? kRoot : 0u, o);
    __syncthreads();
    if (active) {
#pragma unroll
      for (int i = 0; i < 8; ++i) scv[8 * tid + i] = o[i];
    }
    __syncthreads();
  }
  if (tid == 0) store_digest(out + (long long)blockIdx.x * 32, scv);
}

}  // namespace

extern "C" int blake3_rows(int device, const void* x, long long L, long long n,
                           void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  if (L <= 0 || L % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (L <= 1024) {
    const long long blocks = (n + kSmallThreads - 1) / kSmallThreads;
    blake3_small_kernel<<<(unsigned)blocks, kSmallThreads, 0, st>>>(
        (const uint8_t*)x, L, n, (uint8_t*)out);
  } else {
    const long long n_chunks = L / 1024;
    if (L % 1024 != 0 || (n_chunks & (n_chunks - 1)) != 0) return (int)cudaErrorInvalidValue;
    const int threads = (int)(n_chunks < kMaxThreads ? n_chunks : kMaxThreads);
    for (long long r0 = 0; r0 < n; r0 += 0x7FFFFFFFLL) {
      const long long nr = (n - r0 < 0x7FFFFFFFLL) ? n - r0 : 0x7FFFFFFFLL;
      blake3_multi_kernel<<<(unsigned)nr, threads, 0, st>>>(
          (const uint8_t*)x + r0 * L, L, n_chunks, (uint8_t*)out + r0 * 32);
    }
  }
  return (int)cudaGetLastError();
}
