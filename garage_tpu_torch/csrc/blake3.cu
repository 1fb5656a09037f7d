// K2: batched BLAKE3-256 for Hopper (sm_90a).
//
// Replaces: garage_tpu/ops/hash_tpu.py, _build.<locals>.hash_batch (jax.numpy,
// the second half of every fused encode dispatch).  Same function: the
// official BLAKE3 digest (32 bytes, default mode) of each of n equal-length
// rows of L bytes, for L a multiple of 64 up to 1024 (one chunk) or a
// power-of-two count of 1024-byte chunks.  The wrapper (ops/hash_cuda.py)
// rejects every other length, exactly as the reference does.
//
// Rows are read where they lie: the rows are the concatenation, entry by
// entry of a batch of B, of q0 rows of a first source and q1 rows of a
// second, each source with its own batch and row strides (data shards and
// parity shards of an encode, without copying them into one buffer).
// Digest r = b * (q0 + q1) + j is that of row j of batch entry b.
//
// What bounds it on this card: integer operations.  One 64-byte compression
// is 7 rounds x 8 G functions of 4 XORs (LOP3), 4 rotates (SHF or PRMT) and
// 6 adds, + 8 output XORs.  The 456 XORs and rotates run only on the ALU
// pipe (64 lanes per SM); the adds may issue on the IMAD pipe (another 64
// lanes), so the floor is 456 ALU instructions per compression, ~7.1 per
// input byte, at 64 lanes x 132 SMs x the SM clock: longer than reading the
// bytes at 3.35 TB/s.  tools/int_pipes.py measures those rates on the card
// (one pipe ~63, ALU + IMAD side by side ~117 thread-instructions per SM
// per clock); this kernel's instruction stream issues ~62, about half the
// floor's rate, whatever the occupancy, code size or operand form
// (tools/k2_compare.py's variants and probes).
//
// What the design does about it:
//  - Every add is `mad.lo.u32 x, y, one, z` with `one` a kernel argument
//    (1 at run time), so ptxas cannot fold it into an IADD3 on the ALU pipe:
//    the adds go to the IMAD pipe and the ALU pipe carries only the 456.
//  - All state and message words stay in registers; the message schedule of
//    every round is spelled out with constant indices, so the permutation
//    costs no instructions, and rotates are single __funnelshift_r.
//  - Multi-chunk rows: the work is balanced over the SMs by chunks, not by
//    rows.  A warp hashes one aligned subtree of 32 x kPer chunks (lane i
//    chains chunks kPer*i ..), and reduces the lanes' chaining values with
//    warp shuffles, without barriers or shared memory.  A warp is one
//    thread block, so the SMs hold equal numbers of subtrees, +-1.
//  - Rows of more than one subtree: each warp writes its subtree's CV to a
//    scratch buffer (n x subtrees x 32 bytes, in L2; the wrapper allocates
//    it) and counts itself in an arrival counter per row (zeroed by
//    blake3_rows before the launch); the last warp of a row reduces the row's
//    subtree CVs and writes the ROOT, while the other warps on its SM still
//    chain chunks.  Rows of at most one subtree finish inside the warp:
//    several rows share a warp when they have fewer than 32 x kPer chunks.
//  - No CV stack: a lane's chunks are merged in registers, the rest of the
//    tree by shuffles, so no kernel has a stack frame.
//  - Rows of <= 1024 bytes: one thread per row, ROOT on its last block.
//  - Message words are 16-byte little-endian loads (the wrapper requires
//    16-byte aligned rows).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kChunkStart = 1u << 0;
constexpr uint32_t kChunkEnd = 1u << 1;
constexpr uint32_t kParent = 1u << 2;
constexpr uint32_t kRoot = 1u << 3;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSmallThreads = 128;
constexpr int kPer = 1;             // chunks chained by one lane (1 or 2)
constexpr int kSub = 32 * kPer;     // chunks in one warp's subtree
constexpr int kWarps = 1;           // warps (subtrees) per thread block
// warps an SM must hold at once (caps the registers a thread may use):
// the 704 x 128-chunk main shape is 21.3 subtrees per SM
constexpr int kMinWarps = 24;

__constant__ uint32_t kIV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                                0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};

// The rows: entry b of the batch holds rows (b, 0..q0-1) of source 0, then
// rows (b, q0..q0+q1-1) of source 1.  Strides are in bytes.
struct Rows {
  const uint8_t* x0;
  const uint8_t* x1;
  long long q0, q1, b0, r0, b1, r1;
  long long n;    // rows in all: B * (q0 + q1)
  long long len;  // bytes per row
};

__device__ __forceinline__ const uint8_t* row_ptr(const Rows& R, long long r) {
  const long long q = R.q0 + R.q1;
  const long long b = q == 1 ? r : r / q;
  const long long j = r - b * q;
  return j < R.q0 ? R.x0 + b * R.b0 + j * R.r0 : R.x1 + b * R.b1 + (j - R.q0) * R.r1;
}

__device__ __forceinline__ uint32_t rotr(uint32_t v, int n) {
  return __funnelshift_r(v, v, n);
}

// x + y on the IMAD pipe: `one` is 1 at run time, unknown to the compiler.
__device__ __forceinline__ uint32_t add(uint32_t x, uint32_t y, uint32_t one) {
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(y), "r"(one), "r"(x));
  return r;
}

#define G(a, b, c, d, mx, my)              \
  a = add(add(a, mx, one), b, one);        \
  d = rotr(d ^ a, 16);                     \
  c = add(c, d, one);                      \
  b = rotr(b ^ c, 12);                     \
  a = add(add(a, my, one), b, one);        \
  d = rotr(d ^ a, 8);                      \
  c = add(c, d, one);                      \
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
                                         unsigned long long counter, uint32_t flags,
                                         uint32_t one) {
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
                                       uint32_t flags, uint32_t out[8], uint32_t one) {
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = l[i];
    m[8 + i] = r[i];
  }
  set_iv(out);
  compress(out, m, 0ull, kParent | flags, one);
}

// CV of the 1024-byte chunk at p, chunk number `chunk` of its row: one
// compression per loop trip (a second message buffer with the next block
// in flight measured 7% slower: more registers, twice the code).
__device__ __forceinline__ void chunk_cv(const uint8_t* p, unsigned long long chunk,
                                         uint32_t one, uint32_t cv[8]) {
  uint32_t m[16];
  set_iv(cv);
#pragma unroll 1
  for (int b = 0; b < 16; ++b) {
    load_block(p + 64 * b, m);
    compress(cv, m, chunk, (b == 0 ? kChunkStart : 0u) | (b == 15 ? kChunkEnd : 0u), one);
  }
}

// `levels` PARENT levels over the lanes' CVs, by shuffles: after level l,
// lane i with i % 2^(l+1) == 0 holds the parent of its 2^(l+1) lanes.
// The last level carries ROOT when `root`.  Every lane computes every level
// (a warp-wide compression costs the same with one lane or 32).
__device__ __forceinline__ void warp_tree(uint32_t cv[8], int levels, bool root,
                                          uint32_t one) {
#pragma unroll 1
  for (int l = 0; l < levels; ++l) {
    uint32_t right[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) right[i] = __shfl_down_sync(kFull, cv[i], 1 << l);
    parent(cv, right, root && l == levels - 1 ? kRoot : 0u, cv, one);
  }
}

__device__ __forceinline__ int log2i(long long v) { return 63 - __clzll(v); }

// The last warp of a row: reduce its `ns` subtree CVs (scratch, in order)
// to the ROOT and write the digest.  ns is a power of two >= 2; groups of
// 32 are reduced in place until at most 32 remain.
__device__ void finish_row(uint32_t* __restrict__ s, long long ns, uint8_t* out,
                           uint32_t one) {
  const int lane = threadIdx.x & 31;
  uint32_t cv[8];
  for (; ns > 32; ns /= 32) {
    for (long long g = 0; g < ns / 32; ++g) {
      const uint4* src = reinterpret_cast<const uint4*>(s + (g * 32 + lane) * 8);
      const uint4 a = __ldcg(src), b = __ldcg(src + 1);
      cv[0] = a.x; cv[1] = a.y; cv[2] = a.z; cv[3] = a.w;
      cv[4] = b.x; cv[5] = b.y; cv[6] = b.z; cv[7] = b.w;
      warp_tree(cv, 5, false, one);
      // every lane has read group g before lane 0 overwrites entry g
      __syncwarp();
      if (lane == 0) {
        uint4* dst = reinterpret_cast<uint4*>(s + g * 8);
        __stcg(dst, make_uint4(cv[0], cv[1], cv[2], cv[3]));
        __stcg(dst + 1, make_uint4(cv[4], cv[5], cv[6], cv[7]));
      }
    }
    __syncwarp();
  }
  const uint4* src = reinterpret_cast<const uint4*>(s + (lane < ns ? lane : 0) * 8);
  const uint4 a = __ldcg(src), b = __ldcg(src + 1);
  cv[0] = a.x; cv[1] = a.y; cv[2] = a.z; cv[3] = a.w;
  cv[4] = b.x; cv[5] = b.y; cv[6] = b.z; cv[7] = b.w;
  warp_tree(cv, log2i(ns), true, one);
  if (lane == 0) store_digest(out, cv);
}

// Rows of one chunk (L <= 1024): one thread per row.
__global__ void __launch_bounds__(kSmallThreads)
blake3_small_kernel(Rows R, uint8_t* __restrict__ out, uint32_t one) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R.n) return;
  const uint8_t* p = row_ptr(R, row);
  const int nb = (int)(R.len / 64);
  uint32_t cv[8], m[16];
  set_iv(cv);
  for (int b = 0; b < nb; ++b) {
    load_block(p + 64 * b, m);
    uint32_t flags = (b == 0) ? kChunkStart : 0u;
    if (b == nb - 1) flags |= kChunkEnd | kRoot;
    compress(cv, m, 0ull, flags, one);
  }
  store_digest(out + row * 32, cv);
}

// Rows of a power-of-two count (>= 2) of whole chunks: one warp per work
// item.  A row of more than kSub chunks is ns = chunks / kSub items, one
// per aligned subtree; shorter rows share an item, lpr lanes per row.
__global__ void __launch_bounds__(32 * kWarps, kMinWarps / kWarps)
blake3_warp_kernel(Rows R, long long n_chunks, uint32_t* __restrict__ scratch,
                   unsigned int* __restrict__ arrivals, uint8_t* __restrict__ out,
                   uint32_t one) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long ns = n_chunks > kSub ? n_chunks / kSub : 1;  // subtrees per row
  const int lpr = n_chunks >= kSub ? 32 : (int)(n_chunks / kPer);  // lanes per row
  long long row, chunk0;
  if (ns > 1) {
    row = item / ns;
    chunk0 = (item - row * ns) * kSub + (long long)lane * kPer;
  } else {
    row = item * (32 / lpr) + lane / lpr;
    chunk0 = (long long)(lane % lpr) * kPer;
  }
  if (row >= R.n) {
    if (ns > 1 || item * (32 / lpr) >= R.n) return;  // the whole warp is past the end
    row = R.n - 1;  // a spare lane: it hashes a real row and stores nothing
  }
  const uint8_t* p = row_ptr(R, row) + chunk0 * 1024;

  uint32_t cv[8];
  chunk_cv(p, chunk0, one, cv);
  if (kPer == 2) {
    uint32_t right[8];
    chunk_cv(p + 1024, chunk0 + 1, one, right);
    parent(cv, right, lpr == 1 ? kRoot : 0u, cv, one);
  }
  warp_tree(cv, log2i(lpr), ns == 1, one);

  if (ns == 1) {
    const bool spare = (long long)item * (32 / lpr) + lane / lpr >= R.n;
    if (lane % lpr == 0 && !spare) store_digest(out + row * 32, cv);
    return;
  }
  // one subtree of a longer row: publish its CV, then the row's last warp
  // finishes the row
  unsigned int prior = 0;
  if (lane == 0) {
    uint4* dst = reinterpret_cast<uint4*>(scratch + item * 8);
    __stcg(dst, make_uint4(cv[0], cv[1], cv[2], cv[3]));
    __stcg(dst + 1, make_uint4(cv[4], cv[5], cv[6], cv[7]));
    __threadfence();
    prior = atomicAdd(arrivals + row, 1u);
  }
  prior = __shfl_sync(kFull, prior, 0);
  if (prior != ns - 1) return;
  __threadfence();
  finish_row(scratch + row * ns * 8, ns, out + row * 32, one);
}

}  // namespace

// 32-bit words of scratch that rows of `len` bytes need per row: the
// row's subtree CVs (8 words each) and its arrival counter (the kernel
// zeroes the counters itself); 0 when such rows need no scratch.
extern "C" int blake3_scratch_words(long long len) {
  const long long n_chunks = len / 1024;
  return len > 1024 && n_chunks > kSub ? (int)(n_chunks / kSub * 8 + 1) : 0;
}

// Digests of the rows of two sources (see Rows; q1 = 0 for one source):
// out[b * (q0 + q1) + j] for b < batch.  Row strides and bases must be
// 16-byte aligned; the wrapper checks.  `scratch` holds n x
// blake3_scratch_words(len) words (unused when that is 0).
extern "C" int blake3_rows(int device, const void* x0, long long q0, long long b0,
                           long long r0, const void* x1, long long q1, long long b1,
                           long long r1, long long batch, long long len, void* scratch,
                           void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Rows R{(const uint8_t*)x0, (const uint8_t*)x1, q0, q1, b0, r0, b1, r1,
               batch * (q0 + q1), len};
  if (R.n <= 0) return (int)cudaGetLastError();
  if (len <= 0 || len % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t one = 1u;
  long long blocks;
  if (len <= 1024) {
    blocks = (R.n + kSmallThreads - 1) / kSmallThreads;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    blake3_small_kernel<<<(unsigned)blocks, kSmallThreads, 0, st>>>(R, (uint8_t*)out, one);
  } else {
    const long long n_chunks = len / 1024;
    if (len % 1024 != 0 || (n_chunks & (n_chunks - 1)) != 0 || n_chunks < kPer)
      return (int)cudaErrorInvalidValue;
    const long long ns = n_chunks > kSub ? n_chunks / kSub : 1;
    uint32_t* cvs = (uint32_t*)scratch;
    unsigned int* arrivals = nullptr;
    if (ns > 1) {
      if (scratch == nullptr) return (int)cudaErrorInvalidValue;
      arrivals = (unsigned int*)(cvs + R.n * ns * 8);
      err = cudaMemsetAsync(arrivals, 0, (size_t)R.n * sizeof(unsigned int), st);
      if (err != cudaSuccess) return (int)err;
    }
    const long long rows_per_item = n_chunks >= kSub ? 1 : kSub / n_chunks;
    const long long items = ns > 1 ? R.n * ns : (R.n + rows_per_item - 1) / rows_per_item;
    blocks = (items + kWarps - 1) / kWarps;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    blake3_warp_kernel<<<(unsigned)blocks, 32 * kWarps, 0, st>>>(
        R, n_chunks, cvs, arrivals, (uint8_t*)out, one);
  }
  return (int)cudaGetLastError();
}
