// K1: GF(2^8) coding kernel for Hopper (sm_90a).
//
// Replaces: garage_tpu/ops/ec_tpu.py, gf_bitmatmul_pallas (the repo's one
// pl.pallas_call).  Same function: out(B, r, S) = M (x) x(B, q, S) where M is
// an (8r, 8q) 0/1 matrix acting on bit-unpacked bytes, LSB first, i.e.
//   out_bit[b, 8i+t, s] = sum_{j,a} M[8i+t, 8j+a] * bit_a(x[b, j, s])  mod 2.
// For an expansion of a GF(2^8) matrix (gf.bitmatrix_of) that is GF coding
// over poly 0x11d; the kernel computes it for ANY 0/1 matrix, and the matrix
// is a device argument, so one build serves encode and every repair pattern.
//
// What bounds it on this card.  The floor is bytes: (B*q*S + B*r*S) over the
// HBM rate (3.35 TB/s).  The first form of this kernel kept one 256-entry
// byte table per (output row i, input row j) and did r*q byte lookups per
// column; at EC(8,3) that is 24 lookups per column, each an LDS.U8 plus
// about four ALU instructions.  Instruction issue and shared-memory
// wavefronts bounded it, not bytes: a 256-byte table spans 64 words over 32
// banks, so random bytes made most warp-wide LDS.U8 two-way conflicts, and
// every input row was re-read through L1 once per output row.
//
// What the nibble tables do about it:
//  - Each 8x8 block M_ij is linear over GF(2), so M_ij(v) =
//    M_ij(v & 0xF) ^ M_ij(v & 0xF0), for any 0/1 matrix.  Each thread block
//    builds, per input row j and nibble half h, a 16-entry table T[j][h][n]
//    whose entry is a word of W bytes: byte i - g*W is M_ij(n << 4h), for
//    the W output rows of group g.  W = 4 (uint32) when r <= 4, else W = 8
//    (uint2) and output rows go in groups of 8, one group per block.  The
//    tables take q*2*16*W bytes (1 KiB for EC(8,3), 2 KiB for EC(16,4)):
//    the entries n = 1, 2, 4, 8 are the columns of M_ij, read from `bitmat`,
//    and every other entry is the XOR of the columns of its set bits.
//  - Lookups are conflict-free.  For W = 4, T[j][0] lies in banks 0-15 and
//    T[j][1] in banks 16-31, one word per bank, so a warp's 32 lookups take
//    one wavefront (equal words broadcast); for W = 8 one table covers all
//    32 banks once.
//  - Per input byte: two lookups and one three-input XOR (LOP3) into that
//    column's packed accumulator, whatever r is (r*q lookups per column
//    before, 2*q now).  The offsets are made in place: one shift and one
//    LOP3 per 4 bytes per nibble half, then one PRMT per lookup, which also
//    brings in j's table base, so the LDS takes it as its address.  Per 16
//    bytes of a row the W = 4 SASS has 32 LDS, 32 PRMT, 16 + 12 LOP3 and
//    8 shifts: about 4 ALU-pipe instructions and 2 LDS per input byte.
//  - Every input and output byte crosses HBM once: a thread owns 16
//    consecutive byte columns and reads them as one 16-byte load per input
//    row, with a ring of kAhead rows in flight; no row is re-read (with
//    r > 8, each further group of 8 output rows reads the input again).
//  - Epilogue: the 16 packed accumulators are transposed into W output rows
//    of 16 bytes with PRMT and written as 16-byte stores.
//  - Rows with an unaligned stride or base, and the ragged tail of S, take a
//    byte path through the same tables, so any S >= 1 works.
//  - Input and output are strided views: the fused encode passes the data
//    and parity halves of one (B, k+m, S) buffer, so the hash kernel that
//    follows reads all k+m pieces with no concatenation copy.
//
// Measured on an H100 SXM at 700 W, EC(8,3) encode of 64 blocks of 1 MiB:
// about 40 us, 0.67-0.69 of the byte floor.  The lookups hide under the
// memory traffic: with the table reads taken out, or with only the loads,
// XOR and stores left, the kernel is within 1.5 us of that, so its load and
// store pattern, not the tables, is what bounds it now.
//
// Shapes: blocks of 256 threads; a block owns one output group and walks
// (batch row, 4096-column tile) items with a grid-stride loop, so it builds
// its tables once.  The grid is as many blocks as the card holds at once
// (SMs x resident blocks per SM), rounded to whole groups.  The register cap
// keeps 32 warps per SM for W = 4 (16 for W = 8), enough loads in flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;   // byte columns per thread: one 16-byte load per row
constexpr long long kTile = (long long)kThreads * kCols;  // columns per item
constexpr int kAhead = 2;   // input rows in flight ahead of their lookups
// resident blocks per SM that the register cap guarantees: 32 warps for
// W = 4, 16 for the twice as wide accumulators of W = 8; the tables of any
// q <= 255 fit that many times in shared memory
template <int W> constexpr int kBlocksPerSm = W == 4 ? 4 : 2;

template <int W> struct Entry;
template <> struct Entry<4> { using T = uint32_t; };
template <> struct Entry<8> { using T = uint2; };

__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
  return a ^ b ^ c;
}
__device__ __forceinline__ uint2 xor3(uint2 a, uint2 b, uint2 c) {
  return make_uint2(a.x ^ b.x ^ c.x, a.y ^ b.y ^ c.y);
}
__device__ __forceinline__ void set_zero(uint32_t& a) { a = 0u; }
__device__ __forceinline__ void set_zero(uint2& a) { a = make_uint2(0u, 0u); }
__device__ __forceinline__ uint32_t row_byte(uint32_t a, int i) { return a >> (8 * i); }
__device__ __forceinline__ uint32_t row_byte(uint2 a, int i) {
  return i < 4 ? a.x >> (8 * i) : a.y >> (8 * (i - 4));
}
__device__ __forceinline__ void set_basis(uint32_t& e, const uint32_t* w) { e = w[0]; }
__device__ __forceinline__ void set_basis(uint2& e, const uint32_t* w) {
  e = make_uint2(w[0], w[1]);
}

// Builds the tables of output group g: tab[(j*2 + h)*16 + n], entry byte i
// = M_{gW+i, j}(n << 4h).  Ends with a barrier.
template <int W>
__device__ void build_tables(const uint8_t* __restrict__ bitmat, int r, int q, int g,
                             typename Entry<W>::T* tab) {
  using E = typename Entry<W>::T;
  // the columns: bit 8i+t of entry (j, a/4, 1 << a%4) is M[8(gW+i)+t, 8j+a]
  for (int t = threadIdx.x; t < 8 * q; t += blockDim.x) {
    const int j = t >> 3, a = t & 7;
    uint32_t w[W / 4] = {};
#pragma unroll
    for (int rr = 0; rr < 8 * W; ++rr) {
      const int row = 8 * g * W + rr;
      if (row < 8 * r)
        w[rr >> 5] |= (uint32_t)(bitmat[(long long)row * 8 * q + 8 * j + a] & 1u) << (rr & 31);
    }
    set_basis(tab[(j * 2 + (a >> 2)) * 16 + (1 << (a & 3))], w);
  }
  __syncthreads();
  // every other entry: the XOR of the columns of its set bits (entry 0 is 0)
  for (int t = threadIdx.x; t < 32 * q; t += blockDim.x) {
    const int n = t & 15;
    if ((n & (n - 1)) == 0 && n != 0) continue;
    E v, zero;
    set_zero(v);
    set_zero(zero);
    const E* base = tab + (t & ~15);
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if ((n >> a) & 1) v = xor3(v, base[1 << a], zero);
    tab[t] = v;
  }
  __syncthreads();
}

// 16 input bytes of row j into the 16 column accumulators.  The byte offset
// of an entry is made in place, 4 bytes at a time, one byte per column:
// T[j][0] starts at j*32*W, T[j][1] 16*W bytes later, entry n at n*W.  The
// low byte of j*32*W (0x80 for odd j when W = 4) and the nibble offsets go
// into each byte by one shift and one LOP3; PRMT then takes one such byte
// and the upper bytes of j*32*W, so the offset feeds the LDS directly.
template <int W>
__device__ __forceinline__ void lookup16(const uint8_t* tabs, int j, uint4 w,
                                         typename Entry<W>::T (&acc)[kCols]) {
  using E = typename Entry<W>::T;
  constexpr int kShift = W == 4 ? 2 : 3;
  constexpr uint32_t kMask = 0x0F0F0F0Fu << kShift;
  const uint32_t base = (uint32_t)j * 32 * W;
  const uint32_t low = (base & 0xFFu) * 0x01010101u;
  const uint32_t high = low | 0x01010101u * (16 * W);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = ((ws[k] << kShift) & kMask) | low;
    const uint32_t hi = ((ws[k] >> (4 - kShift)) & kMask) | high;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const E a = *reinterpret_cast<const E*>(tabs + __byte_perm(lo, base, 0x7650u + c));
      const E b = *reinterpret_cast<const E*>(tabs + __byte_perm(hi, base, 0x7650u + c));
      acc[4 * k + c] = xor3(acc[4 * k + c], a, b);
    }
  }
}

// 4x4 byte transpose: row i of the result holds byte i of a0..a3.
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                           uint32_t* r0, uint32_t* r1, uint32_t* r2,
                                           uint32_t* r3) {
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140u);  // a0.b0 a1.b0 a0.b1 a1.b1
  const uint32_t t1 = __byte_perm(a2, a3, 0x5140u);
  const uint32_t t2 = __byte_perm(a0, a1, 0x7362u);  // a0.b2 a1.b2 a0.b3 a1.b3
  const uint32_t t3 = __byte_perm(a2, a3, 0x7362u);
  *r0 = __byte_perm(t0, t1, 0x5410u);
  *r1 = __byte_perm(t0, t1, 0x7632u);
  *r2 = __byte_perm(t2, t3, 0x5410u);
  *r3 = __byte_perm(t2, t3, 0x7632u);
}

__device__ __forceinline__ void transpose_quad(const uint32_t (&acc)[kCols], int k,
                                               uint32_t (*rows)[4]) {
  transpose4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3],
             &rows[0][k], &rows[1][k], &rows[2][k], &rows[3][k]);
}
__device__ __forceinline__ void transpose_quad(const uint2 (&acc)[kCols], int k,
                                               uint32_t (*rows)[4]) {
  transpose4(acc[4 * k].x, acc[4 * k + 1].x, acc[4 * k + 2].x, acc[4 * k + 3].x,
             &rows[0][k], &rows[1][k], &rows[2][k], &rows[3][k]);
  transpose4(acc[4 * k].y, acc[4 * k + 1].y, acc[4 * k + 2].y, acc[4 * k + 3].y,
             &rows[4][k], &rows[5][k], &rows[6][k], &rows[7][k]);
}

// 16 aligned columns: q 16-byte loads in, nrows 16-byte stores out.  A
// ring of kAhead rows stays in flight: row j's slot is refilled with row
// j + kAhead before row j's lookups.
template <int W>
__device__ __forceinline__ void vector_step(const uint8_t* tabs, int q,
                                            const uint8_t* __restrict__ xs, long long xr,
                                            uint8_t* __restrict__ os, long long orow,
                                            int nrows) {
  using E = typename Entry<W>::T;
  E acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) set_zero(acc[c]);
  uint4 ring[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (u < q) ring[u] = __ldg(reinterpret_cast<const uint4*>(xs + u * xr));
  for (int j0 = 0; j0 < q; j0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int j = j0 + u;
      if (j < q) {
        const uint4 cur = ring[u];
        if (j + kAhead < q)
          ring[u] = __ldg(reinterpret_cast<const uint4*>(xs + (j + kAhead) * xr));
        lookup16<W>(tabs, j, cur, acc);
      }
    }
  }
  uint32_t rows[W][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) transpose_quad(acc, k, rows);
#pragma unroll
  for (int i = 0; i < W; ++i)
    if (i < nrows)
      *reinterpret_cast<uint4*>(os + i * orow) =
          make_uint4(rows[i][0], rows[i][1], rows[i][2], rows[i][3]);
}

// n <= 16 columns of any alignment, one byte at a time.
template <int W>
__device__ __forceinline__ void byte_step(const uint8_t* tabs, int q,
                                          const uint8_t* __restrict__ xs, long long xr,
                                          uint8_t* __restrict__ os, long long orow,
                                          int nrows, int n) {
  using E = typename Entry<W>::T;
  const E* tab = reinterpret_cast<const E*>(tabs);
#pragma unroll 1
  for (int c = 0; c < n; ++c) {
    E a;
    set_zero(a);
#pragma unroll 4
    for (int j = 0; j < q; ++j) {
      const uint32_t v = xs[j * xr + c];
      a = xor3(a, tab[j * 32 + (v & 15u)], tab[j * 32 + 16 + (v >> 4)]);
    }
    for (int i = 0; i < nrows; ++i) os[i * orow + c] = (uint8_t)row_byte(a, i);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<W>)
gf_bitplane_kernel(const uint8_t* __restrict__ bitmat, int r, int q,
                   const uint8_t* __restrict__ x, long long xb, long long xr,
                   uint8_t* __restrict__ out, long long ob, long long orow,
                   long long batch, long long S, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int groups = (r + W - 1) / W;
  const int g = blockIdx.x % groups;
  const int nrows = r - g * W < W ? r - g * W : W;
  const long long tiles = (S + kTile - 1) / kTile;
  const long long items = batch * tiles;
  const long long slots = gridDim.x / groups;
  build_tables<W>(bitmat, r, q, g, reinterpret_cast<typename Entry<W>::T*>(smem));

  for (long long it = blockIdx.x / groups; it < items; it += slots) {
    const long long b = it / tiles;
    const long long s0 = (it - b * tiles) * kTile + (long long)threadIdx.x * kCols;
    if (s0 >= S) continue;  // no barrier follows
    const uint8_t* xs = x + b * xb + s0;
    uint8_t* os = out + b * ob + (long long)g * W * orow + s0;
    if (vec && s0 + kCols <= S)
      vector_step<W>(smem, q, xs, xr, os, orow, nrows);
    else
      byte_step<W>(smem, q, xs, xr, os, orow, nrows, (int)(S - s0 < kCols ? S - s0 : kCols));
  }
}

template <int W>
int launch(int device, const uint8_t* bitmat, int r, int q, const uint8_t* x, long long xb,
           long long xr, uint8_t* out, long long ob, long long orow, long long batch,
           long long S, cudaStream_t st) {
  const size_t smem = (size_t)q * 32 * W;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gf_bitplane_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int vec = (xb % 16 == 0) && (xr % 16 == 0) && (ob % 16 == 0) && (orow % 16 == 0) &&
                  ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long groups = (r + W - 1) / W;
  const long long items = batch * ((S + kTile - 1) / kTile);
  long long slots = ((long long)sms * kBlocksPerSm<W> + groups - 1) / groups;
  if (slots > items) slots = items;
  gf_bitplane_kernel<W><<<(unsigned)(slots * groups), kThreads, smem, st>>>(
      bitmat, r, q, x, xb, xr, out, ob, orow, batch, S, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gf_bitplane_apply(int device, const void* bitmat, int r, int q,
                                 const void* x, long long xb, long long xr,
                                 void* out, long long ob, long long orow,
                                 long long batch, long long S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0 || S <= 0 || r <= 0) return (int)cudaGetLastError();
  const auto* bm = (const uint8_t*)bitmat;
  const auto* xp = (const uint8_t*)x;
  auto* op = (uint8_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  return r <= 4 ? launch<4>(device, bm, r, q, xp, xb, xr, op, ob, orow, batch, S, st)
                : launch<8>(device, bm, r, q, xp, xb, xr, op, ob, orow, batch, S, st);
}
