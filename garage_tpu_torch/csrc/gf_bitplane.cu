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
// What bounds it on this card: bytes.  Per output byte it does q table
// lookups and q XORs; per byte moved that is far below the card's ALU rate,
// so the floor is (B*q*S + B*r*S) bytes over the HBM rate (3.35 TB/s).
//
// What the design does about it:
//  - Each (i, j) 8x8 block of M is linear over GF(2), so it is folded once
//    per thread block into a 256-entry byte table in shared memory:
//      lut[i][j][v] = sum_t (popcount(M[8i+t, 8j:8j+8] & v) & 1) << t
//    (r*q*256 bytes: 6 KiB for EC(8,3), 16 KiB for EC(16,4)).  The bit-plane
//    unpack, the 0/1 product and the re-pack of the TPU kernel collapse into
//    out[i] = XOR_j lut[i][j][x_j].
//  - Every input and output byte crosses HBM once: a thread owns 16
//    consecutive byte columns, reads them as one 16-byte load per input row
//    (consecutive threads on consecutive addresses) and writes 16-byte
//    stores.  Repeated reads of an input row for the next output row hit L1.
//  - Rows with an unaligned length or base take a byte path; the kernel
//    masks the ragged tail itself, so any S >= 1 works.
//  - Input and output are strided views: the fused encode passes the data
//    and parity halves of one (B, k+m, S) buffer, so the hash kernel that
//    follows reads all k+m pieces with no concatenation copy.
//
// Shapes: grid (ceil(S / 16384), B), 256 threads; the batch is launched in
// slices of 65535 rows (the grid's y limit).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;   // byte columns per thread per step
constexpr int kSteps = 4;   // steps per thread block
constexpr long long kBytesPerBlock = (long long)kThreads * kCols * kSteps;

__device__ __forceinline__ uint32_t lookup4(const uint8_t* lt, uint32_t w) {
  return (uint32_t)lt[w & 0xFFu] | ((uint32_t)lt[(w >> 8) & 0xFFu] << 8) |
         ((uint32_t)lt[(w >> 16) & 0xFFu] << 16) | ((uint32_t)lt[w >> 24] << 24);
}

__global__ void __launch_bounds__(kThreads)
gf_bitplane_kernel(const uint8_t* __restrict__ bitmat, int r, int q,
                   const uint8_t* __restrict__ x, long long xb, long long xr,
                   uint8_t* __restrict__ out, long long ob, long long orow,
                   long long S, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nrows = 8 * r * q;
  uint8_t* rowbyte = smem;                      // [8r][q] packed matrix bits
  uint8_t* lut = smem + ((nrows + 15) & ~15);   // [r][q][256]

  for (int t = threadIdx.x; t < nrows; t += blockDim.x) {
    const int row = t / q, j = t - (t / q) * q;
    const uint8_t* src = bitmat + (long long)row * 8 * q + 8 * j;
    uint32_t v = 0;
    for (int a = 0; a < 8; ++a) v |= (uint32_t)(src[a] & 1u) << a;
    rowbyte[t] = (uint8_t)v;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < r * q * 256; t += blockDim.x) {
    const int v = t & 255, ij = t >> 8;
    const int i = ij / q, j = ij - (ij / q) * q;
    uint32_t o = 0;
    for (int b = 0; b < 8; ++b)
      o |= (uint32_t)(__popc(rowbyte[(8 * i + b) * q + j] & v) & 1) << b;
    lut[t] = (uint8_t)o;
  }
  __syncthreads();

  const uint8_t* xrow = x + (long long)blockIdx.y * xb;
  uint8_t* orow0 = out + (long long)blockIdx.y * ob;
  const long long base = (long long)blockIdx.x * kBytesPerBlock;
  for (int step = 0; step < kSteps; ++step) {
    const long long s0 = base + ((long long)step * kThreads + threadIdx.x) * kCols;
    if (s0 >= S) break;  // no barrier follows
    if (vec) {
      for (int i = 0; i < r; ++i) {
        const uint8_t* lt = lut + (long long)i * q * 256;
        uint4 acc = make_uint4(0u, 0u, 0u, 0u);
        for (int j = 0; j < q; ++j, lt += 256) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(xrow + j * xr + s0));
          acc.x ^= lookup4(lt, w.x);
          acc.y ^= lookup4(lt, w.y);
          acc.z ^= lookup4(lt, w.z);
          acc.w ^= lookup4(lt, w.w);
        }
        *reinterpret_cast<uint4*>(orow0 + i * orow + s0) = acc;
      }
    } else {
      const long long e = (s0 + kCols < S) ? s0 + kCols : S;
      for (int i = 0; i < r; ++i) {
        const uint8_t* lt = lut + (long long)i * q * 256;
        for (long long s = s0; s < e; ++s) {
          uint32_t a = 0;
          for (int j = 0; j < q; ++j) a ^= lt[j * 256 + xrow[j * xr + s]];
          orow0[i * orow + s] = (uint8_t)a;
        }
      }
    }
  }
}

}  // namespace

extern "C" int gf_bitplane_apply(int device, const void* bitmat, int r, int q,
                                 const void* x, long long xb, long long xr,
                                 void* out, long long ob, long long orow,
                                 long long batch, long long S, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0 || S <= 0 || r <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)((8 * r * q + 15) & ~15) + (size_t)r * q * 256;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gf_bitplane_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = (S % 16 == 0) && (xb % 16 == 0) && (xr % 16 == 0) &&
                  (ob % 16 == 0) && (orow % 16 == 0) &&
                  ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const unsigned nbx = (unsigned)((S + kBytesPerBlock - 1) / kBytesPerBlock);
  cudaStream_t st = (cudaStream_t)stream;
  for (long long b0 = 0; b0 < batch; b0 += 65535) {
    const unsigned nb = (unsigned)((batch - b0 < 65535) ? batch - b0 : 65535);
    gf_bitplane_kernel<<<dim3(nbx, nb), kThreads, smem, st>>>(
        (const uint8_t*)bitmat, r, q, (const uint8_t*)x + b0 * xb, xb, xr,
        (uint8_t*)out + b0 * ob, ob, orow, S, vec);
  }
  return (int)cudaGetLastError();
}
