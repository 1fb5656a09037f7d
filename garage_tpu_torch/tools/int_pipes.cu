// Throughput of the int32 instructions BLAKE3 is made of, on one card: the
// number that bounds kernel K2 (csrc/blake3.cu).  Each thread runs 8
// independent chains (enough to hide every latency) of `iters` steps; a
// step is the kernel's instruction, or a pair of two kinds, written as
// inline PTX with `volatile` so nothing is folded away.  ptxas maps
//   lop3   lop3.b32 (XOR of three)           -> LOP3
//   shf    shf.r.wrap.b32 (rotate by 7)      -> SHF
//   prmt   prmt.b32 (rotate by 16)           -> PRMT
//   imad   mad.lo.u32 by a run-time 1        -> IMAD
//   iadd3  two add.u32 (ptxas picks IADD3 or IMAD.IADD)
// and the pairs interleave two of them; the tool prints each kernel's SASS
// opcode counts, so what ran is on record.  tools/int_pipes.py times each
// kernel and prints thread-instructions per SM per clock.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void lop3(uint32_t& a, uint32_t b, uint32_t c) {
  asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(a) : "r"(b), "r"(c));
}
__device__ __forceinline__ void shf(uint32_t& a, uint32_t, uint32_t) {
  asm volatile("shf.r.wrap.b32 %0, %0, %0, 7;" : "+r"(a));
}
__device__ __forceinline__ void prmt(uint32_t& a, uint32_t, uint32_t) {
  asm volatile("prmt.b32 %0, %0, %0, 0x1032;" : "+r"(a));
}
__device__ __forceinline__ void imad(uint32_t& a, uint32_t b, uint32_t c) {
  asm volatile("mad.lo.u32 %0, %1, %2, %0;" : "+r"(a) : "r"(b), "r"(c));
}
__device__ __forceinline__ void iadd3(uint32_t& a, uint32_t b, uint32_t c) {
  uint32_t t;
  asm volatile("add.u32 %0, %1, %2;" : "=r"(t) : "r"(a), "r"(b));
  asm volatile("add.u32 %0, %1, %2;" : "=r"(a) : "r"(t), "r"(c));
}

// a ^= b and a += b (by a multiply-add with the run-time one), each reading
// two registers that change every step: no operand is loop-invariant
__device__ __forceinline__ void lop3x(uint32_t& a, uint32_t b, uint32_t) {
  asm volatile("lop3.b32 %0, %0, %1, %0, 0x3c;" : "+r"(a) : "r"(b));
}
__device__ __forceinline__ void imadx(uint32_t& a, uint32_t b, uint32_t c) {
  asm volatile("mad.lo.u32 %0, %1, %2, %0;" : "+r"(a) : "r"(b), "r"(c));
}

// As pair_kernel, but the second operand of each step is another chain's
// current word (chain i reads chain i+1, then chain i+5).
template <void (*F)(uint32_t&, uint32_t, uint32_t), void (*H)(uint32_t&, uint32_t, uint32_t)>
__global__ void __launch_bounds__(256) fresh_kernel(uint32_t* out, int iters, uint32_t one) {
  uint32_t a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = threadIdx.x * 8u + i + blockIdx.x;
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      F(a[i], a[(i + 1) & 7], one);
      H(a[i], a[(i + 5) & 7], one);
    }
  }
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s ^= a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <void (*F)(uint32_t&, uint32_t, uint32_t), void (*H)(uint32_t&, uint32_t, uint32_t)>
__global__ void __launch_bounds__(256) pair_kernel(uint32_t* out, int iters, uint32_t one) {
  uint32_t a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = threadIdx.x * 8u + i;
  const uint32_t b = blockIdx.x, c = one;
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      F(a[i], b, c);
      H(a[i], b, c);
    }
  }
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s ^= a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// kind: 0 lop3+lop3, 1 shf+shf, 2 prmt+prmt, 3 imad+imad, 4 iadd3 (two adds),
// 5 lop3+imad, 6 shf+imad, 7 lop3+shf, 8 prmt+imad; then with two changing
// register operands per step: 9 xor+xor, 10 add+add, 11 xor+add.  Each launch runs
// blocks x 256 threads x iters x 8 chains x 2 instructions.
extern "C" int int_pipes_run(int kind, int blocks, int iters, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  switch (kind) {
    case 0: pair_kernel<lop3, lop3><<<blocks, 256, 0, st>>>(o, iters, 1u); break;
    case 1: pair_kernel<shf, shf><<<blocks, 256, 0, st>>>(o, iters, 1u); break;
    case 2: pair_kernel<prmt, prmt><<<blocks, 256, 0, st>>>(o, iters, 1u); break;
    case 3: pair_kernel<imad, imad><<<blocks, 256, 0, st>>>(o, iters, 1u); break;
    case 4: pair_kernel<iadd3, iadd3><<<blocks, 256, 0, st>>>(o, iters, 1u); break;
    case 5: pair_kernel<lop3, imad><<<blocks, 256, 0, st>>>(o, iters, 1u); break;
    case 6: pair_kernel<shf, imad><<<blocks, 256, 0, st>>>(o, iters, 1u); break;
    case 7: pair_kernel<lop3, shf><<<blocks, 256, 0, st>>>(o, iters, 1u); break;
    case 8: pair_kernel<prmt, imad><<<blocks, 256, 0, st>>>(o, iters, 1u); break;
    case 9: fresh_kernel<lop3x, lop3x><<<blocks, 256, 0, st>>>(o, iters, 1u); break;
    case 10: fresh_kernel<imadx, imadx><<<blocks, 256, 0, st>>>(o, iters, 1u); break;
    case 11: fresh_kernel<lop3x, imadx><<<blocks, 256, 0, st>>>(o, iters, 1u); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
