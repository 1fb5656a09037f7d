// The CUDA the port's kernels use, on the host: tools/cuda_on_host.py
// compiles csrc/gf_bitplane.cu and csrc/blake3.cu with g++ against this
// header (as <cuda_runtime.h>), under AddressSanitizer + UBSan or under
// ThreadSanitizer, to check on the CPU what compute-sanitizer's racecheck,
// synccheck and memcheck check on a card:
//
//  - every CUDA thread is a host thread, every block's threads run at once
//    (blocks run in waves of at most kMaxThreads threads, several blocks a
//    wave, so blocks overlap as they do on a card), each block has its own
//    shared memory (a heap buffer of exactly the launch's size, filled with
//    a poison byte) and a barrier, each warp a barrier of its live lanes;
//  - __syncthreads, __syncwarp and the shuffles are those barriers (a
//    mutex and a condition variable, which ThreadSanitizer follows), so a
//    missing barrier is a data race it reports;
//  - a shuffle or __syncwarp whose mask names a lane that has exited, and
//    a __syncthreads reached after some of the block's threads exited
//    mid-kernel, are counted as synchronisation errors
//    (`cuda_on_host_sync_errors`);
//  - atomicAdd is a sequentially consistent read-modify-write,
//    __threadfence a sequentially consistent fence; loads and stores
//    (__ldg, __ldcg, __stcg) are plain.
//
// It models no timing, caching or memory model of the card beyond C++'s.

#pragma once

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#pragma GCC visibility push(hidden)  // the kernels' extern "C" entries stay exported

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct uint2 {
  uint32_t x, y;
};
struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};
inline uint2 make_uint2(uint32_t x, uint32_t y) { return {x, y}; }
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return {x, y, z, w}; }

struct CudaDim {
  unsigned x = 0, y = 1, z = 1;
};
inline thread_local CudaDim threadIdx, blockIdx, blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

namespace cuda_on_host {

constexpr unsigned kMaxThreads = 512;  // host threads of one wave
constexpr unsigned char kSmemPoison = 0xA5;
inline int sm_count = 2;  // what cudaDeviceGetAttribute reports: small grids

// A barrier whose participants can leave (an exited CUDA thread).
struct Barrier {
  std::mutex mu;
  std::condition_variable cv;
  int expected = 0, count = 0;
  long phase = 0;
  void init(int n) { expected = count = n; }
  void arrive(std::unique_lock<std::mutex>& l) {
    if (--count == 0) {
      ++phase;
      count = expected;
      cv.notify_all();
    }
    (void)l;
  }
  void wait() {
    std::unique_lock<std::mutex> l(mu);
    const long p = phase;
    arrive(l);
    cv.wait(l, [&] { return phase != p; });
  }
  void drop() {
    std::unique_lock<std::mutex> l(mu);
    --expected;
    arrive(l);
  }
};

struct Warp {
  Barrier bar;
  std::atomic<uint32_t> live{0};  // lanes that have not exited
  uint64_t slot[32] = {};
};

struct Block {
  std::vector<unsigned char> smem;
  Barrier bar;
  std::unique_ptr<Warp[]> warps;
  std::atomic<int> exited{0};
};

inline std::atomic<long long> sync_errors{0};
inline thread_local Block* cur_block = nullptr;

inline void sync_error(const char* what) {
  if (sync_errors.fetch_add(1) < 8)
    std::fprintf(stderr, "cuda_on_host: synccheck: %s (block %u thread %u)\n", what,
                 blockIdx.x, threadIdx.x);
}

inline unsigned lane() { return threadIdx.x & 31u; }
inline Warp& warp() { return cur_block->warps[threadIdx.x >> 5]; }

inline void check_mask(unsigned mask, const char* what) {
  if ((mask & warp().live.load()) != mask) sync_error(what);
  if (!(mask >> lane() & 1u)) sync_error("a lane outside the mask joined a warp collective");
}

template <class T>
T exchange(unsigned mask, T v, int src, const char* what) {
  static_assert(sizeof(T) <= 8, "shuffles move at most 8 bytes");
  check_mask(mask, what);
  Warp& w = warp();
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  w.slot[lane()] = bits;
  w.bar.wait();  // every live lane has written its value
  const uint64_t got = w.slot[src];
  w.bar.wait();  // every live lane has read before the slots are reused
  T out;
  std::memcpy(&out, &got, sizeof(T));
  return out;
}

// A fixed set of host threads that runs one wave of CUDA threads at a
// time; waves are ordered by its mutex.
class Pool {
 public:
  ~Pool() {
    {
      std::lock_guard<std::mutex> l(mu_);
      stop_ = true;
    }
    work_.notify_all();
    for (auto& t : threads_) t.join();
  }
  void run(size_t n, const std::function<void(size_t)>& task) {
    while (threads_.size() < n) {
      const size_t id = threads_.size();
      threads_.emplace_back([this, id] { loop(id); });
    }
    {
      std::lock_guard<std::mutex> l(mu_);
      task_ = &task;
      active_ = remaining_ = n;
      ++gen_;
    }
    work_.notify_all();
    std::unique_lock<std::mutex> l(mu_);
    done_.wait(l, [&] { return remaining_ == 0; });
  }

 private:
  void loop(size_t id) {
    long seen = 0;
    for (;;) {
      const std::function<void(size_t)>* task;
      {
        std::unique_lock<std::mutex> l(mu_);
        work_.wait(l, [&] { return stop_ || gen_ != seen; });
        if (stop_) return;
        seen = gen_;
        if (id >= active_) continue;
        task = task_;
      }
      (*task)(id);
      std::lock_guard<std::mutex> l(mu_);
      if (--remaining_ == 0) done_.notify_all();
    }
  }
  std::mutex mu_;
  std::condition_variable work_, done_;
  std::vector<std::thread> threads_;
  const std::function<void(size_t)>* task_ = nullptr;
  size_t active_ = 0, remaining_ = 0;
  long gen_ = 0;
  bool stop_ = false;
};

inline Pool& pool() {
  static Pool p;
  return p;
}

inline void run_grid(unsigned grid, unsigned block, size_t smem,
                     const std::function<void()>& body) {
  if (grid == 0 || block == 0) return;
  const unsigned per_wave = std::max(1u, kMaxThreads / block);
  for (unsigned b0 = 0; b0 < grid; b0 += per_wave) {
    const unsigned nb = std::min(per_wave, grid - b0);
    const unsigned nwarps = (block + 31) / 32;
    std::vector<std::unique_ptr<Block>> blocks(nb);
    for (auto& b : blocks) {
      b = std::make_unique<Block>();
      b->smem.assign(smem, kSmemPoison);
      b->bar.init((int)block);
      b->warps.reset(new Warp[nwarps]);
      for (unsigned w = 0; w < nwarps; ++w) {
        const unsigned lanes = std::min(32u, block - 32 * w);
        b->warps[w].bar.init((int)lanes);
        b->warps[w].live = lanes == 32 ? 0xFFFFFFFFu : (1u << lanes) - 1;
      }
    }
    pool().run((size_t)nb * block, [&](size_t i) {
      Block* b = blocks[i / block].get();
      cur_block = b;
      blockIdx.x = b0 + (unsigned)(i / block);
      threadIdx.x = (unsigned)(i % block);
      blockDim.x = block;
      gridDim.x = grid;
      body();
      // the thread exits: it leaves its warp's and its block's barriers
      Warp& w = warp();
      w.live.fetch_and(~(1u << lane()));
      w.bar.drop();
      b->exited.fetch_add(1);
      b->bar.drop();
      cur_block = nullptr;
    });
  }
}

}  // namespace cuda_on_host

inline unsigned char* cuda_on_host_shared() { return cuda_on_host::cur_block->smem.data(); }

inline void __syncthreads() {
  using namespace cuda_on_host;
  if (cur_block->exited.load() != 0)
    sync_error("__syncthreads after threads of the block exited");
  cur_block->bar.wait();
}
inline void __syncwarp(unsigned mask = 0xFFFFFFFFu) {
  cuda_on_host::check_mask(mask, "__syncwarp names a lane that has exited");
  cuda_on_host::warp().bar.wait();
}
template <class T>
T __shfl_sync(unsigned mask, T v, int src) {
  return cuda_on_host::exchange(mask, v, src & 31, "__shfl_sync names a lane that has exited");
}
template <class T>
T __shfl_down_sync(unsigned mask, T v, unsigned delta) {
  const unsigned src = cuda_on_host::lane() + delta;
  return cuda_on_host::exchange(mask, v, src < 32 ? (int)src : (int)cuda_on_host::lane(),
                                "__shfl_down_sync names a lane that has exited");
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
template <class T>
T __ldg(const T* p) { return *p; }
template <class T>
T __ldcg(const T* p) { return *p; }
template <class T>
void __stcg(T* p, T v) { *p = v; }
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7u))) & 0xFFu) << (8 * i);
  return r;
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t shift) {
  const uint64_t v = ((uint64_t)hi << 32) | lo;
  return (uint32_t)(v >> (shift & 31u));
}
inline int __clzll(long long v) { return v == 0 ? 64 : __builtin_clzll((unsigned long long)v); }

inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = cuda_on_host::sm_count;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int value, size_t n, cudaStream_t) {
  std::memset(p, value, n);
  return cudaSuccess;
}

// kernel<<<grid, block, smem, stream>>>(args...) becomes this call
template <class... P, class... A>
void cuda_on_host_launch(void (*kernel)(P...), unsigned grid, unsigned block, size_t smem,
                         cudaStream_t, A... args) {
  cuda_on_host::run_grid(grid, block, smem, [&] { kernel(args...); });
}

#pragma GCC visibility pop

// the synchronisation errors counted so far (the header is included by one
// translation unit per library)
extern "C" long long cuda_on_host_sync_errors() { return cuda_on_host::sync_errors.load(); }
