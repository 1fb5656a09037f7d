// Guard-page allocator for PyTorch on one CUDA card: memcheck's and
// initcheck's kind of check where compute-sanitizer cannot attach to the
// card.  tools/sanitize_cuda.py installs it in a child process with
// torch.cuda.memory.CUDAPluggableAllocator before the first allocation, so
// every tensor of the child, the kernels' scratch and outputs included, is
// one allocation of its own, laid out by CUDA's virtual memory management
// calls (cuMemAddressReserve, cuMemCreate, cuMemMap):
//
//   after   the tensor ends (its size rounded up to 16 bytes, the alignment
//           the kernels take) at the end of its mapped granules, and the
//           next granule of the reserved range is never mapped: a read or a
//           write past the end faults (an illegal address, which kills the
//           context)
//   before  the tensor starts right after one unmapped granule: an access
//           before its start faults
//
// Every mapped byte is first filled with a poison byte.  The bytes of the
// mapped granules that lie outside the tensor are read back when it is
// freed and must still hold the poison: a write there (up to 15 bytes past
// the end, or before the start, in "after" mode) is counted as a violation.
// Run twice with two poison bytes, a kernel output that depends on memory
// nobody wrote differs from the oracle in at least one run.
//
// The cuMem* entry points come through the runtime's entry-point query, so
// the library needs no link against libcuda.  Every call synchronises the
// device: this is a checking tool, not a fast allocator.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cuda.h>
#include <cuda_runtime.h>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Region {
  CUdeviceptr va;                  // the reserved range
  size_t reserved;
  CUdeviceptr mapped_at;           // the mapped granules within it
  size_t mapped;
  CUmemGenericAllocationHandle handle;
  uintptr_t base;                  // the tensor
  size_t size;
};

struct VmmApi {
  decltype(&cuMemGetAllocationGranularity) granularity = nullptr;
  decltype(&cuMemAddressReserve) reserve = nullptr;
  decltype(&cuMemAddressFree) release_va = nullptr;
  decltype(&cuMemCreate) create = nullptr;
  decltype(&cuMemRelease) release = nullptr;
  decltype(&cuMemMap) map = nullptr;
  decltype(&cuMemUnmap) unmap = nullptr;
  decltype(&cuMemSetAccess) set_access = nullptr;
};

std::mutex mu;
std::unordered_map<uintptr_t, Region> live;
VmmApi vmm;
bool vmm_ready = false;
int mode_before = 0;           // 0: guard after the end, 1: before the start
unsigned char poison = 0xA5;
long long n_allocs = 0, n_frees = 0, n_violations = 0, n_failures = 0;
long long bytes_live = 0, bytes_peak = 0;
int last_error = 0;

template <class F>
bool entry(const char* name, F* out) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q) != cudaSuccess ||
      q != cudaDriverEntryPointSuccess || p == nullptr)
    return false;
  *out = reinterpret_cast<F>(p);
  return true;
}

bool load_vmm() {
  if (vmm_ready) return true;
  vmm_ready = entry("cuMemGetAllocationGranularity", &vmm.granularity) &&
              entry("cuMemAddressReserve", &vmm.reserve) &&
              entry("cuMemAddressFree", &vmm.release_va) && entry("cuMemCreate", &vmm.create) &&
              entry("cuMemRelease", &vmm.release) && entry("cuMemMap", &vmm.map) &&
              entry("cuMemUnmap", &vmm.unmap) && entry("cuMemSetAccess", &vmm.set_access);
  return vmm_ready;
}

size_t round_up(size_t v, size_t to) { return (v + to - 1) / to * to; }

bool fail(int code) {
  last_error = code;
  ++n_failures;
  return false;
}

// Unmaps and releases what `r` holds (any part may be missing).
void drop(const Region& r) {
  if (r.mapped_at) vmm.unmap(r.mapped_at, r.mapped);
  if (r.handle) vmm.release(r.handle);
  if (r.va) vmm.release_va(r.va, r.reserved);
}

bool allocate(size_t size, int device, Region* r) {
  if (!load_vmm()) return fail(-1);
  CUmemAllocationProp prop;
  std::memset(&prop, 0, sizeof(prop));
  prop.type = CU_MEM_ALLOCATION_TYPE_PINNED;
  prop.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
  prop.location.id = device;
  size_t gran = 0;
  CUresult e = vmm.granularity(&gran, &prop, CU_MEM_ALLOC_GRANULARITY_MINIMUM);
  if (e != CUDA_SUCCESS) return fail(e);
  const size_t padded = round_up(size ? size : 1, 16);
  std::memset(r, 0, sizeof(*r));
  r->size = size;
  r->mapped = round_up(padded, gran);
  r->reserved = r->mapped + gran;  // one granule stays unmapped: the guard
  if ((e = vmm.reserve(&r->va, r->reserved, gran, 0, 0)) != CUDA_SUCCESS) return fail(e);
  if ((e = vmm.create(&r->handle, r->mapped, &prop, 0)) != CUDA_SUCCESS) {
    drop(*r);
    return fail(e);
  }
  const CUdeviceptr at = mode_before ? r->va + gran : r->va;
  if ((e = vmm.map(at, r->mapped, 0, r->handle, 0)) != CUDA_SUCCESS) {
    drop(*r);
    return fail(e);
  }
  r->mapped_at = at;
  CUmemAccessDesc acc;
  std::memset(&acc, 0, sizeof(acc));
  acc.location = prop.location;
  acc.flags = CU_MEM_ACCESS_FLAGS_PROT_READWRITE;
  if ((e = vmm.set_access(at, r->mapped, &acc, 1)) != CUDA_SUCCESS) {
    drop(*r);
    return fail(e);
  }
  cudaError_t ce = cudaMemset((void*)at, poison, r->mapped);
  if (ce == cudaSuccess) ce = cudaDeviceSynchronize();
  if (ce != cudaSuccess) {
    drop(*r);
    return fail(ce);
  }
  r->base = mode_before ? at : at + r->mapped - padded;
  return true;
}

// The mapped bytes outside the tensor must still hold the poison.
bool poison_intact(const Region& r) {
  std::vector<unsigned char> host(r.mapped);
  if (cudaMemcpy(host.data(), (void*)r.mapped_at, r.mapped, cudaMemcpyDeviceToHost) !=
      cudaSuccess)
    return false;
  const size_t lo = r.base - r.mapped_at, hi = lo + r.size;
  for (size_t i = 0; i < r.mapped; ++i)
    if ((i < lo || i >= hi) && host[i] != poison) return false;
  return true;
}

}  // namespace

extern "C" {

// mode 0: guard after the end; 1: guard before the start.  Applies to
// later allocations.
void guard_configure(int before, int poison_byte) {
  std::lock_guard<std::mutex> g(mu);
  mode_before = before ? 1 : 0;
  poison = (unsigned char)poison_byte;
}

void* guard_malloc(ssize_t size, int device, cudaStream_t /*stream*/) {
  std::lock_guard<std::mutex> g(mu);
  Region r;
  if (size < 0 || cudaSetDevice(device) != cudaSuccess || !allocate((size_t)size, device, &r))
    return nullptr;
  live[r.base] = r;
  ++n_allocs;
  bytes_live += (long long)r.size;
  if (bytes_live > bytes_peak) bytes_peak = bytes_live;
  return (void*)r.base;
}

void guard_free(void* ptr, ssize_t /*size*/, int device, cudaStream_t /*stream*/) {
  std::lock_guard<std::mutex> g(mu);
  auto it = live.find((uintptr_t)ptr);
  if (it == live.end()) {
    ++n_violations;  // a pointer this allocator never handed out
    return;
  }
  cudaSetDevice(device);
  // the work queued on any stream may still use the tensor
  if (cudaDeviceSynchronize() != cudaSuccess || !poison_intact(it->second)) ++n_violations;
  drop(it->second);
  bytes_live -= (long long)it->second.size;
  live.erase(it);
  ++n_frees;
}

// out[0..6]: allocations, frees, violations, failed allocations, bytes
// live, peak bytes live, the last failure's CUDA error code
void guard_stats(long long* out) {
  std::lock_guard<std::mutex> g(mu);
  out[0] = n_allocs;
  out[1] = n_frees;
  out[2] = n_violations;
  out[3] = n_failures;
  out[4] = bytes_live;
  out[5] = bytes_peak;
  out[6] = last_error;
}

}  // extern "C"
