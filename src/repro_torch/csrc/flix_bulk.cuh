// Hopper's asynchronous copies as small device functions: mbarriers, the
// bulk-copy engine's loads (cp.async.bulk, no tensor map: contiguous bytes,
// 16-byte aligned, a multiple of 16 long, global to shared), and the 4-byte
// cp.async whose completion an mbarrier can track.  Used by the
// single-buffer stripe kernel (flix_apply.cu).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace flix {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (the copy engine).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive, and expect `bytes` more of copies to complete in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Until the phase of parity `parity` has completed.  Each try suspends the
// thread until the phase completes or kWaitHintNs pass, so that waiting
// warps take no issue slots from the working ones.
constexpr uint32_t kWaitHintNs = 1000000;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity), "r"(kWaitHintNs)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// the bulk-copy engine
// ---------------------------------------------------------------------------

// Copy `bytes` from global src to shared dst; the copy's bytes complete
// on `bar` (announced by mbar_arrive_expect_tx).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order this thread's earlier generic writes to shared memory before later
// accesses of it by the async proxy (a bulk copy into it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// cp.async (4 bytes a thread)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared::cta.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's committed cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// An arrival on `bar` once all of this thread's earlier cp.async copies have
// landed; the barrier's pending count is raised first, so the phase cannot
// complete before then and the barrier's own count is unchanged.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Copy n ints from global src to shared dst by the 32 lanes of a warp,
// 4 bytes a copy.
__device__ __forceinline__ void warp_copy_async(int* dst, const int* src, int n, int lane) {
  for (int i = lane; i < n; i += 32) cp_async4(dst + i, src + i);
}

}  // namespace flix
