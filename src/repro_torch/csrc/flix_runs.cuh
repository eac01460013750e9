// Persistent warps over runs of buckets, a lane per query: the pieces that
// the point-query and successor kernels (flix_query.cu, flix_successor.cu)
// share.
//
// The grid holds as many warps as the card keeps resident; warp w owns the
// contiguous buckets [w * run, (w + 1) * run), run at least kRunMin, so that
// each warp routes once, by warp_upper_bound32 over the sorted queries, and
// then walks its queries in windows of 32 against the run's fences held 32
// at a time in lanes (fences_below).  A lane reads its bucket's rows with
// count_below.  run_length sizes the runs for a kernel on the current
// device, from warps_resident, which other grids sized to the card use too.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "flix_phases.cuh"

namespace flix {

constexpr int kRunMin = 64;  // fewest buckets a warp owns (two fence groups)

// Number of entries of ascending a[0, n) at or below x, by the whole warp:
// while more than 32 entries are left, lane l reads the pivot ending the
// l-th of 32 equal steps and a ballot keeps the step holding the answer.
// Every lane must call it; all get the count.
__device__ inline int warp_upper_bound32(const int* __restrict__ a, int n, int x, int lane) {
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]; a[lo, hi) is unread
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long at = lo + (lane + 1) * step - 1;
    const int c = __popc(__ballot_sync(kFull, at < hi && a[at] <= x));
    hi = min(lo + (c + 1) * step - 1, hi);
    lo = min(lo + c * step, hi);
  }
  const long long at = lo + lane;
  return (int)lo + __popc(__ballot_sync(kFull, at < hi && a[at] <= x));
}

// Number of the group's fences below x, where lane j holds fence j
// (ascending, EMPTY past the group): a binary search over shuffles.  Every
// lane must call it, each with its own x.
__device__ __forceinline__ int fences_below(int fence, int x) {
  int i = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) i += __shfl_sync(kFull, fence, i + s - 1) < x ? s : 0;
  return i + (__shfl_sync(kFull, fence, i) < x);
}

// Number of entries of row[0, n) below x, read by one lane: 16-byte loads
// when vec (the row 16-byte aligned and n a multiple of 4).
__device__ __forceinline__ int count_below(const int* __restrict__ row, int n, int x,
                                           bool vec) {
  int c = 0;
  if (vec) {
    const int4* r4 = reinterpret_cast<const int4*>(row);
#pragma unroll 8
    for (int j = 0; j < n / 4; ++j) {
      const int4 v = __ldg(r4 + j);
      c += (v.x < x) + (v.y < x) + (v.z < x) + (v.w < x);
    }
  } else {
#pragma unroll 8
    for (int j = 0; j < n; ++j) c += __ldg(row + j) < x;
  }
  return c;
}

// The resident warps of one kernel, by device (0: not asked yet).  Their
// number depends on the kernel and the device alone, so it is asked once a
// device; each kernel keeps its own table.
constexpr int kMaxDevices = 64;
struct ResidentWarps {
  std::atomic<long long> by_device[kMaxDevices];
};

// The warps of kernel that the current device keeps resident in blocks of
// threads threads, asked once a device and kept in table.
inline cudaError_t warps_resident(ResidentWarps& table, const void* kernel, int threads,
                                  long long* resident) {
  int dev = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  long long r = table.by_device[dev].load(std::memory_order_relaxed);
  if (r == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0)) !=
        cudaSuccess)
      return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    r = (long long)per_sm * sms * (threads / 32);
    table.by_device[dev].store(r, std::memory_order_relaxed);
  }
  *resident = r;
  return cudaSuccess;
}

// The run length (buckets a warp owns) and the number of warps for nb
// buckets, when kernel runs in blocks of threads threads on the current
// device: the resident warps share the buckets in contiguous runs of at
// least kRunMin.
inline cudaError_t run_length(ResidentWarps& table, const void* kernel, int threads, int nb,
                              long long* run, long long* warps) {
  long long resident = 0;
  const cudaError_t e = warps_resident(table, kernel, threads, &resident);
  if (e != cudaSuccess) return e;
  long long r = (nb + resident - 1) / resident;
  if (r < kRunMin) r = kRunMin;
  *run = r;
  *warps = (nb + r - 1) / r;
  return cudaSuccess;
}

}  // namespace flix
