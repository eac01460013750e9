// flix_query: flipped point queries of FliX for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flix_query.py:_query_kernel (with its
// one-hot MXU gather _exact_gather_i32), launched by flix_point_query_pallas.
//
// Persistent warps, a run of buckets each, a lane per query, on the pieces
// of flix_runs.cuh that the successor kernel shares.  The grid holds
// as many warps as the card keeps resident (the occupancy API times the SMs);
// warp w owns the contiguous buckets [w * run, (w + 1) * run), run at least
// kRunMin, so each warp routes once: one warp-cooperative 32-ary search of
// the sorted queries (32 pivots a round, a ballot narrows the range 32x:
// five dependent loads for 2^24 queries) finds the first query above the
// run's lower fence.  From there the warp walks its queries in windows of
// 32, lane l taking query p + l, against the run's fences held 32 at a time
// in lanes (a group).  Each lane finds its query's bucket by a binary search
// over the group's fences through shuffles; the lanes whose query lies past
// the group end the window, and the next window starts at the first of them,
// so every query is answered once, by the warp that owns its bucket, and a
// bucket's end is where the queries say it is.  Each lane then answers its
// own query as ref.flix_point_query_ref does: node = count of the bucket's
// node_max row below q (clamped to npb - 1), pos = count of that node's keys
// below q, a hit where pos < ns and the key at pos is q.  The counts read
// the rows through L1 in 16-byte loads where the rows are 16-byte aligned,
// all independent, so a window costs three dependent trips (node_max row,
// key row, value), and the next window's queries and the next group's
// fences are loaded before them.  The window's results go out in one
// coalesced store.  The run that holds the last bucket also answers the
// queries above the last fence (misses), so the kernel writes every output.
// The TPU kernel's (window, bucket-block) grid with clamped scalar prefetch
// and its one-hot gathers have no counterpart.
//
// Bound on the card: bytes.  Each query read once and each result written
// once (8 bytes a query), the fences, and for the buckets and nodes that
// these queries touch their node_max rows, node key rows and the values of
// the hits.  At the main path's shapes (2^24 sorted queries on 2^20 buckets
// of 16 x 32 slots) that is 0.27-0.45 GB (all-miss to all-hit), 0.08-0.13
// ms at 3.35 TB/s; chip_smoke.py computes it from each run's queries.
#include <cuda_runtime.h>

#include "flix_runs.cuh"

namespace {

using namespace flix;

constexpr int kThreads = 256;  // 8 warps a block

__global__ void __launch_bounds__(kThreads)
    flix_query_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
                      const int* __restrict__ node_max, const int* __restrict__ mkba,
                      const int* __restrict__ q, int* __restrict__ out, int nq, int nb,
                      int npb, int ns, int run) {
  const int lane = threadIdx.x & 31;
  const long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (w * run >= nb) return;  // a whole warp leaves together
  const int r0 = (int)(w * run), r1 = (int)min((long long)nb, w * run + run);
  const bool vec_n = (npb & 3) == 0 && (reinterpret_cast<uintptr_t>(node_max) & 15) == 0;
  const bool vec_s = (ns & 3) == 0 && (reinterpret_cast<uintptr_t>(keys) & 15) == 0;

  int p = r0 == 0 ? 0 : warp_upper_bound32(q, nq, mkba[r0 - 1], lane);
  int g = r0;  // first bucket of the fence group
  int fence = lane < r1 - g ? mkba[g + lane] : kEmpty;
  int x = p + lane < nq ? q[p + lane] : kEmpty;
  while (p < nq) {
    const int gn = min(32, r1 - g);
    const bool tail = g + gn == nb;  // the group holds the last bucket
    const int idx = fences_below(fence, x);
    // a lane answers its query when the query lies in the group, or past
    // the last fence (a miss); owners are a prefix of the sorted window
    const unsigned own_m = __ballot_sync(kFull, p + lane < nq && (idx < gn || tail));
    const int n_own = own_m == kFull ? 32 : __ffs(~own_m) - 1;
    const bool leave = n_own < 32;  // the group's queries end in this window
    // in flight while this window is answered: the next window, and the
    // next group's fences when this window leaves the group
    const int pn = p + n_own;
    const int xn = pn + lane < nq ? q[pn + lane] : kEmpty;
    int fn = fence;
    if (leave) fn = lane < r1 - g - 32 ? mkba[g + 32 + lane] : kEmpty;
    if (lane < n_own) {
      int v = kMiss;
      if (idx < gn) {
        const int b = g + idx;
        const int nidx = count_below(node_max + (size_t)b * npb, npb, x, vec_n);
        const size_t row = ((size_t)b * npb + min(nidx, npb - 1)) * ns;
        const int pos = count_below(keys + row, ns, x, vec_s);
        if (pos < ns && __ldg(keys + row + pos) == x) v = __ldg(vals + row + pos);
      }
      out[p + lane] = v;
    }
    p = pn;
    x = xn;
    if (leave) {
      g += 32;
      if (g >= r1) break;
      fence = fn;
    }
  }
}

ResidentWarps resident_warps;  // of flix_query_kernel

}  // namespace

extern "C" {

int flix_query_launch(const int* keys, const int* vals, const int* node_max,
                      const int* mkba, const int* q, int* out, int nq, int nb, int npb,
                      int ns, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (nq == 0) return 0;
  if (nb == 0) return (int)cudaMemsetAsync(out, 0xff, (size_t)nq * sizeof(int), s);  // all -1
  long long run = 0, warps = 0;
  const cudaError_t e = run_length(resident_warps, (const void*)flix_query_kernel, kThreads,
                                   nb, &run, &warps);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (int)((warps + kThreads / 32 - 1) / (kThreads / 32));
  flix_query_kernel<<<blocks, kThreads, 0, s>>>(keys, vals, node_max, mkba, q, out, nq, nb,
                                                npb, ns, (int)run);
  return (int)cudaGetLastError();
}

}  // extern "C"
