// flix_successor: flipped successor queries of FliX for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flix_successor.py:_successor_kernel,
// launched by flix_successor_pallas.  Its fence rows next_key / next_val
// come from the fence-row kernel (flix_fence_rows.cu), as the Pallas
// wrapper computes them beside its kernel.
//
// The mapping of flix_query.cu, on the pieces of flix_runs.cuh: persistent
// warps, a run of at least kRunMin buckets each, as many warps as the card
// keeps resident.  Each warp routes once, by one warp-cooperative 32-ary
// search of the sorted queries for the first query above its run's lower
// fence, then walks its queries in windows of 32, lane l taking query p + l,
// against the run's fences held 32 at a time in lanes; the lanes whose
// query lies past the group end the window, so every query is answered
// once, by the warp that owns its bucket.  Each lane answers its own query
// with the formulas of ref.flix_successor_ref: in one pass over its
// bucket's node_max row (16-byte loads where the row is aligned), nidx =
// the entries below q and n_active = the entries that are not EMPTY; where
// nidx < n_active, pos = the keys below q in node nidx; the in-bucket answer
// (key and value at pos) holds where pos < ns, else the bucket's fence row
// (next_key[b], next_val[b]): the smallest key stored in a later bucket.
// The value is NOT_FOUND wherever the key is EMPTY.  The next window's
// queries and the next group's fences are loaded before the current window
// is answered, and each window's results leave in one coalesced store per
// array.  The run that holds the last bucket also answers the queries above
// the last fence (only EMPTY when the fences end at MAX_VALID) with (EMPTY,
// NOT_FOUND), so the kernel writes every output.  The TPU kernel's (window,
// bucket-block) grid with clamped scalar prefetch has no counterpart.
//
// Bound on the card: bytes.  Each query read once and each result pair
// written once (12 bytes a query), the fences, the fence rows of the
// buckets whose queries fall past their last key, and for the buckets and
// nodes that these queries touch their node_max rows, node key rows and the
// values of the in-bucket answers.  At the main path's shapes (2^22 uniform
// queries on 2^20 buckets of 16 x 32 slots) that is 0.26-0.31 GB, 0.08-0.09
// ms at 3.35 TB/s; chip_smoke.py computes it from each run's queries.
#include <cuda_runtime.h>

#include "flix_runs.cuh"

namespace {

using namespace flix;

constexpr int kThreads = 256;  // 8 warps a block

// (entries of row[0, n) below x, entries that are not EMPTY), read by one
// lane in one pass: 16-byte loads when vec (the row 16-byte aligned and n a
// multiple of 4).
__device__ __forceinline__ int2 count_below_active(const int* __restrict__ row, int n, int x,
                                                   bool vec) {
  int c = 0, a = 0;
  if (vec) {
    const int4* r4 = reinterpret_cast<const int4*>(row);
#pragma unroll 8
    for (int j = 0; j < n / 4; ++j) {
      const int4 v = __ldg(r4 + j);
      c += (v.x < x) + (v.y < x) + (v.z < x) + (v.w < x);
      a += (v.x != kEmpty) + (v.y != kEmpty) + (v.z != kEmpty) + (v.w != kEmpty);
    }
  } else {
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const int v = __ldg(row + j);
      c += v < x;
      a += v != kEmpty;
    }
  }
  return make_int2(c, a);
}

__global__ void __launch_bounds__(kThreads)
    flix_successor_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
                          const int* __restrict__ node_max, const int* __restrict__ mkba,
                          const int* __restrict__ next_key, const int* __restrict__ next_val,
                          const int* __restrict__ q, int* __restrict__ out_key,
                          int* __restrict__ out_val, int nq, int nb, int npb, int ns,
                          int run) {
  const int lane = threadIdx.x & 31;
  const long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  // a whole warp leaves together; warp 0 stays when there are no buckets,
  // to answer every query with (EMPTY, NOT_FOUND)
  if (w > 0 && w * run >= nb) return;
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
    // the last fence (no successor); owners are a prefix of the window
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
      int k = kEmpty, v = kMiss;
      if (idx < gn) {
        const int b = g + idx;
        const int2 na = count_below_active(node_max + (size_t)b * npb, npb, x, vec_n);
        int pos = ns;
        size_t row = 0;
        if (na.x < na.y) {  // nidx < n_active <= npb: the node is nidx
          row = ((size_t)b * npb + na.x) * ns;
          pos = count_below(keys + row, ns, x, vec_s);
        }
        if (pos < ns) {
          k = __ldg(keys + row + pos);
          v = __ldg(vals + row + pos);
        } else {
          k = __ldg(next_key + b);
          v = __ldg(next_val + b);
        }
        if (k == kEmpty) v = kMiss;
      }
      out_key[p + lane] = k;
      out_val[p + lane] = v;
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

ResidentWarps resident_warps;  // of flix_successor_kernel

}  // namespace

extern "C" {

int flix_successor_launch(const int* keys, const int* vals, const int* node_max,
                          const int* mkba, const int* next_key, const int* next_val,
                          const int* q, int* out_key, int* out_val, int nq, int nb,
                          int npb, int ns, void* stream) {
  if (nq == 0) return 0;
  long long run = 0, warps = 0;
  const cudaError_t e = run_length(resident_warps, (const void*)flix_successor_kernel,
                                   kThreads, nb, &run, &warps);
  if (e != cudaSuccess) return (int)e;
  if (warps < 1) warps = 1;  // no buckets: warp 0 answers every query
  const int blocks = (int)((warps + kThreads / 32 - 1) / (kThreads / 32));
  flix_successor_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      keys, vals, node_max, mkba, next_key, next_val, q, out_key, out_val, nq, nb, npb, ns,
      (int)run);
  return (int)cudaGetLastError();
}

}  // extern "C"
