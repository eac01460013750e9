// flix_range: the dense RANGE scans of FliX for Hopper (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/flix_range.py, run by
// flix_range_pallas: _range_count_kernel (pass 1) and _range_scatter_kernel
// (pass 2).  Two kernels here:
//
//   flix_range_count_kernel  one thread per RANGE op.  It finds the global
//                            rank (stored keys below the bound) of lo and
//                            of hi: a binary search of the fences for the
//                            owning bucket, whose live-count prefix pref[b]
//                            is the rank of its first key; the counts of
//                            the bucket's nodes whose max lies below the
//                            bound; a binary search of the first node that
//                            reaches it.  Keys are packed at the front of
//                            each node and chain-ordered (I1/I2), so no
//                            per-bucket row sort is needed: the TPU wrapper
//                            sorted every bucket row (O(nb x cap)) and its
//                            kernel had every stripe vote on every op
//                            window.  Writes rank(lo) and the exact count
//                            max(rank(hi) - rank(lo), 0) of keys in [lo, hi).
//   flix_range_gather_kernel one thread per dense output slot: finds the
//                            bucket that owns the slot's global rank by
//                            binary search of pref, then the node by the
//                            running node counts, and reads the key and
//                            value.  The second pass of the standalone scan
//                            and the RANGE phase of the fused apply path
//                            (where the TPU kernel made every block scan
//                            all max_results slots).
//
// Bound on the card: bytes, and both kernels are far from it at the
// phase-7 shapes: each op or slot costs a few dependent loads (fence
// search, node rows), so they are latency-bound.  Pass 1 must read each
// op's bounds and the two fences that place each bound, write its rank and
// count, and read once per bucket it touches the pref entry and the
// node_max and node_count rows, and once per node row the keys; pass 2 must
// read each slot's rank, write its key and value, read one key and value
// per valid slot, and once per bucket it touches the pref entry and the
// node_count row.
#include <cuda_runtime.h>

#include "flix_phases.cuh"

namespace {

using namespace flix;

// Global rank (stored keys below q) of q in a state that holds I1-I4:
// repro_torch/core/query.py node_rank.
__device__ __forceinline__ int node_rank(const int* __restrict__ keys,
                                         const int* __restrict__ node_count,
                                         const int* __restrict__ node_max,
                                         const int* __restrict__ mkba,
                                         const int* __restrict__ pref, int nb, int npb,
                                         int ns, int q) {
  const int b = min(lower_bound(mkba, nb, q), nb - 1);
  const int* nmax = node_max + (size_t)b * npb;
  const int* cnt = node_count + (size_t)b * npb;
  int nidx = 0, before = 0;
  for (int j = 0; j < npb; ++j) {
    if (nmax[j] < q) {
      ++nidx;
      before += cnt[j];
    }
  }
  const int pos =
      nidx < npb ? lower_bound(keys + ((size_t)b * npb + nidx) * ns, ns, q) : 0;
  return pref[b] + before + pos;
}

__global__ void flix_range_count_kernel(
    const int* __restrict__ keys, const int* __restrict__ node_count,
    const int* __restrict__ node_max, const int* __restrict__ mkba,
    const int* __restrict__ pref, const int* __restrict__ lo, const int* __restrict__ hi,
    int* __restrict__ rank_lo, int* __restrict__ count, int q, int nb, int npb, int ns) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const int rl = node_rank(keys, node_count, node_max, mkba, pref, nb, npb, ns, lo[i]);
  const int rh = node_rank(keys, node_count, node_max, mkba, pref, nb, npb, ns, hi[i]);
  rank_lo[i] = rl;
  count[i] = max(rh - rl, 0);
}

__global__ void flix_range_gather_kernel(const int* __restrict__ g,
                                         const int* __restrict__ pref,
                                         const int* __restrict__ node_count,
                                         const int* __restrict__ keys,
                                         const int* __restrict__ vals,
                                         int* __restrict__ rk, int* __restrict__ rv,
                                         int max_results, int nb, int npb, int ns) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= max_results) return;
  const int gg = g[p];
  if (gg < 0) {
    rk[p] = kEmpty;
    rv[p] = kMiss;
    return;
  }
  const int b = min(max(upper_bound(pref, nb + 1, gg) - 1, 0), nb - 1);
  const int r = gg - pref[b];
  const int* cnt = node_count + (size_t)b * npb;
  // node = number of nodes whose inclusive count prefix is <= r
  int node = npb - 1, before = 0;
  for (int j = 0; j < npb; ++j) {
    const int c = cnt[j];
    if (before + c > r) {
      node = j;
      break;
    }
    if (j + 1 < npb) before += c;
  }
  const int pos = min(max(r - before, 0), ns - 1);
  const size_t at = (size_t)b * npb * ns + (size_t)node * ns + pos;
  rk[p] = keys[at];
  rv[p] = vals[at];
}

}  // namespace

extern "C" {

int flix_range_count_launch(const int* keys, const int* node_count, const int* node_max,
                            const int* mkba, const int* pref, const int* lo, const int* hi,
                            int* rank_lo, int* count, int q, int nb, int npb, int ns,
                            void* stream) {
  const int threads = 256;
  const int blocks = (q + threads - 1) / threads;
  if (blocks == 0) return 0;
  flix_range_count_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      keys, node_count, node_max, mkba, pref, lo, hi, rank_lo, count, q, nb, npb, ns);
  return (int)cudaGetLastError();
}

int flix_range_gather_launch(const int* g, const int* pref, const int* node_count,
                             const int* keys, const int* vals, int* rk, int* rv,
                             int max_results, int nb, int npb, int ns, void* stream) {
  const int threads = 256;
  const int blocks = (max_results + threads - 1) / threads;
  if (blocks == 0) return 0;
  flix_range_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, pref, node_count, keys, vals, rk, rv, max_results, nb, npb, ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
