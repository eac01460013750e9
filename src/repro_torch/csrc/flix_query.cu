// flix_query: flipped point queries of FliX for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flix_query.py:_query_kernel (with its
// one-hot MXU gather _exact_gather_i32), launched by flix_point_query_pallas.
//
// One warp per bucket, eight buckets per block.  The warp finds its slice of
// the sorted queries by binary search of its two fences (the paper's flipped
// routing); a bucket with no queries exits at once.  For each query of the
// slice it votes: the node is the popcount of a ballot over node_max < q,
// the position the popcount of a ballot over the node's keys < q, and one
// lane writes the value or NOT_FOUND.  Each query belongs to exactly one
// bucket, so no output is written twice.  Queries above the last fence
// belong to no bucket; the wrapper fills them with NOT_FOUND first.  The
// TPU kernel's (window, bucket-block) grid with clamped scalar prefetch and
// its one-hot gathers have no counterpart: the warp reads the rows it needs.
//
// Bound on the card: bytes.  Each query read once and each result written
// once (8 bytes a query), the fences, and for the buckets and nodes that
// these queries touch their node_max rows, node key rows and the values of
// the hits.  At the main path's shapes (2^24 sorted queries on 2^20 buckets
// of 16 x 32 slots) that is 0.27-0.45 GB (all-miss to all-hit), 0.08-0.13
// ms at 3.35 TB/s; chip_smoke.py computes it from each run's queries.  The design reads each
// touched row from device memory once per warp and lets the queries of one
// bucket hit it in L1; the two routing searches per bucket are its extra
// cost.
#include <cuda_runtime.h>

#include "flix_phases.cuh"

namespace {

using namespace flix;

constexpr int kThreads = 256;  // 8 warps: 8 buckets per block

__global__ void flix_query_kernel(const int* __restrict__ keys,
                                  const int* __restrict__ vals,
                                  const int* __restrict__ node_max,
                                  const int* __restrict__ mkba,
                                  const int* __restrict__ q, int* __restrict__ out,
                                  int nq, int nb, int npb, int ns) {
  const int b = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= nb) return;  // a whole warp leaves together
  const int2 sl = warp_bucket_slice(mkba, b, q, nq, lane);
  if (sl.x >= sl.y) return;  // a bucket with no queries terminates at once
  const size_t S = (size_t)npb * ns;
  const int* kb = keys + b * S;
  const int* vb = vals + b * S;
  const int* mb = node_max + (size_t)b * npb;
  for (int i = sl.x; i < sl.y; ++i) {
    const int x = q[i];
    const WarpLocated l = warp_locate(kb, mb, npb, ns, x, lane);
    if (lane == 0) {
      const size_t at = (size_t)l.node * ns + l.pos;
      out[i] = l.raw_pos < ns && kb[at] == x ? vb[at] : kMiss;
    }
  }
}

}  // namespace

extern "C" {

int flix_query_launch(const int* keys, const int* vals, const int* node_max,
                      const int* mkba, const int* q, int* out, int nq, int nb, int npb,
                      int ns, void* stream) {
  if (nq == 0 || nb == 0) return 0;
  const long long threads = (long long)nb * 32;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  flix_query_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      keys, vals, node_max, mkba, q, out, nq, nb, npb, ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
