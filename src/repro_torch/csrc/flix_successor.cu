// flix_successor: flipped successor queries of FliX for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flix_successor.py:_successor_kernel,
// launched by flix_successor_pallas.
//
// The same mapping as flix_query.cu: one warp per bucket, eight buckets per
// block, the warp's slice of the sorted queries found by binary search of
// its fences, and an early exit for a bucket with no queries.  For each
// query the warp votes the in-bucket candidate (node by node_max ballots,
// position by key ballots, active nodes by a ballot over node_max != EMPTY)
// and takes it when the query is at or below the bucket's largest key;
// otherwise it takes the bucket's fence row next_key/next_val, the smallest
// key stored in any later bucket, which the wrapper computes with one O(nb)
// suffix-min pass.  Queries above the last fence belong to no bucket; the
// wrapper fills them with (EMPTY, NOT_FOUND) first.
//
// Bound on the card: bytes.  Each query read once and each result pair
// written once (12 bytes a query), the fences, the fence rows of the
// buckets whose queries fall past their last key, and for the buckets and
// nodes that these queries touch their node_max rows, node key rows and the
// values of the in-bucket answers.  At the main path's shapes (2^22 uniform
// queries on 2^20 buckets of 16 x 32 slots) that is 0.26-0.31 GB, 0.08-0.09
// ms at 3.35 TB/s; chip_smoke.py computes it from each run's queries.
#include <cuda_runtime.h>

#include "flix_phases.cuh"

namespace {

using namespace flix;

constexpr int kThreads = 256;  // 8 warps: 8 buckets per block

__global__ void flix_successor_kernel(
    const int* __restrict__ keys, const int* __restrict__ vals,
    const int* __restrict__ node_max, const int* __restrict__ mkba,
    const int* __restrict__ next_key, const int* __restrict__ next_val,
    const int* __restrict__ q, int* __restrict__ out_key, int* __restrict__ out_val,
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
  const int n_active = warp_count_active(mb, npb, lane);
  for (int i = sl.x; i < sl.y; ++i) {
    const int x = q[i];
    const WarpLocated l = warp_locate(kb, mb, npb, ns, x, lane);
    if (lane == 0) {
      int sk, sv;
      if (l.nidx < n_active && l.raw_pos < ns) {
        const size_t at = (size_t)l.node * ns + l.pos;
        sk = kb[at];
        sv = vb[at];
      } else {
        sk = next_key[b];
        sv = next_val[b];
      }
      out_key[i] = sk;
      out_val[i] = sk != kEmpty ? sv : kMiss;
    }
  }
}

}  // namespace

extern "C" {

int flix_successor_launch(const int* keys, const int* vals, const int* node_max,
                          const int* mkba, const int* next_key, const int* next_val,
                          const int* q, int* out_key, int* out_val, int nq, int nb,
                          int npb, int ns, void* stream) {
  if (nq == 0 || nb == 0) return 0;
  const long long threads = (long long)nb * 32;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  flix_successor_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      keys, vals, node_max, mkba, next_key, next_val, q, out_key, out_val, nq, nb, npb,
      ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
