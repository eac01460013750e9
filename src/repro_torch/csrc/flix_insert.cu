// flix_insert: TL-Bulk insertion of FliX for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flix_insert.py:_insert_kernel,
// launched by flix_insert_pallas.
//
// One thread block per bucket, its stripe in shared memory.  The block finds
// its slice of the sorted insert batch by binary search of its two fences and
// reads the first cap = npb * ns entries of it straight from the batch (the
// cut of repro/core/batch.py gather_kv_sublists), so the TPU wrapper's
// [nb, cap] key and value tiles do not exist here.  Then the merge phase of
// flix_phases.cuh, shared with flix_apply: the upsert merge (the incoming
// value wins), the balanced re-chunk of each original node region, and the
// overflow flag; the TPU kernel's O(S^2) compare-count masks and one-hot
// reposition are a block scan and binary searches here.  The block writes
// the new stripe (EMPTY keys carry value 0, as the TPU kernel writes them),
// its node metadata, and its overflow count: the pieces flag plus the
// slice's cut at cap.  The pass is functional, so the input state stays
// valid for a restructure-and-retry.
//
// Bound on the card: bytes.  The pass must write every stripe whole, but of
// the old stripe it needs only the node rows that hold keys, which node_max
// marks.  At the Fig. 9 geometry (2^20 buckets of 16 nodes x 32 keys, int32
// keys and vals, 16-40 keys a bucket in 1-2 nodes) that is 4.29 GB written
// and ~0.3-0.5 GB of rows read, plus node_max read, the node_count /
// node_max rows, num_nodes and overflow written, the fences and the batch
// (8 bytes a key): ~4.9-5.1 GB for a batch of 2^22 keys, ~1.5 ms at
// 3.35 TB/s.  This block copies its whole stripe into shared memory, empty
// rows included (8.6 GB moved in all), so it cannot come nearer than ~1.7x
// that bound.  Loads and stores are coalesced along the stripe.
#include <cuda_runtime.h>

#include "flix_phases.cuh"

namespace {

using namespace flix;

__global__ void flix_insert_kernel(
    const int* __restrict__ keys, const int* __restrict__ vals,
    const int* __restrict__ node_max, const int* __restrict__ mkba,
    const int* __restrict__ ins_keys, const int* __restrict__ ins_vals, int n,
    int* __restrict__ keys_out, int* __restrict__ vals_out, int* __restrict__ count_out,
    int* __restrict__ max_out, int* __restrict__ nn_out, int* __restrict__ flow_out,
    int npb, int ns) {
  extern __shared__ int smem[];
  const int S = npb * ns;
  const int b = blockIdx.x;
  const Stripe s = carve_merge(smem, npb, ns);

  if (threadIdx.x == 0) {
    const int2 sl = bucket_slice(mkba, b, ins_keys, n);
    s.Scalar[4] = sl.x;
    s.Scalar[5] = sl.y - sl.x;
  }
  load_stripe(s, keys, vals, node_max, b, npb, ns);  // its barriers publish the slice
  const int start = s.Scalar[4], true_count = s.Scalar[5];
  const int m = min(true_count, S);
  load_insert_slice(s, ins_keys + start, ins_vals + start, m);

  merge_phase(s, m, npb, ns);
  count_rows(s, s.M, npb, ns);
  write_stripe(s, s.M, s.Mv, keys_out, vals_out, count_out, max_out, nn_out, b, npb, ns);
  if (threadIdx.x == 0) flow_out[b] = (s.Scalar[1] > npb) + (true_count > S);
}

}  // namespace

extern "C" {

// Dynamic shared memory one insert block needs for a (npb, ns) geometry.
int flix_insert_smem_bytes(int npb, int ns) {
  return merge_smem_ints(npb, ns) * (int)sizeof(int);
}

int flix_insert_launch(const int* keys, const int* vals, const int* node_max,
                       const int* mkba, const int* ins_keys, const int* ins_vals,
                       int* keys_out, int* vals_out, int* count_out, int* max_out,
                       int* nn_out, int* flow_out, int n, int nb, int npb, int ns,
                       void* stream) {
  if (nb == 0) return 0;
  const int smem = flix_insert_smem_bytes(npb, ns);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flix_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  flix_insert_kernel<<<nb, stripe_threads(npb * ns), smem, (cudaStream_t)stream>>>(
      keys, vals, node_max, mkba, ins_keys, ins_vals, n, keys_out, vals_out, count_out,
      max_out, nn_out, flow_out, npb, ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
