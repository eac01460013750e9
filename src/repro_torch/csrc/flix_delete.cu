// flix_delete: TL-Bulk deletion of FliX for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flix_delete.py:_delete_kernel (with
// its one-hot _reposition), launched by flix_delete_pallas.
//
// One thread block per bucket, its stripe in shared memory.  The wrapper
// keeps the TPU wrapper's pre-filter: the batch is cut to the keys a point
// query finds and re-sorted with EMPTY in place of the rest.  The block finds
// its slice of that batch by binary search of its two fences and keeps its
// first cap = npb * ns entries (the cut of repro/core/batch.py
// gather_sublists), so the TPU wrapper's [nb, cap] delete tile does not
// exist here.  Then the phases of flix_phases.cuh shared with flix_apply:
// each stored key is marked by a binary search of the slice, one block scan
// gives every survivor its in-node position and every surviving node its
// chain slot, and the block writes the compacted stripe (freed slots hold
// EMPTY and value 0) with its node metadata.  The pass is functional.
//
// Bound on the card: bytes.  The pass must write every stripe whole, but of
// the old stripe it needs only the node rows that hold keys, which node_max
// marks.  At the Fig. 9 geometry (2^20 buckets of 16 nodes x 32 keys, int32
// keys and vals, 16-40 keys a bucket in 1-2 nodes) that is 4.29 GB written
// and ~0.3-0.5 GB of rows read, plus node_max read, the node_count /
// node_max rows and num_nodes written, the fences and the batch (4 bytes a
// key): ~4.9-5.1 GB, ~1.5 ms at 3.35 TB/s.  This block copies its whole
// stripe into shared memory, empty rows included (8.6 GB moved in all), so
// it cannot come nearer than ~1.7x that bound.  Loads and stores are
// coalesced along the stripe.
#include <cuda_runtime.h>

#include "flix_phases.cuh"

namespace {

using namespace flix;

__global__ void flix_delete_kernel(const int* __restrict__ keys,
                                   const int* __restrict__ vals,
                                   const int* __restrict__ mkba,
                                   const int* __restrict__ del_keys, int n,
                                   int* __restrict__ keys_out, int* __restrict__ vals_out,
                                   int* __restrict__ count_out, int* __restrict__ max_out,
                                   int* __restrict__ nn_out, int npb, int ns) {
  extern __shared__ int smem[];
  const int S = npb * ns;
  const int b = blockIdx.x;
  const Stripe s = carve_delete(smem, npb, ns);

  if (threadIdx.x == 0) {
    const int2 sl = bucket_slice(mkba, b, del_keys, n);
    s.Scalar[4] = sl.x;
    s.Scalar[5] = min(sl.y - sl.x, S);  // the slice cut at cap
  }
  load_stripe(s, keys, vals, nullptr, b, npb, ns);  // its barriers publish the slice
  mark_deletes(s, s.A, del_keys + s.Scalar[4], s.Scalar[5], S);
  compact_phase(s, s.A, s.Av, s.M, s.Mv, npb, ns, S);
  write_stripe(s, s.M, s.Mv, keys_out, vals_out, count_out, max_out, nn_out, b, npb, ns);
}

}  // namespace

extern "C" {

// Dynamic shared memory one delete block needs for a (npb, ns) geometry.
int flix_delete_smem_bytes(int npb, int ns) {
  return delete_smem_ints(npb, ns) * (int)sizeof(int);
}

int flix_delete_launch(const int* keys, const int* vals, const int* mkba,
                       const int* del_keys, int* keys_out, int* vals_out, int* count_out,
                       int* max_out, int* nn_out, int n, int nb, int npb, int ns,
                       void* stream) {
  if (nb == 0) return 0;
  const int smem = flix_delete_smem_bytes(npb, ns);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flix_delete_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  flix_delete_kernel<<<nb, stripe_threads(npb * ns), smem, (cudaStream_t)stream>>>(
      keys, vals, mkba, del_keys, n, keys_out, vals_out, count_out, max_out, nn_out, npb,
      ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
