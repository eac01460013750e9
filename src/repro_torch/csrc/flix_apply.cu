// flix_apply: the fused mixed-batch pass of FliX for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flix_apply.py:_stripe_body, run by
// _apply_kernel (one pl.pallas_call per batch).  flix_apply_kernel runs one
// thread block per bucket.  It pulls the bucket's slices of the sorted
// batch (the flipped routing: inserts, deletes, reads), upsert-merges the
// inserts with the original-node-region re-chunk, deletes with in-node and
// chain compaction, writes the new stripe and its metadata, and answers
// the bucket's POINT ops and in-bucket SUCCESSOR candidates against the
// post-update stripe (apply_bucket in flix_phases.cuh, shared with the
// staged kernel of flix_apply_staged.cu).  The dense RANGE output is the
// second launch, the gather of flix_range.cu.
//
// Bound on the card: bytes.  The pass is functional (the old state stays
// valid for a restructure-and-retry), so it writes every stripe whole, but
// of the old stripe it needs only the node rows that hold keys, which
// node_max marks.  At the main path's geometry (2^20 buckets of 16 nodes x
// 32 keys, int32 keys and vals, ~16 keys a bucket in one node) that is
// 4.29 GB written and ~0.27 GB of rows read, plus ~0.27 GB of node
// metadata, slices and per-op results: about 4.8 GB or 1.45 ms at
// 3.35 TB/s.  The design keeps the stripe in shared memory for the whole
// merge / delete / read sequence, so each stripe byte crosses device memory
// once each way; it copies empty rows too (8.85 GB moved in all), so it
// cannot come nearer than ~1.8x that bound.  Loads and stores are coalesced
// along the stripe.  There are no per-bucket [nb, cap] tiles: a
// block reads its insert and delete slices straight from the compacted
// batch, and a bucket with no work in the batch costs its copy plus two
// block scans.
#include <cuda_runtime.h>

#include "flix_phases.cuh"

namespace {

using namespace flix;

__global__ void __launch_bounds__(kStripeThreads, kStripeBlocksPerSm)
    flix_apply_kernel(const ApplyArgs a, int npb, int ns) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const Stripe s = carve_merge(smem, npb, ns);
  load_stripe(s, a.keys, a.vals, a.node_max, b, npb, ns);
  const Slices sl = {a.ins_starts[b], a.ins_ends[b], a.del_starts[b],
                     a.del_ends[b],   a.op_starts[b], a.op_ends[b]};
  apply_bucket(s, a, sl, b, npb, ns);
}

}  // namespace

extern "C" {

// Dynamic shared memory one apply block needs for a (npb, ns) geometry.
int flix_apply_smem_bytes(int npb, int ns) {
  return merge_smem_ints(npb, ns) * (int)sizeof(int);
}

// The most dynamic shared memory a block of the current device may opt in to.
int flix_smem_optin_bytes(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return bytes;
}

int flix_apply_launch(const int* keys, const int* vals, const int* node_max,
                      const int* ins_keys, const int* ins_vals, const int* ins_starts,
                      const int* ins_ends, const int* del_keys, const int* del_starts,
                      const int* del_ends, const int* op_tag, const int* op_key,
                      const int* op_starts, const int* op_ends, int* keys_out,
                      int* vals_out, int* count_out, int* max_out, int* nn_out,
                      int* flow_out, int* del_out, int* value_out, int* succ_out,
                      int nb, int npb, int ns, void* stream) {
  const int smem = flix_apply_smem_bytes(npb, ns);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flix_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const ApplyArgs a = {keys,      vals,       node_max,   ins_keys,  ins_vals, ins_starts,
                       ins_ends,  del_keys,   del_starts, del_ends,  op_tag,   op_key,
                       op_starts, op_ends,    keys_out,   vals_out,  count_out, max_out,
                       nn_out,    flow_out,   del_out,    value_out, succ_out};
  flix_apply_kernel<<<nb, stripe_threads(npb * ns), smem, (cudaStream_t)stream>>>(a, npb,
                                                                                    ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
