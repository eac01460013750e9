// flix_apply: the fused mixed-batch pass of FliX for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flix_apply.py:_stripe_body, run by
// _apply_kernel (one pl.pallas_call per batch).  Two launches here:
//
//   flix_apply_kernel        one thread block per bucket.  It pulls the
//                            bucket's slices of the sorted batch (the
//                            flipped routing: inserts, deletes, reads),
//                            upsert-merges the inserts with the
//                            original-node-region re-chunk, deletes with
//                            in-node and chain compaction, writes the new
//                            stripe and its metadata, and answers the
//                            bucket's POINT ops and in-bucket SUCCESSOR
//                            candidates against the post-update stripe.
//   flix_range_gather_kernel one thread per dense RANGE output slot: finds
//                            the bucket that owns the slot's global rank and
//                            reads the key from the stripe the first launch
//                            wrote.  (The TPU kernel made every block scan
//                            all max_results slots; that is nb x max_results
//                            work here.)
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

__global__ void flix_apply_kernel(
    const int* __restrict__ keys, const int* __restrict__ vals,
    const int* __restrict__ node_max, const int* __restrict__ ins_keys,
    const int* __restrict__ ins_vals, const int* __restrict__ ins_starts,
    const int* __restrict__ ins_ends, const int* __restrict__ del_keys,
    const int* __restrict__ del_starts, const int* __restrict__ del_ends,
    const int* __restrict__ op_tag, const int* __restrict__ op_key,
    const int* __restrict__ op_starts, const int* __restrict__ op_ends,
    int* __restrict__ keys_out, int* __restrict__ vals_out,
    int* __restrict__ count_out, int* __restrict__ max_out,
    int* __restrict__ nn_out, int* __restrict__ flow_out,
    int* __restrict__ del_out, int* __restrict__ value_out,
    int* __restrict__ succ_out, int npb, int ns) {
  extern __shared__ int smem[];
  const int S = npb * ns;
  const int b = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const Stripe s = carve_merge(smem, npb, ns);

  // ---- load: stripe, node max row, insert slice (cut at cap = S) --------
  load_stripe(s, keys, vals, node_max, b, npb, ns);
  const int is = ins_starts[b];
  const int m = min(max(ins_ends[b] - is, 0), S);
  load_insert_slice(s, ins_keys + is, ins_vals + is, m);

  // ---- merge, then delete: mark hits in the bucket's delete slice -------
  merge_phase(s, m, npb, ns);
  const int ds = del_starts[b], dn = max(del_ends[b] - ds, 0);
  mark_deletes(s, s.M, del_keys + ds, dn, S);
  compact_phase(s, s.M, s.Mv, s.A, s.Av, npb, ns);

  // ---- write the post-update stripe and its metadata --------------------
  write_stripe(s, s.A, s.Av, keys_out, vals_out, count_out, max_out, nn_out, b, npb, ns);
  if (t == 0) {
    flow_out[b] = s.Scalar[1] > npb;
    del_out[b] = s.Scalar[2];
  }

  // ---- reads of the bucket's op slice against the post-update stripe ----
  // Each op belongs to at most one bucket, so these writes never race.
  // SUCCESSOR ops with no in-bucket candidate keep (EMPTY, NOT_FOUND); the
  // wrapper resolves them from the post-update fence rows.
  const int nn = s.Scalar[3];
  for (int i = op_starts[b] + t; i < op_ends[b]; i += T) {
    const int tg = op_tag[i];
    if (tg != kOpPoint && tg != kOpSuccessor) continue;
    const int q = op_key[i];
    const Located l = locate(s.A, s.Nmax, nn, npb, ns, q);
    const int at = l.node * ns + l.pos;
    const bool use_in = l.in_bucket && l.raw_pos < ns;
    if (tg == kOpPoint) {
      value_out[i] = use_in && s.A[at] == q ? s.Av[at] : kMiss;
    } else if (use_in) {
      succ_out[i] = s.A[at];
      value_out[i] = s.Av[at];
    }
  }
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
  flix_apply_kernel<<<nb, stripe_threads(npb * ns), smem, (cudaStream_t)stream>>>(
      keys, vals, node_max, ins_keys, ins_vals, ins_starts, ins_ends, del_keys,
      del_starts, del_ends, op_tag, op_key, op_starts, op_ends, keys_out, vals_out,
      count_out, max_out, nn_out, flow_out, del_out, value_out, succ_out, npb, ns);
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
