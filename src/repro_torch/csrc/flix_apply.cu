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
// valid for a restructure-and-retry), so it reads every stripe once and
// writes every stripe once: at the main path's geometry (2^20 buckets of
// 16 nodes x 32 keys, int32 keys and vals) that is 4.29 GB read + 4.29 GB
// written, plus ~0.27 GB of node metadata, slices and per-op results, about
// 8.85 GB or 2.64 ms at 3.35 TB/s.  The design keeps the stripe in shared
// memory for the whole merge / delete / read sequence, so each stripe byte
// crosses device memory exactly once each way; loads and stores are
// coalesced along the stripe.  There are no per-bucket [nb, cap] tiles: a
// block reads its insert and delete slices straight from the compacted
// batch, and a bucket with no work in the batch costs its copy plus two
// block scans.
#include <cuda_runtime.h>

#include "flix_phases.cuh"

namespace {

using namespace flix;

// Shared-memory ints the apply kernel needs for one bucket.
__host__ __device__ inline int apply_smem_ints(int npb, int ns) {
  const int S = npb * ns;
  // stripe k/v, insert slice k/v, kept keys, merged k/v, scan, 7 node rows,
  // warp buffer, scalars
  return 2 * S + 2 * S + S + 2 * S + (S + 1) + 7 * npb + 32 + 8;
}

inline int threads_for(int S) {
  const int t = ((S + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

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
  const int cap = S;
  const int b = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;

  int* sA = smem;          // [S] stripe keys (chain order); later the result
  int* sAv = sA + S;       // [S]
  int* sB = sAv + S;       // [cap] the bucket's insert slice (sorted)
  int* sBv = sB + cap;     // [cap]
  int* sK = sBv + cap;     // [S] kept stripe keys, compacted (sorted)
  int* sM = sK + S;        // [S] merged stripe
  int* sMv = sM + S;       // [S]
  int* sX = sMv + S;       // [S+1] scan buffer
  int* sNmax = sX + S + 1; // [npb] input node max; later the output's
  int* sMj = sNmax + npb;  // [npb] keys per original region
  int* sSj = sMj + npb;    // [npb] pieces per region
  int* sFj = sSj + npb;    // [npb] first merged rank of region
  int* sBase = sFj + npb;  // [npb] first output slot of region
  int* sSlot = sBase + npb;  // [npb] node's slot after chain compaction
  int* sCnt = sSlot + npb;   // [npb] output node counts
  int* sWarp = sCnt + npb;   // [32]
  int* sScalar = sWarp + 32; // onn0, total_new, deleted, onn_new

  const size_t base = (size_t)b * S;
  const size_t mbase = (size_t)b * npb;

  if (t < 4) sScalar[t] = 0;
  __syncthreads();

  // ---- load: stripe, node max row, insert slice ----------------------
  for (int i = t; i < S; i += T) {
    sA[i] = keys[base + i];
    sAv[i] = vals[base + i];
    sM[i] = kEmpty;
    sMv[i] = 0;
  }
  const int is = ins_starts[b];
  const int m = min(max(ins_ends[b] - is, 0), cap);
  for (int j = t; j < m; j += T) {
    sB[j] = ins_keys[is + j];
    sBv[j] = ins_vals[is + j];
  }
  for (int j = t; j < npb; j += T) {
    const int x = node_max[mbase + j];
    sNmax[j] = x;
    sMj[j] = 0;
    if (x != kEmpty) atomicAdd(&sScalar[0], 1);
  }
  __syncthreads();

  // ---- merge: stripe keys not upserted, ranked by a block scan ---------
  for (int i = t; i < S; i += T) {
    const int a = sA[i];
    int keep = 0;
    if (a != kEmpty) {
      const int p = lower_bound(sB, m, a);
      keep = !(p < m && sB[p] == a);  // the incoming value wins
    }
    sX[i] = keep;
  }
  __syncthreads();
  block_exclusive_scan(sX, S, sWarp);  // sX[i] = kept keys before slot i
  const int nK = sX[S];
  const int onn_c = max(sScalar[0] - 1, 0);

  for (int i = t; i < S; i += T) {
    if (sX[i + 1] != sX[i]) {
      const int a = sA[i];
      sK[sX[i]] = a;
      atomicAdd(&sMj[region_of(sNmax, npb, onn_c, a)], 1);
    }
  }
  for (int j = t; j < m; j += T) atomicAdd(&sMj[region_of(sNmax, npb, onn_c, sB[j])], 1);
  __syncthreads();

  if (t == 0) {
    int f = 0, slot = 0;
    for (int j = 0; j < npb; ++j) {
      const int mj = sMj[j];
      const int sj = (mj + ns - 1) / ns;
      sSj[j] = sj;
      sFj[j] = f;
      sBase[j] = slot;
      f += mj;
      slot += sj;
    }
    sScalar[1] = slot;  // total pieces: > npb means the bucket overflowed
  }
  __syncthreads();

  for (int i = t; i < S; i += T) {
    if (sX[i + 1] != sX[i]) {
      const int a = sA[i];
      const int rank = sX[i] + lower_bound(sB, m, a);
      const int d = chunk_dest(rank, region_of(sNmax, npb, onn_c, a), sMj, sSj, sFj,
                               sBase, npb, ns);
      if (d < S) {
        sM[d] = a;
        sMv[d] = sAv[i];
      }
    }
  }
  for (int j = t; j < m; j += T) {
    const int k = sB[j];
    const int rank = lower_bound(sK, nK, k) + j;
    const int d = chunk_dest(rank, region_of(sNmax, npb, onn_c, k), sMj, sSj, sFj,
                             sBase, npb, ns);
    if (d < S) {
      sM[d] = k;
      sMv[d] = sBv[j];
    }
  }
  __syncthreads();

  // ---- delete: mark hits in the bucket's delete slice, compact ---------
  const int ds = del_starts[b], dn = max(del_ends[b] - ds, 0);
  const int* dk = del_keys + ds;
  for (int i = t; i < S; i += T) {
    const int k = sM[i];
    int keep = 0;
    if (k != kEmpty) {
      const int p = lower_bound(dk, dn, k);
      const bool hit = p < dn && dk[p] == k;
      if (hit) atomicAdd(&sScalar[2], 1);
      keep = !hit;
    }
    sX[i] = keep;
  }
  __syncthreads();
  block_exclusive_scan(sX, S, sWarp);  // survivors before each slot

  if (t == 0) {
    int slot = 0;
    for (int j = 0; j < npb; ++j) {
      const int c = sX[(j + 1) * ns] - sX[j * ns];
      sSlot[j] = slot;
      if (c > 0) sCnt[slot++] = c;  // non-empty nodes keep chain order
    }
    for (int j = slot; j < npb; ++j) sCnt[j] = 0;
    sScalar[3] = slot;
  }
  for (int i = t; i < S; i += T) {
    sA[i] = kEmpty;
    sAv[i] = 0;
  }
  __syncthreads();
  for (int i = t; i < S; i += T) {
    if (sX[i + 1] != sX[i]) {
      const int j = i / ns;
      const int d = sSlot[j] * ns + (sX[i] - sX[j * ns]);
      sA[d] = sM[i];
      sAv[d] = sMv[i];
    }
  }
  __syncthreads();

  // ---- write the post-update stripe and its metadata --------------------
  for (int j = t; j < npb; j += T) {
    const int c = sCnt[j];
    const int mx = c > 0 ? sA[j * ns + c - 1] : kEmpty;
    sNmax[j] = mx;
    count_out[mbase + j] = c;
    max_out[mbase + j] = mx;
  }
  for (int i = t; i < S; i += T) {
    keys_out[base + i] = sA[i];
    vals_out[base + i] = sAv[i];
  }
  if (t == 0) {
    nn_out[b] = sScalar[3];
    flow_out[b] = sScalar[1] > npb;
    del_out[b] = sScalar[2];
  }
  __syncthreads();

  // ---- reads of the bucket's op slice against the post-update stripe ----
  // Each op belongs to at most one bucket, so these writes never race.
  // SUCCESSOR ops with no in-bucket candidate keep (EMPTY, NOT_FOUND); the
  // wrapper resolves them from the post-update fence rows.
  const int nn = sScalar[3];
  for (int i = op_starts[b] + t; i < op_ends[b]; i += T) {
    const int tg = op_tag[i];
    if (tg != kOpPoint && tg != kOpSuccessor) continue;
    const int q = op_key[i];
    const Located l = locate(sA, sNmax, nn, npb, ns, q);
    const int at = l.node * ns + l.pos;
    const bool use_in = l.in_bucket && l.raw_pos < ns;
    if (tg == kOpPoint) {
      value_out[i] = use_in && sA[at] == q ? sAv[at] : kMiss;
    } else if (use_in) {
      succ_out[i] = sA[at];
      value_out[i] = sAv[at];
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
  return apply_smem_ints(npb, ns) * (int)sizeof(int);
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
  flix_apply_kernel<<<nb, threads_for(npb * ns), smem, (cudaStream_t)stream>>>(
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
