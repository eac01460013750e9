// Per-bucket phases of FliX, as device functions shared by the kernels.
//
// Two kinds of worker here:
//   * a thread block owns one bucket stripe in shared memory: the stripe
//     kernel of flix_apply.cu, and nothing else since the insert and delete
//     kernels became warp-per-bucket.  The block phases are the formulas of
//     the JAX reference (repro/kernels/flix_apply.py _stripe_body,
//     repro/kernels/flix_insert.py _insert_kernel, repro/kernels/flix_delete.py
//     _delete_kernel, repro/core/insert.py _merge_one_bucket) with the TPU's
//     O(S^2) compare-count masks replaced by block scans and binary searches,
//     which give the same ranks because every sequence searched here is
//     ascending;
//   * a warp owns one bucket and answers its slice of a sorted query batch
//     (flix_successor): node and in-node position are popcounts of warp
//     ballots, the paper's tile vote, and the warp finds its slice by binary
//     search of the bucket's fences (warp_bucket_slice), the flipped routing
//     of the paper done by the bucket itself.
// The staged stripe kernel and the insert and delete kernels
// (flix_apply_staged.cu, flix_insert.cu, flix_delete.cu) are a warp per
// bucket too; they run the stripe phases in the warp form of flix_warp.cuh
// and share only the per-element formulas here (region_of, chunk_dest,
// locate, lower_bound) and the ApplyArgs of the fused pass.  The point-query
// kernel (flix_query.cu) keeps its own device functions: a warp owns a run
// of buckets and answers a lane per query.
#pragma once

#include <cuda_runtime.h>

namespace flix {

constexpr int kEmpty = 0x7fffffff;  // empty slot / inactive node sentinel
constexpr int kMiss = -1;           // NOT_FOUND
constexpr int kOpPoint = 2;
constexpr int kOpSuccessor = 3;
constexpr unsigned kFull = 0xffffffffu;

// Number of entries of ascending a[0, n) strictly below x.
__device__ __forceinline__ int lower_bound(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Number of entries of ascending a[0, n) at or below x.
__device__ __forceinline__ int upper_bound(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// the flipped routing
// ---------------------------------------------------------------------------

// Bucket b's slice [start, end) of the ascending batch a[0, n): the entries
// in (mkba[b-1], mkba[b]] (bucket 0 has no lower fence), equal to
// repro/core/batch.py bucket_slices.  Two lanes of a warp search at once and
// broadcast to all 32 lanes; every lane of the warp must call it.
__device__ __forceinline__ int2 warp_bucket_slice(const int* mkba, int b, const int* a,
                                                  int n, int lane) {
  int x = 0;
  if (lane == 0) x = b == 0 ? 0 : upper_bound(a, n, mkba[b - 1]);
  if (lane == 1) x = upper_bound(a, n, mkba[b]);
  const int start = __shfl_sync(kFull, x, 0);
  const int end = __shfl_sync(kFull, x, 1);
  return make_int2(start, max(end, start));
}

// ---------------------------------------------------------------------------
// locate by ballot (one warp, any row width)
// ---------------------------------------------------------------------------

// Number of entries of row[0, n) below q: lane l votes for row[c + l] in
// each 32-wide chunk c, and lanes past n vote false.  Every lane of the
// warp must call it; all get the count.
__device__ __forceinline__ int warp_count_below(const int* row, int n, int q, int lane) {
  int c = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    c += __popc(__ballot_sync(kFull, j < n && row[j] < q));
  }
  return c;
}

// Number of entries of row[0, n) that are not EMPTY (active node slots of a
// node_max row), by the same ballots.
__device__ __forceinline__ int warp_count_active(const int* row, int n, int lane) {
  int c = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    c += __popc(__ballot_sync(kFull, j < n && row[j] != kEmpty));
  }
  return c;
}

// Where query q sits in a bucket, located by a warp: nidx = nodes whose max
// is below q (the node is nidx clamped to the last slot), raw_pos = keys of
// that node below q (pos is raw_pos clamped to the last lane).  Formulas of
// repro/kernels/ref.py flix_point_query_ref.
struct WarpLocated {
  int nidx, node, raw_pos, pos;
};

__device__ __forceinline__ WarpLocated warp_locate(const int* keys_b, const int* nmax_b,
                                                   int npb, int ns, int q, int lane) {
  WarpLocated l;
  l.nidx = warp_count_below(nmax_b, npb, q, lane);
  l.node = min(l.nidx, npb - 1);
  l.raw_pos = warp_count_below(keys_b + (size_t)l.node * ns, ns, q, lane);
  l.pos = min(l.raw_pos, ns - 1);
  return l;
}

// ---------------------------------------------------------------------------
// block-wide pieces of the stripe passes
// ---------------------------------------------------------------------------

// In-place exclusive scan of x[0, n) by the whole block; x[n] receives the
// total.  blockDim.x must be a multiple of 32; warp_buf holds 32 ints.
// Each thread scans one contiguous chunk, so any n works with any block.
// Up to kWarpScan entries the first warp scans alone, behind one barrier
// instead of three.
constexpr int kWarpScan = 128;
__device__ inline void block_exclusive_scan(int* x, int n, int* warp_buf) {
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  if (n <= kWarpScan) {
    if (warp == 0) {
      const int per = (n + 31) / 32;
      const int lo = min(lane * per, n), hi = min(lo + per, n);
      int local = 0;
      for (int i = lo; i < hi; ++i) local += x[i];
      int v = local;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += y;
      }
      int run = v - local;
      for (int i = lo; i < hi; ++i) {
        const int c = x[i];
        x[i] = run;
        run += c;
      }
      if (lane == 31) x[n] = v;
    }
    __syncthreads();
    return;
  }
  const int per = (n + T - 1) / T;
  const int lo = min(t * per, n), hi = min(lo + per, n);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += x[i];
  int v = local;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) warp_buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = T >> 5;
    int w = lane < nw ? warp_buf[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) warp_buf[lane] = w;
  }
  __syncthreads();
  int run = v - local + (warp ? warp_buf[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = x[i];
    x[i] = run;
    run += c;
  }
  if (t == T - 1) x[n] = run;
  __syncthreads();
}

// Region (original node) of key z: the first node whose max is >= z,
// clamped to the last active node (keys above it grow the last node).
__device__ __forceinline__ int region_of(const int* nmax, int npb, int onn_c, int z) {
  return min(lower_bound(nmax, npb, z), onn_c);
}

// Output slot of a merged element: the balanced re-chunk of its region into
// ceil(m_j / ns) pieces (repro/core/insert.py).  Returns S (dropped) when
// the bucket overflows its npb node slots.
__device__ __forceinline__ int chunk_dest(int rank, int r, const int* m_j, const int* s_j,
                                          const int* f_j, const int* base_j, int npb,
                                          int ns) {
  const int m_r = max(m_j[r], 1), s_r = max(s_j[r], 1);
  const int rr = rank - f_j[r];  // >= 0: regions are monotone in the key
  const int piece = (rr * s_r) / m_r;
  const int start = (piece * m_r + s_r - 1) / s_r;
  const int slot = base_j[r] + piece;
  return slot < npb ? slot * ns + (rr - start) : npb * ns;
}

// Shared-memory layout of one bucket's block stripe pass (flix_apply.cu).
struct Stripe {
  int* A;       // [S] stripe keys (chain order); apply: later the result
  int* Av;      // [S]
  int* B;       // [S] the bucket's insert slice (sorted), at most cap = S
  int* Bv;      // [S]
  int* K;       // [S] kept stripe keys, compacted (sorted)
  int* M;       // [S] merged stripe
  int* Mv;      // [S]
  int* X;       // [S+1] scan buffer
  int* Nmax;    // [npb] input node max; apply: later the output's
  int* Mj;      // [npb] keys per original region
  int* Sj;      // [npb] pieces per region
  int* Fj;      // [npb] first merged rank of region
  int* Base;    // [npb] first output slot of region
  int* Slot;    // [npb] node's slot after chain compaction
  int* Cnt;     // [npb] output node counts
  int* Warp;    // [32]
  int* Scalar;  // [8] onn0, total pieces, deleted, output num_nodes; 4-7 free
};

__host__ __device__ inline int merge_smem_ints(int npb, int ns) {
  const int S = npb * ns;
  return 2 * S + 2 * S + S + 2 * S + (S + 1) + 7 * npb + 32 + 8;
}

__device__ inline Stripe carve_merge(int* smem, int npb, int ns) {
  const int S = npb * ns;
  Stripe s;
  s.A = smem;
  s.Av = s.A + S;
  s.B = s.Av + S;
  s.Bv = s.B + S;
  s.K = s.Bv + S;
  s.M = s.K + S;
  s.Mv = s.M + S;
  s.X = s.Mv + S;
  s.Nmax = s.X + S + 1;
  s.Mj = s.Nmax + npb;
  s.Sj = s.Mj + npb;
  s.Fj = s.Sj + npb;
  s.Base = s.Fj + npb;
  s.Slot = s.Base + npb;
  s.Cnt = s.Slot + npb;
  s.Warp = s.Cnt + npb;
  s.Scalar = s.Warp + 32;
  return s;
}

// Threads per stripe block: one per slot up to 256.
constexpr int kStripeThreads = 256;
inline int stripe_threads(int S) {
  const int t = ((S + 31) / 32) * 32;
  return t < kStripeThreads ? t : kStripeThreads;
}

// Resident stripe blocks an SM should hold: with 256 threads that caps the
// block-per-bucket stripe kernel of flix_apply.cu at 32 registers a thread
// (__launch_bounds__).  The warp-per-bucket staged kernel has no such cap:
// the occupancy API sizes it from its shared memory.
constexpr int kStripeBlocksPerSm = 8;

// Load bucket b's stripe into A/Av and clear the merged stripe M/Mv.  With
// node_max given, also load Nmax, clear Mj and count the active nodes into
// Scalar[0].  Ends with a barrier.
__device__ inline void load_stripe(const Stripe& s, const int* __restrict__ keys,
                                   const int* __restrict__ vals,
                                   const int* __restrict__ node_max, int b, int npb,
                                   int ns) {
  const int S = npb * ns, t = threadIdx.x, T = blockDim.x;
  const size_t base = (size_t)b * S;
  if (t < 4) s.Scalar[t] = 0;
  __syncthreads();
  for (int i = t; i < S; i += T) {
    s.A[i] = keys[base + i];
    s.Av[i] = vals[base + i];
    s.M[i] = kEmpty;
    s.Mv[i] = 0;
  }
  if (node_max != nullptr) {
    const size_t mbase = (size_t)b * npb;
    for (int j = t; j < npb; j += T) {
      const int x = node_max[mbase + j];
      s.Nmax[j] = x;
      s.Mj[j] = 0;
      if (x != kEmpty) atomicAdd(&s.Scalar[0], 1);
    }
  }
  __syncthreads();
}

// Load the first m entries of an insert slice into B/Bv.  Ends with a
// barrier.
__device__ inline void load_insert_slice(const Stripe& s, const int* __restrict__ ik,
                                         const int* __restrict__ iv, int m) {
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    s.B[j] = ik[j];
    s.Bv[j] = iv[j];
  }
  __syncthreads();
}

// Upsert merge of the insert slice B[0, m) into the stripe A: stripe keys
// that reappear in B are dropped (the incoming value wins), each original
// node region is re-chunked into balanced pieces, and the result lands in
// M/Mv (EMPTY / 0 elsewhere).  Only the first Scalar[0] rows of A (the
// active nodes, packed first: I3/I4) are read.  Scalar[1] receives the
// number of pieces: more than npb means the bucket overflowed and the
// pieces past the last slot were dropped.  Ends with a barrier.
__device__ inline void merge_phase(const Stripe& s, int m, int npb, int ns) {
  const int S = npb * ns, t = threadIdx.x, T = blockDim.x;
  const int L = s.Scalar[0] * ns;  // the slots of A that may hold keys

  // stripe keys not upserted, ranked by a block scan
  for (int i = t; i < L; i += T) {
    const int a = s.A[i];
    int keep = 0;
    if (a != kEmpty) {
      const int p = lower_bound(s.B, m, a);
      keep = !(p < m && s.B[p] == a);  // the incoming value wins
    }
    s.X[i] = keep;
  }
  __syncthreads();
  block_exclusive_scan(s.X, L, s.Warp);  // X[i] = kept keys before slot i
  const int nK = s.X[L];
  const int onn_c = max(s.Scalar[0] - 1, 0);

  for (int i = t; i < L; i += T) {
    if (s.X[i + 1] != s.X[i]) {
      const int a = s.A[i];
      s.K[s.X[i]] = a;
      atomicAdd(&s.Mj[region_of(s.Nmax, npb, onn_c, a)], 1);
    }
  }
  for (int j = t; j < m; j += T) atomicAdd(&s.Mj[region_of(s.Nmax, npb, onn_c, s.B[j])], 1);
  __syncthreads();

  if (t == 0) {  // regions past onn_c receive no key
    int f = 0, slot = 0;
    for (int j = 0; j <= onn_c; ++j) {
      const int mj = s.Mj[j];
      const int sj = (mj + ns - 1) / ns;
      s.Sj[j] = sj;
      s.Fj[j] = f;
      s.Base[j] = slot;
      f += mj;
      slot += sj;
    }
    s.Scalar[1] = slot;
  }
  __syncthreads();

  for (int i = t; i < L; i += T) {
    if (s.X[i + 1] != s.X[i]) {
      const int a = s.A[i];
      const int rank = s.X[i] + lower_bound(s.B, m, a);
      const int d = chunk_dest(rank, region_of(s.Nmax, npb, onn_c, a), s.Mj, s.Sj, s.Fj,
                               s.Base, npb, ns);
      if (d < S) {
        s.M[d] = a;
        s.Mv[d] = s.Av[i];
      }
    }
  }
  for (int j = t; j < m; j += T) {
    const int k = s.B[j];
    const int rank = lower_bound(s.K, nK, k) + j;
    const int d = chunk_dest(rank, region_of(s.Nmax, npb, onn_c, k), s.Mj, s.Sj, s.Fj,
                             s.Base, npb, ns);
    if (d < S) {
      s.M[d] = k;
      s.Mv[d] = s.Bv[j];
    }
  }
  __syncthreads();
}

// The slots of the merged stripe M that may hold keys: its pieces, cut at
// the npb node slots.
__device__ __forceinline__ int merged_slots(const Stripe& s, int npb, int ns) {
  return min(s.Scalar[1], npb) * ns;
}

// Mark the stored keys of src[0, L) (the slots that may hold keys, a whole
// number of rows) that the delete slice dk[0, dn) (ascending) holds:
// X[i] = 1 for a survivor, 0 for a hit or an EMPTY slot; Scalar[2] counts
// the hits.  Ends with a barrier.
__device__ inline void mark_deletes(const Stripe& s, const int* src, const int* dk, int dn,
                                    int L) {
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int k = src[i];
    int keep = 0;
    if (k != kEmpty) {
      const int p = lower_bound(dk, dn, k);
      const bool hit = p < dn && dk[p] == k;
      if (hit) atomicAdd(&s.Scalar[2], 1);
      keep = !hit;
    }
    s.X[i] = keep;
  }
  __syncthreads();
}

// In-node and chain compaction of src/srcv by the survivor flags in
// X[0, L) (mark_deletes' L; the rows past it hold no key): survivors shift
// left inside their node, emptied nodes drop out of the chain, and the
// result lands in dst/dstv (EMPTY / 0 elsewhere).  Cnt receives the output
// node counts and Scalar[3] the output num_nodes.  Ends with a barrier.
__device__ inline void compact_phase(const Stripe& s, const int* src, const int* srcv,
                                     int* dst, int* dstv, int npb, int ns, int L) {
  const int S = npb * ns, t = threadIdx.x, T = blockDim.x;
  block_exclusive_scan(s.X, L, s.Warp);  // survivors before each slot
  if (t == 0) {
    int slot = 0;
    for (int j = 0; j < L / ns; ++j) {
      const int c = s.X[(j + 1) * ns] - s.X[j * ns];
      s.Slot[j] = slot;
      if (c > 0) s.Cnt[slot++] = c;  // non-empty nodes keep chain order
    }
    for (int j = slot; j < npb; ++j) s.Cnt[j] = 0;
    s.Scalar[3] = slot;
  }
  for (int i = t; i < S; i += T) {
    dst[i] = kEmpty;
    dstv[i] = 0;
  }
  __syncthreads();
  for (int i = t; i < L; i += T) {
    if (s.X[i + 1] != s.X[i]) {
      const int j = i / ns;
      const int d = s.Slot[j] * ns + (s.X[i] - s.X[j * ns]);
      dst[d] = src[i];
      dstv[d] = srcv[i];
    }
  }
  __syncthreads();
}

// Write a finished stripe src/srcv of bucket b and its metadata: node_count
// from Cnt, node_max = the last key of each non-empty node (also kept in
// Nmax when it is given), num_nodes from Scalar[3].  Ends with a barrier.
__device__ inline void write_stripe(const Stripe& s, const int* src, const int* srcv,
                                    int* __restrict__ keys_out, int* __restrict__ vals_out,
                                    int* __restrict__ count_out, int* __restrict__ max_out,
                                    int* __restrict__ nn_out, int b, int npb, int ns) {
  const int S = npb * ns, t = threadIdx.x, T = blockDim.x;
  const size_t base = (size_t)b * S, mbase = (size_t)b * npb;
  for (int j = t; j < npb; j += T) {
    const int c = s.Cnt[j];
    const int mx = c > 0 ? src[j * ns + c - 1] : kEmpty;
    if (s.Nmax != nullptr) s.Nmax[j] = mx;
    count_out[mbase + j] = c;
    max_out[mbase + j] = mx;
  }
  for (int i = t; i < S; i += T) {
    keys_out[base + i] = src[i];
    vals_out[base + i] = srcv[i];
  }
  if (t == 0) nn_out[b] = s.Scalar[3];
  __syncthreads();
}

// Where key q sits in a post-update stripe held by one thread: node = first
// node whose max is >= q, pos = its in-node position.  in_bucket is false
// when q is above every stored key of the bucket.
struct Located {
  int node, pos, raw_pos;
  bool in_bucket;
};

__device__ __forceinline__ Located locate(const int* keys, const int* nmax, int nn,
                                          int npb, int ns, int q) {
  const int nidx = lower_bound(nmax, npb, q);
  Located l;
  l.in_bucket = nidx < nn;
  l.node = min(nidx, npb - 1);
  l.raw_pos = lower_bound(keys + l.node * ns, ns, q);
  l.pos = min(l.raw_pos, ns - 1);
  return l;
}

// ---------------------------------------------------------------------------
// the fused mixed-batch pass of one bucket (flix_apply.cu's stripe kernel;
// the staged kernel takes the same ApplyArgs and computes the same function
// by warp)
// ---------------------------------------------------------------------------

// Inputs and outputs of a fused stripe pass: the pre-batch planes, the
// compacted insert and delete keys with their per-bucket slices, the sorted
// batch with its per-bucket op slices, and the per-bucket and per-op outputs.
struct ApplyArgs {
  const int* __restrict__ keys;
  const int* __restrict__ vals;
  const int* __restrict__ node_max;
  const int* __restrict__ ins_keys;
  const int* __restrict__ ins_vals;
  const int* __restrict__ ins_starts;
  const int* __restrict__ ins_ends;
  const int* __restrict__ del_keys;
  const int* __restrict__ del_starts;
  const int* __restrict__ del_ends;
  const int* __restrict__ op_tag;
  const int* __restrict__ op_key;
  const int* __restrict__ op_starts;
  const int* __restrict__ op_ends;
  int* __restrict__ keys_out;
  int* __restrict__ vals_out;
  int* __restrict__ count_out;
  int* __restrict__ max_out;
  int* __restrict__ nn_out;
  int* __restrict__ flow_out;
  int* __restrict__ del_out;
  int* __restrict__ value_out;
  int* __restrict__ succ_out;
};

// Per-bucket slice bounds of a fused pass: [start, end) of the bucket's
// inserts, deletes and ops in the compacted and sorted batch columns.
struct Slices {
  int ins_start, ins_end, del_start, del_end, op_start, op_end;
};

// The write-back of a bucket with no insert and no delete in the batch.  In
// a state that holds I1-I4 the merge would re-chunk every active row into
// itself and the compaction keep it, so the stripe goes back as it is: its
// active rows (s.A/s.Av, the first Scalar[0] rows), EMPTY / 0 past them and
// 0 for the vals of EMPTY slots (as the compaction writes them), the node
// counts (keys are packed at the front of a row), the node max row, and
// Scalar[3] = the active node count.  Ends with a barrier.
__device__ inline void keep_stripe(const Stripe& s, int* __restrict__ keys_out,
                                   int* __restrict__ vals_out, int* __restrict__ count_out,
                                   int* __restrict__ max_out, int* __restrict__ nn_out, int b,
                                   int npb, int ns) {
  const int S = npb * ns, t = threadIdx.x, T = blockDim.x;
  const int nn = s.Scalar[0], L = nn * ns;
  const size_t base = (size_t)b * S, mbase = (size_t)b * npb;
  for (int i = t; i < S; i += T) {
    const int k = i < L ? s.A[i] : kEmpty;
    keys_out[base + i] = k;
    vals_out[base + i] = k != kEmpty ? s.Av[i] : 0;
  }
  for (int j = t; j < npb; j += T) {
    count_out[mbase + j] = j < nn ? lower_bound(s.A + j * ns, ns, kEmpty) : 0;
    max_out[mbase + j] = s.Nmax[j];
  }
  if (t == 0) {
    nn_out[b] = nn;
    s.Scalar[3] = nn;
  }
  __syncthreads();
}

// The fused pass of bucket b, whose active rows are loaded in s.A/s.Av, its
// node max row in s.Nmax, the active node count in Scalar[0], Scalar[1..3]
// and s.Mj zeroed and s.M/s.Mv cleared (load_stripe does all of that): merge
// the insert slice (cut at cap = S), delete, write the post-update stripe
// and its metadata, then answer the bucket's POINT ops and in-bucket
// SUCCESSOR candidates against it.  A bucket with no insert and no delete
// in the batch skips the merge and the compaction (keep_stripe).  Each op
// belongs to at most one bucket,
// so the per-op writes never race.  SUCCESSOR ops with no in-bucket
// candidate keep (EMPTY, NOT_FOUND); the wrapper resolves them from the
// post-update fence rows.
__device__ inline void apply_bucket(const Stripe& s, const ApplyArgs& a, const Slices& sl,
                                    int b, int npb, int ns) {
  const int S = npb * ns, t = threadIdx.x, T = blockDim.x;
  const int m = min(max(sl.ins_end - sl.ins_start, 0), S);
  const int dn = max(sl.del_end - sl.del_start, 0);
  if (m == 0 && dn == 0) {
    keep_stripe(s, a.keys_out, a.vals_out, a.count_out, a.max_out, a.nn_out, b, npb, ns);
    if (t == 0) {
      a.flow_out[b] = 0;
      a.del_out[b] = 0;
    }
  } else {
    load_insert_slice(s, a.ins_keys + sl.ins_start, a.ins_vals + sl.ins_start, m);
    merge_phase(s, m, npb, ns);
    const int L = merged_slots(s, npb, ns);
    mark_deletes(s, s.M, a.del_keys + sl.del_start, dn, L);
    compact_phase(s, s.M, s.Mv, s.A, s.Av, npb, ns, L);
    write_stripe(s, s.A, s.Av, a.keys_out, a.vals_out, a.count_out, a.max_out, a.nn_out, b,
                 npb, ns);
    if (t == 0) {
      a.flow_out[b] = s.Scalar[1] > npb;
      a.del_out[b] = s.Scalar[2];
    }
  }

  const int nn = s.Scalar[3];
  for (int i = sl.op_start + t; i < sl.op_end; i += T) {
    const int tg = a.op_tag[i];
    if (tg != kOpPoint && tg != kOpSuccessor) continue;
    const int q = a.op_key[i];
    const Located l = locate(s.A, s.Nmax, nn, npb, ns, q);
    const int at = l.node * ns + l.pos;
    const bool use_in = l.in_bucket && l.raw_pos < ns;
    if (tg == kOpPoint) {
      a.value_out[i] = use_in && s.A[at] == q ? s.Av[at] : kMiss;
    } else if (use_in) {
      a.succ_out[i] = s.A[at];
      a.value_out[i] = s.Av[at];
    }
  }
}

}  // namespace flix
