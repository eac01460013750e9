// Per-bucket phases of FliX, as device functions shared by the kernels.
//
// The stripe workers of a block own one bucket stripe in shared memory at a
// time: the single-buffer stripe kernel of flix_apply.cu, and nothing else
// since the insert and delete kernels became a warp per bucket.  Its
// persistent blocks walk many buckets; every warp of a block but the last
// (the producer that stages the next buckets) is a stripe worker, and the
// workers meet at a named barrier (sync_workers).  The block phases are the
// formulas of the JAX reference (repro/kernels/flix_apply.py _stripe_body,
// repro/kernels/flix_insert.py _insert_kernel, repro/kernels/flix_delete.py
// _delete_kernel, repro/core/insert.py _merge_one_bucket) with the TPU's
// O(S^2) compare-count masks replaced by block scans and binary searches,
// which give the same ranks because every sequence searched here is
// ascending.
// The staged stripe kernel and the insert and delete kernels
// (flix_apply_staged.cu, flix_insert.cu, flix_delete.cu) are a warp per
// bucket; they run the stripe phases in the warp form of flix_warp.cuh
// and share only the per-element formulas here (region_of, chunk_dest,
// locate, lower_bound) and the ApplyArgs of the fused pass, so that the
// single-buffer kernel stays an independent second witness of the staged
// one.  The point-query and successor kernels (flix_query.cu,
// flix_successor.cu) share the pieces of flix_runs.cuh: a warp owns a run
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
// block-wide pieces of the stripe passes
// ---------------------------------------------------------------------------

// The stripe workers of a block: threads [0, workers()), every warp but the
// last, the producer warp (kProducerThreads), which never joins their named
// barrier 1.  Every block that runs the block phases is launched with
// block_threads(S) threads (below): stripe_threads(S) workers and the
// producer.
constexpr int kProducerThreads = 32;
__device__ __forceinline__ int workers() { return blockDim.x - kProducerThreads; }

__device__ __forceinline__ void sync_workers() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(workers()) : "memory");
}

// In-place exclusive scan of x[0, n) by the stripe workers; x[n] receives
// the total.  warp_buf holds 32 ints.  Each thread scans one contiguous
// chunk, so any n works with any number of workers.  Up to kWarpScan
// entries the first warp scans alone, behind one barrier instead of three.
constexpr int kWarpScan = 128;
__device__ inline void block_exclusive_scan(int* x, int n, int* warp_buf) {
  const int T = workers(), t = threadIdx.x;
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
    sync_workers();
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
  sync_workers();
  if (warp == 0) {
    const int nw = T >> 5;
    int w = lane < nw ? warp_buf[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) warp_buf[lane] = w;
  }
  sync_workers();
  int run = v - local + (warp ? warp_buf[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = x[i];
    x[i] = run;
    run += c;
  }
  if (t == T - 1) x[n] = run;
  sync_workers();
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

// Shared memory of one bucket's block stripe pass (flix_apply.cu): the
// bucket's stripe and node max row (A, Av, Nmax) lie in the kernel's ring
// stage and change with each bucket; the rest is the workers' scratch.
struct Stripe {
  int* A;       // [S] stripe keys (chain order); later the result
  int* Av;      // [S]
  int* Nmax;    // [npb] input node max; later the output's
  int* B;       // [S] the bucket's insert slice (sorted), at most cap = S
  int* Bv;      // [S]
  int* K;       // [S] kept stripe keys, compacted (sorted)
  int* M;       // [S] merged stripe
  int* Mv;      // [S]
  int* X;       // [S+1] scan buffer
  int* Mj;      // [npb] keys per original region
  int* Sj;      // [npb] pieces per region
  int* Fj;      // [npb] first merged rank of region
  int* Base;    // [npb] first output slot of region
  int* Slot;    // [npb] node's slot after chain compaction
  int* Cnt;     // [npb] output node counts
  int* Warp;    // [32]
  int* Scalar;  // [8] 1: total pieces, 2: deleted, 3: output num_nodes; the rest free
};

__host__ __device__ inline long long block_scratch_ints(int npb, int ns) {
  const long long S = (long long)npb * ns;
  return 5 * S + (S + 1) + 6LL * npb + 32 + 8;
}

// The scratch at p (block_scratch_ints long); A, Av and Nmax are left unset.
__device__ inline Stripe carve_block_scratch(int* p, int npb, int ns) {
  const int S = npb * ns;
  Stripe s;
  s.A = s.Av = s.Nmax = nullptr;
  s.B = p;
  s.Bv = s.B + S;
  s.K = s.Bv + S;
  s.M = s.K + S;
  s.Mv = s.M + S;
  s.X = s.Mv + S;
  s.Mj = s.X + S + 1;
  s.Sj = s.Mj + npb;
  s.Fj = s.Sj + npb;
  s.Base = s.Fj + npb;
  s.Slot = s.Base + npb;
  s.Cnt = s.Slot + npb;
  s.Warp = s.Cnt + npb;
  s.Scalar = s.Warp + 32;
  return s;
}

// Stripe workers per block: one per slot up to 128 (4 warps).  The update
// path is latency-bound, so smaller blocks, more of them on an SM, win.
constexpr int kStripeThreads = 128;
inline int stripe_threads(int S) {
  const int t = ((S + 31) / 32) * 32;
  return t < kStripeThreads ? t : kStripeThreads;
}

// Threads of a block that runs the block phases: the workers, then the
// producer warp that workers() leaves out.
inline int block_threads(int S) { return stripe_threads(S) + kProducerThreads; }

// Load the first m entries of an insert slice into B/Bv.  Ends with a
// barrier.
__device__ inline void load_insert_slice(const Stripe& s, const int* __restrict__ ik,
                                         const int* __restrict__ iv, int m) {
  for (int j = threadIdx.x; j < m; j += workers()) {
    s.B[j] = ik[j];
    s.Bv[j] = iv[j];
  }
  sync_workers();
}

// region_of and chunk_dest in the block phases, with the search and the
// divisions skipped where they cannot change the answer: a bucket of one
// active node has one region, and a region of one piece keeps its ranks.
__device__ __forceinline__ int block_region(const Stripe& s, int npb, int onn_c, int z) {
  return onn_c == 0 ? 0 : region_of(s.Nmax, npb, onn_c, z);
}

__device__ __forceinline__ int block_dest(const Stripe& s, int rank, int r, int npb, int ns) {
  if (s.Sj[r] <= 1) {
    const int slot = s.Base[r];
    return slot < npb ? slot * ns + (rank - s.Fj[r]) : npb * ns;
  }
  return chunk_dest(rank, r, s.Mj, s.Sj, s.Fj, s.Base, npb, ns);
}

// Add to counts[r], for each r >= 0 that lanes of the warp hold, the number
// of lanes that hold it: one shared-memory atomic per distinct r, where one
// per lane would serialise on a shared counter.  Every lane of the warp
// calls it.
__device__ __forceinline__ void warp_count(int* counts, int r) {
  const int lane = threadIdx.x & 31;
  const unsigned held = __ballot_sync(kFull, r >= 0);
  if (held == 0) return;
  const int first = __ffs(held) - 1, r0 = __shfl_sync(kFull, r, first);
  if (__all_sync(kFull, r < 0 || r == r0)) {  // one region: the common case
    if (lane == first) atomicAdd(&counts[r0], __popc(held));
    return;
  }
  const unsigned peers = __match_any_sync(kFull, r);
  if (r >= 0 && lane == __ffs(peers) - 1) atomicAdd(&counts[r], __popc(peers));
}

// chunk_dest of a bucket's only region (first rank 0, first slot 0), from
// its key and piece counts held in registers.
__device__ __forceinline__ int one_region_dest(int rank, int mj, int sj, int npb, int ns) {
  const int m_r = max(mj, 1), s_r = max(sj, 1);
  if (s_r == 1) return rank;
  const int piece = (rank * s_r) / m_r;
  const int start = (piece * m_r + s_r - 1) / s_r;
  return piece < npb ? piece * ns + (rank - start) : npb * ns;
}

// Upsert merge of the insert slice B[0, m) into the stripe A: stripe keys
// that reappear in B are dropped (the incoming value wins), each original
// node region is re-chunked into balanced pieces, and the result lands in
// M/Mv (EMPTY / 0 elsewhere).  Only the first nn rows of A (the active
// nodes, packed first: I3/I4) are read.  Scalar[1] receives the number of
// pieces: more than npb means the bucket overflowed and the pieces past the
// last slot were dropped.  Mj must be 0 and M/Mv cleared in the rows the
// pieces can fill; B (and every other input) must be visible to all
// workers on entry, but nothing needs a barrier before the first loop.
// Ends with a barrier.
__device__ inline void merge_phase(const Stripe& s, int nn, int m, int npb, int ns) {
  const int S = npb * ns, t = threadIdx.x, T = workers();
  const int L = nn * ns;  // the slots of A that may hold keys

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
  sync_workers();
  block_exclusive_scan(s.X, L, s.Warp);  // X[i] = kept keys before slot i
  const int nK = s.X[L];
  const int onn_c = max(nn - 1, 0);

  // keys per region, each warp's lanes counted by one atomic per region
  for (int i0 = t & ~31; i0 < L; i0 += T) {
    const int i = i0 + (t & 31);
    int r = -1;
    if (i < L && s.X[i + 1] != s.X[i]) {
      const int a = s.A[i];
      s.K[s.X[i]] = a;
      r = block_region(s, npb, onn_c, a);
    }
    warp_count(s.Mj, r);
  }
  for (int j0 = t & ~31; j0 < m; j0 += T) {
    const int j = j0 + (t & 31);
    warp_count(s.Mj, j < m ? block_region(s, npb, onn_c, s.B[j]) : -1);
  }
  sync_workers();

  // each region's pieces, first rank and first slot; a bucket's only
  // region needs no table: every worker holds its counts
  int mj0 = 0, sj0 = 0;
  if (onn_c == 0) {
    mj0 = s.Mj[0];
    sj0 = (mj0 + ns - 1) / ns;
    if (t == 0) s.Scalar[1] = sj0;
  } else {
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
    sync_workers();
  }
  auto dest = [&](int rank, int z) {
    return onn_c == 0 ? one_region_dest(rank, mj0, sj0, npb, ns)
                      : block_dest(s, rank, region_of(s.Nmax, npb, onn_c, z), npb, ns);
  };

  for (int i = t; i < L; i += T) {
    if (s.X[i + 1] != s.X[i]) {
      const int a = s.A[i];
      const int d = dest(s.X[i] + lower_bound(s.B, m, a), a);
      if (d < S) {
        s.M[d] = a;
        s.Mv[d] = s.Av[i];
      }
    }
  }
  for (int j = t; j < m; j += T) {
    const int k = s.B[j];
    const int d = dest(lower_bound(s.K, nK, k) + j, k);
    if (d < S) {
      s.M[d] = k;
      s.Mv[d] = s.Bv[j];
    }
  }
  sync_workers();
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
  const int t = threadIdx.x;
  for (int i0 = t & ~31; i0 < L; i0 += workers()) {
    const int i = i0 + (t & 31);
    bool hit = false;
    if (i < L) {
      const int k = src[i];
      int keep = 0;
      if (k != kEmpty) {
        const int p = lower_bound(dk, dn, k);
        hit = p < dn && dk[p] == k;
        keep = !hit;
      }
      s.X[i] = keep;
    }
    warp_count(s.Scalar + 2, hit ? 0 : -1);
  }
  sync_workers();
}

// In-node and chain compaction of src/srcv by the survivor flags in
// X[0, L) (mark_deletes' L; the rows past it hold no key): survivors shift
// left inside their node, emptied nodes drop out of the chain, and the
// result lands in dst/dstv (EMPTY / 0 elsewhere in dst[0, L); the rows past
// L are left as they were, and the output's nodes end before them).  Cnt
// receives the output node counts and Scalar[3] the output num_nodes.  Ends
// with a barrier.
__device__ inline void compact_phase(const Stripe& s, const int* src, const int* srcv,
                                     int* dst, int* dstv, int npb, int ns, int L) {
  const int t = threadIdx.x, T = workers();
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
  for (int i = t; i < L; i += T) {
    dst[i] = kEmpty;
    dstv[i] = 0;
  }
  sync_workers();
  for (int i = t; i < L; i += T) {
    if (s.X[i + 1] != s.X[i]) {
      const int j = i / ns;
      const int d = s.Slot[j] * ns + (s.X[i] - s.X[j * ns]);
      dst[d] = src[i];
      dstv[d] = srcv[i];
    }
  }
  sync_workers();
}


// Write the metadata of a finished stripe src of bucket b: node_count from
// Cnt, node_max = the last key of each non-empty node (also kept in Nmax for
// the reads that follow), num_nodes from Scalar[3].  The stripe's planes go
// out by the kernel's own stores (flix_apply.cu).  No barrier.
__device__ inline void write_stripe(const Stripe& s, const int* src,
                                    int* __restrict__ count_out, int* __restrict__ max_out,
                                    int* __restrict__ nn_out, int b, int npb, int ns) {
  const size_t mbase = (size_t)b * npb;
  for (int j = threadIdx.x; j < npb; j += workers()) {
    const int c = s.Cnt[j];
    const int mx = c > 0 ? src[j * ns + c - 1] : kEmpty;
    s.Nmax[j] = mx;
    count_out[mbase + j] = c;
    max_out[mbase + j] = mx;
  }
  if (threadIdx.x == 0) nn_out[b] = s.Scalar[3];
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

// Inputs and outputs of a fused stripe pass (flix_apply.cu's and
// flix_apply_staged.cu's): the pre-batch planes, the compacted insert and
// delete keys with their per-bucket slices, the sorted batch with its
// per-bucket op slices, and the per-bucket and per-op outputs.
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

}  // namespace flix
