// flix_apply_staged: the fused mixed-batch pass of FliX with staged stripes,
// for Hopper (sm_90a), one warp per bucket.
//
// Replaces the TPU kernel repro/kernels/flix_apply.py:_apply_kernel_pipelined
// (the double-buffered variant of the same pl.pallas_call): there the
// sequential grid started the DMA of the next bucket block's stripes into
// one VMEM slot while the current block merged in the other.  Here the
// paper's mapping holds instead: a warp owns one bucket at a time.  Blocks
// are persistent, sized by the occupancy API from the per-warp shared memory
// of the geometry, and each warp walks the buckets b = w, w + W, ... (w its
// global index, W the resident warps).  Each warp has its own two-slot ring
// in shared memory: while bucket b is processed in one slot, cp.async copies
// the next bucket's live rows (the num_nodes[b] rows that hold keys: I3/I4
// pack the active nodes first), its node_max row and, where they fit, its
// op, insert and delete slices into the other.  The six slice bounds and
// num_nodes that address those copies are loaded into registers one bucket
// earlier still, so no global round trip is left on a bucket's own path
// (longer slices are read in place).  Warps synchronise with __syncwarp
// only; no block barrier sits on the per-bucket path.
//
// Per bucket, with L = num_nodes * ns live slots:
//   * the keep path (no insert and no delete in the slice, most buckets of a
//     mixed batch): the live rows go straight back out, vals 0 at EMPTY
//     slots, EMPTY / 0 past them; node counts by one ballot per 32 slots,
//     node_max as staged, num_nodes.  No scratch is cleared.  This is
//     keep_stripe of flix_phases.cuh;
//   * the update path: lane l handles slots 32k + l.  Every block scan of
//     merge_phase / mark_deletes / compact_phase becomes a ballot and a
//     popcount with a running total, the loops over regions and rows become
//     warp scans of 32 at a time.  A kept stripe key's region is its row
//     (in a state that holds I1-I4, region_of can return nothing else);
//     only the inserts binary-search node_max.  An insert's rank counts the
//     kept keys before the first stripe key at or above it, read from the
//     per-chunk ballots, so no compacted copy of the kept keys is needed.
//     The merged stripe is deleted and compacted back into the slot it came
//     from, then written out.  The results are those of merge_phase ->
//     mark_deletes -> compact_phase -> write_stripe, byte for byte: the same
//     chunk_dest re-chunk, overflow past npb pieces with the pieces past the
//     last slot dropped, flow_out and del_out;
//   * the reads: one POINT / SUCCESSOR op per lane against the post-update
//     stripe in the slot.  SUCCESSOR ops with no in-bucket candidate keep
//     (EMPTY, NOT_FOUND); the wrapper resolves them from the fence rows.
//
// Bound on the card: bytes, as for flix_apply.cu: the pass writes every
// stripe whole (it is functional, the old state stays valid for a
// restructure-and-retry) and needs of the old stripe only the rows that
// hold keys, which is all this kernel reads of it.  The output is written
// from the slot in 16-byte stores, 512 bytes a warp instruction.
#include <cuda_runtime.h>

#include "flix_phases.cuh"

namespace {

using namespace flix;

// the staged per-bucket scalars: the six slice bounds, then num_nodes
constexpr int kBoundInts = 8;
constexpr int kNumNodes = 6;
// slices staged with the stripe when they fit; longer ones are read in place
constexpr int kOpCap = 32, kInsCap = 16, kDelCap = 16;
// warps of a block, and the shared memory a Hopper block may opt in to
constexpr int kMaxWarps = 4;
constexpr long long kSmemOptin = 232448;

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

__device__ __forceinline__ void cp_async_4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every group but the newest one of this thread has landed.
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start the copy of src[0, n) to the shared dst[0, n) by one warp, 16 bytes
// a lane where both ends are 16-byte aligned and n is a multiple of 4, else 4.
__device__ inline void stage_ints(int* dst, const int* src, int n, int lane) {
  const size_t ends = reinterpret_cast<size_t>(src) |
                      static_cast<size_t>(__cvta_generic_to_shared(dst));
  if ((ends & 15) == 0 && (n & 3) == 0) {
    for (int i = 4 * lane; i < n; i += 128) cp_async_16(dst + i, src + i);
  } else {
    for (int i = lane; i < n; i += 32) cp_async_4(dst + i, src + i);
  }
}

// ---------------------------------------------------------------------------
// a warp's shared memory
// ---------------------------------------------------------------------------

__host__ __device__ inline long long round4(long long x) { return (x + 3) & ~3LL; }

// One slot of a warp's ring: a bucket's stripe, node max row, scalars and
// (where they fit) slices.
// The update path compacts its result back into A/Av and the output's node
// max into Nmax, and the reads use them.
struct Ring {
  int* A;     // [S] keys
  int* Av;    // [S] vals
  int* Nmax;  // [npb]
  int* Bnd;   // [kBoundInts]
  int* Op;    // [2 * kOpCap] the op slice's tags, then keys
  int* Ins;   // [2 * kInsCap] the insert slice's keys, then vals
  int* Del;   // [kDelCap] the delete slice
};

__host__ __device__ inline long long ring_ints(int npb, int ns) {
  return 2 * round4((long long)npb * ns) + round4(npb) + kBoundInts + 2 * kOpCap +
         2 * kInsCap + kDelCap;
}

// The update path's scratch.
struct Scratch {
  int* M;       // [S] merged stripe
  int* Mv;      // [S]
  int* Mask;    // [S/32] per 32-slot chunk: the ballot of kept / surviving slots
  int* Before;  // [S/32] kept / surviving slots before the chunk
  int* Mj;      // [npb] keys per region
  int* Sj;      // [npb] pieces per region
  int* Fj;      // [npb] first merged rank of region
  int* Base;    // [npb] first output slot of region
  int* Xrow;    // [npb+1] kept / surviving slots before each row
  int* Slot;    // [npb] row's slot after chain compaction
  int* Cnt;     // [npb] output node counts
};

__host__ __device__ inline long long warp_ints(int npb, int ns) {
  const long long S = (long long)npb * ns, chunks = (S + 31) / 32;
  return round4(2 * ring_ints(npb, ns) + 2 * round4(S) + 2 * chunks + 7LL * npb + 1);
}

__device__ inline Ring ring_at(int* w, int k, int npb, int ns) {
  const int S4 = (int)round4(npb * ns);
  int* p = w + k * ring_ints(npb, ns);
  int* bnd = p + 2 * S4 + round4(npb);
  int* op = bnd + kBoundInts;
  return Ring{p, p + S4, p + 2 * S4, bnd, op, op + 2 * kOpCap, op + 2 * kOpCap + 2 * kInsCap};
}

__device__ inline Scratch carve_scratch(int* w, int npb, int ns) {
  const int S = npb * ns, chunks = (S + 31) / 32;
  Scratch s;
  s.M = w + 2 * ring_ints(npb, ns);
  s.Mv = s.M + round4(S);
  s.Mask = s.Mv + round4(S);
  s.Before = s.Mask + chunks;
  s.Mj = s.Before + chunks;
  s.Sj = s.Mj + npb;
  s.Fj = s.Sj + npb;
  s.Base = s.Fj + npb;
  s.Xrow = s.Base + npb;
  s.Slot = s.Xrow + npb + 1;
  s.Cnt = s.Slot + npb;
  return s;
}

// Warps of a block for a geometry: as many as kMaxWarps whose shared memory
// fits one block, at least one.
inline int warps_per_block(int npb, int ns) {
  const long long per_warp = warp_ints(npb, ns) * (long long)sizeof(int);
  const long long w = kSmemOptin / per_warp;
  return w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : (int)w);
}

// ---------------------------------------------------------------------------
// the per-bucket steps of one warp
// ---------------------------------------------------------------------------

// Bucket b's scalars, one a lane: lanes 0-5 its six slice bounds, lane 6
// its active rows (0 past the last bucket).
__device__ __forceinline__ int load_bounds(const ApplyArgs& a, const int* num_nodes, int b,
                                           int nb, int npb, int lane) {
  if (b >= nb || lane > kNumNodes) return 0;
  if (lane == kNumNodes) return min(max(num_nodes[b], 0), npb);
  const int* bound = lane == 0   ? a.ins_starts
                     : lane == 1 ? a.ins_ends
                     : lane == 2 ? a.del_starts
                     : lane == 3 ? a.del_ends
                     : lane == 4 ? a.op_starts
                                 : a.op_ends;
  return bound[b];
}

__device__ __forceinline__ void stage_slice(int* dst, const int* src, int n, int lane) {
  if (lane < n) cp_async_4(dst + lane, src + lane);
}

// Start staging bucket b, whose scalars the lanes hold in bnd (load_bounds),
// into slot r: its live rows, node max row, scalars, and its slices where
// they fit.
__device__ inline void stage_bucket(const Ring& r, const ApplyArgs& a, int b, int bnd, int npb,
                                    int ns, int lane) {
  const int S = npb * ns, nn = __shfl_sync(kFull, bnd, kNumNodes), live = nn * ns;
  const int i0 = __shfl_sync(kFull, bnd, 0), i1 = __shfl_sync(kFull, bnd, 1);
  const int d0 = __shfl_sync(kFull, bnd, 2), d1 = __shfl_sync(kFull, bnd, 3);
  const int o0 = __shfl_sync(kFull, bnd, 4), o1 = __shfl_sync(kFull, bnd, 5);
  stage_ints(r.A, a.keys + (size_t)b * S, live, lane);
  stage_ints(r.Av, a.vals + (size_t)b * S, live, lane);
  stage_ints(r.Nmax, a.node_max + (size_t)b * npb, nn, lane);
  for (int j = nn + lane; j < npb; j += 32) r.Nmax[j] = kEmpty;
  if (lane <= kNumNodes) r.Bnd[lane] = bnd;
  const int m = min(max(i1 - i0, 0), S), dn = max(d1 - d0, 0), no = max(o1 - o0, 0);
  if (m <= kInsCap) {
    stage_slice(r.Ins, a.ins_keys + i0, m, lane);
    stage_slice(r.Ins + kInsCap, a.ins_vals + i0, m, lane);
  }
  if (dn <= kDelCap) stage_slice(r.Del, a.del_keys + d0, dn, lane);
  if (no <= kOpCap) {
    stage_slice(r.Op, a.op_tag + o0, no, lane);
    stage_slice(r.Op + kOpCap, a.op_key + o0, no, lane);
  }
}

// Write a stripe whose first `live` slots are src/srcv: keys, EMPTY past
// them; vals, 0 at every EMPTY slot.  16-byte stores where S allows.
__device__ inline void write_rows(const int* src, const int* srcv, int live,
                                  int* __restrict__ kout, int* __restrict__ vout, int S,
                                  int lane) {
  const size_t ends = reinterpret_cast<size_t>(kout) | reinterpret_cast<size_t>(vout);
  if ((S & 3) == 0 && (ends & 15) == 0) {
    for (int i = 4 * lane; i < S; i += 128) {
      int k[4], v[4];
      if (i + 4 <= live) {
        const int4 kk = *reinterpret_cast<const int4*>(src + i);
        const int4 vv = *reinterpret_cast<const int4*>(srcv + i);
        k[0] = kk.x, k[1] = kk.y, k[2] = kk.z, k[3] = kk.w;
        v[0] = vv.x, v[1] = vv.y, v[2] = vv.z, v[3] = vv.w;
      } else {
        for (int e = 0; e < 4; ++e) {
          k[e] = i + e < live ? src[i + e] : kEmpty;
          v[e] = i + e < live ? srcv[i + e] : 0;
        }
      }
      for (int e = 0; e < 4; ++e) v[e] = k[e] != kEmpty ? v[e] : 0;
      *reinterpret_cast<int4*>(kout + i) = make_int4(k[0], k[1], k[2], k[3]);
      *reinterpret_cast<int4*>(vout + i) = make_int4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int i = lane; i < S; i += 32) {
      const int k = i < live ? src[i] : kEmpty;
      kout[i] = k;
      vout[i] = k != kEmpty ? srcv[i] : 0;
    }
  }
}

// The keep path of bucket b (no insert, no delete): keep_stripe's writes.
__device__ inline void keep_bucket(const Ring& r, const Scratch& s, const ApplyArgs& a, int b,
                                   int nn, int npb, int ns, int lane) {
  const int S = npb * ns, L = nn * ns;
  write_rows(r.A, r.Av, L, a.keys_out + (size_t)b * S, a.vals_out + (size_t)b * S, S, lane);
  int run = 0;  // keys before the chunk; Xrow[j] = keys before row j
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int i = c0 + lane;
    const unsigned mask = __ballot_sync(kFull, i < L && r.A[i] != kEmpty);
    if (i < L && i % ns == 0) s.Xrow[i / ns] = run + __popc(mask & lanes_below(lane));
    run += __popc(mask);
  }
  if (lane == 0) s.Xrow[nn] = run;
  __syncwarp();
  const size_t mb = (size_t)b * npb;
  for (int j = lane; j < npb; j += 32) {
    a.count_out[mb + j] = j < nn ? s.Xrow[j + 1] - s.Xrow[j] : 0;
    a.max_out[mb + j] = r.Nmax[j];
  }
  if (lane == 0) {
    a.nn_out[b] = nn;
    a.flow_out[b] = 0;
    a.del_out[b] = 0;
  }
}

// The update path of bucket b: upsert-merge the insert slice ib/ibv[0, m)
// with the region re-chunk, delete the slice dk[0, dn), compact, write the
// stripe and its metadata.  Leaves the post-update stripe in r.A/r.Av and
// its node max in r.Nmax; returns its num_nodes.
__device__ inline int update_bucket(const Ring& r, const Scratch& s, const ApplyArgs& a,
                                    const int* ib, const int* ibv, int m, const int* dk,
                                    int dn, int b, int nn, int npb, int ns, int lane) {
  const int S = npb * ns, L = nn * ns, onn_c = max(nn - 1, 0);
  const unsigned below = lanes_below(lane);

  // 1. stripe keys not upserted (the incoming value wins), by ballot
  int nK = 0;
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int i = c0 + lane;
    bool keep = false;
    if (i < L) {
      const int x = r.A[i];
      if (x != kEmpty) {
        const int p = lower_bound(ib, m, x);
        keep = !(p < m && ib[p] == x);
      }
    }
    const unsigned mask = __ballot_sync(kFull, keep);
    if (lane == 0) {
      s.Mask[c0 >> 5] = mask;
      s.Before[c0 >> 5] = nK;
    }
    if (i < L && i % ns == 0) s.Xrow[i / ns] = nK + __popc(mask & below);
    nK += __popc(mask);
  }
  if (lane == 0) s.Xrow[nn] = nK;
  __syncwarp();

  // 2. keys per region: a kept key's region is its row; an insert's is
  // region_of its key (a leader per group of equal regions adds the group)
  for (int j = lane; j < npb; j += 32) s.Mj[j] = j < nn ? s.Xrow[j + 1] - s.Xrow[j] : 0;
  __syncwarp();
  for (int j0 = 0; j0 < m; j0 += 32) {
    const int j = j0 + lane;
    const int reg = j < m ? region_of(r.Nmax, npb, onn_c, ib[j]) : -1;
    const unsigned peers = __match_any_sync(kFull, reg);
    if (j < m && (peers & below) == 0) atomicAdd(&s.Mj[reg], __popc(peers));
  }
  __syncwarp();

  // 3. per region: pieces, first merged rank, first output slot (warp scans)
  int f = 0, pieces = 0;
  for (int j0 = 0; j0 < npb; j0 += 32) {
    const int j = j0 + lane;
    const int mj = j < npb ? s.Mj[j] : 0;
    const int sj = (mj + ns - 1) / ns;
    int im = mj, is = sj;
    for (int d = 1; d < 32; d <<= 1) {
      const int ym = __shfl_up_sync(kFull, im, d);
      const int ys = __shfl_up_sync(kFull, is, d);
      if (lane >= d) {
        im += ym;
        is += ys;
      }
    }
    if (j < npb) {
      s.Sj[j] = sj;
      s.Fj[j] = f + im - mj;
      s.Base[j] = pieces + is - sj;
    }
    f += __shfl_sync(kFull, im, 31);
    pieces += __shfl_sync(kFull, is, 31);
  }
  const int L2 = min(pieces, npb) * ns;  // the merged slots that may hold keys
  for (int i = lane; i < L2; i += 32) {
    s.M[i] = kEmpty;
    s.Mv[i] = 0;
  }
  __syncwarp();

  // 4. the merge: every kept key and insert to its slot of the re-chunk
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int i = c0 + lane;
    const unsigned mask = s.Mask[c0 >> 5];
    if ((mask >> lane) & 1) {
      const int x = r.A[i];
      const int rank = s.Before[c0 >> 5] + __popc(mask & below) + lower_bound(ib, m, x);
      const int d = chunk_dest(rank, i / ns, s.Mj, s.Sj, s.Fj, s.Base, npb, ns);
      if (d < S) {
        s.M[d] = x;
        s.Mv[d] = r.Av[i];
      }
    }
  }
  for (int j = lane; j < m; j += 32) {
    const int x = ib[j];
    const int node = lower_bound(r.Nmax, npb, x);
    // kept keys below x: those before the first stripe key at or above x
    int kept_below = nK;
    if (node < nn) {
      const int p = node * ns + lower_bound(r.A + node * ns, ns, x);
      if (p < L) kept_below = s.Before[p >> 5] + __popc(s.Mask[p >> 5] & lanes_below(p & 31));
    }
    const int d = chunk_dest(kept_below + j, min(node, onn_c), s.Mj, s.Sj, s.Fj, s.Base, npb,
                             ns);
    if (d < S) {
      s.M[d] = x;
      s.Mv[d] = ibv[j];
    }
  }
  __syncwarp();

  // 5. deletes: the surviving merged keys, by ballot
  int nS = 0, hits = 0;
  for (int c0 = 0; c0 < L2; c0 += 32) {
    const int i = c0 + lane;
    bool keep = false, hit = false;
    if (i < L2) {
      const int x = s.M[i];
      if (x != kEmpty) {
        const int p = lower_bound(dk, dn, x);
        hit = p < dn && dk[p] == x;
        keep = !hit;
      }
    }
    const unsigned mask = __ballot_sync(kFull, keep);
    hits += __popc(__ballot_sync(kFull, hit));
    if (lane == 0) {
      s.Mask[c0 >> 5] = mask;
      s.Before[c0 >> 5] = nS;
    }
    if (i < L2 && i % ns == 0) s.Xrow[i / ns] = nS + __popc(mask & below);
    nS += __popc(mask);
  }
  const int R2 = L2 / ns;
  if (lane == 0) s.Xrow[R2] = nS;
  __syncwarp();

  // 6. chain compaction: emptied rows drop out (a warp scan of row flags)
  int nn_out = 0;
  for (int j0 = 0; j0 < R2; j0 += 32) {
    const int j = j0 + lane;
    const int c = j < R2 ? s.Xrow[j + 1] - s.Xrow[j] : 0;
    const unsigned mask = __ballot_sync(kFull, c > 0);
    const int slot = nn_out + __popc(mask & below);
    if (j < R2) s.Slot[j] = slot;
    if (c > 0) s.Cnt[slot] = c;
    nn_out += __popc(mask);
  }
  for (int j = nn_out + lane; j < npb; j += 32) s.Cnt[j] = 0;
  for (int i = lane; i < nn_out * ns; i += 32) {  // every stripe key is in M now
    r.A[i] = kEmpty;
    r.Av[i] = 0;
  }
  __syncwarp();
  for (int c0 = 0; c0 < L2; c0 += 32) {
    const int i = c0 + lane;
    const unsigned mask = s.Mask[c0 >> 5];
    if ((mask >> lane) & 1) {
      const int j = i / ns;
      const int d = s.Slot[j] * ns + (s.Before[c0 >> 5] + __popc(mask & below) - s.Xrow[j]);
      r.A[d] = s.M[i];
      r.Av[d] = s.Mv[i];
    }
  }
  __syncwarp();

  // 7. write the stripe and its metadata (write_stripe)
  write_rows(r.A, r.Av, nn_out * ns, a.keys_out + (size_t)b * S, a.vals_out + (size_t)b * S,
             S, lane);
  const size_t mb = (size_t)b * npb;
  for (int j = lane; j < npb; j += 32) {
    const int c = s.Cnt[j];
    const int mx = c > 0 ? r.A[j * ns + c - 1] : kEmpty;
    r.Nmax[j] = mx;
    a.count_out[mb + j] = c;
    a.max_out[mb + j] = mx;
  }
  if (lane == 0) {
    a.nn_out[b] = nn_out;
    a.flow_out[b] = pieces > npb;
    a.del_out[b] = hits;
  }
  return nn_out;
}

// The bucket's POINT ops and in-bucket SUCCESSOR candidates, one op a lane,
// against the post-update stripe in r (apply_bucket's reads).
__device__ inline void read_ops(const Ring& r, const ApplyArgs& a, const int* tags,
                                const int* qs, int start, int end, int nn, int npb, int ns,
                                int lane) {
  for (int i = start + lane; i < end; i += 32) {
    const int tg = tags[i - start];
    if (tg != kOpPoint && tg != kOpSuccessor) continue;
    const int q = qs[i - start];
    const Located l = locate(r.A, r.Nmax, nn, npb, ns, q);
    const int at = l.node * ns + l.pos;
    const bool use_in = l.in_bucket && l.raw_pos < ns;
    if (tg == kOpPoint) {
      a.value_out[i] = use_in && r.A[at] == q ? r.Av[at] : kMiss;
    } else if (use_in) {
      a.succ_out[i] = r.A[at];
      a.value_out[i] = r.Av[at];
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    flix_apply_staged_kernel(const ApplyArgs a, const int* __restrict__ num_nodes, int nb,
                             int npb, int ns) {
  extern __shared__ __align__(16) int smem[];
  const int S = npb * ns, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  int* w = smem + (threadIdx.x >> 5) * warp_ints(npb, ns);
  const Scratch s = carve_scratch(w, npb, ns);
  const int W = gridDim.x * warps;
  int b = blockIdx.x * warps + (threadIdx.x >> 5);
  if (b >= nb) return;  // the whole warp leaves together

  stage_bucket(ring_at(w, 0, npb, ns), a, b, load_bounds(a, num_nodes, b, nb, npb, lane), npb,
               ns, lane);
  cp_async_commit();
  // the scalars of the bucket staged next; loaded one bucket ahead of their use
  int bnd_next = load_bounds(a, num_nodes, b + W, nb, npb, lane);
  for (int it = 0; b < nb; b += W, ++it) {
    const Ring cur = ring_at(w, it & 1, npb, ns);
    // the other slot's last reader finished with the previous bucket
    // (__syncwarp below), so the next bucket may land there now
    if (b + W < nb)
      stage_bucket(ring_at(w, (it & 1) ^ 1, npb, ns), a, b + W, bnd_next, npb, ns, lane);
    cp_async_commit();
    bnd_next = load_bounds(a, num_nodes, b + 2 * W, nb, npb, lane);
    cp_async_wait_all_but_newest();  // this lane's copies of bucket b
    __syncwarp();                    // and every lane's

    const int nn = cur.Bnd[kNumNodes];
    const int i0 = cur.Bnd[0], d0 = cur.Bnd[2], o0 = cur.Bnd[4], o1 = cur.Bnd[5];
    const int m = min(max(cur.Bnd[1] - i0, 0), S);
    const int dn = max(cur.Bnd[3] - d0, 0);
    int nn_out = nn;
    if (m == 0 && dn == 0) {
      keep_bucket(cur, s, a, b, nn, npb, ns, lane);
    } else {
      const bool ins_in = m <= kInsCap;
      nn_out = update_bucket(cur, s, a, ins_in ? cur.Ins : a.ins_keys + i0,
                             ins_in ? cur.Ins + kInsCap : a.ins_vals + i0, m,
                             dn <= kDelCap ? cur.Del : a.del_keys + d0, dn, b, nn, npb, ns,
                             lane);
    }
    __syncwarp();
    const bool ops_in = o1 - o0 <= kOpCap;
    read_ops(cur, a, ops_in ? cur.Op : a.op_tag + o0, ops_in ? cur.Op + kOpCap : a.op_key + o0,
             o0, o1, nn_out, npb, ns, lane);
    __syncwarp();  // the reads of this slot are done before it is restaged
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one staged block needs for a (npb, ns) geometry:
// its warps' rings and scratch (INT_MAX where that does not fit an int).
int flix_apply_staged_smem_bytes(int npb, int ns) {
  const long long bytes = warps_per_block(npb, ns) * warp_ints(npb, ns) * (long long)sizeof(int);
  return bytes > 0x7fffffffLL ? 0x7fffffff : (int)bytes;
}

int flix_apply_staged_launch(const int* keys, const int* vals, const int* node_max,
                             const int* ins_keys, const int* ins_vals,
                             const int* ins_starts, const int* ins_ends,
                             const int* del_keys, const int* del_starts,
                             const int* del_ends, const int* op_tag, const int* op_key,
                             const int* op_starts, const int* op_ends,
                             const int* num_nodes, int* keys_out, int* vals_out,
                             int* count_out, int* max_out, int* nn_out, int* flow_out,
                             int* del_out, int* value_out, int* succ_out, int nb, int npb,
                             int ns, void* stream) {
  const int smem = flix_apply_staged_smem_bytes(npb, ns);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(flix_apply_staged_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int wpb = warps_per_block(npb, ns), threads = 32 * wpb;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flix_apply_staged_kernel,
                                                         threads, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int need = (nb + wpb - 1) / wpb;
  const int blocks = need < per_sm * sms ? need : per_sm * sms;
  const ApplyArgs a = {keys,      vals,       node_max,   ins_keys,  ins_vals, ins_starts,
                       ins_ends,  del_keys,   del_starts, del_ends,  op_tag,   op_key,
                       op_starts, op_ends,    keys_out,   vals_out,  count_out, max_out,
                       nn_out,    flow_out,   del_out,    value_out, succ_out};
  flix_apply_staged_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(a, num_nodes, nb,
                                                                           npb, ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
