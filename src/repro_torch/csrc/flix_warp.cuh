// The warp-per-bucket stripe passes of FliX for Hopper (sm_90a): what the
// staged stripe kernel (flix_apply_staged.cu) and the TL-Bulk insert and
// delete kernels (flix_insert.cu, flix_delete.cu) share.
//
// The paper's mapping: a warp owns one bucket at a time.  Blocks are
// persistent, sized by the occupancy API from the per-warp shared memory of
// the geometry (launch_walk), and each warp walks the buckets b = w, w + W,
// ... (w its global index, W the resident warps; walk_buckets).  Each warp
// has its own two-slot ring in shared memory: while bucket b is processed in
// one slot, cp.async copies the next bucket's live rows (the num_nodes[b]
// rows that hold keys: I3/I4 pack the active nodes first), its node_max row
// and, where they fit, the slices of the batch it owns into the other.  The
// bucket's scalars that address those copies (slice bounds, num_nodes) are
// loaded into registers one bucket earlier still, so no global round trip
// is left on a bucket's own path (longer slices are read in place).  Warps
// synchronise with __syncwarp only; no block barrier sits on the per-bucket
// path.
//
// Per bucket, with L = num_nodes * ns live slots:
//   * the keep path (write_packed; no update for the bucket): the live rows
//     go straight back out, vals 0 at EMPTY slots, EMPTY / 0 past them;
//     node counts by one ballot per 32 slots; node_max as staged or from
//     each row's last key; num_nodes.  No scratch is cleared.
//   * the update path: lane l handles slots 32k + l.  Every block scan of
//     flix_phases.cuh's merge_phase / mark_deletes / compact_phase becomes a
//     ballot and a popcount with a running total, the loops over regions and
//     rows become warp scans of 32 at a time.  It has two parts, and a
//     kernel with one of them skips the other's ballots and scans:
//       - merge_inserts (steps 1-4): the upsert merge with the original-node
//         region re-chunk into the scratch stripe M.  A kept stripe key's
//         region is its row (in a state that holds I1-I4, region_of can
//         return nothing else); only the inserts binary-search node_max.  An
//         insert's rank counts the kept keys before the first stripe key at
//         or above it, read from the per-chunk ballots, so no compacted copy
//         of the kept keys is needed;
//       - delete_compact (steps 5-6): the deletes by ballot over a stripe,
//         in-node compaction and the chain compaction of emptied rows into
//         another buffer;
//     then the write of the compacted stripe and its metadata (step 7,
//     write_compacted), or, after a merge with no deletes, write_packed of
//     M.  The results are those of merge_phase -> mark_deletes ->
//     compact_phase -> write_stripe, byte for byte: the same chunk_dest
//     re-chunk, overflow past npb pieces with the pieces past the last slot
//     dropped.
//
// Bound on the card: bytes.  The functional passes (the old state stays
// valid for a restructure-and-retry) write every stripe whole, and of the
// old stripe need only the rows that hold keys, which is all these kernels
// read of it.  The staged kernel's donated pass writes in place instead: only
// the updated buckets, and of those the rows that held or now hold keys
// (write_compacted's end).  The output is written from shared memory in
// 16-byte stores, 512 bytes a warp instruction.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "flix_phases.cuh"

namespace flix {

// a bucket's staged scalars: its slice bounds, then num_nodes; lane i of the
// warp loads scalar i
constexpr int kBoundInts = 8;
constexpr int kInsStart = 0, kInsEnd = 1, kDelStart = 2, kDelEnd = 3, kOpStart = 4,
              kOpEnd = 5, kNumNodes = 6;
// warps of a block by default, the most a launch may ask for (the staged
// kernel's launch bounds), and the shared memory a Hopper block may opt in to
constexpr int kMaxWarps = 4;
constexpr int kMaxWalkWarps = 8;
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

// Start the copy of a slice of at most 32 entries, one a lane.
__device__ __forceinline__ void stage_slice(int* dst, const int* src, int n, int lane) {
  if (lane < n) cp_async_4(dst + lane, src + lane);
}

// ---------------------------------------------------------------------------
// a warp's shared memory
// ---------------------------------------------------------------------------

__host__ __device__ inline long long round4(long long x) { return (x + 3) & ~3LL; }

// One slot of a warp's ring: a bucket's stripe, node max row, scalars and
// (where they fit) the slices of the batch it owns, of at most OpCap ops,
// InsCap inserts and DelCap deletes.  The update path compacts its result
// into A/Av or the scratch stripe, and the output's node max into Nmax.
template <int OpCap, int InsCap, int DelCap>
struct Ring {
  static constexpr int kOpCap = OpCap, kInsCap = InsCap, kDelCap = DelCap;
  static_assert(OpCap <= 32 && InsCap <= 32 && DelCap <= 32, "a slice stages a lane an entry");
  static_assert((2 * OpCap + 2 * InsCap + DelCap) % 4 == 0, "slots stay 16-byte aligned");
  int* A;     // [S] keys
  int* Av;    // [S] vals
  int* Nmax;  // [npb]
  int* Bnd;   // [kBoundInts]
  int* Op;    // [2 * OpCap] the op slice's tags, then keys
  int* Ins;   // [2 * InsCap] the insert slice's keys, then vals
  int* Del;   // [DelCap] the delete slice

  __host__ __device__ static long long ints(int npb, int ns) {
    return 2 * round4((long long)npb * ns) + round4(npb) + kBoundInts + 2 * OpCap +
           2 * InsCap + DelCap;
  }

  // Slot k of the ring that starts at w.
  __device__ static Ring at(int* w, int k, int npb, int ns) {
    const int S4 = (int)round4(npb * ns);
    int* p = w + k * ints(npb, ns);
    int* bnd = p + 2 * S4 + round4(npb);
    int* op = bnd + kBoundInts;
    return Ring{p, p + S4, p + 2 * S4, bnd, op, op + 2 * OpCap, op + 2 * OpCap + 2 * InsCap};
  }
};

// The update path's scratch.
struct Scratch {
  int* M;       // [S] merged stripe (or the compacted one of a delete pass)
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

// Shared memory of one warp: its two ring slots, then its scratch.
template <class R>
__host__ __device__ inline long long warp_ints(int npb, int ns) {
  const long long S = (long long)npb * ns, chunks = (S + 31) / 32;
  return round4(2 * R::ints(npb, ns) + 2 * round4(S) + 2 * chunks + 7LL * npb + 1);
}

template <class R>
__device__ inline Scratch carve_scratch(int* w, int npb, int ns) {
  const int S = npb * ns, chunks = (S + 31) / 32;
  Scratch s;
  s.M = w + 2 * R::ints(npb, ns);
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

// Warps of a block for a geometry: `warps` where the launch asks for a
// count (1 to kMaxWalkWarps), else (0) as many as kMaxWarps whose shared
// memory fits one block, at least one.
template <class R>
inline int warps_per_block(int npb, int ns, int warps = 0) {
  if (warps > 0) return warps;
  const long long per_warp = warp_ints<R>(npb, ns) * (long long)sizeof(int);
  const long long w = kSmemOptin / per_warp;
  return w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : (int)w);
}

// Dynamic shared memory of one block of warps_per_block<R>(npb, ns, warps)
// warps (INT_MAX where that does not fit an int).
template <class R>
inline int walk_smem_bytes(int npb, int ns, int warps = 0) {
  const long long bytes =
      warps_per_block<R>(npb, ns, warps) * warp_ints<R>(npb, ns) * (long long)sizeof(int);
  return bytes > 0x7fffffffLL ? 0x7fffffff : (int)bytes;
}

// ---------------------------------------------------------------------------
// the walk over the buckets
// ---------------------------------------------------------------------------

// Bucket b's scalars for a pass over one slice of a sorted batch whose
// per-bucket ends (searchsorted right of the fences) are `ends`: lane `lo`
// its start (the previous bucket's end), lane lo + 1 its end, lane
// kNumNodes its active rows; 0 elsewhere and past the last bucket.
__device__ __forceinline__ int slice_bounds(const int* ends, const int* num_nodes, int b,
                                            int nb, int npb, int lo, int lane) {
  if (b >= nb) return 0;
  if (lane == kNumNodes) return min(max(num_nodes[b], 0), npb);
  if (lane == lo) return b == 0 ? 0 : ends[b - 1];
  return lane == lo + 1 ? ends[b] : 0;
}

// Start staging bucket b, whose scalars the lanes hold in bnd, into slot r:
// its live rows, its scalars and, given node_max, its node max row (EMPTY
// past the live rows).  The caller stages the slices.
template <class R>
__device__ inline void stage_rows(const R& r, const int* keys, const int* vals,
                                  const int* node_max, int b, int bnd, int npb, int ns,
                                  int lane) {
  const int S = npb * ns, nn = __shfl_sync(kFull, bnd, kNumNodes), live = nn * ns;
  stage_ints(r.A, keys + (size_t)b * S, live, lane);
  stage_ints(r.Av, vals + (size_t)b * S, live, lane);
  if (node_max != nullptr) {
    stage_ints(r.Nmax, node_max + (size_t)b * npb, nn, lane);
    for (int j = nn + lane; j < npb; j += 32) r.Nmax[j] = kEmpty;
  }
  if (lane <= kNumNodes) r.Bnd[lane] = bnd;
}

// One warp's walk over the buckets b = w, w + W, ... through its two-slot
// ring in smem.  bounds(b, lane) gives a lane's scalar of bucket b (0 past
// the last bucket), stage(slot, b, bnd, lane) starts the copies of bucket b
// into a slot, and bucket(slot, scratch, b, lane) processes it once they
// have landed.  Every lane of the warp calls each of them.
template <class R, class Bounds, class Stage, class Bucket>
__device__ inline void walk_buckets(int* smem, int nb, int npb, int ns, Bounds bounds,
                                    Stage stage, Bucket bucket) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  int* w = smem + (threadIdx.x >> 5) * warp_ints<R>(npb, ns);
  const Scratch s = carve_scratch<R>(w, npb, ns);
  const int W = gridDim.x * warps;
  int b = blockIdx.x * warps + (threadIdx.x >> 5);
  if (b >= nb) return;  // the whole warp leaves together

  stage(R::at(w, 0, npb, ns), b, bounds(b, lane), lane);
  cp_async_commit();
  // the scalars of the bucket staged next; loaded one bucket ahead of their use
  int bnd_next = bounds(b + W, lane);
  for (int it = 0; b < nb; b += W, ++it) {
    const R cur = R::at(w, it & 1, npb, ns);
    // the other slot's last reader finished with the previous bucket
    // (__syncwarp below), so the next bucket may land there now
    if (b + W < nb) stage(R::at(w, (it & 1) ^ 1, npb, ns), b + W, bnd_next, lane);
    cp_async_commit();
    bnd_next = bounds(b + 2 * W, lane);
    cp_async_wait_all_but_newest();  // this lane's copies of bucket b
    __syncwarp();                    // and every lane's
    bucket(cur, s, b, lane);
    __syncwarp();  // this slot is done with before it is restaged
  }
}

// The blocks of `threads` threads and `smem` bytes of shared memory that
// every SM of the current device holds at once for `kernel`, in *blocks,
// with the kernel's shared memory opt-in raised to smem where it passes
// 48 KiB.  The runtime's answers depend on the kernel, the device, the
// geometry and the block's threads alone, so each is asked on its first
// launch and kept; a later launch pays cudaGetDevice and a lookup (and the
// opt-in again only where the block's shared memory changed).  Returns the
// CUDA error code.
inline int walk_capacity(const void* kernel, int npb, int ns, int threads, int smem,
                         int* blocks) {
  int dev = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int>, int> resident;
  static std::map<std::pair<const void*, int>, int> optin;  // as last set
  const std::lock_guard<std::mutex> hold(mu);
  if (smem > 48 * 1024) {
    int& set = optin[{kernel, dev}];
    if (set != smem) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      set = smem;
    }
  }
  const auto key = std::make_tuple(kernel, dev, npb, ns, threads);
  auto it = resident.find(key);
  if (it == resident.end()) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
        cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    it = resident.emplace(key, per_sm * sms).first;
  }
  *blocks = it->second;
  return 0;
}

// Launch a walk_buckets kernel: blocks of warps_per_block<R>(npb, ns, warps)
// warps, as many as the occupancy API lets every SM hold, at most a warp per
// bucket.  Returns the CUDA error code (cudaErrorInvalidValue for a warp
// count outside 0 to kMaxWalkWarps).
template <class R, class... P, class... A>
inline int launch_walk(void (*kernel)(P...), int nb, int npb, int ns, int warps, void* stream,
                       A&&... args) {
  if (warps < 0 || warps > kMaxWalkWarps) return (int)cudaErrorInvalidValue;
  if (nb == 0) return 0;
  const int smem = walk_smem_bytes<R>(npb, ns, warps);
  const int wpb = warps_per_block<R>(npb, ns, warps), threads = 32 * wpb;
  int resident = 0;
  const int e = walk_capacity(reinterpret_cast<const void*>(kernel), npb, ns, threads, smem,
                              &resident);
  if (e != 0) return e;
  const int need = (nb + wpb - 1) / wpb;
  const int blocks = need < resident ? need : resident;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(std::forward<A>(args)...);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the per-bucket steps of one warp
// ---------------------------------------------------------------------------

// The stripe outputs every pass writes: keys and vals [nb, npb, ns],
// node_count and node_max [nb, npb], num_nodes [nb].
struct StripeOut {
  int* __restrict__ keys;
  int* __restrict__ vals;
  int* __restrict__ count;
  int* __restrict__ max;
  int* __restrict__ nn;
};

// Write slots [0, S) of a stripe whose first `live` slots are src/srcv:
// keys, EMPTY past them; vals, 0 at every EMPTY slot.  16-byte stores where
// S allows.
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

// Write EMPTY keys and 0 vals over slots [from, S) of a stripe.  16-byte
// stores where from and S allow.
__device__ inline void write_empty(int* __restrict__ kout, int* __restrict__ vout, int from,
                                   int S, int lane) {
  const size_t ends = reinterpret_cast<size_t>(kout) | reinterpret_cast<size_t>(vout);
  if (((from | S) & 3) == 0 && (ends & 15) == 0) {
    const int4 e = make_int4(kEmpty, kEmpty, kEmpty, kEmpty), z = make_int4(0, 0, 0, 0);
    for (int i = from + 4 * lane; i < S; i += 128) {
      *reinterpret_cast<int4*>(kout + i) = e;
      *reinterpret_cast<int4*>(vout + i) = z;
    }
  } else {
    for (int i = from + lane; i < S; i += 32) {
      kout[i] = kEmpty;
      vout[i] = 0;
    }
  }
}

// Write bucket b's stripe from src/srcv, whose first L slots are whole rows
// with their keys packed at the front of each row (EMPTY / 0 past them),
// over its slots [0, end) (the caller has written the rest, which holds no
// key), and its metadata: node counts by ballot, node max from nmax
// (kRowMax false: the staged node max row; num_nodes is then L / ns) or
// each row's last key (kRowMax true: num_nodes counts the non-empty rows,
// as row_metadata of kernels/_phases.py does).  Returns num_nodes.  On a
// state that holds I1-I4 both give the same bytes; the staged kernel's keep
// path takes the staged row because the row-derived form raised it from 96
// to 127 registers.
template <bool kRowMax>
__device__ inline int write_packed(const Scratch& s, const int* src, const int* srcv, int L,
                                   int end, const int* nmax, const StripeOut& o, int b,
                                   int npb, int ns, int lane) {
  const int S = npb * ns, R = L / ns;
  write_rows(src, srcv, L, o.keys + (size_t)b * S, o.vals + (size_t)b * S, end, lane);
  int run = 0;  // keys before the chunk; Xrow[j] = keys before row j
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int i = c0 + lane;
    const unsigned mask = __ballot_sync(kFull, i < L && src[i] != kEmpty);
    if (i < L && i % ns == 0) s.Xrow[i / ns] = run + __popc(mask & lanes_below(lane));
    run += __popc(mask);
  }
  if (lane == 0) s.Xrow[R] = run;
  __syncwarp();
  const size_t mb = (size_t)b * npb;
  int nn = R;
  if (kRowMax) {
    nn = 0;
    for (int j0 = 0; j0 < npb; j0 += 32) {
      const int j = j0 + lane;
      const int c = j < R ? s.Xrow[j + 1] - s.Xrow[j] : 0;
      if (j < npb) {
        o.count[mb + j] = c;
        o.max[mb + j] = c > 0 ? src[j * ns + c - 1] : kEmpty;
      }
      nn += __popc(__ballot_sync(kFull, c > 0));
    }
  } else {
    for (int j = lane; j < npb; j += 32) {
      o.count[mb + j] = j < R ? s.Xrow[j + 1] - s.Xrow[j] : 0;
      o.max[mb + j] = nmax[j];
    }
  }
  if (lane == 0) o.nn[b] = nn;
  return nn;
}

// What merge_inserts leaves: the slots of M that may hold keys (its pieces
// cut at npb, whole rows) and the number of pieces (more than npb: the
// bucket overflowed and the pieces past the last slot were dropped).
struct Merged {
  int slots, pieces;
};

// What merge_plan leaves: the stripe keys the merge keeps and the pieces of
// the re-chunk (more than npb: the bucket overflows).
struct Plan {
  int kept, pieces;
};

// Steps 1-3 of the update path: the upsert merge's plan for the insert
// slice ib[0, m) against the bucket's nn live rows in slot r (r.A and
// r.Nmax), into the scratch's masks and per-region tables.  Reads nothing
// of r.Av; merge_inserts goes on from it, and a pass that only needs to
// know whether a bucket overflows stops here.
template <class R>
__device__ inline Plan merge_plan(const R& r, const Scratch& s, const int* ib, int m, int nn,
                                  int npb, int ns, int lane) {
  const int L = nn * ns, onn_c = max(nn - 1, 0);
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
  return Plan{nK, pieces};
}

// Steps 1-4 of the update path: upsert-merge the insert slice ib/ibv[0, m)
// into the bucket's nn live rows in slot r (the incoming value wins) with
// the region re-chunk of r.Nmax's regions; the result lands in s.M/s.Mv.
template <class R>
__device__ inline Merged merge_inserts(const R& r, const Scratch& s, const int* ib,
                                       const int* ibv, int m, int nn, int npb, int ns,
                                       int lane) {
  const int S = npb * ns, L = nn * ns, onn_c = max(nn - 1, 0);
  const unsigned below = lanes_below(lane);
  const Plan plan = merge_plan(r, s, ib, m, nn, npb, ns, lane);
  const int nK = plan.kept, pieces = plan.pieces;
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
  return Merged{L2, pieces};
}

// What delete_compact leaves: the output's num_nodes and the keys deleted.
struct Compacted {
  int nn, hits;
};

// Steps 5-6 of the update path: delete from src/srcv[0, L) (whole rows,
// distinct from dst) the keys of the ascending slice dk[0, dn), compact the
// survivors inside their rows and the emptied rows out of the chain into
// dst/dstv (EMPTY / 0 past the survivors of each output row, over the
// output's rows); s.Cnt receives the output node counts.
__device__ inline Compacted delete_compact(const Scratch& s, const int* src, const int* srcv,
                                           int L, const int* dk, int dn, int* dst, int* dstv,
                                           int npb, int ns, int lane) {
  const unsigned below = lanes_below(lane);

  // 5. deletes: the surviving keys, by ballot
  int nS = 0, hits = 0;
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int i = c0 + lane;
    bool keep = false, hit = false;
    if (i < L) {
      const int x = src[i];
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
    if (i < L && i % ns == 0) s.Xrow[i / ns] = nS + __popc(mask & below);
    nS += __popc(mask);
  }
  const int R2 = L / ns;
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
  for (int i = lane; i < nn_out * ns; i += 32) {
    dst[i] = kEmpty;
    dstv[i] = 0;
  }
  __syncwarp();
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int i = c0 + lane;
    const unsigned mask = s.Mask[c0 >> 5];
    if ((mask >> lane) & 1) {
      const int j = i / ns;
      const int d = s.Slot[j] * ns + (s.Before[c0 >> 5] + __popc(mask & below) - s.Xrow[j]);
      dst[d] = src[i];
      dstv[d] = srcv[i];
    }
  }
  __syncwarp();
  return Compacted{nn_out, hits};
}

// Step 7 of the update path: write bucket b's compacted stripe src[0,
// nn * ns) (delete_compact's dst, node counts in s.Cnt) over its slots [0,
// end) (-1: the whole stripe; a pass that writes in place passes the rows
// that held or now hold keys, the rest being EMPTY / 0 already) and its
// metadata; the output's node max also lands in nmax (the slot's Nmax,
// which the staged kernel's reads use).
__device__ inline void write_compacted(const Scratch& s, const int* src, const int* srcv, int nn,
                                       int* nmax, const StripeOut& o, int b, int npb, int ns,
                                       int lane, int end = -1) {
  const int S = npb * ns;
  write_rows(src, srcv, nn * ns, o.keys + (size_t)b * S, o.vals + (size_t)b * S,
             end < 0 ? S : end, lane);
  const size_t mb = (size_t)b * npb;
  for (int j = lane; j < npb; j += 32) {
    const int c = s.Cnt[j];
    const int mx = c > 0 ? src[j * ns + c - 1] : kEmpty;
    nmax[j] = mx;
    o.count[mb + j] = c;
    o.max[mb + j] = mx;
  }
  if (lane == 0) o.nn[b] = nn;
}

}  // namespace flix
