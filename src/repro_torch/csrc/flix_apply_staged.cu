// flix_apply_staged: the fused mixed-batch pass of FliX with staged stripes,
// for Hopper (sm_90a), one warp per bucket.
//
// Replaces the TPU kernel repro/kernels/flix_apply.py:_apply_kernel_pipelined
// (the double-buffered variant of the same pl.pallas_call): there the
// sequential grid started the DMA of the next bucket block's stripes into
// one VMEM slot while the current block merged in the other.  Here the
// paper's mapping holds instead: a warp owns one bucket at a time, walking
// the buckets of persistent blocks through a two-slot cp.async ring
// (walk_buckets of flix_warp.cuh, shared with the insert and delete
// kernels).  Each slot stages a bucket's live rows, its node max row, and
// its op, insert and delete slices where they fit; the six slice bounds and
// num_nodes that address those copies are loaded a bucket earlier still.
// The launch's `warps` a block are the TPU kernel's block_b (the bucket
// stripes one grid step holds): ExecConfig.block_b, or the tile table's pick
// (kernels/autotune.py), 1 to kMaxWalkWarps; 0 keeps warps_per_block's rule.
// Each warp keeps its own ring, so the count changes the blocks an SM holds
// and never a bucket's result.  Blocks of up to kMaxWarps warps run the
// instantiation bounded at kMaxWarps (ptxas sizes its registers for 128
// threads: 96 on sm_90a), larger ones the instantiation bounded at
// kMaxWalkWarps (128 registers: the wider bound lets ptxas spend more, and
// the same body ran ~6% slower on an H100 with it); the body is one.
//
// Per bucket: the keep path (no insert and no delete in the slice, most
// buckets of a mixed batch; write_packed), or the whole update path of
// flix_warp.cuh: merge_inserts, then delete_compact of the merged stripe
// back into the slot it came from, then write_compacted.  The results are
// those of flix_phases.cuh's merge_phase -> mark_deletes -> compact_phase ->
// write_stripe, byte for byte, with flow_out and del_out.  Then the reads:
// one POINT / SUCCESSOR op per lane against the post-update stripe in the
// slot.  SUCCESSOR ops with no in-bucket candidate keep (EMPTY, NOT_FOUND);
// the wrapper resolves them from the fence rows.
//
// Bound on the card: bytes, as for flix_apply.cu: the functional pass
// writes every stripe whole (the old state stays valid for a
// restructure-and-retry) and needs of the old stripe only the rows that
// hold keys, which is all this kernel reads of it.
//
// The donated pass (flix_apply_inplace_launch, ExecConfig.donate) writes
// the result into the input's planes instead, so its bytes are those of the
// batch: each update's and each read's rows, and of the buckets whose keys
// move, their rows (as many as they hold before or after) and metadata.
// Five kernels, one launch call:
//   * flix_apply_inplace_plan_kernel, a thread per bucket: copies num_nodes
//     into the result's (the counts stay functional), lists the buckets
//     with deletes for the write, counts the inserts, and decides for each
//     bucket with inserts whether it may overflow: it cannot where
//     nn + m <= npb (a region's keys and inserts take at most a piece for
//     each old row and one for each insert), it does where m > S, and the
//     rest are listed;
//   * flix_apply_inplace_check_kernel, a warp per listed bucket: the
//     merge's own plan (merge_plan) on its rows, an overflow counted where
//     the merge would overflow;
//   * flix_apply_inplace_upsert_kernel, a thread per INSERT op: a key the
//     bucket holds gets its new value in place (where the merge would put
//     it: an upsert moves no key); a key it does not hold lists its bucket
//     for the write, once, unless it has deletes and is listed already;
//   * flix_apply_inplace_kernel, the staged walk over the listed buckets:
//     the update path above, its rows, node counts, node max and num_nodes
//     written back;
//   * flix_apply_inplace_read_kernel, a thread per op: each POINT and
//     SUCCESSOR op located in its bucket's post-update rows, as the staged
//     kernel's reads do, so that many reads of a hot key are answered in
//     parallel and not by one warp.
// Where a bucket overflows, or the state already needs restructuring, the
// last three write nothing at all: the input stays whole for
// apply_ops_safe's functional rerun and retry.  A bucket the batch leaves
// alone keeps its bytes, which are the functional pass's on every state the
// engine makes (EMPTY keys, 0 values and counts past the live slots).
//
// The read-only pass (flix_apply_read_launch) serves a batch without
// updates: one kernel, a thread per op, that finds each op's bucket by a
// binary search of the fences (the 16 MB of a 2^22-bucket index stay in
// L2), locates it as the donated pass's reads do, and writes nothing of the
// state.  A thread an op and not a warp a run of buckets: a skewed batch
// reads a hot key tens of thousands of times, and a warp that owned its
// bucket would answer them 32 at a time.
#include <cuda_runtime.h>

#include "flix_warp.cuh"

namespace {

using namespace flix;

// the op, insert and delete slices staged with a bucket when they fit
using StagedRing = Ring<32, 16, 16>;

// Bucket b's scalars, one a lane: lanes 0-5 its six slice bounds, lane 6
// its active rows (0 past the last bucket).
__device__ __forceinline__ int load_bounds(const ApplyArgs& a, const int* num_nodes, int b,
                                           int nb, int npb, int lane) {
  if (b >= nb || lane > kNumNodes) return 0;
  if (lane == kNumNodes) return min(max(num_nodes[b], 0), npb);
  const int* bound = lane == kInsStart  ? a.ins_starts
                     : lane == kInsEnd  ? a.ins_ends
                     : lane == kDelStart ? a.del_starts
                     : lane == kDelEnd  ? a.del_ends
                     : lane == kOpStart ? a.op_starts
                                        : a.op_ends;
  return bound[b];
}

// Start staging bucket b, whose scalars the lanes hold in bnd (load_bounds),
// into slot r: its live rows, node max row, scalars, and its slices where
// they fit.
__device__ inline void stage_bucket(const StagedRing& r, const ApplyArgs& a, int b, int bnd,
                                    int npb, int ns, int lane) {
  const int S = npb * ns;
  const int i0 = __shfl_sync(kFull, bnd, kInsStart), i1 = __shfl_sync(kFull, bnd, kInsEnd);
  const int d0 = __shfl_sync(kFull, bnd, kDelStart), d1 = __shfl_sync(kFull, bnd, kDelEnd);
  const int o0 = __shfl_sync(kFull, bnd, kOpStart), o1 = __shfl_sync(kFull, bnd, kOpEnd);
  stage_rows(r, a.keys, a.vals, a.node_max, b, bnd, npb, ns, lane);
  const int m = min(max(i1 - i0, 0), S), dn = max(d1 - d0, 0), no = max(o1 - o0, 0);
  if (m <= StagedRing::kInsCap) {
    stage_slice(r.Ins, a.ins_keys + i0, m, lane);
    stage_slice(r.Ins + StagedRing::kInsCap, a.ins_vals + i0, m, lane);
  }
  if (dn <= StagedRing::kDelCap) stage_slice(r.Del, a.del_keys + d0, dn, lane);
  if (no <= StagedRing::kOpCap) {
    stage_slice(r.Op, a.op_tag + o0, no, lane);
    stage_slice(r.Op + StagedRing::kOpCap, a.op_key + o0, no, lane);
  }
}

// The bucket's POINT ops and in-bucket SUCCESSOR candidates, one op a lane,
// against the post-update stripe in r (apply_bucket's reads).
__device__ inline void read_ops(const StagedRing& r, const ApplyArgs& a, const int* tags,
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

// Bucket b in slot r: the keep path, or the update path (merge, delete and
// compact back into r.A/r.Av, write); then the reads against the result.
__device__ inline void staged_bucket(const StagedRing& r, const Scratch& s, const ApplyArgs& a,
                                     int b, int npb, int ns, int lane) {
  const int S = npb * ns;
  const StripeOut o = {a.keys_out, a.vals_out, a.count_out, a.max_out, a.nn_out};
  const int nn = r.Bnd[kNumNodes];
  const int i0 = r.Bnd[kInsStart], d0 = r.Bnd[kDelStart];
  const int o0 = r.Bnd[kOpStart], o1 = r.Bnd[kOpEnd];
  const int m = min(max(r.Bnd[kInsEnd] - i0, 0), S);
  const int dn = max(r.Bnd[kDelEnd] - d0, 0);
  int nn_out = nn;
  if (m == 0 && dn == 0) {
    write_packed<false>(s, r.A, r.Av, nn * ns, S, r.Nmax, o, b, npb, ns, lane);
    if (lane == 0) {
      a.flow_out[b] = 0;
      a.del_out[b] = 0;
    }
  } else {
    const bool ins_in = m <= StagedRing::kInsCap;
    const Merged mg = merge_inserts(r, s, ins_in ? r.Ins : a.ins_keys + i0,
                                    ins_in ? r.Ins + StagedRing::kInsCap : a.ins_vals + i0, m,
                                    nn, npb, ns, lane);
    const Compacted c = delete_compact(s, s.M, s.Mv, mg.slots,
                                       dn <= StagedRing::kDelCap ? r.Del : a.del_keys + d0, dn,
                                       r.A, r.Av, npb, ns, lane);
    write_compacted(s, r.A, r.Av, c.nn, r.Nmax, o, b, npb, ns, lane);
    if (lane == 0) {
      a.flow_out[b] = mg.pieces > npb;
      a.del_out[b] = c.hits;
    }
    nn_out = c.nn;
  }
  __syncwarp();
  const bool ops_in = o1 - o0 <= StagedRing::kOpCap;
  read_ops(r, a, ops_in ? r.Op : a.op_tag + o0, ops_in ? r.Op + StagedRing::kOpCap : a.op_key + o0,
           o0, o1, nn_out, npb, ns, lane);
}

template <int MaxWarps>
__global__ void __launch_bounds__(MaxWarps * 32)
    flix_apply_staged_kernel(const ApplyArgs a, const int* __restrict__ num_nodes, int nb,
                             int npb, int ns) {
  extern __shared__ __align__(16) int smem[];
  walk_buckets<StagedRing>(
      smem, nb, npb, ns,
      [&](int b, int lane) { return load_bounds(a, num_nodes, b, nb, npb, lane); },
      [&](const StagedRing& r, int b, int bnd, int lane) {
        stage_bucket(r, a, b, bnd, npb, ns, lane);
      },
      [&](const StagedRing& r, const Scratch& s, int b, int lane) {
        staged_bucket(r, s, a, b, npb, ns, lane);
      });
}

// ---------------------------------------------------------------------------
// the donated pass
// ---------------------------------------------------------------------------

// counts[] of the donated pass (zeroed by its launch): the inserts (each
// bucket's slice cut at its capacity), the keys deleted, the buckets that
// overflow, the buckets listed for the write (with deletes, or an insert of
// a key they do not hold), the buckets whose overflow the check kernel
// decides
constexpr int kInserted = 0, kDeleted = 1, kOverflowed = 2, kWritten = 3, kChecked = 4,
              kCounts = 5;
// the plan's blocks: threads, and buckets a thread
constexpr int kPlanThreads = 256, kPlanPerThread = 4;
// the blocks of the kernels a thread an op
constexpr int kOpThreads = 256;
constexpr int kOpInsert = 0, kOpRange = 5;
// the bits of the read pass's class word: the batch holds SUCCESSOR ops, RANGE ops
constexpr int kHasSuccessor = 1, kHasRange = 2;
// the lane whose staged scalar is the bucket's index: the walk goes by a list
constexpr int kBucket = kBoundInts - 1;
static_assert(kBucket > kNumNodes, "the bucket's index takes a scalar of its own");

// The slot in a list of each thread of the block whose flag is set: one
// atomicAdd on *count a block.  sm holds a count a warp and the base.
__device__ inline int block_slot(bool flag, int* count, int* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const unsigned mask = __ballot_sync(kFull, flag);
  if (lane == 0) sm[warp] = __popc(mask);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < warps; ++w) {
      const int c = sm[w];
      sm[w] = total;
      total += c;
    }
    sm[warps] = total != 0 ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  const int slot = sm[warps] + sm[warp] + __popc(mask & lanes_below(lane));
  __syncthreads();  // sm is free for the next call
  return slot;
}

// Add the block's values of v to *target: one atomicAdd a block.
__device__ inline void block_add(int v, int* target, int* sm) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += sm[w];
    if (total != 0) atomicAdd(target, total);
  }
  __syncthreads();
}

// The plan: kPlanPerThread buckets a thread, their loads issued together.
__global__ void __launch_bounds__(kPlanThreads)
    flix_apply_inplace_plan_kernel(const ApplyArgs a, const int* __restrict__ num_nodes,
                                   int* __restrict__ work, int* __restrict__ checks,
                                   int* __restrict__ counts, int nb, int npb, int ns) {
  __shared__ int sm[kPlanThreads / 32 + 1];
  const int S = npb * ns;
  int raw[kPlanPerThread], m[kPlanPerThread], dn[kPlanPerThread];
  const long long b0 = (long long)blockIdx.x * kPlanPerThread * kPlanThreads + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPlanPerThread; ++k) {
    const long long b = b0 + k * kPlanThreads;
    raw[k] = m[k] = dn[k] = 0;
    if (b < nb) {
      raw[k] = num_nodes[b];
      m[k] = max(a.ins_ends[b] - a.ins_starts[b], 0);
      dn[k] = max(a.del_ends[b] - a.del_starts[b], 0);
    }
  }
  int inserted = 0, over = 0;
#pragma unroll
  for (int k = 0; k < kPlanPerThread; ++k) {
    const long long b = b0 + k * kPlanThreads;
    if (b < nb) a.nn_out[b] = raw[k];
    const int nn = min(max(raw[k], 0), npb);
    inserted += min(m[k], S);
    over += m[k] > S;
    const bool listed = dn[k] > 0;
    const bool check = m[k] > 0 && m[k] <= S && nn + m[k] > npb;
    const int ws = block_slot(listed, counts + kWritten, sm);
    if (listed) work[ws] = (int)b;
    const int cs = block_slot(check, counts + kChecked, sm);
    if (check) checks[cs] = (int)b;
  }
  block_add(inserted, counts + kInserted, sm);
  block_add(over, counts + kOverflowed, sm);
}

// The listed buckets whose overflow the plan left open, a warp each: the
// merge's plan on the bucket's rows, read into the warp's first ring slot.
__global__ void __launch_bounds__(kMaxWarps * 32)
    flix_apply_inplace_check_kernel(const ApplyArgs a, const int* __restrict__ num_nodes,
                                    const int* __restrict__ checks, int* counts, int npb,
                                    int ns) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31, S = npb * ns, n = counts[kChecked];
  int* w = smem + (threadIdx.x >> 5) * warp_ints<StagedRing>(npb, ns);
  const StagedRing r = StagedRing::at(w, 0, npb, ns);
  const Scratch s = carve_scratch<StagedRing>(w, npb, ns);
  const int W = gridDim.x * (blockDim.x >> 5);
  int over = 0;
  for (int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); i < n; i += W) {
    const int b = checks[i];
    const int nn = min(max(num_nodes[b], 0), npb), i0 = a.ins_starts[b];
    const int m = a.ins_ends[b] - i0;
    for (int j = lane; j < nn * ns; j += 32) r.A[j] = a.keys[(size_t)b * S + j];
    for (int j = lane; j < npb; j += 32)
      r.Nmax[j] = j < nn ? a.node_max[(size_t)b * npb + j] : kEmpty;
    __syncwarp();
    over += merge_plan(r, s, a.ins_keys + i0, m, nn, npb, ns, lane).pieces > npb;
    __syncwarp();  // the slot and scratch are free for the next bucket
  }
  if (lane == 0 && over != 0) atomicAdd(counts + kOverflowed, over);
}

// Start staging listed bucket b, whose scalars the lanes hold in bnd, into
// slot r: its live rows, node max row, scalars and, where they fit, its
// insert and delete slices.
__device__ inline void stage_updates(const StagedRing& r, const ApplyArgs& a, int b, int bnd,
                                     int npb, int ns, int lane) {
  const int S = npb * ns;
  const int i0 = __shfl_sync(kFull, bnd, kInsStart), i1 = __shfl_sync(kFull, bnd, kInsEnd);
  const int d0 = __shfl_sync(kFull, bnd, kDelStart), d1 = __shfl_sync(kFull, bnd, kDelEnd);
  stage_rows(r, a.keys, a.vals, a.node_max, b, bnd, npb, ns, lane);
  if (lane == kBucket) r.Bnd[kBucket] = bnd;
  const int m = min(max(i1 - i0, 0), S), dn = max(d1 - d0, 0);
  if (m <= StagedRing::kInsCap) {
    stage_slice(r.Ins, a.ins_keys + i0, m, lane);
    stage_slice(r.Ins + StagedRing::kInsCap, a.ins_vals + i0, m, lane);
  }
  if (dn <= StagedRing::kDelCap) stage_slice(r.Del, a.del_keys + d0, dn, lane);
}

// Listed bucket r.Bnd[kBucket] in slot r, written in place: the update
// path, then the rows that held or now hold keys, and the metadata.  Adds
// the keys deleted to `deleted`.
__device__ inline void inplace_bucket(const StagedRing& r, const Scratch& s, const ApplyArgs& a,
                                      int npb, int ns, int lane, int& deleted) {
  const int S = npb * ns, b = r.Bnd[kBucket];
  const int nn = r.Bnd[kNumNodes], i0 = r.Bnd[kInsStart], d0 = r.Bnd[kDelStart];
  const int m = min(max(r.Bnd[kInsEnd] - i0, 0), S);
  const int dn = max(r.Bnd[kDelEnd] - d0, 0);
  const bool ins_in = m <= StagedRing::kInsCap;
  const StripeOut o = {a.keys_out, a.vals_out, a.count_out, a.max_out, a.nn_out};
  const Merged mg = merge_inserts(r, s, ins_in ? r.Ins : a.ins_keys + i0,
                                  ins_in ? r.Ins + StagedRing::kInsCap : a.ins_vals + i0, m,
                                  nn, npb, ns, lane);
  const Compacted c = delete_compact(s, s.M, s.Mv, mg.slots,
                                     dn <= StagedRing::kDelCap ? r.Del : a.del_keys + d0, dn,
                                     r.A, r.Av, npb, ns, lane);
  write_compacted(s, r.A, r.Av, c.nn, r.Nmax, o, b, npb, ns, lane, max(nn, c.nn) * ns);
  deleted += c.hits;
}

// The INSERT ops, a thread each (bucket[i] its op's bucket): a key the
// bucket holds (in the input's rows) gets op_val[i] in place; a key it does
// not hold marks the bucket in `fresh` (a bit a bucket, zeroed by the
// launch) and the first to mark it lists it for the write, unless it has
// deletes (the plan listed those).  The write's merge of a listed bucket
// then puts every upserted value where this kernel did.
__global__ void __launch_bounds__(kOpThreads)
    flix_apply_inplace_upsert_kernel(const ApplyArgs a, const int* __restrict__ num_nodes,
                                     const int* __restrict__ op_val,
                                     const int* __restrict__ bucket, int* __restrict__ work,
                                     int* counts, unsigned* __restrict__ fresh,
                                     const unsigned char* __restrict__ needs_restructure,
                                     int n, int nb, int npb, int ns) {
  if (counts[kOverflowed] != 0 || *needs_restructure != 0) return;  // write nothing
  const int lane = threadIdx.x & 31, S = npb * ns;
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < n; base += stride) {
    const int i = base + lane;
    bool listed = false;
    int b = 0;
    if (i < n && a.op_tag[i] == kOpInsert) {
      b = bucket[i];
      if (b >= 0 && b < nb && i >= a.op_starts[b] && i < a.op_ends[b]) {
        const int q = a.op_key[i], nn = min(max(num_nodes[b], 0), npb);
        const int* keys = a.keys + (size_t)b * S;
        const Located l = locate(keys, a.node_max + (size_t)b * npb, nn, npb, ns, q);
        const int at = l.node * ns + l.pos;
        if (l.in_bucket && l.raw_pos < ns && keys[at] == q) {
          a.vals_out[(size_t)b * S + at] = op_val[i];
        } else {
          const unsigned bit = 1u << (b & 31);
          listed = (atomicOr(fresh + (b >> 5), bit) & bit) == 0 &&
                   a.del_ends[b] == a.del_starts[b];
        }
      }
    }
    const unsigned mask = __ballot_sync(kFull, listed);
    int at = 0;
    if (lane == 0 && mask != 0) at = atomicAdd(counts + kWritten, __popc(mask));
    at = __shfl_sync(kFull, at, 0);
    if (listed) work[at + __popc(mask & lanes_below(lane))] = b;
  }
}

// The listed buckets, a warp each at a time through the staged ring: the
// write of the donated pass.  Its outputs alias its inputs (a.keys_out is
// a.keys, and so on): a bucket's rows are staged before its warp writes
// them and are read by no other warp, nor again by this one.
template <int MaxWarps>
__global__ void __launch_bounds__(MaxWarps * 32)
    flix_apply_inplace_kernel(const ApplyArgs a, const int* __restrict__ num_nodes,
                              const int* __restrict__ work, int* counts,
                              const unsigned char* __restrict__ needs_restructure, int nb,
                              int npb, int ns) {
  if (counts[kOverflowed] != 0 || *needs_restructure != 0) return;  // write nothing
  const int n = counts[kWritten];
  extern __shared__ __align__(16) int smem[];
  int deleted = 0;
  walk_buckets<StagedRing>(
      smem, n, npb, ns,
      [&](int i, int lane) {
        if (i >= n) return 0;
        const int b = work[i];
        return lane == kBucket ? b : load_bounds(a, num_nodes, b, nb, npb, lane);
      },
      [&](const StagedRing& r, int, int bnd, int lane) {
        stage_updates(r, a, __shfl_sync(kFull, bnd, kBucket), bnd, npb, ns, lane);
      },
      [&](const StagedRing& r, const Scratch& s, int, int lane) {
        inplace_bucket(r, s, a, npb, ns, lane, deleted);
      });
  if ((threadIdx.x & 31) == 0 && deleted != 0) atomicAdd(counts + kDeleted, deleted);
}

// A POINT or SUCCESSOR op's answer from bucket b's rows (keys, vals
// [nb, npb, ns], node_max [nb, npb], nn of them active): a POINT op's value
// where the bucket holds q, a SUCCESSOR op's in-bucket candidate (its key
// and value).  Where q lies above every key of the bucket, or the POINT
// key is absent, value and succ keep what the caller set.
__device__ __forceinline__ void answer_op(const int* keys, const int* vals, const int* node_max,
                                          int nn, int npb, int ns, int b, int tg, int q,
                                          int& value, int& succ) {
  const int S = npb * ns;
  const int* row = keys + (size_t)b * S;
  const Located l = locate(row, node_max + (size_t)b * npb, min(max(nn, 0), npb), npb, ns, q);
  const int at = l.node * ns + l.pos;
  if (!l.in_bucket || l.raw_pos >= ns) return;
  if (tg == kOpPoint) {
    if (row[at] == q) value = vals[(size_t)b * S + at];
  } else {
    succ = row[at];
    value = vals[(size_t)b * S + at];
  }
}

// The reads of the donated pass, a thread per op, writing every op's value
// and successor key: a POINT or SUCCESSOR op of bucket bucket[i]'s slice
// located in the bucket's post-update rows (nn_out of them; node max EMPTY
// past them) and answered by answer_op; (NOT_FOUND, EMPTY) for the
// rest, and for every op where nothing was written.
__global__ void __launch_bounds__(kOpThreads)
    flix_apply_inplace_read_kernel(const ApplyArgs a, const int* __restrict__ bucket,
                                   const int* counts,
                                   const unsigned char* __restrict__ needs_restructure, int n,
                                   int nb, int npb, int ns) {
  const bool none = counts[kOverflowed] != 0 || *needs_restructure != 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    int value = kMiss, succ = kEmpty;
    const int tg = none ? -1 : a.op_tag[i];
    const int b = tg == kOpPoint || tg == kOpSuccessor ? bucket[i] : -1;
    if (b >= 0 && b < nb && i >= a.op_starts[b] && i < a.op_ends[b])
      answer_op(a.keys, a.vals, a.node_max, a.nn_out[b], npb, ns, b, tg, a.op_key[i], value,
                succ);
    a.value_out[i] = value;
    a.succ_out[i] = succ;
  }
}

// The read-only pass, a thread per op, on a state the batch does not
// write: the op's bucket by a binary search of the fences (clamped to the
// last bucket, as the engine routes: a key above the last fence finds no
// row there), then a POINT or SUCCESSOR op answered by answer_op from the
// bucket's num_nodes active rows; (NOT_FOUND, EMPTY) for the rest.  Writes every op's bucket, and
// ORs into *classes the kHasSuccessor and kHasRange bits of the ops it
// met, one atomic a warp that met any.  No restructure flag gates it: a
// flagged state is read as it stands.
__global__ void __launch_bounds__(kOpThreads)
    flix_apply_read_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
                           const int* __restrict__ node_max, const int* __restrict__ num_nodes,
                           const int* __restrict__ mkba, const int* __restrict__ op_tag,
                           const int* __restrict__ op_key, int* __restrict__ value_out,
                           int* __restrict__ succ_out, int* __restrict__ bucket_out,
                           int* classes, int n, int nb, int npb, int ns) {
  int seen = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int tg = op_tag[i], q = op_key[i];
    const int b = min(lower_bound(mkba, nb, q), nb - 1);
    int value = kMiss, succ = kEmpty;
    if (tg == kOpPoint || tg == kOpSuccessor)
      answer_op(keys, vals, node_max, num_nodes[b], npb, ns, b, tg, q, value, succ);
    seen |= (tg == kOpSuccessor ? kHasSuccessor : 0) | (tg == kOpRange ? kHasRange : 0);
    value_out[i] = value;
    succ_out[i] = succ;
    bucket_out[i] = b;
  }
  seen = __reduce_or_sync(kFull, seen);
  if ((threadIdx.x & 31) == 0 && seen != 0) atomicOr(classes, seen);
}

using StagedKernel = decltype(&flix_apply_staged_kernel<kMaxWarps>);
using InplaceKernel = decltype(&flix_apply_inplace_kernel<kMaxWarps>);

// The instantiation that runs blocks of `warps` warps (0: the default count).
StagedKernel staged_kernel(int npb, int ns, int warps) {
  if (warps_per_block<StagedRing>(npb, ns, warps) <= kMaxWarps)
    return flix_apply_staged_kernel<kMaxWarps>;
  return flix_apply_staged_kernel<kMaxWalkWarps>;
}

// The same choice for the donated pass's write.
InplaceKernel inplace_kernel(int npb, int ns, int warps) {
  if (warps_per_block<StagedRing>(npb, ns, warps) <= kMaxWarps)
    return flix_apply_inplace_kernel<kMaxWarps>;
  return flix_apply_inplace_kernel<kMaxWalkWarps>;
}

}  // namespace

extern "C" {

// Dynamic shared memory one staged block of `warps` warps (0: the default
// count of warps_per_block) needs for a (npb, ns) geometry: its warps' rings
// and scratch (INT_MAX where that does not fit an int).
int flix_apply_staged_smem_bytes(int npb, int ns, int warps) {
  return walk_smem_bytes<StagedRing>(npb, ns, warps);
}

// Staged blocks of `warps` warps (0: the default count) that one SM holds at
// once for a (npb, ns) geometry, as the occupancy API answers for the launch
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor after the shared memory
// opt-in); minus the CUDA error code on failure.
int flix_apply_staged_blocks_per_sm(int npb, int ns, int warps) {
  if (warps < 0 || warps > kMaxWalkWarps) return -(int)cudaErrorInvalidValue;
  const int threads = 32 * warps_per_block<StagedRing>(npb, ns, warps);
  int dev = 0, sms = 0, resident = 0;
  int e = walk_capacity(reinterpret_cast<const void*>(staged_kernel(npb, ns, warps)), npb, ns,
                        threads, walk_smem_bytes<StagedRing>(npb, ns, warps), &resident);
  if (e == 0) e = (int)cudaGetDevice(&dev);
  if (e == 0) e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e != 0 ? -e : resident / sms;
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
                             int ns, int warps, void* stream) {
  const ApplyArgs a = {keys,      vals,       node_max,   ins_keys,  ins_vals, ins_starts,
                       ins_ends,  del_keys,   del_starts, del_ends,  op_tag,   op_key,
                       op_starts, op_ends,    keys_out,   vals_out,  count_out, max_out,
                       nn_out,    flow_out,   del_out,    value_out, succ_out};
  return launch_walk<StagedRing>(staged_kernel(npb, ns, warps), nb, npb, ns, warps, stream, a,
                                 num_nodes, nb, npb, ns);
}

// The donated pass: zero counts[kCounts] and fresh[(nb + 31) / 32], then its
// five kernels (the write in blocks of `warps` warps, as for
// flix_apply_staged_launch).  keys, vals, node_count and node_max are the
// state's planes, written in place; nn_out [nb] receives num_nodes; op_val
// and bucket [ops] hold each op's value and bucket (clamped into range);
// work and checks hold work_cap >= min(nb, ops) ints each.  Returns the
// CUDA error code.
int flix_apply_inplace_launch(int* keys, int* vals, int* node_max, const int* ins_keys,
                              const int* ins_vals, const int* ins_starts, const int* ins_ends,
                              const int* del_keys, const int* del_starts, const int* del_ends,
                              const int* op_tag, const int* op_key, const int* op_starts,
                              const int* op_ends, const int* num_nodes, int* node_count,
                              const unsigned char* needs_restructure, const int* op_val,
                              const int* bucket, int* nn_out, int* value_out, int* succ_out,
                              int* work, int* checks, unsigned* fresh, int* counts, int nb,
                              int npb, int ns, int n_ops, int work_cap, int warps,
                              void* stream) {
  if (warps < 0 || warps > kMaxWalkWarps) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int e = (int)cudaMemsetAsync(counts, 0, kCounts * sizeof(int), st);
  if (e == 0) e = (int)cudaMemsetAsync(fresh, 0, ((nb + 31) / 32) * sizeof(unsigned), st);
  if (e != 0 || nb == 0) return e;
  const ApplyArgs a = {keys,      vals,       node_max,   ins_keys,  ins_vals,   ins_starts,
                       ins_ends,  del_keys,   del_starts, del_ends,  op_tag,     op_key,
                       op_starts, op_ends,    keys,       vals,      node_count, node_max,
                       nn_out,    nullptr,    nullptr,    value_out, succ_out};
  const long long per_block = (long long)kPlanThreads * kPlanPerThread;
  flix_apply_inplace_plan_kernel<<<(int)((nb + per_block - 1) / per_block), kPlanThreads, 0,
                                   st>>>(a, num_nodes, work, checks, counts, nb, npb, ns);
  if ((e = (int)cudaGetLastError()) != 0 || work_cap == 0) return e;
  const int smem = walk_smem_bytes<StagedRing>(npb, ns);
  const int wpb = warps_per_block<StagedRing>(npb, ns);
  int resident = 0, dev = 0, sms = 0;
  e = walk_capacity(reinterpret_cast<const void*>(flix_apply_inplace_check_kernel), npb, ns,
                    32 * wpb, smem, &resident);
  if (e != 0) return e;
  const int need = (work_cap + wpb - 1) / wpb;
  flix_apply_inplace_check_kernel<<<need < resident ? need : resident, 32 * wpb, smem, st>>>(
      a, num_nodes, checks, counts, npb, ns);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  if ((e = (int)cudaGetDevice(&dev)) != 0) return e;
  if ((e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0) return e;
  const int op_blocks = (n_ops + kOpThreads - 1) / kOpThreads, most = 8 * sms;
  const int grid = op_blocks < most ? op_blocks : most;
  flix_apply_inplace_upsert_kernel<<<grid, kOpThreads, 0, st>>>(
      a, num_nodes, op_val, bucket, work, counts, fresh, needs_restructure, n_ops, nb, npb, ns);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  e = launch_walk<StagedRing>(inplace_kernel(npb, ns, warps), work_cap, npb, ns, warps, stream,
                              a, num_nodes, work, counts, needs_restructure, nb, npb, ns);
  if (e != 0) return e;
  flix_apply_inplace_read_kernel<<<grid, kOpThreads, 0, st>>>(a, bucket, counts,
                                                              needs_restructure, n_ops, nb,
                                                              npb, ns);
  return (int)cudaGetLastError();
}

// The read-only pass: zero classes[1], then flix_apply_read_kernel over the
// n_ops ops of the sorted batch (op_tag, op_key) against the state's planes
// keys, vals [nb, npb, ns], node_max [nb, npb], num_nodes and the fences
// mkba [nb] (nb >= 1), none of which it writes; value_out, succ_out and
// bucket_out [n_ops] receive every op's answer and bucket.  Returns the
// CUDA error code.
int flix_apply_read_launch(const int* keys, const int* vals, const int* node_max,
                           const int* num_nodes, const int* mkba, const int* op_tag,
                           const int* op_key, int* value_out, int* succ_out, int* bucket_out,
                           int* classes, int nb, int npb, int ns, int n_ops, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int e = (int)cudaMemsetAsync(classes, 0, sizeof(int), st);
  if (e != 0 || n_ops == 0) return e;
  if (nb < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  if ((e = (int)cudaGetDevice(&dev)) != 0) return e;
  if ((e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0) return e;
  const int op_blocks = (n_ops + kOpThreads - 1) / kOpThreads, most = 8 * sms;
  flix_apply_read_kernel<<<op_blocks < most ? op_blocks : most, kOpThreads, 0, st>>>(
      keys, vals, node_max, num_nodes, mkba, op_tag, op_key, value_out, succ_out, bucket_out,
      classes, n_ops, nb, npb, ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
