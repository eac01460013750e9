// flix_apply: the fused mixed-batch pass of FliX for Hopper (sm_90a), a
// thread block per bucket at a time.
//
// Replaces the TPU kernel repro/kernels/flix_apply.py:_stripe_body, run by
// _apply_kernel (one pl.pallas_call per batch).  For each bucket the block
// takes its slices of the sorted batch (the flipped routing: inserts,
// deletes, reads), upsert-merges the inserts with the original-node-region
// re-chunk, deletes with in-node and chain compaction, writes the new
// stripe and its metadata, and answers the bucket's POINT ops and in-bucket
// SUCCESSOR candidates against the post-update stripe.  The merge, delete
// and compaction are the block phases of flix_phases.cuh (block scans),
// and the active rows are counted from node_max: this kernel shares no
// stripe code with the warp-per-bucket staged kernel (flix_apply_staged.cu)
// and stays its independent witness.  The dense RANGE output is the second
// launch, the gather of flix_range.cu.
//
// Bound on the card: bytes.  The pass is functional (the old state stays
// valid for a restructure-and-retry), so it writes every stripe whole, but
// of the old stripe it reads only the node rows that hold keys, which
// node_max marks.  At the main path's geometry (2^20 buckets of 16 nodes x
// 32 keys, int32 keys and vals, ~16 keys a bucket in one node) that is
// 4.29 GB written and ~0.27 GB of rows read, plus the node_max plane,
// slices and per-op results: about 4.8 GB or 1.44 ms at 3.35 TB/s.
//
// Design.  Persistent blocks, as many as the occupancy API lets every SM
// hold (asked once per device and geometry), each walking the buckets
// b = blockIdx.x, blockIdx.x + gridDim.x, ...  A block is one producer warp
// (the last) and stripe_threads(S) stripe workers (4 warps at most;
// block_threads(S) in all, flix_phases.cuh), which
// run one bucket at a time through a ring of kStages stages in shared
// memory:
//   * the producer fetches each bucket's node max row and six slice bounds
//     by cp.async into a ring of its own, kMetaDepth buckets ahead.  Once a
//     bucket's have landed and its stage is free, it counts the active rows
//     nn (node_max not EMPTY; I3/I4 pack them first), copies the row and
//     bounds over, and has the bulk-copy engine bring just those rows, nn*ns
//     keys and vals, and the 16-byte windows around the bucket's op, insert
//     and delete slices where they fit, completing on the stage's full
//     mbarrier;
//   * the workers wait on the full barrier and run the bucket.  A bucket
//     with no insert and no delete (about two thirds of a mixed batch's)
//     keeps its rows: only the vals at EMPTY slots in them are zeroed.
//     Otherwise the update path: merge_phase -> mark_deletes ->
//     compact_phase, the result compacted back into the stage;
//   * the finished stripe goes out whole: the rows that hold keys from the
//     stage, the rest EMPTY / 0, by the workers' 16-byte stores; the stage
//     is handed back to the producer (its empty mbarrier) at the next
//     bucket.  Bulk stores of the stripe (the tail from a constant EMPTY / 0
//     stripe in shared memory) were slower on the H100's mixed batches
//     (PERF.md, the PR 20 findings) and are not kept.
// So the stripe crosses device memory once each way, with only the bytes a
// bucket needs read, and no thread waits on device memory on a bucket's
// path (longer slices are read in place).  Where alignment forbids a bulk
// copy (ns not a multiple of 4 ints, a plane not 16-byte aligned) the same
// kernel copies rows in by cp.async, stripes out by 4-byte stores, and
// reads the slices in place; the launch picks these paths from the planes'
// alignment alone.
//
// What holds it above the bound: a bucket takes a whole block, and both
// paths are chains of dependent shared-memory steps and barriers (the
// update path's block phases several times a keep bucket's), so the pass
// goes as fast as the buckets in flight: one a block, 7 blocks an SM (the
// register cap below).  Blocks of 4 worker warps fit more of them than 8
// warps would.  Compiling the main path's geometry (16 x 32, aligned
// planes) in as constants (pick_kernel) shortens those chains the most:
// every other launch runs the generic instantiation; shared-memory
// stores cost more than their count suggests, so the update path clears
// only the rows it can fill.  On the H100 a batch that keeps every bucket
// still takes ~2.05 ms for 2^20 buckets, where fill_ / zero_ of both
// planes takes ~1.31 ms (tools/torch_stripe_bench.py).
#include <cuda_runtime.h>

#include <climits>
#include <map>
#include <mutex>
#include <tuple>

#include "flix_bulk.cuh"
#include "flix_phases.cuh"

namespace {

using namespace flix;

constexpr int kStages = 3;  // at least 3: a stage is handed back a bucket late
constexpr int kMetaDepth = 8;  // buckets whose metadata the producer has in flight
// the longest op (tag and key), insert (key and val) and delete slices
// staged with a bucket; longer ones are read in place.  A slice is copied
// as the 16-byte window around it, at most cap + 4 ints.
constexpr int kOpCap = 32, kInsCap = 16, kDelCap = 16;
constexpr int kOpWin = kOpCap + 4, kInsWin = kInsCap + 4, kDelWin = kDelCap + 4;
// copy paths (the kernel's `paths`), each where the planes' alignment
// allows it: rows in by bulk copies (else by 4-byte cp.async), stripes out
// by 16-byte stores (else 4-byte), short slices staged by bulk copies (else
// read in place)
constexpr int kBulkRows = 1, kVecStores = 2, kBulkSlices = 4;
constexpr int kAligned = kBulkRows | kVecStores | kBulkSlices;
// a bucket's scalars: the six slice bounds, then (in a stage) the active
// node count and which slices are staged (kStagedOps | kStagedIns | ...)
enum { kInsStart, kInsEnd, kDelStart, kDelEnd, kOpStart, kOpEnd, kActive, kStaged, kBndInts };
constexpr int kStagedOps = 1, kStagedIns = 2, kStagedDel = 4;

__host__ __device__ inline long long round4(long long x) { return (x + 3) & ~3LL; }

// One ring stage: the bucket's rows (A/Av: nn rows copied in, the whole
// result before it goes out), node max row, scalars and short slices.
struct Stage {
  int* A;
  int* Av;
  int* Nmax;
  int* Bnd;
  int* Op;   // [2 * kOpWin] tags, then keys
  int* Ins;  // [2 * kInsWin] keys, then vals
  int* Del;  // [kDelWin]
};

// Every region of a stage that a bulk copy writes starts 16-byte aligned.
__host__ __device__ inline long long stage_ints(int npb, int ns) {
  const long long S4 = round4((long long)npb * ns);
  return round4(2 * S4 + npb + kBndInts) + 2 * kOpWin + 2 * kInsWin + kDelWin;
}

// One slot of the producer's metadata ring: a bucket's node max row and its
// six slice bounds.
__host__ __device__ inline long long meta_ints(int npb) { return round4(npb + kBndInts); }

constexpr int kBarInts = 4 * kStages;  // the full and empty barriers, 8 bytes each

// barriers, ring, metadata ring, scratch
__host__ __device__ inline long long apply_smem_ints(int npb, int ns) {
  return kBarInts + kStages * stage_ints(npb, ns) + kMetaDepth * meta_ints(npb) +
         block_scratch_ints(npb, ns);
}

__device__ inline Stage stage_at(int* ring, int k, int npb, int ns) {
  const int S4 = (int)round4(npb * ns);
  Stage r;
  r.A = ring + k * stage_ints(npb, ns);
  r.Av = r.A + S4;
  r.Nmax = r.Av + S4;
  r.Bnd = r.Nmax + npb;
  r.Op = r.A + round4(2 * S4 + npb + kBndInts);
  r.Ins = r.Op + 2 * kOpWin;
  r.Del = r.Ins + 2 * kInsWin;
  return r;
}

// ---------------------------------------------------------------------------
// the producer warp
// ---------------------------------------------------------------------------

// Start copying bucket b's node max row and slice bounds into meta slot m
// (node max row, then the bounds).
__device__ inline void fetch_meta(int* m, const ApplyArgs& a, int b, int npb, int lane) {
  warp_copy_async(m, a.node_max + (size_t)b * npb, npb, lane);
  if (lane < kActive) {
    const int* bound = lane == kInsStart  ? a.ins_starts
                       : lane == kInsEnd  ? a.ins_ends
                       : lane == kDelStart ? a.del_starts
                       : lane == kDelEnd  ? a.del_ends
                       : lane == kOpStart ? a.op_starts
                                          : a.op_ends;
    cp_async4(m + npb + lane, bound + b);
  }
}

// The 16-byte window [w0, w1) of ints around a slice [start, start + n) of
// a column whose buckets' slices end at or before `last`: false where the
// slice is longer than cap or its window would pass `last`.
__device__ __forceinline__ bool slice_window(int start, int n, int cap, int last, int& w0,
                                             int& w1) {
  w0 = start & ~3;
  w1 = (start + n + 3) & ~3;
  return n <= cap && (n == 0 || w1 <= last);
}

// Stage bucket b, whose metadata has landed in meta slot m, into stage r:
// count its active rows, copy its node max row and scalars over, and have
// the copy engine bring its active rows and short slices in; the stage's
// full barrier completes when all of it has landed.  `last` holds the end
// of the last bucket's insert, delete and op slices.
__device__ inline void stage_bucket(const Stage& r, const int* m, uint64_t* full,
                                    const ApplyArgs& a, int b, int npb, int ns, int paths,
                                    int3 last, int lane) {
  const int S = npb * ns;
  int nn = 0;
  for (int j0 = 0; j0 < npb; j0 += 32) {
    const int j = j0 + lane;
    const int x = j < npb ? m[j] : kEmpty;
    if (j < npb) r.Nmax[j] = x;
    nn += __popc(__ballot_sync(kFull, x != kEmpty));
  }
  const int* bnd = m + npb;
  const int i0 = bnd[kInsStart], d0 = bnd[kDelStart], o0 = bnd[kOpStart];
  const int n_ins = min(max(bnd[kInsEnd] - i0, 0), S);
  const int n_del = max(bnd[kDelEnd] - d0, 0), n_op = max(bnd[kOpEnd] - o0, 0);
  int wi0, wi1, wd0, wd1, wo0, wo1;
  int staged = 0;
  if (paths & kBulkSlices) {
    staged |= slice_window(i0, n_ins, kInsCap, last.x, wi0, wi1) ? kStagedIns : 0;
    staged |= slice_window(d0, n_del, kDelCap, last.y, wd0, wd1) ? kStagedDel : 0;
    staged |= slice_window(o0, n_op, kOpCap, last.z, wo0, wo1) ? kStagedOps : 0;
  }
  if (lane < kActive) r.Bnd[lane] = bnd[lane];
  if (lane == kActive) r.Bnd[kActive] = nn;
  if (lane == kStaged) r.Bnd[kStaged] = staged;

  const int L = nn * ns;
  const size_t base = (size_t)b * S;
  const bool bulk_rows = (paths & kBulkRows) && L > 0;
  if (!(paths & kBulkRows) && L > 0) {  // rows by cp.async, tracked by the full barrier
    warp_copy_async(r.A, a.keys + base, L, lane);
    warp_copy_async(r.Av, a.vals + base, L, lane);
    cp_async_arrive(full);  // before lane 0's arrival: __syncwarp below
  }
  __syncwarp();  // every lane's writes to the stage, before lane 0's arrival
  if (lane != 0) return;
  const bool ins = (staged & kStagedIns) && n_ins > 0, del = (staged & kStagedDel) && n_del > 0;
  const bool ops = (staged & kStagedOps) && n_op > 0;
  const uint32_t tx = (bulk_rows ? 8u * L : 0u) + (ins ? 8u * (wi1 - wi0) : 0u) +
                      (del ? 4u * (wd1 - wd0) : 0u) + (ops ? 8u * (wo1 - wo0) : 0u);
  if (tx == 0) {
    mbar_arrive(full);
    return;
  }
  mbar_arrive_expect_tx(full, tx);
  if (bulk_rows) {
    bulk_load(r.A, a.keys + base, 4u * L, full);
    bulk_load(r.Av, a.vals + base, 4u * L, full);
  }
  if (ins) {
    bulk_load(r.Ins, a.ins_keys + wi0, 4u * (wi1 - wi0), full);
    bulk_load(r.Ins + kInsWin, a.ins_vals + wi0, 4u * (wi1 - wi0), full);
  }
  if (del) bulk_load(r.Del, a.del_keys + wd0, 4u * (wd1 - wd0), full);
  if (ops) {
    bulk_load(r.Op, a.op_tag + wo0, 4u * (wo1 - wo0), full);
    bulk_load(r.Op + kOpWin, a.op_key + wo0, 4u * (wo1 - wo0), full);
  }
}

// The producer's walk: bucket j of the block's walk is staged once its
// metadata, fetched kMetaDepth buckets earlier into the metadata ring, has
// landed and the workers have handed its stage back.
__device__ inline void produce(int* ring, int* metas, uint64_t* full, uint64_t* empty,
                               const ApplyArgs& a, int nb, int npb, int ns, int paths) {
  const int lane = threadIdx.x & 31;
  const int3 last = make_int3(a.ins_ends[nb - 1], a.del_ends[nb - 1], a.op_ends[nb - 1]);
  const long long mi = meta_ints(npb);
  for (int d = 0; d < kMetaDepth; ++d) {  // one cp.async group per walk step
    const long long b = blockIdx.x + (long long)d * gridDim.x;
    if (b < nb) fetch_meta(metas + d * mi, a, (int)b, npb, lane);
    cp_async_commit();
  }
  for (int j = 0, b = blockIdx.x; b < nb; ++j, b += gridDim.x) {
    cp_async_wait<kMetaDepth - 1>();
    __syncwarp();
    const int k = j % kStages;
    mbar_wait(&empty[k], ((j / kStages) & 1) ^ 1);
    int* m = metas + (j % kMetaDepth) * mi;
    stage_bucket(stage_at(ring, k, npb, ns), m, &full[k], a, b, npb, ns, paths, last, lane);
    __syncwarp();  // the slot is read
    const long long next = b + (long long)kMetaDepth * gridDim.x;
    if (next < nb) fetch_meta(m, a, (int)next, npb, lane);
    cp_async_commit();
  }
  cp_async_wait<0>();  // every copy of this warp has landed before it exits
}

// ---------------------------------------------------------------------------
// the stripe workers
// ---------------------------------------------------------------------------

// The keep path's rows, in the stage: 0 for the vals of EMPTY slots in the
// nn active rows (as the compaction writes them).  In a state that holds
// I1-I4 the merge would re-chunk every active row into itself and the
// compaction keep it, so the rest goes out as it came in.
__device__ inline void keep_rows(const Stage& r, int nn, int ns) {
  for (int i = threadIdx.x; i < nn * ns; i += workers())
    if (r.A[i] == kEmpty) r.Av[i] = 0;
}

// The finished stripe out by the workers: its first L slots from the
// stage, EMPTY / 0 past them.
__device__ inline void store_stripe(const Stage& r, int* __restrict__ kout,
                                    int* __restrict__ vout, int L, int S, int paths) {
  const int t = threadIdx.x, T = workers();
  if (paths & kVecStores) {  // L is a whole number of rows: a multiple of 4
    for (int i = 4 * t; i < S; i += 4 * T) {
      const bool in = i < L;
      *reinterpret_cast<int4*>(kout + i) =
          in ? *reinterpret_cast<const int4*>(r.A + i) : make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
      *reinterpret_cast<int4*>(vout + i) =
          in ? *reinterpret_cast<const int4*>(r.Av + i) : make_int4(0, 0, 0, 0);
    }
  } else {
    for (int i = t; i < S; i += T) {
      kout[i] = i < L ? r.A[i] : kEmpty;
      vout[i] = i < L ? r.Av[i] : 0;
    }
  }
}

// The fused pass of bucket b, staged in r: merge the insert slice (cut at
// cap = S), delete, write the post-update stripe and its metadata, then
// answer the bucket's POINT ops and in-bucket SUCCESSOR candidates against
// it.  A bucket with no insert and no delete skips the merge and the
// compaction.  Each op belongs to at most one bucket, so the per-op writes
// never race.  SUCCESSOR ops with no in-bucket candidate keep (EMPTY,
// NOT_FOUND); the wrapper resolves them from the post-update fence rows.
// `done` is the previous bucket's stage, handed back to the producer here.
__device__ inline void apply_bucket(const Stage& r, Stripe s, uint64_t* done,
                                    const ApplyArgs& a, int b, int npb, int ns, int paths) {
  const int S = npb * ns, t = threadIdx.x, T = workers();
  const int nn = r.Bnd[kActive];
  const int i0 = r.Bnd[kInsStart], d0 = r.Bnd[kDelStart];
  const int o0 = r.Bnd[kOpStart], o1 = r.Bnd[kOpEnd];
  const int m = min(max(r.Bnd[kInsEnd] - i0, 0), S);
  const int dn = max(r.Bnd[kDelEnd] - d0, 0);
  const int staged = r.Bnd[kStaged];
  s.A = r.A;
  s.Av = r.Av;
  s.Nmax = r.Nmax;
  int nn_out = nn, flow = 0, hits = 0;
  if (m == 0 && dn == 0) {
    keep_rows(r, nn, ns);
    const size_t mbase = (size_t)b * npb;
    for (int j = t; j < npb; j += T) {
      a.count_out[mbase + j] = j < nn ? lower_bound(r.A + j * ns, ns, kEmpty) : 0;
      a.max_out[mbase + j] = r.Nmax[j];
    }
    if (t == 0) a.nn_out[b] = nn;
  } else {
    // the update path's scratch, first used behind merge_phase's first
    // barrier; a staged insert slice is read where it landed.  The merge
    // fills at most 2 max(nn, 1) + ceil(m / ns) pieces (each region's
    // count over ns, plus one), and only those rows of M are read after it.
    if (t == 0) s.Scalar[2] = 0;
    for (int j = t; j < npb; j += T) s.Mj[j] = 0;
    const int rows = min(npb, 2 * max(nn, 1) + (m + ns - 1) / ns);
    for (int i = t; i < rows * ns; i += T) {
      s.M[i] = kEmpty;
      s.Mv[i] = 0;
    }
    if (staged & kStagedIns) {
      s.B = r.Ins + (i0 & 3);
      s.Bv = r.Ins + kInsWin + (i0 & 3);
    } else {
      load_insert_slice(s, a.ins_keys + i0, a.ins_vals + i0, m);
    }
    merge_phase(s, nn, m, npb, ns);
    const int L = merged_slots(s, npb, ns);
    mark_deletes(s, s.M, staged & kStagedDel ? r.Del + (d0 & 3) : a.del_keys + d0, dn, L);
    compact_phase(s, s.M, s.Mv, r.A, r.Av, npb, ns, L);
    write_stripe(s, r.A, a.count_out, a.max_out, a.nn_out, b, npb, ns);
    flow = s.Scalar[1] > npb;
    hits = s.Scalar[2];
    nn_out = s.Scalar[3];
  }
  // the workers' writes to this stage are ordered before the copy engine's
  // later loads into it; then the stripe is whole, and every read of the
  // last bucket's stage done, so that stage goes back to the producer
  fence_proxy_async();
  sync_workers();
  if (t == 0) {
    a.flow_out[b] = flow;
    a.del_out[b] = hits;
    if (done != nullptr) mbar_arrive(done);
  }
  store_stripe(r, a.keys_out + (size_t)b * S, a.vals_out + (size_t)b * S, nn_out * ns, S, paths);

  const bool ops_in = staged & kStagedOps;
  const int w0 = o0 & ~3;  // the staged window's first op
  for (int i = o0 + t; i < o1; i += T) {
    const int tg = ops_in ? r.Op[i - w0] : a.op_tag[i];
    if (tg != kOpPoint && tg != kOpSuccessor) continue;
    const int q = ops_in ? r.Op[kOpWin + i - w0] : a.op_key[i];
    const Located l = locate(r.A, r.Nmax, nn_out, npb, ns, q);
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

// The kernel for copy paths P and a geometry (NPB, NS) fixed at compile time,
// or (P = -1, NPB = NS = 0) taken from its arguments.  7 blocks an SM: at
// most 56 registers a thread.
template <int P, int NPB, int NS>
__global__ void __launch_bounds__(kStripeThreads + kProducerThreads, 7)
    flix_apply_kernel(const ApplyArgs a, int nb, int npb_arg, int ns_arg, int paths_arg) {
  const int paths = P >= 0 ? P : paths_arg;
  const int npb = NPB > 0 ? NPB : npb_arg, ns = NS > 0 ? NS : ns_arg;
  extern __shared__ __align__(128) int smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  int* ring = smem + kBarInts;
  int* metas = ring + kStages * stage_ints(npb, ns);
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) {
      mbar_init(&full[k], 1);   // the producer's lane 0
      mbar_init(&empty[k], 1);  // worker thread 0
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x >= workers()) {
    produce(ring, metas, full, empty, a, nb, npb, ns, paths);
    return;
  }
  const Stripe scratch = carve_block_scratch(metas + kMetaDepth * meta_ints(npb), npb, ns);
  uint64_t* done = nullptr;
  for (int j = 0, b = blockIdx.x; b < nb; ++j, b += gridDim.x) {
    const int k = j % kStages;
    mbar_wait(&full[k], (j / kStages) & 1);
    apply_bucket(stage_at(ring, k, npb, ns), scratch, done, a, b, npb, ns, paths);
    done = &empty[k];
  }
}

using Kernel = void (*)(const ApplyArgs, int, int, int, int);

// The instantiation that runs a launch.  The main path's geometry (16 nodes
// of 32 keys) on aligned planes is compiled with its sizes and copy paths as
// constants: on the H100 that took the mixed batch from 4.0 to 2.6 ms, 1.8x
// its bound (tools/torch_stripe_bench.py).  Any other launch reads them at
// run time: at 16-key nodes, 32 a bucket, the same tool has it at 2.1x.
Kernel pick_kernel(int paths, int npb, int ns) {
  if (npb == 16 && ns == 32 && paths == kAligned) return flix_apply_kernel<kAligned, 16, 32>;
  return flix_apply_kernel<-1, 0, 0>;
}

// Dynamic shared memory of one block (INT_MAX where that overflows an int).
int smem_bytes(int npb, int ns) {
  const long long b = apply_smem_ints(npb, ns) * (long long)sizeof(int);
  return b > INT_MAX ? INT_MAX : (int)b;
}

// Blocks of a flix_apply_kernel instantiation that the current device holds
// at once for a geometry: asked of the occupancy API once per kernel,
// device and geometry, after opting the kernel in to its shared memory.
// Returns the CUDA error code.
int resident_blocks(Kernel kernel, int npb, int ns, int* blocks) {
  int dev = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, int> resident;
  static std::map<std::pair<const void*, int>, int> optin;  // as last set
  const std::lock_guard<std::mutex> hold(mu);
  const int smem = smem_bytes(npb, ns);
  if (smem > 48 * 1024) {
    int& set = optin[{reinterpret_cast<const void*>(kernel), dev}];
    if (set != smem) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      set = smem;
    }
  }
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), dev, npb, ns);
  auto it = resident.find(key);
  if (it == resident.end()) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    const int threads = block_threads(npb * ns);
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
        cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    it = resident.emplace(key, per_sm * sms).first;
  }
  *blocks = it->second;
  return 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Dynamic shared memory one apply block needs for a (npb, ns) geometry: its
// ring, its workers' scratch and its barriers.
int flix_apply_smem_bytes(int npb, int ns) { return smem_bytes(npb, ns); }

// The most dynamic shared memory a block of the current device may opt in to.
int flix_smem_optin_bytes(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return bytes;
}

// The persistent grid of a (npb, ns) geometry on the current device: the
// blocks it holds at once (a launch takes fewer when there are fewer
// buckets); a negative CUDA error code on failure.
int flix_apply_grid(int npb, int ns) {
  int blocks = 0;
  const int e = resident_blocks(pick_kernel(ns % 4 == 0 ? kAligned : -1, npb, ns), npb, ns,
                                &blocks);
  return e ? -e : blocks;
}

// The pass, with each copy path taken where the planes' alignment allows it.
int flix_apply_launch(const int* keys, const int* vals, const int* node_max,
                      const int* ins_keys, const int* ins_vals, const int* ins_starts,
                      const int* ins_ends, const int* del_keys, const int* del_starts,
                      const int* del_ends, const int* op_tag, const int* op_key,
                      const int* op_starts, const int* op_ends, int* keys_out,
                      int* vals_out, int* count_out, int* max_out, int* nn_out,
                      int* flow_out, int* del_out, int* value_out, int* succ_out,
                      int nb, int npb, int ns, void* stream) {
  if (nb == 0) return 0;
  const bool rows_in = ns % 4 == 0 && aligned16(keys) && aligned16(vals);
  const bool rows_out = ns % 4 == 0 && aligned16(keys_out) && aligned16(vals_out);
  const bool slices_in = aligned16(ins_keys) && aligned16(ins_vals) && aligned16(del_keys) &&
                         aligned16(op_tag) && aligned16(op_key);
  const int paths = (rows_in ? kBulkRows : 0) | (rows_out ? kVecStores : 0) |
                    (slices_in ? kBulkSlices : 0);
  const ApplyArgs a = {keys,      vals,       node_max,   ins_keys,  ins_vals, ins_starts,
                       ins_ends,  del_keys,   del_starts, del_ends,  op_tag,   op_key,
                       op_starts, op_ends,    keys_out,   vals_out,  count_out, max_out,
                       nn_out,    flow_out,   del_out,    value_out, succ_out};
  const Kernel kernel = pick_kernel(paths, npb, ns);
  int resident = 0;
  const int e = resident_blocks(kernel, npb, ns, &resident);
  if (e != 0) return e;
  const int blocks = nb < resident ? nb : resident;
  kernel<<<blocks, block_threads(npb * ns), smem_bytes(npb, ns), (cudaStream_t)stream>>>(
      a, nb, npb, ns, paths);
  return (int)cudaGetLastError();
}

}  // extern "C"
