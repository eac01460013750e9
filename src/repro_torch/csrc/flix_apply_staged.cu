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
// Bound on the card: bytes, as for flix_apply.cu: the pass writes every
// stripe whole (it is functional, the old state stays valid for a
// restructure-and-retry) and needs of the old stripe only the rows that
// hold keys, which is all this kernel reads of it.
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

using StagedKernel = decltype(&flix_apply_staged_kernel<kMaxWarps>);

// The instantiation that runs blocks of `warps` warps (0: the default count).
StagedKernel staged_kernel(int npb, int ns, int warps) {
  if (warps_per_block<StagedRing>(npb, ns, warps) <= kMaxWarps)
    return flix_apply_staged_kernel<kMaxWarps>;
  return flix_apply_staged_kernel<kMaxWalkWarps>;
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

}  // extern "C"
