// flix_insert: TL-Bulk insertion of FliX for Hopper (sm_90a), one warp per
// bucket.
//
// Replaces the TPU kernel repro/kernels/flix_insert.py:_insert_kernel,
// launched by flix_insert_pallas.
//
// The paper's mapping: a warp owns a bucket, and walks the buckets of
// persistent blocks through a two-slot cp.async ring (walk_buckets of
// flix_warp.cuh, shared with the staged stripe kernel and the delete
// kernel).  Each slot stages a bucket's live rows (num_nodes of them), its
// node max row and, where it fits, its slice of the sorted insert batch;
// the slice bounds (the wrapper's one searchsorted of the fences) and
// num_nodes are loaded a bucket earlier still.  The slice is cut at cap =
// npb * ns entries (the cut of repro/core/batch.py gather_kv_sublists), so
// the TPU wrapper's [nb, cap] key and value tiles do not exist here.  A
// bucket with no insert goes back as it is (write_packed); the others take
// the insert half of the update path: merge_inserts (the upsert merge, the
// incoming value winning, with the balanced re-chunk of each original node
// region), then write_packed of the merged rows with their counts, maxima
// and num_nodes, as the TPU kernel computes them.  EMPTY slots carry value
// 0; pieces past the last slot are dropped, and overflow[b] is the pieces
// flag plus the slice's cut at cap.  The pass is functional, so the input
// state stays valid for a restructure-and-retry.
//
// Bound on the card: bytes.  The pass writes every stripe whole and reads
// of the old stripe only the rows that hold keys and their node_max
// entries, with the fences, the batch (8 bytes a key) and num_nodes; it
// writes the node count and max rows, num_nodes and overflow.  At the
// Fig. 9 geometry (2^20 buckets of 16 nodes x 32 keys, int32 keys and vals,
// 16-40 keys a bucket in 1-2 nodes) that is 4.29 GB written and ~0.3-0.5 GB
// read: ~4.8 GB for a batch of 2^22 keys, ~1.42 ms at 3.35 TB/s
// (chip_smoke.update_bytes).
#include <cuda_runtime.h>

#include "flix_warp.cuh"

namespace {

using namespace flix;

// the insert slice staged with a bucket when it fits
using InsertRing = Ring<0, 32, 0>;

__global__ void __launch_bounds__(kMaxWarps * 32)
    flix_insert_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
                       const int* __restrict__ node_max, const int* __restrict__ num_nodes,
                       const int* __restrict__ ends, const int* __restrict__ ins_keys,
                       const int* __restrict__ ins_vals, const StripeOut o,
                       int* __restrict__ flow_out, int nb, int npb, int ns) {
  extern __shared__ __align__(16) int smem[];
  const int S = npb * ns;
  walk_buckets<InsertRing>(
      smem, nb, npb, ns,
      [&](int b, int lane) {
        return slice_bounds(ends, num_nodes, b, nb, npb, kInsStart, lane);
      },
      [&](const InsertRing& r, int b, int bnd, int lane) {
        stage_rows(r, keys, vals, node_max, b, bnd, npb, ns, lane);
        const int i0 = __shfl_sync(kFull, bnd, kInsStart);
        const int m = min(max(__shfl_sync(kFull, bnd, kInsEnd) - i0, 0), S);
        if (m <= InsertRing::kInsCap) {
          stage_slice(r.Ins, ins_keys + i0, m, lane);
          stage_slice(r.Ins + InsertRing::kInsCap, ins_vals + i0, m, lane);
        }
      },
      [&](const InsertRing& r, const Scratch& s, int b, int lane) {
        const int nn = r.Bnd[kNumNodes], i0 = r.Bnd[kInsStart];
        const int n_in = max(r.Bnd[kInsEnd] - i0, 0), m = min(n_in, S);
        int pieces = 0;
        if (m == 0) {
          write_packed<true>(s, r.A, r.Av, nn * ns, S, nullptr, o, b, npb, ns, lane);
        } else {
          // a region gains at most a piece per insert, so the rows from
          // max(nn, 1) + m on hold no key after the merge: their stores go
          // out first, beside the merge
          const int cut = min(max(nn, 1) + m, npb) * ns;
          write_empty(o.keys + (size_t)b * S, o.vals + (size_t)b * S, cut, S, lane);
          const bool in_ring = m <= InsertRing::kInsCap;
          const Merged mg =
              merge_inserts(r, s, in_ring ? r.Ins : ins_keys + i0,
                            in_ring ? r.Ins + InsertRing::kInsCap : ins_vals + i0, m, nn, npb,
                            ns, lane);
          write_packed<true>(s, s.M, s.Mv, mg.slots, cut, nullptr, o, b, npb, ns, lane);
          pieces = mg.pieces;
        }
        if (lane == 0) flow_out[b] = (pieces > npb) + (n_in > S);
      });
}

}  // namespace

extern "C" {

// Dynamic shared memory one insert block needs for a (npb, ns) geometry.
int flix_insert_smem_bytes(int npb, int ns) { return walk_smem_bytes<InsertRing>(npb, ns); }

// ends[b]: the batch entries at or below bucket b's fence (searchsorted
// right of mkba in the sorted batch).
int flix_insert_launch(const int* keys, const int* vals, const int* node_max,
                       const int* num_nodes, const int* ends, const int* ins_keys,
                       const int* ins_vals, int* keys_out, int* vals_out, int* count_out,
                       int* max_out, int* nn_out, int* flow_out, int nb, int npb, int ns,
                       void* stream) {
  const StripeOut o = {keys_out, vals_out, count_out, max_out, nn_out};
  return launch_walk<InsertRing>(flix_insert_kernel, nb, npb, ns, 0, stream, keys, vals,
                                 node_max, num_nodes, ends, ins_keys, ins_vals, o, flow_out, nb,
                                 npb, ns);
}

}  // extern "C"
