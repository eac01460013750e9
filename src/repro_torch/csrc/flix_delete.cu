// flix_delete: TL-Bulk deletion of FliX for Hopper (sm_90a), one warp per
// bucket.
//
// Replaces the TPU kernel repro/kernels/flix_delete.py:_delete_kernel (with
// its one-hot _reposition), launched by flix_delete_pallas.
//
// The wrapper keeps the TPU wrapper's pre-filter: the batch is cut to the
// keys a point query finds and re-sorted with EMPTY in place of the rest.
// Then the paper's mapping: a warp owns a bucket, and walks the buckets of
// persistent blocks through a two-slot cp.async ring (walk_buckets of
// flix_warp.cuh, shared with the staged stripe kernel and the insert
// kernel).  Each slot stages a bucket's live rows (num_nodes of them) and,
// where it fits, its slice of the batch, cut at cap = npb * ns entries (the
// cut of repro/core/batch.py gather_sublists), so the TPU wrapper's
// [nb, cap] delete tile does not exist here; the slice bounds (the
// wrapper's one searchsorted of the fences) and num_nodes are loaded a
// bucket earlier still.  A bucket with no delete goes back as it is
// (write_packed); the others take the delete half of the update path:
// delete_compact marks the stored keys the slice holds by ballot, compacts
// survivors inside their nodes and emptied nodes out of the chain into the
// warp's scratch stripe, and write_compacted writes it (freed slots hold
// EMPTY and value 0) with its node counts, maxima and num_nodes.  The pass
// is functional.
//
// Bound on the card: bytes.  The pass writes every stripe whole and reads
// of the old stripe only the rows that hold keys, with the fences, the
// batch (4 bytes a key) and num_nodes; it writes the node count and max
// rows and num_nodes.  At the Fig. 9 geometry (2^20 buckets of 16 nodes x
// 32 keys, int32 keys and vals, 16-40 keys a bucket in 1-2 nodes) that is
// 4.29 GB written and ~0.3-0.5 GB read: ~4.8 GB for a batch of 2^22 keys,
// ~1.45 ms at 3.35 TB/s (chip_smoke.update_bytes).
#include <cuda_runtime.h>

#include "flix_warp.cuh"

namespace {

using namespace flix;

// the delete slice staged with a bucket when it fits
using DeleteRing = Ring<0, 0, 32>;

__global__ void __launch_bounds__(kMaxWarps * 32)
    flix_delete_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
                       const int* __restrict__ num_nodes, const int* __restrict__ ends,
                       const int* __restrict__ del_keys, const StripeOut o, int nb, int npb,
                       int ns) {
  extern __shared__ __align__(16) int smem[];
  const int S = npb * ns;
  walk_buckets<DeleteRing>(
      smem, nb, npb, ns,
      [&](int b, int lane) {
        return slice_bounds(ends, num_nodes, b, nb, npb, kDelStart, lane);
      },
      [&](const DeleteRing& r, int b, int bnd, int lane) {
        stage_rows(r, keys, vals, nullptr, b, bnd, npb, ns, lane);
        const int d0 = __shfl_sync(kFull, bnd, kDelStart);
        const int dn = min(max(__shfl_sync(kFull, bnd, kDelEnd) - d0, 0), S);
        if (dn <= DeleteRing::kDelCap) stage_slice(r.Del, del_keys + d0, dn, lane);
      },
      [&](const DeleteRing& r, const Scratch& s, int b, int lane) {
        const int nn = r.Bnd[kNumNodes], d0 = r.Bnd[kDelStart];
        const int dn = min(max(r.Bnd[kDelEnd] - d0, 0), S);  // the slice cut at cap
        if (dn == 0) {
          write_packed<true>(s, r.A, r.Av, nn * ns, S, nullptr, o, b, npb, ns, lane);
        } else {
          const int* dk = dn <= DeleteRing::kDelCap ? r.Del : del_keys + d0;
          const Compacted c =
              delete_compact(s, r.A, r.Av, nn * ns, dk, dn, s.M, s.Mv, npb, ns, lane);
          write_compacted(s, s.M, s.Mv, c.nn, r.Nmax, o, b, npb, ns, lane);
        }
      });
}

}  // namespace

extern "C" {

// Dynamic shared memory one delete block needs for a (npb, ns) geometry.
int flix_delete_smem_bytes(int npb, int ns) { return walk_smem_bytes<DeleteRing>(npb, ns); }

// ends[b]: the batch entries at or below bucket b's fence (searchsorted
// right of mkba in the sorted batch).
int flix_delete_launch(const int* keys, const int* vals, const int* num_nodes, const int* ends,
                       const int* del_keys, int* keys_out, int* vals_out, int* count_out,
                       int* max_out, int* nn_out, int nb, int npb, int ns, void* stream) {
  const StripeOut o = {keys_out, vals_out, count_out, max_out, nn_out};
  return launch_walk<DeleteRing>(flix_delete_kernel, nb, npb, ns, 0, stream, keys, vals,
                                 num_nodes, ends, del_keys, o, nb, npb, ns);
}

}  // extern "C"
