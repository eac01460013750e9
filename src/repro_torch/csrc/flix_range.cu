// flix_range: the dense RANGE scans of FliX for Hopper (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/flix_range.py, run by
// flix_range_pallas: _range_count_kernel (pass 1, with the flat_rank of lo
// in its wrapper) and _range_scatter_kernel (pass 2); and, on the fused
// apply path, the rank plumbing beside the Pallas kernel
// (repro/kernels/flix_apply.py _range_plumbing) and its RANGE gather
// (_stripe_body's phase 4).  Two kernels here, each a thread per op or per
// few slots, built to shorten each thread's chain of dependent loads:
//
//   flix_range_count_kernel  the global rank (stored keys below the bound)
//                            of each op's lo, and the exact count
//                            max(rank(hi) - rank(lo), 0) of keys in
//                            [lo, hi), as repro_torch/core/query.py
//                            node_rank gives them: the bucket's live-count
//                            prefix pref[b], plus the keys of its nodes
//                            wholly below the bound, plus the bound's
//                            position in the node that reaches it.  A lane
//                            per op: the lo and hi searches of the fences
//                            run in lockstep, a fixed number of branch-free
//                            steps; lo and hi in one bucket share one pass
//                            over its rows (the node_max row in 16-byte
//                            loads, a node_count entry only for a node below
//                            hi); the two key-row searches run in lockstep.
//                            A hi at or below lo needs no rank (its count is
//                            0: the rank is monotone).  A warp takes 32 K
//                            ops (K = 1, 2 or 4, the fewest that fit the
//                            grid, of 4-warp blocks, in one wave): it
//                            writes 0 and 0 for the ops outside the
//                            optional mask and gives the ops under it to
//                            its lanes in turns, so that the few RANGE ops
//                            of a fused batch (its mask) run side by side.
//                            The ops need no order.
//   flix_range_gather_kernel the (key, value) of global rank g[p] for K
//                            consecutive slots a thread (K = 1, 2 or 4, the
//                            fewest that fit every slot in one wave): the
//                            owning bucket is the last whose pref is at or
//                            below the rank (so an empty bucket owns no
//                            slot), the K searches of pref in lockstep; the
//                            node by the running counts of the node_count
//                            row; then one key and one value load per slot,
//                            issued together.  The second pass of the
//                            standalone scan and the RANGE gather of the
//                            fused apply path, where the TPU kernel swept
//                            every output slot once per bucket block.
//
// Bound on the card: bytes.  Pass 1 must read each op's bounds (and the mask
// where there is one), write each op's rank and count, and read the two
// fences that place each bound that needs a rank, and once per bucket or row
// those bounds touch the bucket's pref entry, node_max and node_count rows
// and the key row that holds the bound; the gather must read each slot's
// rank, write its key and value, read one key and value per valid slot, and
// once per bucket a valid slot lands in its pref entry and node_count row.
// chip_smoke.py counts both from each run's inputs (range_count_bytes,
// gather_bytes).  Those bytes are rows and sectors scattered over GB-sized
// planes, a few dependent loads apart, so the count kernel runs at about
// 1.5 times its bound and the gather at about 3 (phase 7's shapes).  The designs that lost to these, each timed
// against them on the card, are listed in PERF.md's findings.
#include <cuda_runtime.h>

#include <cstdint>

#include "flix_runs.cuh"

namespace {

using namespace flix;

constexpr int kCountThreads = 128;   // 4 warps a count block
constexpr int kGatherThreads = 256;  // 8 warps a gather block
constexpr int kMaxPerThread = 4;     // most ops a lane of the count kernel takes
constexpr int kMaxSlots = 4;         // most slots a thread of the gather takes

// For each k < K: the entries of ascending a[k][0, n) below x[k] (at or
// below it when kUpper), by a fixed number of halving steps (those of n),
// branch-free, so that the K searches' loads are in flight together.  An
// index is clamped into a[k] before its load.
template <int K, bool kUpper>
__device__ __forceinline__ void lockstep_bound(const int* const (&a)[K], int n,
                                               const int (&x)[K], int (&pos)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) pos[k] = 0;  // a[k][0, pos[k]) qualify
  if (n <= 0) return;
  for (int step = 1 << (31 - __clz(n)); step > 0; step >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int at = pos[k] + step;
      const int v = __ldg(a[k] + min(at, n) - 1);  // at >= 1
      if (at <= n && (kUpper ? v <= x[k] : v < x[k])) pos[k] = at;
    }
  }
}

// For bounds x0 <= x1 in one bucket: the nodes whose max lies below each
// bound (n0, n1) and the keys those nodes hold (c0, c1).  The node_max row
// in 16-byte loads when vec (16-byte aligned, npb a multiple of 4); a
// node_count entry is loaded only for a node below x1.
__device__ __forceinline__ void nodes_below(const int* __restrict__ nmax,
                                            const int* __restrict__ cnt, int npb, int x0,
                                            int x1, bool vec, int& n0, int& c0, int& n1,
                                            int& c1) {
  n0 = c0 = n1 = c1 = 0;
  for (int j = 0; j < npb; j += 4) {
    int m[4];
    if (vec) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(nmax + j));
      m[0] = v.x, m[1] = v.y, m[2] = v.z, m[3] = v.w;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int v = __ldg(nmax + min(j + t, npb - 1));
        m[t] = j + t < npb ? v : kEmpty;
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (m[t] < x1) {  // EMPTY (an inactive node, or past the row) never is
        const int c = __ldg(cnt + min(j + t, npb - 1));
        n1 += 1;
        c1 += c;
        if (m[t] < x0) {
          n0 += 1;
          c0 += c;
        }
      }
    }
  }
}

// rank_lo and count of op j.
__device__ __forceinline__ void rank_op(const int* __restrict__ keys,
                                        const int* __restrict__ node_count,
                                        const int* __restrict__ node_max,
                                        const int* __restrict__ mkba,
                                        const int* __restrict__ pref,
                                        const int* __restrict__ lo, const int* __restrict__ hi,
                                        int* __restrict__ rank_lo, int* __restrict__ count,
                                        int nb, int npb, int ns, bool vec, long long j) {
  const int x = __ldg(lo + j), h = __ldg(hi + j);
  const bool need_hi = h > x;  // else rank(hi) <= rank(lo): count 0
  const int xs[2] = {x, need_hi ? h : x};
  // the clamped lower_bound of both bounds in mkba, in lockstep
  const int* const fences[2] = {mkba, mkba};
  int b[2];
  lockstep_bound<2, false>(fences, nb, xs, b);
  const int bl = min(b[0], nb - 1), bh = min(b[1], nb - 1);
  const size_t rowl = (size_t)bl * npb, rowh = (size_t)bh * npb;
  int n0, c0, n1, c1;
  if (bh == bl) {
    nodes_below(node_max + rowl, node_count + rowl, npb, xs[0], xs[1], vec, n0, c0, n1, c1);
  } else {
    int u, v;
    nodes_below(node_max + rowl, node_count + rowl, npb, xs[0], xs[0], vec, n0, c0, u, v);
    nodes_below(node_max + rowh, node_count + rowh, npb, xs[1], xs[1], vec, n1, c1, u, v);
  }
  // each bound's position in the key row that reaches it (ascending,
  // EMPTY-padded: I1; none past the bucket's nodes), the two searches in
  // lockstep
  const int* const rows[2] = {keys + (rowl + min(n0, npb - 1)) * ns,
                              keys + (rowh + min(n1, npb - 1)) * ns};
  int pos[2];
  lockstep_bound<2, false>(rows, ns, xs, pos);
  const int rl = __ldg(pref + bl) + c0 + (n0 < npb ? pos[0] : 0);
  rank_lo[j] = rl;
  count[j] = need_hi ? max(__ldg(pref + bh) + c1 + (n1 < npb ? pos[1] : 0) - rl, 0) : 0;
}

// Position of the n-th (from 0) set bit of m, which holds more than n.
__device__ __forceinline__ int nth_set(unsigned m, int n) {
  int at = 0;  // bits [0, at) hold at most n set bits
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    if (__popc(m & ((1u << (at + s)) - 1u)) <= n) at += s;
  return at;
}

// Warp w takes ops [32 K w, 32 K (w + 1)): the ops outside the mask get 0
// and 0 at once, the ops under it (all, without a mask) go to the lanes in
// turns of 32, a lane the i-th of them.
template <int K>
__global__ void __launch_bounds__(kCountThreads)
    flix_range_count_kernel(const int* __restrict__ keys, const int* __restrict__ node_count,
                            const int* __restrict__ node_max, const int* __restrict__ mkba,
                            const int* __restrict__ pref, const int* __restrict__ lo,
                            const int* __restrict__ hi,
                            const unsigned char* __restrict__ is_range,
                            int* __restrict__ rank_lo, int* __restrict__ count, int q, int nb,
                            int npb, int ns) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kCountThreads + threadIdx.x) >> 5;
  const long long base = warp * 32 * K;
  unsigned act[K];
  int n_act = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long j = base + 32 * k + lane;
    const bool in = j < q;
    const bool on = in && (is_range == nullptr || is_range[min(j, (long long)q - 1)]);
    if (in && !on) rank_lo[j] = count[j] = 0;
    act[k] = __ballot_sync(kFull, on);
    n_act += __popc(act[k]);
  }
  const bool vec = (npb & 3) == 0 && (reinterpret_cast<uintptr_t>(node_max) & 15) == 0;
  for (int r = 0; r < n_act; r += 32) {  // n_act is the warp's
    int left = r + lane;
    long long j = -1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = __popc(act[k]);
      if (j < 0 && left < c) j = base + 32 * k + nth_set(act[k], left);
      left -= c;
    }
    if (j >= 0)
      rank_op(keys, node_count, node_max, mkba, pref, lo, hi, rank_lo, count, nb, npb, ns, vec,
              j);
  }
}

// Slots [K t, K t + K) of thread t.
template <int K>
__global__ void __launch_bounds__(kGatherThreads)
    flix_range_gather_kernel(const int* __restrict__ g, const int* __restrict__ pref,
                             const int* __restrict__ node_count, const int* __restrict__ keys,
                             const int* __restrict__ vals, int* __restrict__ rk,
                             int* __restrict__ rv, int mr, int nb, int npb, int ns) {
  const long long p0 = ((long long)blockIdx.x * kGatherThreads + threadIdx.x) * K;
  if (p0 >= mr) return;
  const int n = (int)min((long long)K, mr - p0);
  int r[K], x[K], b[K];
  bool any = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = __ldg(g + p0 + min(k, n - 1));
    r[k] = k < n ? v : -1;
    x[k] = max(r[k], 0);
    any |= r[k] >= 0;
  }
  // the pref entries at or below each rank: the owner is the last of them
  if (any) {
    const int* pa[K];
#pragma unroll
    for (int k = 0; k < K; ++k) pa[k] = pref;
    lockstep_bound<K, true>(pa, nb + 1, x, b);
  }
  size_t at[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    at[k] = 0;
    if (r[k] < 0) continue;
    const int bk = min(max(b[k] - 1, 0), nb - 1);
    const int rr = r[k] - __ldg(pref + bk);
    // node = the nodes whose inclusive count prefix is at or below rr (the
    // last node when all are), before = the keys ahead of it
    const int* cnt = node_count + (size_t)bk * npb;
    int node = npb - 1, before = 0;
    for (int j = 0; j < npb; ++j) {
      const int c = __ldg(cnt + j);
      if (before + c > rr) {
        node = j;
        break;
      }
      if (j + 1 < npb) before += c;
    }
    at[k] = ((size_t)bk * npb + node) * ns + min(max(rr - before, 0), ns - 1);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k >= n) continue;
    const bool ok = r[k] >= 0;
    const int key = __ldg(keys + at[k]), val = __ldg(vals + at[k]);
    rk[p0 + k] = ok ? key : kEmpty;
    rv[p0 + k] = ok ? val : kMiss;
  }
}

// The fewest units a thread (K, a power of two up to kmax) that let `units`
// units fit the resident threads of the kernel in one wave.
int per_thread(long long units, long long resident_threads, int kmax) {
  int k = 1;
  while (k < kmax && units > resident_threads * k) k *= 2;
  return k;
}

ResidentWarps count_resident;   // of flix_range_count_kernel<1>
ResidentWarps gather_resident;  // of flix_range_gather_kernel<1>

template <int K>
cudaError_t launch_count(const int* keys, const int* node_count, const int* node_max,
                         const int* mkba, const int* pref, const int* lo, const int* hi,
                         const unsigned char* is_range, int* rank_lo, int* count, int q,
                         int nb, int npb, int ns, cudaStream_t s) {
  const long long warps = ((long long)q + 32 * K - 1) / (32 * K);
  const int blocks = (int)((warps + kCountThreads / 32 - 1) / (kCountThreads / 32));
  flix_range_count_kernel<K><<<blocks, kCountThreads, 0, s>>>(
      keys, node_count, node_max, mkba, pref, lo, hi, is_range, rank_lo, count, q, nb, npb, ns);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_gather(const int* g, const int* pref, const int* node_count,
                          const int* keys, const int* vals, int* rk, int* rv, int mr, int nb,
                          int npb, int ns, cudaStream_t s) {
  const long long threads = ((long long)mr + K - 1) / K;
  const int blocks = (int)((threads + kGatherThreads - 1) / kGatherThreads);
  flix_range_gather_kernel<K><<<blocks, kGatherThreads, 0, s>>>(g, pref, node_count, keys, vals,
                                                                rk, rv, mr, nb, npb, ns);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// is_range: a bool per op, or null for every op.
int flix_range_count_launch(const int* keys, const int* node_count, const int* node_max,
                            const int* mkba, const int* pref, const int* lo, const int* hi,
                            const unsigned char* is_range, int* rank_lo, int* count, int q,
                            int nb, int npb, int ns, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (q == 0) return 0;
  long long resident = 0;
  const cudaError_t e = warps_resident(count_resident, (const void*)flix_range_count_kernel<1>,
                                       kCountThreads, &resident);
  if (e != cudaSuccess) return (int)e;
  switch (per_thread(q, resident * 32, kMaxPerThread)) {
    case 1:
      return (int)launch_count<1>(keys, node_count, node_max, mkba, pref, lo, hi, is_range,
                                  rank_lo, count, q, nb, npb, ns, s);
    case 2:
      return (int)launch_count<2>(keys, node_count, node_max, mkba, pref, lo, hi, is_range,
                                  rank_lo, count, q, nb, npb, ns, s);
    default:
      return (int)launch_count<4>(keys, node_count, node_max, mkba, pref, lo, hi, is_range,
                                  rank_lo, count, q, nb, npb, ns, s);
  }
}

int flix_range_gather_launch(const int* g, const int* pref, const int* node_count,
                             const int* keys, const int* vals, int* rk, int* rv,
                             int max_results, int nb, int npb, int ns, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (max_results == 0) return 0;
  long long resident = 0;
  const cudaError_t e = warps_resident(gather_resident, (const void*)flix_range_gather_kernel<1>,
                                       kGatherThreads, &resident);
  if (e != cudaSuccess) return (int)e;
  switch (per_thread(max_results, resident * 32, kMaxSlots)) {
    case 1:
      return (int)launch_gather<1>(g, pref, node_count, keys, vals, rk, rv, max_results, nb,
                                   npb, ns, s);
    case 2:
      return (int)launch_gather<2>(g, pref, node_count, keys, vals, rk, rv, max_results, nb,
                                   npb, ns, s);
    default:
      return (int)launch_gather<4>(g, pref, node_count, keys, vals, rk, rv, max_results, nb,
                                   npb, ns, s);
  }
}

}  // extern "C"
