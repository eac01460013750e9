// flix_fence_rows: the successor fence rows of FliX for Hopper (sm_90a).
//
// Replaces the jnp suffix scan that repro/kernels/flix_successor.py
// flix_successor_pallas runs beside its kernel (flix_successor.py:150-159;
// the fused apply's wrapper builds the same rows, flix_apply.py:544).  For
// each bucket b of nb:
//   next_key[b] = the smallest head keys[b', 0, 0] of the non-empty buckets
//                 b' > b, EMPTY if there are none;
//   next_val[b] = vals[i, 0, 0], i the bucket attaining it; ties go to the
//                 higher index (the reference's associative scan), so
//                 i = nb - 1 over an all-empty suffix, and i = 0 for
//                 b = nb - 1.
// A bucket is non-empty where num_nodes[b] > 0 when the caller gives
// num_nodes (the fused apply), else where any entry of its node_max row is
// not EMPTY (flix_successor, on the raw planes).  The kernel computes the
// suffix minimum itself, for any heads, monotone or not.
//
// Two launches over tiles of kTile buckets.  The head pass issues all its
// loads of a thread's kPer buckets at once (the non-empty test, the head
// key and the head value: a sector each), writes the heads (EMPTY for an
// empty bucket) and the head values compactly to scratch, and reduces its
// tile to one (value, index) pair.  The scan pass reduces the pairs of the
// tiles after its own, scans its tile's heads from the right (kPer a
// thread, then warp shuffles, then the block's warps), shifts the scan by
// one bucket, and writes both rows, taking each attaining bucket's head
// value from the compact scratch.
// The pairs combine by (smaller value, then higher index), a total order,
// so the combine is associative and commutative, and (EMPTY, -1) is its
// identity.
//
// Bound on the card: bytes.  Per bucket the non-empty test (4 bytes of
// num_nodes, or a sector of node_max, its whole row where the first entry
// is EMPTY), a 32-byte sector of each non-empty bucket's head, a sector of
// vals per distinct attaining bucket, and 8 bytes out: at 2^20 buckets of
// 16 x 32 slots about 0.024 ms (num_nodes) and 0.033 ms (node_max) at
// 3.35 TB/s; chip_smoke.py computes it from each run's rows.  Sectors read
// 2 KiB apart come far below that rate: one torch gather of the 2^20 head
// keys alone takes ~0.043 ms on the card, and the head pass reads two such
// planes.
#include <cuda_runtime.h>

#include <cstdint>

#include "flix_phases.cuh"

namespace {

using namespace flix;

constexpr int kThreads = 256;
constexpr int kPer = 8;                    // buckets a thread takes
constexpr int kTile = kThreads * kPer;     // buckets a block takes
constexpr int kWarps = kThreads / 32;

struct Pair {
  int v, i;
};

// the better of two (value, index) pairs: the smaller value, on a tie the
// higher index
// nb rounded up to a multiple of kPer, so that the scratch's second array
// starts 32-byte aligned
long long padded(int nb) { return ((long long)nb + kPer - 1) / kPer * kPer; }

__device__ __forceinline__ Pair best(Pair a, Pair b) {
  return (a.v < b.v || (a.v == b.v && a.i > b.i)) ? a : b;
}

__device__ __forceinline__ Pair shfl_down(Pair a, int d) {
  return {__shfl_down_sync(kFull, a.v, d), __shfl_down_sync(kFull, a.i, d)};
}

// The best pair over the block's threads, given to every thread.
__device__ Pair block_best(Pair a, Pair* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) a = best(a, shfl_down(a, d));
  if (lane == 0) red[wid] = a;
  __syncthreads();
  Pair r = red[0];
#pragma unroll
  for (int j = 1; j < kWarps; ++j) r = best(r, red[j]);
  __syncthreads();  // red is free again
  return r;
}

__global__ void __launch_bounds__(kThreads)
    fence_heads_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
                       const int* __restrict__ node_max, const int* __restrict__ num_nodes,
                       int* __restrict__ heads, int* __restrict__ hvals,
                       int* __restrict__ agg_v, int* __restrict__ agg_i, int nb, int npb,
                       long long S) {
  __shared__ Pair red[kWarps];
  const int base = blockIdx.x * kTile;
  int h[kPer], hv[kPer], t[kPer];
  // every load of the thread's buckets at once: the non-empty test's first
  // word, the head key and the head value (any bucket's may be asked for)
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = min(base + j * kThreads + (int)threadIdx.x, nb - 1);
    t[j] = num_nodes ? __ldg(num_nodes + b) : __ldg(node_max + (size_t)b * npb);
    h[j] = __ldg(keys + (size_t)b * S);
    hv[j] = __ldg(vals + (size_t)b * S);
  }
  Pair a = {kEmpty, -1};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = base + j * kThreads + threadIdx.x;
    if (b >= nb) break;
    bool live;
    if (num_nodes) {
      live = t[j] > 0;
    } else {  // the rest of a node_max row only where its first entry is EMPTY
      const int* row = node_max + (size_t)b * npb;
      live = t[j] != kEmpty;
      for (int e = 1; e < npb && !live; ++e) live = __ldg(row + e) != kEmpty;
    }
    const int v = live ? h[j] : kEmpty;
    heads[b] = v;
    hvals[b] = hv[j];
    a = best(a, Pair{v, b});
  }
  a = block_best(a, red);
  if (threadIdx.x == 0) {
    agg_v[blockIdx.x] = a.v;
    agg_i[blockIdx.x] = a.i;
  }
}

__global__ void __launch_bounds__(kThreads)
    fence_scan_kernel(const int* __restrict__ heads, const int* __restrict__ hvals,
                      const int* __restrict__ agg_v, const int* __restrict__ agg_i,
                      int* __restrict__ next_key, int* __restrict__ next_val, int nb,
                      int tiles) {
  __shared__ Pair red[kWarps];
  __shared__ Pair warp_tot[kWarps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  // the tiles after this one
  Pair after = {kEmpty, -1};
  for (int t = blockIdx.x + 1 + threadIdx.x; t < tiles; t += kThreads)
    after = best(after, Pair{__ldg(agg_v + t), __ldg(agg_i + t)});
  after = block_best(after, red);

  // this thread's kPer buckets, contiguous, scanned from the right: loc[j]
  // is the best over buckets j .. kPer - 1 of the thread.  A thread whose
  // buckets all exist moves them in 16-byte loads and stores (b0 is a
  // multiple of kPer, the arrays 32-byte aligned)
  const int b0 = blockIdx.x * kTile + threadIdx.x * kPer;
  const bool whole = b0 + kPer <= nb;
  int hk[kPer];
  if (whole) {
    const int4* h4 = reinterpret_cast<const int4*>(heads + b0);
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j) {
      const int4 v = __ldg(h4 + j);
      hk[4 * j] = v.x, hk[4 * j + 1] = v.y, hk[4 * j + 2] = v.z, hk[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) hk[j] = b0 + j < nb ? __ldg(heads + b0 + j) : kEmpty;
  }
  Pair loc[kPer];
  Pair run = {kEmpty, -1};
#pragma unroll
  for (int j = kPer - 1; j >= 0; --j) {
    if (b0 + j < nb) run = best(run, Pair{hk[j], b0 + j});
    loc[j] = run;
  }
  // suffix over the warp's lanes, inclusive: lane l gets lanes l .. 31
  Pair incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Pair o = shfl_down(incl, d);
    if (lane + d < 32) incl = best(incl, o);
  }
  if (lane == 0) warp_tot[wid] = incl;  // the warp's total
  __syncthreads();
  // everything after this thread's buckets: the later lanes of its warp,
  // the later warps of the block, the later tiles
  Pair rest = shfl_down(incl, 1);
  if (lane == 31) rest = Pair{kEmpty, -1};
#pragma unroll
  for (int j = kWarps - 1; j > 0; --j)
    if (j > wid) rest = best(rest, warp_tot[j]);
  rest = best(rest, after);
  int nk[kPer], nv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {  // buckets after b0 + j; none after the last
    const Pair n = j + 1 < kPer ? best(loc[j + 1], rest) : rest;
    const bool last = b0 + j == nb - 1;
    nk[j] = last ? kEmpty : n.v;
    nv[j] = b0 + j < nb ? __ldg(hvals + (last ? 0 : n.i)) : 0;
  }
  if (whole) {
    int4* k4 = reinterpret_cast<int4*>(next_key + b0);
    int4* v4 = reinterpret_cast<int4*>(next_val + b0);
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j) {
      k4[j] = make_int4(nk[4 * j], nk[4 * j + 1], nk[4 * j + 2], nk[4 * j + 3]);
      v4[j] = make_int4(nv[4 * j], nv[4 * j + 1], nv[4 * j + 2], nv[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (b0 + j < nb) {
        next_key[b0 + j] = nk[j];
        next_val[b0 + j] = nv[j];
      }
    }
  }
}

}  // namespace

extern "C" {

// ints of scratch that flix_fence_rows_launch needs for nb buckets: the
// heads and the head values, each padded to a multiple of kPer, then each
// tile's value and index
long long flix_fence_rows_scratch_ints(int nb) {
  const long long tiles = ((long long)nb + kTile - 1) / kTile;
  return 2 * padded(nb) + 2 * tiles;
}

// next_key / next_val [nb] of the state's planes (both, and the scratch,
// 16-byte aligned); num_nodes, when not null, decides which buckets are
// non-empty, else node_max does
int flix_fence_rows_launch(const int* keys, const int* vals, const int* node_max,
                           const int* num_nodes, int* scratch, int* next_key, int* next_val,
                           int nb, int npb, int ns, void* stream) {
  if (nb == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(scratch) | reinterpret_cast<uintptr_t>(next_key) |
       reinterpret_cast<uintptr_t>(next_val)) & 15)  // the scan pass's 16-byte accesses
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (int)(((long long)nb + kTile - 1) / kTile);
  int* heads = scratch;  // 32-byte aligned, as torch allocates
  int* hvals = heads + padded(nb);
  int* agg_v = hvals + padded(nb);
  int* agg_i = agg_v + tiles;
  fence_heads_kernel<<<tiles, kThreads, 0, s>>>(keys, vals, node_max, num_nodes, heads, hvals,
                                                agg_v, agg_i, nb, npb, (long long)npb * ns);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fence_scan_kernel<<<tiles, kThreads, 0, s>>>(heads, hvals, agg_v, agg_i, next_key, next_val,
                                               nb, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
