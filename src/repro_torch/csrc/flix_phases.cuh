// Per-bucket phases of the FliX update-then-read pass, as device functions.
//
// One thread block owns one bucket stripe in shared memory.  The phases are
// the formulas of the JAX reference (repro/kernels/flix_apply.py
// _stripe_body, repro/core/insert.py _merge_one_bucket, repro/core/delete.py)
// with the TPU's O(S^2) compare-count masks replaced by block scans and
// binary searches, which give the same ranks because every sequence searched
// here is ascending.  The standalone insert / delete / query / successor
// kernels of later ports reuse these functions.
#pragma once

namespace flix {

constexpr int kEmpty = 0x7fffffff;  // empty slot / inactive node sentinel
constexpr int kMiss = -1;           // NOT_FOUND
constexpr int kOpPoint = 2;
constexpr int kOpSuccessor = 3;

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

// In-place exclusive scan of x[0, n) by the whole block; x[n] receives the
// total.  blockDim.x must be a multiple of 32; warp_buf holds 32 ints.
// Each thread scans one contiguous chunk, so any n works with any block.
__device__ inline void block_exclusive_scan(int* x, int n, int* warp_buf) {
  const int T = blockDim.x, t = threadIdx.x;
  const int per = (n + T - 1) / T;
  const int lo = min(t * per, n), hi = min(lo + per, n);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += x[i];
  const int lane = t & 31, warp = t >> 5;
  int v = local;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) warp_buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = T >> 5;
    int w = lane < nw ? warp_buf[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nw) warp_buf[lane] = w;
  }
  __syncthreads();
  int run = v - local + (warp ? warp_buf[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = x[i];
    x[i] = run;
    run += c;
  }
  if (t == T - 1) x[n] = run;
  __syncthreads();
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

// Where key q sits in a post-update stripe: node = first node whose max is
// >= q, pos = its in-node position.  in_bucket is false when q is above
// every stored key of the bucket.
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

}  // namespace flix
