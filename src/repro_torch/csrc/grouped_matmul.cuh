// What the grouped GEMM kernels share (grouped_matmul.cu, grouped_matmul_sm90.cu):
// the placement of a row tile in the device-side tile schedule, and the
// zero fill of the rows outside every group by the spare tiles.
#pragma once

#include <cstdint>

namespace gmm {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Row tile `tile` of the schedule: [row0, row0 + rows) of expert e.  False
// for a spare tile (tile >= tile_start[E]), which holds no rows.
__device__ __forceinline__ bool place_tile(int tile, const int* __restrict__ offs,
                                           const int* __restrict__ tile_start, int T, int E,
                                           int bm, int& e, int& row0, int& rows) {
  if (tile >= tile_start[E]) return false;
  // the expert of this row tile: the last e with tile_start[e] <= tile
  int a = 0, b = E - 1;
  while (a < b) {
    const int m = (a + b + 1) >> 1;
    if (tile_start[m] <= tile) a = m; else b = m - 1;
  }
  e = a;
  const int lo = clampi(offs[e], 0, T);
  const int hi = clampi(offs[e + 1], 0, T);
  row0 = lo + (tile - tile_start[e]) * bm;
  rows = min(bm, hi - row0);
  return true;
}

// Spare row tile `tile` of n_tiles: zero its share of the rows outside every
// group ([0, lo0) then [hiE, T), every n_spare-th chunk of BM rows), columns
// [col0, col0 + BN) only, with threads tid of nthreads.
template <int BM, int BN>
__device__ void zero_outside(int tile, int n_tiles, int tid, int nthreads,
                             const int* __restrict__ offs, const int* __restrict__ tile_start,
                             float* __restrict__ out, int T, int F, int E, int col0) {
  const int total = tile_start[E];
  const int lo0 = clampi(offs[0], 0, T);
  const int hiE = max(clampi(offs[E], 0, T), lo0);
  const long long n_out = (long long)lo0 + (T - hiE);
  const int n_spare = n_tiles - total;
  for (long long chunk = tile - total; chunk * BM < n_out; chunk += n_spare) {
    for (int idx = tid; idx < BM * BN; idx += nthreads) {
      const long long i = chunk * BM + idx / BN;
      const int c = col0 + idx % BN;
      if (i < n_out && c < F) {
        const long long row = i < lo0 ? i : hiE + (i - lo0);
        out[row * F + c] = 0.0f;
      }
    }
  }
}

// The rows of this block's row tile (blockIdx.x of gridDim.x): true with
// [row0, row0 + rows) of expert e, or false for a spare tile after its zero
// fill, with all THREADS threads.
template <int BM, int BN, int THREADS>
__device__ bool locate_tile(const int* __restrict__ offs, const int* __restrict__ tile_start,
                            float* __restrict__ out, int T, int F, int E, int col0,
                            int& e, int& row0, int& rows) {
  if (place_tile(blockIdx.x, offs, tile_start, T, E, BM, e, row0, rows)) return true;
  zero_outside<BM, BN>(blockIdx.x, gridDim.x, threadIdx.x, THREADS, offs, tile_start, out, T, F,
                       E, col0);
  return false;
}

}  // namespace gmm

// Launch the wgmma kernel (grouped_matmul_sm90.cu) after the schedule of
// BM-row tiles is in tile_start[0..E] and tile_start[E+1] is 0; returns
// cudaGetLastError's code.
int gmm_wgmma_run(const void* x, const void* w, const int* offs, int* tile_start,
                  float* out, int T, int D, int F, int E, int x_dtype, bool small,
                  void* stream);
// The row-tile height of the wgmma kernel: 64 rows (one consumer
// warpgroup) when small, else 128.
int gmm_wgmma_bm(bool small);
