// grouped_matmul: ragged grouped GEMM over expert-sorted rows for Hopper
// (sm_90a), the expert FFN of the flipped MoE dispatch.
//
// Replaces the TPU kernel src/repro/kernels/grouped_matmul.py:_gmm_kernel
// (:33), launched by grouped_matmul_pallas.  It computes what that kernel
// computes, not its grid:
//
//   out [T, F] float32;  out[t] = f32(x[t]) @ f32(w[g])  for offs[g] <= t < offs[g+1],
//   and out[t] = 0 for every row outside [offs[0], offs[E]), as the Pallas
//   mask leaves them.  x [T, D] and w [E, D, F] are each float32 or bfloat16,
//   in any mix; offs [E+1] int32 ascending, empty groups allowed.  Offsets
//   are clamped into [0, T], so no row outside the tensors is touched; for
//   offsets that are not ascending the result is unspecified.
//
// Design: compute goes to the bucket, as in FliX.  The Pallas grid
// (token block x F block x expert span) runs every 128-row token block once
// for each expert it touches, each time a full masked product.  Here each
// expert pulls its own contiguous slice instead:
//
//   1. gmm_schedule_kernel (one warp) turns the offsets into each expert's
//      row-tile count ceil(size_e / BM) and their exclusive prefix
//      tile_start[0..E], on the device, with no host sync.
//   2. The GEMM kernel runs on the upper bound ceil(T/BM) + E row tiles
//      times ceil(F/BN) column tiles.  Row tile i binary-searches its expert
//      in tile_start (FliX's one binary search); its rows are that expert's
//      rows [lo + j*BM, min(lo + (j+1)*BM, hi)).  x and w[e] tiles are
//      staged through shared memory along D (register-staged double
//      buffer: the next tile's loads are in flight while this one computes),
//      sums are kept in float32 registers, and each row of a group is
//      written once: a row belongs to one group, so there are no atomics.
//   3. Rows outside every group: since sum_e ceil(size_e/BM) <=
//      ceil(T/BM) + E - 1 for sizes summing to at most T, at least one row
//      tile of the launch is past the schedule's end.  Those spare tiles
//      zero-fill [0, offs[0]) and [offs[E], T) in strides, so the output
//      needs no memset and no host sync.
//
// Three variants, chosen on the host from the dtypes, the widths and the
// base addresses alone (grouped_matmul_variant), each counted apart:
//   - wgmma (grouped_matmul_sm90.cu): bf16 w with bf16 x, or with f32 x
//     split exactly into three bf16 pieces, when TMA can address both
//     tensors (rows of a multiple of 16 bytes, 16-byte-aligned bases).  The
//     main path's GEMMs all take it; its note says what bounds it.
//   - gmm_mma_kernel: any other bf16 x bf16 (odd widths, unaligned views),
//     mma.sync m16n8k16 with float32 accumulate.  A bf16 x bf16 product is
//     exact in float32, so the tensor cores give the reference's products;
//     only the order of the float32 sums differs.  Tiles are staged as bf16
//     and read with ldmatrix.
//   - gmm_fma_kernel: the rest (f32 w, and f32 x at odd widths or unaligned),
//     float32 FMA on the SIMT pipe (never TF32, which would drop bits of an
//     f32 operand the reference keeps), 8 x 8 or 2 x 8 outputs a thread.  Its
//     tiles are staged as float32, so a bf16 operand is widened once.
// Their row tiles are 32 rows when the mean group has at most 48 rows (a
// decode step: a dozen rows an expert), else 128, so that a small group
// wastes little of its tile.  No variant falls back to another.
//
// Element offsets are 64-bit: w[e]'s base e*D*F passes 2^31 at widths the
// repo's configurations reach (8.05e8 at mixtral-8x22b width, 7 experts in).
//
// Bound on the card for these two kernels: the larger of the bytes (x's
// grouped rows read once, the weights of the non-empty experts read once,
// out written once as f32, at 3.35 TB/s) and the operations 2 * rows * D * F
// (at 989 TFLOP/s when both operands are bf16, 67 TFLOP/s when one is f32 on
// the FMA pipe).  They stage through registers with one load in flight and
// use mma.sync or the f32 pipe, so they sit well above that bound (PERF.md);
// they stay for the shapes that TMA cannot address.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grouped_matmul.cuh"

namespace {

using gmm::clampi;

constexpr int kThreads = 256;
constexpr int BN = 128;  // output columns of a tile
constexpr int kSmallTile = 32, kLargeTile = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// tile_start[e] = sum over e' < e of ceil(size_e' / bm); tile_start[E] is the
// number of row tiles that hold rows.  One warp, 32 experts per step.
__global__ void gmm_schedule_kernel(const int* __restrict__ offs, int* __restrict__ tile_start,
                                    int E, int T, int bm) {
  const int lane = threadIdx.x;
  int carry = 0;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    int c = 0;
    if (e < E) {
      const int lo = clampi(offs[e], 0, T);
      const int hi = clampi(offs[e + 1], 0, T);
      c = hi > lo ? (int)(((long long)hi - lo + bm - 1) / bm) : 0;
    }
    int inc = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += n;
    }
    if (e < E) tile_start[e] = carry + inc - c;
    carry += __shfl_sync(kFull, inc, 31);
  }
  if (lane == 0) {
    tile_start[E] = carry;
    tile_start[E + 1] = 0;  // tiles handed out by gmm_wgmma_kernel's scheduler
  }
}

// ---------------------------------------------------------------- f32 FMA

// Rows of the thread's outputs: two runs of 4 (one in each half of a
// 128-row tile), or TM consecutive rows.
template <int TM>
__device__ __forceinline__ int fma_row(int ty, int i) {
  if constexpr (TM == 8) return (i / 4) * 64 + ty * 4 + (i % 4);
  return ty * TM + i;
}

template <typename TX, typename TW, int BM>
__global__ void __launch_bounds__(kThreads, 2)
    gmm_fma_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   const int* __restrict__ offs, const int* __restrict__ tile_start,
                   float* __restrict__ out, int T, int D, int F, int E) {
  // depth a step: 16 for 32-row tiles, whose few rows leave registers for
  // more weight bytes in flight
  constexpr int BK = BM == kSmallTile ? 16 : 8;
  constexpr int TM = BM / 16;  // rows a thread: 8 or 2; columns: 8
  constexpr int A_LOADS = BM * BK / kThreads;
  constexpr int B_LOADS = BK * BN / kThreads;
  static_assert(TM == 8 || TM == 2, "tile height");
  __shared__ __align__(16) float As[2][BK][BM + 4];  // x tile, transposed
  __shared__ __align__(16) float Bs[2][BK][BN];      // w[e] tile

  const int col0 = blockIdx.y * BN;
  int e, row0, rows;
  if (!gmm::locate_tile<BM, BN, kThreads>(offs, tile_start, out, T, F, E, col0, e, row0, rows))
    return;
  const TW* __restrict__ we = w + (size_t)e * D * F;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  float ra[A_LOADS], rb[B_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    const int idx = tid + i * kThreads, r = idx / BK, k = idx % BK;
    ra[i] = r < rows && k < D ? to_f32(x[(size_t)(row0 + r) * D + k]) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < B_LOADS; ++i) {
    const int idx = tid + i * kThreads, k = idx / BN, c = col0 + idx % BN;
    rb[i] = k < D && c < F ? to_f32(we[(size_t)k * F + c]) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    const int idx = tid + i * kThreads;
    As[0][idx % BK][idx / BK] = ra[i];
  }
#pragma unroll
  for (int i = 0; i < B_LOADS; ++i) {
    const int idx = tid + i * kThreads;
    Bs[0][idx / BN][idx % BN] = rb[i];
  }
  __syncthreads();

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  int buf = 0;
  for (int k0 = 0; k0 < D; k0 += BK) {
    const int k1 = k0 + BK;
    const bool more = k1 < D;
    if (more) {  // the next tile's loads, in flight while this one computes
#pragma unroll
      for (int i = 0; i < A_LOADS; ++i) {
        const int idx = tid + i * kThreads, r = idx / BK, k = k1 + idx % BK;
        ra[i] = r < rows && k < D ? to_f32(x[(size_t)(row0 + r) * D + k]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < B_LOADS; ++i) {
        const int idx = tid + i * kThreads, k = k1 + idx / BN, c = col0 + idx % BN;
        rb[i] = k < D && c < F ? to_f32(we[(size_t)k * F + c]) : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM];
      if constexpr (TM == 8) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
        av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
        av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      } else {
        const float2 a0 = *reinterpret_cast<const float2*>(&As[buf][k][ty * 2]);
        av[0] = a0.x; av[1] = a0.y;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {  // the other buffer was last read a step ago
#pragma unroll
      for (int i = 0; i < A_LOADS; ++i) {
        const int idx = tid + i * kThreads;
        As[buf ^ 1][idx % BK][idx / BK] = ra[i];
      }
#pragma unroll
      for (int i = 0; i < B_LOADS; ++i) {
        const int idx = tid + i * kThreads;
        Bs[buf ^ 1][idx / BN][idx % BN] = rb[i];
      }
    }
    __syncthreads();
    buf ^= 1;
  }

  const bool vec = (F % 4) == 0;  // then every row of out is 16-byte aligned
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = fma_row<TM>(ty, i);
    if (r >= rows) continue;
    float* orow = out + (size_t)(row0 + r) * F;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * 64 + tx * 4;
      if (vec && c + 3 < F) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(
            acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < F) orow[c + j] = acc[i][h * 4 + j];
      }
    }
  }
}

// ------------------------------------------------------ bf16 x bf16 mma.sync

// 8 bf16 of p[j, j+8) as a uint4, zero past n or when !ok; one 16-byte load
// when the whole run is in range and aligned.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int j, int n, bool ok, bool vec) {
  if (!ok) return make_uint4(0, 0, 0, 0);
  if (vec && j + 8 <= n) return *reinterpret_cast<const uint4*>(p + j);
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  unsigned u[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const unsigned lo = j + 2 * t < n ? q[j + 2 * t] : 0u;
    const unsigned hi = j + 2 * t + 1 < n ? q[j + 2 * t + 1] : 0u;
    u[t] = lo | (hi << 16);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16 x 16, row) * b (16 x 8, col), float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight warps as 2 (rows) x 4 (columns); a warp computes MT x 4 m16n8 tiles,
// (16 MT) x 32 outputs.
template <int MT>
__global__ void __launch_bounds__(kThreads)
    gmm_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ offs, const int* __restrict__ tile_start,
                   float* __restrict__ out, int T, int D, int F, int E, int vec_x,
                   int vec_w) {
  constexpr int BM = 32 * MT;
  constexpr int BK = 32;
  constexpr int AST = BK + 8;  // row strides in bf16: 80 and 272 bytes keep
  constexpr int BST = BN + 8;  // ldmatrix's 8 row reads on distinct banks
  constexpr int A_CHUNKS = BM * BK / 8;  // 16-byte chunks of a tile
  constexpr int B_CHUNKS = BK * BN / 8;
  constexpr int A_LOADS = (A_CHUNKS + kThreads - 1) / kThreads;
  constexpr int B_LOADS = B_CHUNKS / kThreads;
  __shared__ __align__(16) __nv_bfloat16 As[2][BM][AST];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BK][BST];

  const int col0 = blockIdx.y * BN;
  int e, row0, rows;
  if (!gmm::locate_tile<BM, BN, kThreads>(offs, tile_start, out, T, F, E, col0, e, row0, rows))
    return;
  const __nv_bfloat16* __restrict__ we = w + (size_t)e * D * F;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;

  uint4 ra[A_LOADS], rb[B_LOADS];
  auto a_chunk = [&](int i, int& r, int& kc) {
    const int c = tid + i * kThreads;
    r = c / (BK / 8);
    kc = (c % (BK / 8)) * 8;
    return c < A_CHUNKS;
  };
  auto b_chunk = [&](int i, int& k, int& nc) {
    const int c = tid + i * kThreads;
    k = c / (BN / 8);
    nc = (c % (BN / 8)) * 8;
  };
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    int r, kc;
    const bool in = a_chunk(i, r, kc);
    ra[i] = load8(x + (size_t)(row0 + r) * D, kc, D, in && r < rows, vec_x);
  }
#pragma unroll
  for (int i = 0; i < B_LOADS; ++i) {
    int k, nc;
    b_chunk(i, k, nc);
    rb[i] = load8(we + (size_t)k * F, col0 + nc, F, k < D, vec_w);
  }
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    int r, kc;
    if (a_chunk(i, r, kc)) *reinterpret_cast<uint4*>(&As[0][r][kc]) = ra[i];
  }
#pragma unroll
  for (int i = 0; i < B_LOADS; ++i) {
    int k, nc;
    b_chunk(i, k, nc);
    *reinterpret_cast<uint4*>(&Bs[0][k][nc]) = rb[i];
  }
  __syncthreads();

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.0f;

  int buf = 0;
  for (int k0 = 0; k0 < D; k0 += BK) {
    const int k1 = k0 + BK;
    const bool more = k1 < D;
    if (more) {  // the next tile's loads, in flight while this one computes
#pragma unroll
      for (int i = 0; i < A_LOADS; ++i) {
        int r, kc;
        const bool in = a_chunk(i, r, kc);
        ra[i] = load8(x + (size_t)(row0 + r) * D, k1 + kc, D, in && r < rows, vec_x);
      }
#pragma unroll
      for (int i = 0; i < B_LOADS; ++i) {
        int k, nc;
        b_chunk(i, k, nc);
        rb[i] = load8(we + (size_t)(k1 + k) * F, col0 + nc, F, k1 + k < D, vec_w);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], &As[buf][wm * 16 * MT + mt * 16 + lane % 16][kk + (lane / 16) * 8]);
      unsigned bf[2][4];  // two k16 x n16 pieces: n8 tiles (0, 1) and (2, 3)
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(bf[np], &Bs[buf][kk + lane % 16][wn * 32 + np * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bf[nt / 2][(nt % 2) * 2], bf[nt / 2][(nt % 2) * 2 + 1]);
    }
    if (more) {  // the other buffer was last read a step ago
#pragma unroll
      for (int i = 0; i < A_LOADS; ++i) {
        int r, kc;
        if (a_chunk(i, r, kc)) *reinterpret_cast<uint4*>(&As[buf ^ 1][r][kc]) = ra[i];
      }
#pragma unroll
      for (int i = 0; i < B_LOADS; ++i) {
        int k, nc;
        b_chunk(i, k, nc);
        *reinterpret_cast<uint4*>(&Bs[buf ^ 1][k][nc]) = rb[i];
      }
    }
    __syncthreads();
    buf ^= 1;
  }

  // accumulator t of an m16n8 tile: row lane/4 (+8 for t >= 2), column
  // 2 (lane % 4) + t % 2
  const bool pair = (F % 2) == 0;  // then a float2 at an even column is aligned
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 * MT + mt * 16 + lane / 4 + h * 8;
      if (r >= rows) continue;
      float* orow = out + (size_t)(row0 + r) * F;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = col0 + wn * 32 + nt * 8 + (lane % 4) * 2;
        const float v0 = acc[mt][nt][h * 2], v1 = acc[mt][nt][h * 2 + 1];
        if (pair && c + 1 < F) {
          *reinterpret_cast<float2*>(orow + c) = make_float2(v0, v1);
        } else {
          if (c < F) orow[c] = v0;
          if (c + 1 < F) orow[c + 1] = v1;
        }
      }
    }
}

template <typename TX, typename TW>
void launch_fma(bool small, dim3 grid, cudaStream_t s, const void* x, const void* w,
                const int* offs, const int* tile_start, float* out, int T, int D, int F, int E) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  if (small)
    gmm_fma_kernel<TX, TW, kSmallTile><<<grid, kThreads, 0, s>>>(xp, wp, offs, tile_start, out,
                                                                 T, D, F, E);
  else
    gmm_fma_kernel<TX, TW, kLargeTile><<<grid, kThreads, 0, s>>>(xp, wp, offs, tile_start, out,
                                                                 T, D, F, E);
}

}  // namespace

extern "C" {

// The variant that grouped_matmul_launch runs, from the dtypes (0 float32,
// 1 bfloat16), the widths and the base addresses alone: 2 for
// gmm_wgmma_kernel (bf16 x bf16, or f32 x with bf16 w, where TMA can
// address both tensors: rows of a multiple of 16 bytes, 16-byte-aligned
// bases, D, E > 0), 1 for gmm_mma_kernel (any other bf16 x bf16), 0 for
// gmm_fma_kernel (any other mix).
int grouped_matmul_variant(const void* x, const void* w, int D, int F, int E, int x_dtype,
                           int w_dtype) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 && D > 0 && E > 0 &&
                       F % 8 == 0 && D % (x_dtype == 1 ? 8 : 4) == 0;
  if (w_dtype == 1 && aligned) return 2;
  return x_dtype == 1 && w_dtype == 1 ? 1 : 0;
}

// dtype codes: 0 float32, 1 bfloat16.  tile_start is int32 scratch of E+2.
int grouped_matmul_launch(const void* x, const void* w, const int* offs, int* tile_start,
                          float* out, int T, int D, int F, int E, int x_dtype, int w_dtype,
                          void* stream) {
  if (T == 0 || F == 0) return 0;
  if (x_dtype < 0 || x_dtype > 1 || w_dtype < 0 || w_dtype > 1 || E < 0 || D < 0)
    return (int)cudaErrorInvalidValue;
  const int variant = grouped_matmul_variant(x, w, D, F, E, x_dtype, w_dtype);
  // small tiles when the mean group has at most 48 rows
  const bool small = (long long)T <= 48LL * (E > 0 ? E : 1);
  const int bm = variant == 2 ? gmm_wgmma_bm(small) : small ? kSmallTile : kLargeTile;
  const long long nx = ((long long)T + bm - 1) / bm + E;
  const long long ny = ((long long)F + BN - 1) / BN;
  if (nx > INT_MAX || ny > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  gmm_schedule_kernel<<<1, 32, 0, s>>>(offs, tile_start, E, T, bm);
  if (variant == 2)
    return gmm_wgmma_run(x, w, offs, tile_start, out, T, D, F, E, x_dtype, small, stream);
  const dim3 grid((unsigned)nx, (unsigned)ny);
  switch (x_dtype * 2 + w_dtype) {
    case 0:
      launch_fma<float, float>(small, grid, s, x, w, offs, tile_start, out, T, D, F, E);
      break;
    case 1:
      launch_fma<float, __nv_bfloat16>(small, grid, s, x, w, offs, tile_start, out, T, D, F, E);
      break;
    case 2:
      launch_fma<__nv_bfloat16, float>(small, grid, s, x, w, offs, tile_start, out, T, D, F, E);
      break;
    default: {
      const auto* xp = static_cast<const __nv_bfloat16*>(x);
      const auto* wp = static_cast<const __nv_bfloat16*>(w);
      // 16-byte loads need 8-element rows and 16-byte-aligned bases
      const int vec_x = D % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
      const int vec_w = F % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
      if (small)
        gmm_mma_kernel<1><<<grid, kThreads, 0, s>>>(xp, wp, offs, tile_start, out, T, D, F, E,
                                                    vec_x, vec_w);
      else
        gmm_mma_kernel<4><<<grid, kThreads, 0, s>>>(xp, wp, offs, tile_start, out, T, D, F, E,
                                                    vec_x, vec_w);
      break;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
