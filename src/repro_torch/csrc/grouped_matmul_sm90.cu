// gmm_wgmma_kernel: the grouped GEMM of grouped_matmul.cu on Hopper's own
// path (sm_90a): TMA loads into a ring of shared-memory stages, wgmma on
// the tensor cores, one producer warp and one or two consumer warpgroups.
//
// It computes what src/repro/kernels/grouped_matmul.py:_gmm_kernel (:33)
// computes, on the device-side schedule of grouped_matmul.cu (the one-warp
// gmm_schedule_kernel, each row tile's binary search for its expert, the
// ceil(T/BM) + E upper-bound grid whose spare tiles zero the rows outside
// every group): out [T, F] float32, out[t] = f32(x[t]) @ f32(w[g]).  Two
// operand mixes come here, chosen on the host (grouped_matmul_variant) when
// TMA can address both tensors: rows of a multiple of 16 bytes and
// 16-byte-aligned bases.
//
//   - bf16 x bf16 (the up projections): both operands go to wgmma from
//     shared memory (SS form).  A bf16 product is exact in float32, so only
//     the order of the float32 sums differs from the reference.
//   - f32 x, bf16 w (the down projections): the consumers read the f32 x
//     tile from shared memory and split each element exactly into three
//     bf16 pieces, hi = trunc(x), mid = trunc(x - hi), lo = rn(x - hi - mid)
//     (hi = x, mid = lo = 0 for inf and NaN), held in registers in wgmma's
//     A-fragment layout (RS form); three wgmma against the same w stage sum
//     hi*w + mid*w + lo*w into one float32 accumulator.  hi + mid + lo == x
//     bit for bit down to about 2^-100 (below, the residual falls under
//     bf16's subnormal range: an error under 2^-126), and each piece's
//     product with a bf16 w is exact in float32, so the result keeps the
//     reference's float32 tolerance at three times the tensor-core work.
//     No f32 operand reaches the tensor cores as TF32.
//
// Layout.  A stage holds BK = 64 along D.  x's box is [BM rows][128 bytes]
// (64 bf16, or two boxes of 32 f32) from a 2-D tensor map over x [T, D]
// starting at the tile's first row: rows past T come back zero, and rows
// past the tile's group (the next expert's) are multiplied and dropped by
// the masked epilogue.  w's box is BN/64 slabs of [64 rows of D][64
// columns of F] from a 3-D tensor map over w [E, D, F], so the K tail of
// expert e (D % 64 != 0) reads zeros, not expert e+1's first rows.  Every
// box is 128-byte swizzled; A is read K-major and B MN-major (F contiguous,
// the transpose bit that wgmma allows for 16-bit types).  Each stage has a
// full mbarrier (the producer's expect_tx and TMA's bytes) and an empty one
// (one arrival per consumer warp once its wgmma have retired).
//
// Tiles.  A decode step (mean group <= 48 rows) takes 64-row tiles with one
// consumer warpgroup, BN = 128 and ~96 KB of stages, so two blocks share an
// SM: a group of ~12 rows makes the tile bytes-bound, and the ring keeps
// every SM's weight stream in flight.  Prefill takes 128-row tiles with two
// consumer warpgroups (a warpgroup whose 64 rows hold none of the group's
// skips its wgmma), BN = 256 and ~192 KB of stages; setmaxnreg moves
// registers from the producer to the consumers; a last column tile with at
// most 128 columns left runs m64n128.  The blocks are persistent (as many
// as fit on the card) and take output tiles from a counter in the schedule's
// scratch, in groups of 8 row tiles so that the tiles at work share x rows
// and w columns in L2; the producer runs on into the next tile's loads while
// the consumers store this one.
//
// Epilogue.  float32 is stored with a mask to the tile's own rows
// [row0, row0 + rows), never a TMA store of the whole box (its bottom rows
// belong to the next expert).  Prefill tiles go through 4 KB of shared
// memory a consumer warp, so that each store writes 16 bytes a thread,
// two whole 256-byte row pieces a warp.
//
// Bound on the card: bytes (x's grouped rows read once, the non-empty
// experts' weights once, out written once as f32, at 3.35 TB/s) or
// operations: 2 * rows * D * F for bf16 x bf16 and 3 * 2 * rows * D * F for
// the split f32 x bf16, at 989 TFLOP/s.  What holds it there (PERF.md, on
// an H100 SXM at 700 W): a decode step sits at 1.2-1.4x its bytes bound; a
// dense bf16 product runs at ~716 TFLOP/s, near cuBLAS's ~750; grouped
// prefill reads every expert's weights from device memory and writes twice
// the bytes of a bf16 output, and the float32 epilogue costs ~10% of the
// prefill time (measured by dropping the stores).
#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grouped_matmul.cuh"

namespace {

constexpr int BK = 64;               // depth of a stage: 64 bf16 = 128 bytes
constexpr uint32_t kSlab = 64 * 128;  // one [64][128-byte] box of w

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptors, 128-byte swizzle (layout type 1 in bits
// 62-63), byte offsets in 16-byte units.  K-major A: 8-row groups 1024 bytes
// apart (SBO), LBO unused; a k16 step moves the start 32 bytes along the
// swizzled row.  MN-major B: 8-row (K) groups 1024 bytes apart (SBO), the
// next 64 columns one 8 KB slab further (LBO); a k16 step moves 16 rows,
// 2048 bytes.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kSlab >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of these registers across
// the asynchronous wgmma that use them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma m64nNk16, float32 += bf16 x bf16; B MN-major (transpose bit set).
// SS: A K-major in shared memory.  RS: A in registers, wgmma's fragment
// layout (per warp the m16n8k16 A fragment of rows 16 * warp + [0, 16)).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// x as three bf16 bit patterns with hi + mid + lo == x (see the note above),
// without a branch: inf and NaN ride in hi (as x, rounded), mid = lo = 0.
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const uint32_t b = __float_as_uint(x);
  const bool finite = (b & 0x7f800000u) != 0x7f800000u;
  const uint32_t hb = b & 0xffff0000u;
  const float r1 = finite ? x - __uint_as_float(hb) : 0.0f;  // exact: x's low 16 bits
  const uint32_t mb = __float_as_uint(r1) & 0xffff0000u;
  const float r2 = r1 - __uint_as_float(mb);  // exact
  hi = finite ? hb >> 16 : __bfloat16_as_ushort(__float2bfloat16_rn(x));
  mid = mb >> 16;
  lo = __bfloat16_as_ushort(__float2bfloat16_rn(r2));
}

// Two f32 at (row, col), (row, col + 1) of a [rows][32] f32 box, 128-byte
// swizzled: 16-byte chunk (col / 4) ^ (row % 8) of the row's 128 bytes.
__device__ __forceinline__ float2 lds_f32x2(uint32_t box, int row, int col) {
  const uint32_t a = box + row * 128 + ((((col >> 2) ^ row) & 7) << 4) + ((col & 3) << 2);
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}

template <int BN>
__device__ __forceinline__ void mma_ss(float (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_ss_n128(acc, da, db);
  else wgmma_ss_n256(acc, da, db);
}

template <int BN>
__device__ __forceinline__ void mma_rs(float (&acc)[BN / 2], const uint32_t (&a)[4],
                                       uint64_t db) {
  if constexpr (BN == 128) wgmma_rs_n128(acc, a, db);
  else wgmma_rs_n256(acc, a, db);
}

template <bool kF32X, int kWG, int BN>
struct Geometry {
  static constexpr int BM = 64 * kWG;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr uint32_t A_BYTES = (kF32X ? 2 : 1) * BM * 128;
  static constexpr uint32_t B_BYTES = (BN / 64) * kSlab;
  static constexpr uint32_t STAGE = A_BYTES + B_BYTES;
  // the staged epilogue's 4 KB a consumer warp, for the prefill tiles
  static constexpr uint32_t EPI_BYTES = kWG > 1 ? kWG * 4 * 4096 : 0;
};

constexpr int kGroup = 8;  // row tiles of a raster group

// Output tile i of nx row tiles x ny column tiles, in groups of kGroup row
// tiles with the row tile running fastest inside a group: the blocks at work
// at one time share a few x row tiles and a few w column strips in L2.
__device__ __forceinline__ void raster(int i, int nx, int ny, int& rt, int& ct) {
  const int per_group = kGroup * ny;
  const int first = (i / per_group) * kGroup;
  const int size = min(kGroup, nx - first);
  const int j = i % per_group;
  rt = first + j % size;
  ct = j / size;
}

// Persistent: block b takes output tile b first, then the next one that no
// block has taken (a counter in the schedule's scratch), so blocks that drew
// short tiles take more.  Warpgroups 0 .. kWG-1 consume, 64 rows each;
// warpgroup kWG produces: one thread takes the tiles, hands each to the
// consumers through a two-slot ring, and issues every TMA load.  Both roles
// count the same k-steps, so the stage ring runs on across tiles: the next
// tile's loads are in flight while the consumers store this one.
template <bool kF32X, int kWG, int BN, int S>
__global__ void __launch_bounds__(128 * (kWG + 1), kWG == 1 ? 2 : 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w, const int* __restrict__ offs,
                     int* __restrict__ tile_start, float* __restrict__ out, int T, int D,
                     int F, int E, int nx, int ny) {
  using G = Geometry<kF32X, kWG, BN>;
  constexpr int BM = G::BM;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[S];
  __shared__ __align__(8) uint64_t empty_bar[S];
  __shared__ __align__(8) uint64_t tile_full[2], tile_empty[2];
  __shared__ int tile_slot[2];

  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle's 1024-byte atoms
  const int nk = (D + BK - 1) / BK;
  const int n_tiles = nx * ny;
  int* tile_next = tile_start + E + 1;  // tiles handed out past the first gridDim.x
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), 4 * kWG);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(smem_u32(&tile_full[i]), 1);
      mbar_init(smem_u32(&tile_empty[i]), 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWG) {  // ------------------------------------------ producer
    if constexpr (kWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kWG * 128) {
      int it = 0;  // k-steps loaded so far
      for (int tile = blockIdx.x, ti = 0;; ++ti) {
        // hand the tile to the consumers through a two-slot ring
        mbar_wait(smem_u32(&tile_empty[ti & 1]), ((ti >> 1) & 1) ^ 1);
        tile_slot[ti & 1] = tile;
        mbar_arrive(smem_u32(&tile_full[ti & 1]));
        if (tile >= n_tiles) break;
        const int this_tile = tile;
        // the next tile: the first one no block has taken
        tile = gridDim.x + atomicAdd(tile_next, 1);
        int rt, ct, e, row0, rows;
        raster(this_tile, nx, ny, rt, ct);
        if (!gmm::place_tile(rt, offs, tile_start, T, E, BM, e, row0, rows)) continue;
        const int col0 = ct * BN;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(smem_u32(&empty_bar[s]), ((it / S) & 1) ^ 1);
          const uint32_t full = smem_u32(&full_bar[s]);
          mbar_expect_tx(full, G::STAGE);
          const uint32_t a = base + s * G::STAGE, b = a + G::A_BYTES;
          const int k0 = kb * BK;
          tma_2d(a, &map_x, full, k0, row0);
          if constexpr (kF32X) tma_2d(a + BM * 128, &map_x, full, k0 + 32, row0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_3d(b + j * kSlab, &map_w, full, col0 + 64 * j, k0, e);
        }
      }
    }
  } else {  // -------------------------------------------------- consumers
    if constexpr (kWG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 64 * wg + 16 * warp + g;  // fragment and accumulator rows r0, r0 + 8
    int it = 0;  // k-steps consumed so far
    for (int ti = 0;; ++ti) {
      mbar_wait(smem_u32(&tile_full[ti & 1]), (ti >> 1) & 1);
      const int tile = *reinterpret_cast<volatile int*>(&tile_slot[ti & 1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&tile_empty[ti & 1]));
      if (tile >= n_tiles) break;
      int rt, ct, e, row0, rows;
      raster(tile, nx, ny, rt, ct);
      const int col0 = ct * BN;
      if (!gmm::place_tile(rt, offs, tile_start, T, E, BM, e, row0, rows)) {
        gmm::zero_outside<BM, BN>(rt, nx, threadIdx.x, 128 * kWG, offs, tile_start, out, T, F,
                                  E, col0);
        continue;
      }
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

      if constexpr (!kF32X) {
        const bool active = 64 * wg < rows;  // else this warpgroup's rows are all dropped
        // a last column tile with at most 128 columns left multiplies only those
        const bool narrow = BN > 128 && F - col0 <= 128;
        int prev = -1;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(smem_u32(&full_bar[s]), (it / S) & 1);
          if (active) {
            const uint32_t a = base + s * G::STAGE + wg * 64 * 128;
            const uint32_t b = base + s * G::STAGE + G::A_BYTES;
            fence_regs(acc);
            wgmma_fence();
            if (narrow) {
#pragma unroll
              for (int kk = 0; kk < BK / 16; ++kk)
                mma_ss<128>(reinterpret_cast<float(&)[64]>(acc), desc_k_major(a + kk * 32),
                            desc_mn_major(b + kk * 2048));
            } else {
#pragma unroll
              for (int kk = 0; kk < BK / 16; ++kk)
                mma_ss<BN>(acc, desc_k_major(a + kk * 32), desc_mn_major(b + kk * 2048));
            }
            wgmma_commit();
            wgmma_wait<1>();  // the previous stage's wgmma have retired
            fence_regs(acc);
          }
          if (prev >= 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[prev]));
          prev = s;
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(smem_u32(&empty_bar[prev]));
      } else {
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(smem_u32(&full_bar[s]), (it / S) & 1);
          {  // no branch around the RS-form wgmma: in a divergent path ptxas
             // serializes them (C7520), so every warpgroup multiplies
            const uint32_t a = base + s * G::STAGE, b = a + G::A_BYTES;
            // [k16 step][piece hi, mid, lo][fragment register]
            uint32_t fr[BK / 16][3][4];
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
              const uint32_t box = a + (kk / 2) * BM * 128;
#pragma unroll
              for (int h = 0; h < 2; ++h) {  // columns 2t, 2t+1, then 8 further
                const int c = (kk % 2) * 16 + h * 8 + 2 * t;
#pragma unroll
                for (int q = 0; q < 2; ++q) {  // rows r0, r0 + 8
                  const float2 v = lds_f32x2(box, r0 + 8 * q, c);
                  uint32_t p0[3], p1[3];
                  split3(v.x, p0[0], p0[1], p0[2]);
                  split3(v.y, p1[0], p1[1], p1[2]);
#pragma unroll
                  for (int p = 0; p < 3; ++p) fr[kk][p][2 * h + q] = p0[p] | (p1[p] << 16);
                }
              }
            }
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
              const uint64_t db = desc_mn_major(b + kk * 2048);
              mma_rs<BN>(acc, fr[kk][2], db);  // the smallest piece first
              mma_rs<BN>(acc, fr[kk][1], db);
              mma_rs<BN>(acc, fr[kk][0], db);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
              for (int p = 0; p < 3; ++p) fence_regs(fr[kk][p]);  // live until retired
          }
          if (lane == 0) mbar_arrive(smem_u32(&empty_bar[s]));
        }
      }

      if constexpr (G::EPI_BYTES > 0) {
        // through this warp's 16 x 64 float32 of shared memory, 64 columns at
        // a time (8-column groups swizzled by row), then 16 bytes a thread:
        // a warp stores two whole 256-byte row pieces an instruction
        const uint32_t scratch = base + S * G::STAGE + (threadIdx.x / 32) * 4096;
#pragma unroll
        for (int cc = 0; cc < BN / 64; ++cc) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int row = g + 8 * q;
              const uint32_t at = scratch + (row * 64 + 8 * (jj ^ (row & 7)) + 2 * t) * 4;
              asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at),
                           "f"(acc[4 * (8 * cc + jj) + 2 * q]),
                           "f"(acc[4 * (8 * cc + jj) + 2 * q + 1])
                           : "memory");
            }
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = 2 * i + lane / 16, c4 = 4 * (lane % 16);
            float4 v;
            asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                         : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                         : "r"(scratch + (row * 64 + (c4 ^ (8 * (row & 7)))) * 4)
                         : "memory");
            const int rr = r0 - g + row, c = col0 + 64 * cc + c4;
            if (rr < rows && c < F)  // F % 8 == 0: four columns are in or out whole
              *reinterpret_cast<float4*>(out + (size_t)(row0 + rr) * F + c) = v;
          }
          __syncwarp();
        }
      } else {
        // accumulator 4j + i: row r0 (+8 for i >= 2), column 8j + 2t + i % 2
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int rr = r0 + 8 * q;
          if (rr >= rows) continue;
          float* orow = out + (size_t)(row0 + rr) * F;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int c = col0 + 8 * j + 2 * t;
            if (c < F)  // F % 8 == 0 on this path: a pair is in or out whole
              *reinterpret_cast<float2*>(orow + c) =
                  make_float2(acc[4 * j + 2 * q], acc[4 * j + 2 * q + 1]);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime: no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

bool encode(CUtensorMap* map, CUtensorMapDataType dtype, cuuint32_t rank, const void* base,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, dtype, rank, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kF32X, int kWG, int BN, int S>
int run(const void* x, const void* w, const int* offs, int* tile_start, float* out, int T,
        int D, int F, int E, cudaStream_t stream) {
  using G = Geometry<kF32X, kWG, BN>;
  const int esize = kF32X ? 4 : 2;
  CUtensorMap map_x, map_w;
  const cuuint64_t x_dims[2] = {(cuuint64_t)D, (cuuint64_t)T};
  const cuuint64_t x_strides[1] = {(cuuint64_t)D * esize};
  const cuuint32_t x_box[2] = {(cuuint32_t)(128 / esize), (cuuint32_t)G::BM};
  const cuuint64_t w_dims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)F * 2, (cuuint64_t)D * F * 2};
  const cuuint32_t w_box[3] = {64, 64, 1};
  if (!encode(&map_x, kF32X ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
              2, x, x_dims, x_strides, x_box) ||
      !encode(&map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, w_dims, w_strides, w_box))
    return (int)cudaErrorInvalidValue;
  // + the slack that aligns the ring to 1024 bytes
  const int smem = S * G::STAGE + G::EPI_BYTES + 1024;
  auto kernel = gmm_wgmma_kernel<kF32X, kWG, BN, S>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: as many blocks as fit on the card at once, at most one a tile
  const long long nx = ((long long)T + G::BM - 1) / G::BM + E, ny = (F + BN - 1) / BN;
  if (nx * ny > INT_MAX) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  static int per_sm = 0;  // blocks of this instantiation that fit on one SM
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G::kThreads, smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = nx * ny < (long long)sms * per_sm ? nx * ny : (long long)sms * per_sm;
  kernel<<<(unsigned)grid, G::kThreads, smem, stream>>>(map_x, map_w, offs, tile_start, out, T,
                                                        D, F, E, (int)nx, (int)ny);
  return (int)cudaGetLastError();
}

}  // namespace

int gmm_wgmma_bm(bool small) { return small ? 64 : 128; }

int gmm_wgmma_run(const void* x, const void* w, const int* offs, int* tile_start,
                  float* out, int T, int D, int F, int E, int x_dtype, bool small,
                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 1)
    return small ? run<false, 1, 128, 4>(x, w, offs, tile_start, out, T, D, F, E, s)
                 : run<false, 2, 256, 4>(x, w, offs, tile_start, out, T, D, F, E, s);
  return small ? run<true, 1, 128, 3>(x, w, offs, tile_start, out, T, D, F, E, s)
               : run<true, 2, 256, 3>(x, w, offs, tile_start, out, T, D, F, E, s);
}
