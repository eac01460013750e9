// flix_apply_staged: the fused mixed-batch pass of FliX with staged stripes,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flix_apply.py:_apply_kernel_pipelined
// (the double-buffered variant of the same pl.pallas_call): there the
// sequential grid started the DMA of the next bucket block's stripes into
// one VMEM slot while the current block merged in the other.  Blocks here
// run in parallel in no order, so the sequential grid becomes a persistent
// loop: a grid of a few blocks per SM (as many as fit at once), each walking
// the buckets b = blockIdx.x, blockIdx.x + gridDim.x, ...  While bucket i
// is merged, deleted and read in one shared-memory stripe (apply_bucket of
// flix_phases.cuh, the very device functions of the single-buffer kernel in
// flix_apply.cu, so the two compute one function), cp.async copies bucket
// i+1's rows and slice bounds into the second buffer.  Only the num_nodes[b]
// node rows that hold keys are copied (I3/I4 pack the active nodes first),
// and the phases read no further (merge_phase stops at the active rows);
// the empty rows of the output stripe are written as EMPTY / 0 by the
// compaction without ever being read.
//
// Bound on the card: bytes, as for flix_apply.cu: the pass writes every
// stripe whole (it is functional, the old state stays valid for a
// restructure-and-retry) and needs of the old stripe only the rows that
// hold keys, which is all this kernel reads of it.  What the single-buffer
// kernel spent on the dependent round trips of each block's start (the
// stripe copy, then the slice bounds) overlaps the previous bucket's work
// here; the round trips to the insert, delete and op slices remain.
#include <cuda_runtime.h>

#include "flix_phases.cuh"

namespace {

using namespace flix;

// the staged per-bucket scalars: the six slice bounds, then num_nodes
constexpr int kBoundInts = 8;
constexpr int kNumNodes = 6;

__device__ __forceinline__ void cp_async_4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every group but the newest one of this thread has landed.
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start the copy of src[0, n) to the shared dst[0, n), 16 bytes a thread
// where both ends are 16-byte aligned and n is a multiple of 4, else 4.
__device__ inline void stage_ints(int* dst, const int* src, int n) {
  const int t = threadIdx.x, T = blockDim.x;
  const size_t ends = reinterpret_cast<size_t>(src) |
                      static_cast<size_t>(__cvta_generic_to_shared(dst));
  if ((ends & 15) == 0 && (n & 3) == 0) {
    for (int i = 4 * t; i < n; i += 4 * T) cp_async_16(dst + i, src + i);
  } else {
    for (int i = t; i < n; i += T) cp_async_4(dst + i, src + i);
  }
}

// One of the two input buffers: a bucket's stripe, node max row and scalars.
struct Buffer {
  int* A;    // [S] keys
  int* Av;   // [S] vals
  int* Nmax; // [npb]
  int* Bnd;  // [kBoundInts]
};

__host__ __device__ inline int buffer_ints(int npb, int ns) {
  return 2 * npb * ns + npb + kBoundInts;
}

// Shared memory of a staged block: the two input buffers, then the scratch
// of a merge pass except its input stripe and node max row.
__host__ __device__ inline int staged_smem_ints(int npb, int ns) {
  return 2 * buffer_ints(npb, ns) + merge_smem_ints(npb, ns) - 2 * npb * ns - npb;
}

// Input buffer k (0 or 1) of a staged block.
__device__ inline Buffer buffer_at(int* smem, int k, int npb, int ns) {
  const int S = npb * ns;
  int* p = smem + k * buffer_ints(npb, ns);
  return Buffer{p, p + S, p + 2 * S, p + 2 * S + npb};
}

// The merge scratch past the two input buffers; A, Av and Nmax are set per
// bucket to the buffer that holds it.
__device__ inline Stripe carve_staged(int* smem, int npb, int ns) {
  const int S = npb * ns;
  Stripe s;
  s.A = s.Av = s.Nmax = nullptr;
  s.B = smem + 2 * buffer_ints(npb, ns);
  s.Bv = s.B + S;
  s.K = s.Bv + S;
  s.M = s.K + S;
  s.Mv = s.M + S;
  s.X = s.Mv + S;
  s.Mj = s.X + S + 1;
  s.Sj = s.Mj + npb;
  s.Fj = s.Sj + npb;
  s.Base = s.Fj + npb;
  s.Slot = s.Base + npb;
  s.Cnt = s.Slot + npb;
  s.Warp = s.Cnt + npb;
  s.Scalar = s.Warp + 32;
  return s;
}

// Start staging bucket b, whose first nn node rows hold keys, into buf.
__device__ inline void stage_bucket(const Buffer& buf, const ApplyArgs& a, int b, int nn,
                                    int npb, int ns) {
  const int S = npb * ns, t = threadIdx.x, T = blockDim.x;
  const int live = nn * ns;
  stage_ints(buf.A, a.keys + (size_t)b * S, live);
  stage_ints(buf.Av, a.vals + (size_t)b * S, live);
  stage_ints(buf.Nmax, a.node_max + (size_t)b * npb, nn);
  for (int j = nn + t; j < npb; j += T) buf.Nmax[j] = kEmpty;
  if (t < 6) {
    const int* bound = t == 0   ? a.ins_starts
                       : t == 1 ? a.ins_ends
                       : t == 2 ? a.del_starts
                       : t == 3 ? a.del_ends
                       : t == 4 ? a.op_starts
                                : a.op_ends;
    cp_async_4(buf.Bnd + t, bound + b);
  }
  if (t == 0) buf.Bnd[kNumNodes] = nn;
}

__device__ __forceinline__ int active_rows(const int* num_nodes, int b, int nb, int npb) {
  return b < nb ? min(max(num_nodes[b], 0), npb) : 0;
}

__global__ void __launch_bounds__(kStripeThreads, kStripeBlocksPerSm)
    flix_apply_staged_kernel(const ApplyArgs a, const int* __restrict__ num_nodes, int nb,
                             int npb, int ns) {
  extern __shared__ int smem[];
  const int S = npb * ns, t = threadIdx.x, T = blockDim.x, G = gridDim.x;
  Stripe s = carve_staged(smem, npb, ns);
  int b = blockIdx.x;
  if (b >= nb) return;  // the whole block leaves together

  stage_bucket(buffer_at(smem, 0, npb, ns), a, b, active_rows(num_nodes, b, nb, npb), npb,
               ns);
  cp_async_commit();
  // num_nodes of the bucket staged next; loaded one bucket ahead of its use
  int nn_next = active_rows(num_nodes, b + G, nb, npb);
  for (int it = 0; b < nb; b += G, ++it) {
    const Buffer cur = buffer_at(smem, it & 1, npb, ns);
    // the other buffer's last reader finished at the end of the previous
    // bucket (barrier below), so the next bucket may land there now
    if (b + G < nb) stage_bucket(buffer_at(smem, (it & 1) ^ 1, npb, ns), a, b + G, nn_next,
                                 npb, ns);
    cp_async_commit();
    nn_next = active_rows(num_nodes, b + 2 * G, nb, npb);
    cp_async_wait_all_but_newest();  // this thread's copies of bucket b
    __syncthreads();                 // and every thread's

    s.A = cur.A;
    s.Av = cur.Av;
    s.Nmax = cur.Nmax;
    // the scratch load_stripe resets in the single-buffer kernel
    for (int i = t; i < S; i += T) {
      s.M[i] = kEmpty;
      s.Mv[i] = 0;
    }
    for (int j = t; j < npb; j += T) s.Mj[j] = 0;
    if (t < 4) s.Scalar[t] = t == 0 ? cur.Bnd[kNumNodes] : 0;
    __syncthreads();

    const Slices sl = {cur.Bnd[0], cur.Bnd[1], cur.Bnd[2],
                       cur.Bnd[3], cur.Bnd[4], cur.Bnd[5]};
    apply_bucket(s, a, sl, b, npb, ns);
    __syncthreads();  // the reads of this buffer are done before it is restaged
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one staged block needs for a (npb, ns) geometry.
int flix_apply_staged_smem_bytes(int npb, int ns) {
  return staged_smem_ints(npb, ns) * (int)sizeof(int);
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
                             int ns, void* stream) {
  const int smem = flix_apply_staged_smem_bytes(npb, ns);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(flix_apply_staged_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = stripe_threads(npb * ns);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flix_apply_staged_kernel,
                                                         threads, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = nb < per_sm * sms ? nb : per_sm * sms;
  const ApplyArgs a = {keys,      vals,       node_max,   ins_keys,  ins_vals, ins_starts,
                       ins_ends,  del_keys,   del_starts, del_ends,  op_tag,   op_key,
                       op_starts, op_ends,    keys_out,   vals_out,  count_out, max_out,
                       nn_out,    flow_out,   del_out,    value_out, succ_out};
  flix_apply_staged_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(a, num_nodes, nb,
                                                                           npb, ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
