"""Hand-written CUDA kernels for Hopper (sm_90a), with their plain versions.

ops             — the kernel entry points on a state, with the reference's
                  signatures: ``mode="auto"`` runs the kernel (its plain
                  version on a CPU state), ``mode="ref"`` the core function
flix_apply      — fused mixed-batch apply: merge + delete + post-update reads
                  in one thread block per bucket (``csrc/flix_apply.cu``) or
                  one warp per bucket with cp.async-staged stripes
                  (``csrc/flix_apply_staged.cu``), plus the RANGE ranks (the
                  count kernel under a RANGE mask) and the dense RANGE gather
flix_range      — standalone dense RANGE scans: a count kernel, a lane per
                  op, and the gather as the scatter, a thread per 1, 2 or 4
                  consecutive slots (``csrc/flix_range.cu``)
flix_query      — flipped point queries, one warp per run of buckets and
                  a lane per query (``csrc/flix_query.cu``)
flix_successor  — flipped successor queries, one warp per run of buckets
                  and a lane per query (``csrc/flix_successor.cu``), and
                  their suffix-min fence rows (``csrc/flix_fence_rows.cu``,
                  also run by ``flix_apply``)
flix_insert     — TL-Bulk insertion, persistent warps, a warp per bucket
                  at a time (``csrc/flix_insert.cu``)
flix_delete     — TL-Bulk deletion, persistent warps, a warp per bucket
                  at a time (``csrc/flix_delete.cu``)
grouped_matmul  — ragged grouped GEMM over expert-sorted rows, float32
                  accumulate and output: TMA and wgmma for bf16 weights
                  (``csrc/grouped_matmul_sm90.cu``), mma.sync or f32 FMA
                  for the rest (``csrc/grouped_matmul.cu``)
moe_dispatch    — the flipped MoE dispatch around it: route and sort by
                  expert, dispatch, combine, and the dense oracle
_phases         — plain torch versions of the stripe phases of
                  ``csrc/flix_phases.cuh``
_launch         — input checks, the launch call, the ``LAUNCHES`` counts
                  and ``GMM_VARIANTS``, grouped_matmul's by variant
_build          — nvcc build of ``csrc/`` into a ctypes-loaded library
"""

from repro_torch.kernels._launch import GMM_VARIANTS, LAUNCHES, reset_launches

__all__ = ["GMM_VARIANTS", "LAUNCHES", "reset_launches"]
