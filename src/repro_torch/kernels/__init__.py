"""Hand-written CUDA kernels for Hopper (sm_90a), with their plain versions.

flix_apply  — fused mixed-batch apply: merge + delete + post-update reads in
              one thread block per bucket, plus the dense RANGE gather
              (``csrc/flix_apply.cu``)
_build      — nvcc build of ``csrc/`` into a ctypes-loaded library
"""
