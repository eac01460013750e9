"""What every kernel wrapper shares: input checks, the launch on the current
stream with its error check, and the per-kernel launch counts.

A wrapper checks its tensors, runs the kernel's plain torch version when
they lie on the CPU (that is how the CPU tests run), and otherwise calls
:func:`launch`, which raises unless the tensors lie on a CUDA card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import trace
from repro_torch.kernels._build import load_library

# launches per kernel since the last reset; a run reads these to show that
# its main path went through the kernels.  Only :func:`launch` adds to them.
LAUNCHES = {
    "flix_apply": 0,
    "flix_apply_staged": 0,
    "flix_apply_staged_inplace": 0,
    "flix_apply_range": 0,
    "flix_apply_rank": 0,
    "flix_point_query": 0,
    "flix_successor": 0,
    "flix_fence_rows": 0,
    "flix_insert": 0,
    "flix_delete": 0,
    "flix_range_count": 0,
    "flix_range_scatter": 0,
    "grouped_matmul": 0,
}
# grouped_matmul's launches by the kernel they ran (csrc/grouped_matmul.cu's
# grouped_matmul_variant); they sum to LAUNCHES["grouped_matmul"]
GMM_VARIANTS = {"wgmma": 0, "mma": 0, "fma": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, GMM_VARIANTS):
        for k in counts:
            counts[k] = 0


def check(device: torch.device, names, tensors, dtypes=(torch.int32,)) -> None:
    """Every tensor: one of ``dtypes`` (int32 unless the caller allows
    others), contiguous, on ``device``."""
    for name, t in zip(names, tensors):
        if t.dtype not in dtypes:
            allowed = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise TypeError(f"{name}: expected {allowed}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, expected {device}")


def _require_cuda(kernel: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA or the CPU, not {device}")


def check_smem(
    kernel: str, bytes_fn: str, npb: int, ns: int, device, *, warps: int | None = None
) -> None:
    """Raise ``ValueError`` naming the geometry (and the warps a block, where
    the launch asks for a count) when one stripe block of ``kernel`` needs
    more shared memory than the card allows.  ``bytes_fn`` takes ``(npb,
    ns)``, or ``(npb, ns, warps)`` where ``warps`` is given."""
    _require_cuda(kernel, device)
    lib = load_library()
    with torch.cuda.device(device):
        need = getattr(lib, bytes_fn)(npb, ns, *(() if warps is None else (warps,)))
        limit = lib.flix_smem_optin_bytes()
    if need > limit:
        block = f" with {warps} warps a block" if warps else ""
        raise ValueError(
            f"{kernel}: geometry (npb={npb}, ns={ns}){block} needs {need} bytes of "
            f"shared memory per block; this card allows {limit}"
        )


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call the C entry point ``entry`` with tensors as device pointers and
    ints as ints, on the current stream of ``device``; raise on its CUDA
    error code, else count one launch of ``kernel``; the host side of it is
    the span ``launch.<kernel>``."""
    with trace.span("launch." + kernel):
        _require_cuda(kernel, device)
        lib = load_library()
        conv = [
            ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor) else a
            for a in args
        ]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, entry)(*conv, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")
        LAUNCHES[kernel] += 1
