"""Ragged grouped GEMM over expert slices (port of
``repro/kernels/grouped_matmul.py`` and of ``repro/kernels/ref.py``'s
``grouped_matmul_ref``).

Tokens sorted by expert are the sorted batch, ``group_offsets`` the
per-expert slice boundaries, and each expert, a bucket, pulls its
contiguous slice.  :func:`grouped_matmul` runs ``csrc/grouped_matmul.cu``
on the card: a one-warp schedule of each expert's row tiles, then one
block per (row tile, column tile) that binary-searches its expert in that
schedule and multiplies the expert's rows with float32 sums.  On the CPU it
runs :func:`grouped_matmul_reference`.

The card picks one of three variants from the dtypes, the widths and the
base addresses alone (:func:`kernel_variant`; the counts are
``GMM_VARIANTS``): ``"wgmma"`` (``csrc/grouped_matmul_sm90.cu``: TMA and
wgmma) for bf16 weights with bf16 or float32 ``x`` when TMA can address
both tensors (``F`` a multiple of 8, ``D`` of 8 for bf16 ``x`` or of 4 for
float32 ``x``, 16-byte-aligned bases); ``"mma"`` (``mma.sync``) for any
other bf16 x bf16; ``"fma"`` (float32 FMA) for the rest.  A float32 ``x``
reaches the tensor cores as the three exact bf16 pieces of
:func:`split_bf16x3`.

Two plain versions, because the reference package has two semantics for a
row outside every group (``t < offs[0]`` or ``t >= offs[E]``):

* :func:`grouped_matmul_reference` holds the Pallas kernel's: such a row is
  zero.  It is what the CUDA kernel computes.
* :func:`grouped_matmul_ref` holds ``ref.grouped_matmul_ref``'s: such a row
  takes the clipped group (0 before ``offs[0]``, ``E-1`` from ``offs[E]``).

Both loop over the groups, so neither builds the ``[T, D, F]`` gather of
``ref.grouped_matmul_ref``.  ``x`` and ``w`` may each be float32 or
bfloat16; both are multiplied in float32, and the output is float32.
``group_offsets`` is int32 ``[E+1]`` and ascending.  The TPU kernel's
``block_t``/``block_f``/``max_span`` have no counterpart, and no divisibility
of ``T`` or ``F`` is needed.
"""

from __future__ import annotations

import torch

import ctypes

from repro_torch.kernels._build import load_library
from repro_torch.kernels._launch import GMM_VARIANTS, check, launch

FLOAT_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/grouped_matmul.cu
_VARIANTS = ("fma", "mma", "wgmma")  # grouped_matmul_variant's codes
_HIGH_16 = -(1 << 16)  # 0xffff0000 as int32: a float32's bf16 truncation


def check_inputs(x, w, group_offsets) -> None:
    """``x [T, D]``, ``w [E, D, F]`` float32 or bfloat16 and
    ``group_offsets [E+1]`` int32, contiguous, on one device."""
    if x.dim() != 2 or w.dim() != 3 or group_offsets.dim() != 1:
        raise ValueError("expected x [T, D], w [E, D, F] and group_offsets [E+1]")
    if w.shape[1] != x.shape[1]:
        raise ValueError(f"x is [T, {x.shape[1]}] but w is [E, {w.shape[1]}, F]")
    if group_offsets.shape[0] != w.shape[0] + 1:
        raise ValueError(f"group_offsets has {group_offsets.shape[0]} entries, "
                         f"expected E + 1 = {w.shape[0] + 1}")
    check(x.device, ("x", "w"), (x, w), FLOAT_DTYPES)
    check(x.device, ("group_offsets",), (group_offsets,))


def grouped_matmul(x, w, group_offsets):
    """``out [T, F]`` float32: ``x[t] @ w[g]`` for the rows of group ``g``,
    zero for rows outside every group.  The CUDA kernel on the card,
    :func:`grouped_matmul_reference` on the CPU."""
    check_inputs(x, w, group_offsets)
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, w, group_offsets)
    (T, D), (E, _, F) = x.shape, w.shape
    out = torch.empty((T, F), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    tile_start = torch.empty((E + 2,), dtype=torch.int32, device=x.device)
    variant = kernel_variant(x, w)
    launch(
        "grouped_matmul",
        "grouped_matmul_launch",
        x.device,
        x,
        w,
        group_offsets,
        tile_start,
        out,
        T,
        D,
        F,
        E,
        _DTYPE_CODE[x.dtype],
        _DTYPE_CODE[w.dtype],
    )
    GMM_VARIANTS[variant] += 1
    return out


def kernel_variant(x, w) -> str:
    """The kernel that :func:`grouped_matmul` runs on these CUDA tensors:
    ``"wgmma"``, ``"mma"`` or ``"fma"``, by the library's own rule."""
    (_, D), (E, _, F) = x.shape, w.shape
    code = load_library().grouped_matmul_variant(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w.data_ptr()), D, F, E,
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype],
    )
    return _VARIANTS[code]


def split_bf16x3(x):
    """float32 ``x`` as three bfloat16 tensors ``hi, mid, lo`` whose float32
    sum is ``x``, as the wgmma kernel splits its float32 operand:
    ``hi = trunc_bf16(x)``, ``mid = trunc_bf16(x - hi)``,
    ``lo = rn_bf16(x - hi - mid)``; for inf and NaN ``hi = x`` and
    ``mid = lo = 0``.  The sum is bit-exact down to about ``2**-100`` in
    magnitude; below, ``lo`` falls into bf16's subnormal range and the error
    stays under ``2**-126``."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_bf16x3 takes float32, got {x.dtype}")
    finite = torch.isfinite(x)
    hi = torch.where(finite, (x.view(torch.int32) & _HIGH_16).view(torch.float32), x)
    r1 = torch.where(finite, x - hi, torch.zeros_like(x))
    mid = (r1.view(torch.int32) & _HIGH_16).view(torch.float32)
    lo = r1 - mid
    # hi and mid convert exactly; lo rounds to nearest even
    return hi.bfloat16(), mid.bfloat16(), lo.bfloat16()


def grouped_matmul_reference(x, w, group_offsets):
    """Plain version with the Pallas kernel's semantics: each group's rows
    ``x[lo:hi].float() @ w[e].float()``; rows outside every group zero."""
    check_inputs(x, w, group_offsets)
    T, F = x.shape[0], w.shape[2]
    out = torch.zeros((T, F), dtype=torch.float32, device=x.device)
    offs = torch.clamp(group_offsets, 0, T).tolist()
    for e in range(w.shape[0]):
        lo, hi = offs[e], offs[e + 1]
        if hi > lo:
            out[lo:hi] = x[lo:hi].float() @ w[e].float()
    return out


def grouped_matmul_ref(x, w, group_offsets):
    """Port of ``ref.grouped_matmul_ref``: row ``t`` takes group
    ``clip(searchsorted(offs, t, 'right') - 1, 0, E - 1)``, so rows before
    ``offs[0]`` take group 0 and rows from ``offs[E]`` on take group
    ``E - 1``.  Groups are contiguous row ranges, multiplied one by one."""
    check_inputs(x, w, group_offsets)
    T, E, F = x.shape[0], w.shape[0], w.shape[2]
    out = torch.empty((T, F), dtype=torch.float32, device=x.device)
    if E == 0:
        return out.zero_()
    t_idx = torch.arange(T, dtype=torch.int32, device=x.device)
    group = torch.searchsorted(group_offsets, t_idx, right=True, out_int32=True) - 1
    group = torch.clamp(group, 0, E - 1)
    ends = torch.cumsum(torch.bincount(group, minlength=E), 0).tolist()
    lo = 0
    for e, hi in enumerate(ends):
        if hi > lo:
            out[lo:hi] = x[lo:hi].float() @ w[e].float()
        lo = hi
    return out
