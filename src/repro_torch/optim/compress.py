"""Int8 gradient compression with error feedback (port of
``repro/optim/compress.py``).

Each tensor is quantized to int8 against its absmax scale after the carried
quantization error is added back, and the new error is carried into the
next call (error feedback keeps the scheme unbiased over steps).
``torch.round`` rounds half to even, as ``jnp.round`` does.  The trainer's
step does not call these, as the reference's does not.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.pytree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class CompressState:
    error: Any  # per-tensor error feedback buffers (f32)


def compress_init(params) -> CompressState:
    return CompressState(error=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                        params))


def quantize_grads(grads, state: CompressState):
    """→ (int8 tensors, scales, new_state). g_q = round((g+err)/s)."""

    def q(g, err):
        g = g.float() + err
        scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
        q8 = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        new_err = g - q8.float() * scale
        return q8, scale, new_err

    out = [q(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(state.error))]
    q8, scales, err = (tree_unflatten(grads, [o[i] for o in out]) for i in range(3))
    return q8, scales, CompressState(error=err)


def decompress_add(acc, q8, scales):
    return tree_map(lambda a, q, s: a + q.float() * s, acc, q8, scales)
