"""AdamW, global-norm clipping and the cosine schedule (port of
``repro/optim/adamw.py``).

The reference's formulas in their order of operations, in float32 tensors
on the parameters' device: the step is a 0-d int32 tensor, and ``b1 **
step``, the bias corrections, the schedule's ``cos`` and ``lr(step)`` are
0-d float32 tensors there, so neither the schedule nor the update waits on
the host.  Leaves are visited in JAX's flatten order (``repro_torch.pytree``),
which is also the order the global norm sums them in.

The update writes ``p``, ``m`` and ``v`` in place, as the reference's jitted
step does with donated buffers: a functional copy would cost another three
copies of the parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.pytree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWState:
    step: torch.Tensor  # 0-d int32, on the parameters' device
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    device = tree_leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=zeros,
        v=tree_map(torch.clone, zeros),
    )


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    added in JAX's order."""
    sq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads))
    return torch.sqrt(sq)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = _global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """:func:`clip_by_global_norm` writing the gradients in place (no second
    copy of them); returns the norm."""
    norm = _global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    for g in tree_leaves(grads):
        g.mul_(scale)  # (g * scale).astype(g.dtype)
    return norm


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return lr


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: AdamWState,
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    """One AdamW step.  Writes ``params``' tensors and ``state.m`` /
    ``state.v`` in place and returns ``(params, AdamWState(step + 1, m, v))``."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    t = step.float()
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr_t * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v)
