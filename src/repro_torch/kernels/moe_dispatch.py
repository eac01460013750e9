"""Flipped (sort-based) MoE dispatch (port of ``repro/kernels/moe_dispatch.py``).

Traditional dispatch is compute-to-operation: every token scatters itself to
its expert.  Here the token batch is sorted by expert id (the sorted
operation batch) and every expert, a bucket, pulls its contiguous token
slice through the same searchsorted boundaries as ``core.batch``.  The
expert FFN then runs as a ragged grouped GEMM over those slices
(``kernels.grouped_matmul``), composed as ``examples/moe_routing.py`` does:

    plan = make_plan(logits, k, E)
    xs = dispatch(x, plan, k)
    h = silu(ops.grouped_matmul(xs, w_up, plan.group_offsets))
    y = combine(ops.grouped_matmul(h, w_down, plan.group_offsets), plan, k)

Every index is int32 where the reference's is.  ``jax.lax.top_k`` puts the
lower index first among equal gates, so the top ``k`` here are the first
``k`` of a stable descending sort.  :func:`params_from_numpy` carries the
path's arrays across from numpy (JAX bfloat16 included, bit for bit).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.state import resolve_device


class DispatchPlan(NamedTuple):
    sort_idx: torch.Tensor  # [T*k] int32 token-slot order, sorted by expert
    unsort_idx: torch.Tensor  # [T*k] int32 inverse permutation
    group_offsets: torch.Tensor  # [E+1] int32 per-expert slice boundaries
    expert_sorted: torch.Tensor  # [T*k] int32 expert id per sorted slot
    weights: torch.Tensor  # [T, k] float32 router combine weights


def _route(router_logits, top_k: int):
    """Softmax gates, their top ``k`` (lower index first on ties) and the
    renormalised combine weights."""
    gate = torch.softmax(router_logits.float(), dim=-1)
    vals, idx = torch.sort(gate, dim=-1, descending=True, stable=True)
    weights, experts = vals[:, :top_k], idx[:, :top_k].to(torch.int32)
    return weights / torch.sum(weights, dim=-1, keepdim=True), experts


def make_plan(router_logits, top_k: int, num_experts: int) -> DispatchPlan:
    """Route and sort: the 'sort the batch' step of flipped indexing."""
    weights, experts = _route(router_logits, top_k)
    flat_expert = experts.reshape(-1)
    sort_idx = torch.sort(flat_expert, stable=True).indices.to(torch.int32)
    expert_sorted = flat_expert[sort_idx.long()]
    unsort_idx = torch.empty_like(sort_idx)  # the inverse permutation
    unsort_idx[sort_idx.long()] = torch.arange(
        sort_idx.numel(), dtype=torch.int32, device=sort_idx.device
    )
    # bucket boundaries: one searchsorted over expert ids (MKBA analogue)
    bounds = torch.arange(num_experts + 1, dtype=torch.int32, device=sort_idx.device)
    group_offsets = torch.searchsorted(expert_sorted, bounds, side="left", out_int32=True)
    return DispatchPlan(sort_idx, unsort_idx, group_offsets, expert_sorted, weights)


def dispatch(x, plan: DispatchPlan, top_k: int):
    """Gather token rows into expert-contiguous order: ``[T*k, D]``."""
    token_of_slot = plan.sort_idx // top_k
    return x[token_of_slot.long()]


def combine(y_sorted, plan: DispatchPlan, top_k: int):
    """Weighted sum back to token order: ``[T, D]``.  The weights are cast
    to ``y``'s dtype before the ``k`` terms are summed, as in the reference."""
    T = y_sorted.shape[0] // top_k
    y = y_sorted[plan.unsort_idx.long()].reshape(T, top_k, -1)
    w = plan.weights[..., None].to(y.dtype)
    return torch.sum(y * w, dim=1)


def moe_ffn_reference(x, router_logits, w_up, w_down, top_k: int):
    """Dense oracle: every expert computes every token, one-hot combine."""
    E = w_up.shape[0]
    weights, experts = _route(router_logits, top_k)
    h = torch.einsum("td,edf->etf", x.float(), w_up.float())
    h = torch.nn.functional.silu(h)
    y = torch.einsum("etf,efd->etd", h, w_down.float())  # [E, T, D]
    oh = torch.nn.functional.one_hot(experts.long(), E).float()  # [T, k, E]
    return torch.einsum("tke,etd,tk->td", oh, y, weights)


def params_from_numpy(arrays: dict, device=None) -> dict:
    """The path's arrays (``x``, the router or its logits, ``w_up [E, D, F]``,
    ``w_down [E, F, D]``) as tensors, in their layout and dtype, on the card
    unless ``device`` names another.  A bfloat16 array (``ml_dtypes``, what
    ``np.asarray`` of a JAX bfloat16 array gives) crosses as its 16-bit
    pattern, so no value is rounded."""
    dev = resolve_device(device)
    out = {}
    for name, a in arrays.items():
        a = np.array(a, order="C")  # a copy the tensor may own and write
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out[name] = t.to(dev)
    return out
