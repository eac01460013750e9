"""MoE layer with flipped (sort-based) dispatch (port of ``repro/models/moe.py``).

Tokens are sorted by expert id; each expert (bucket) pulls its contiguous
slice through static per-expert capacity windows (GShard-style capacity;
overflow drops are counted).  FLOPs scale with *active* experts
(E × C × D × F), not E × T — unlike the dense one-hot formulation.

This is the model's own layer: capacity windows and einsums, as the
reference computes them, not the grouped GEMM of ``kernels.moe_dispatch``.
Routing is that module's ``_route`` (a stable descending sort: the lower
expert first on tied gates, as ``jax.lax.top_k``).  The reference's
``dispatch_spec`` is a sharding constraint for expert × token parallelism
on the [E, C, ·] intermediates and the combine's output; the port computes
them whole (``repro_torch.sharding``), so it checks the spec against the
current mesh where the reference constrains, and is the identity there.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.kernels.moe_dispatch import _route


def capacity(tokens: int, top_k: int, num_experts: int, factor: float) -> int:
    c = math.ceil(tokens * top_k / num_experts * factor)
    return max(8, math.ceil(c / 8) * 8)


def _constrain3(cfg):
    """``with_sharding_constraint`` by ``cfg.dispatch_spec``, or nothing."""
    if cfg.dispatch_spec is None:
        return lambda a: a
    return lambda a: sharding.constrain(a, cfg.dispatch_spec, "dispatch_spec")


def _shared(x, p):
    hs = F.silu(x @ p["shared_gate"]) * (x @ p["shared_up"])
    return hs @ p["shared_down"]


def moe_ffn(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """x: [T, D] → [T, D].  Params:

    router [D, E]; w_gate/w_up [E·split, D, F/split]; w_down [E·split, F/split, D];
    shared_gate/shared_up [D, Fs]; shared_down [Fs, D] (when shared experts).

    ``cfg.moe_split`` > 1 splits each expert's FFN into column chunks
    ("virtual experts"); a token visits all chunks of its expert and the
    down-projection partial sums add in the combine.
    """
    constrain3 = _constrain3(cfg)
    T, D = x.shape
    E, k, split = cfg.num_experts, cfg.top_k, cfg.moe_split
    logits = x.float() @ p["router"].float()
    weights, experts = _route(logits, k)  # [T, k]
    if split > 1:  # expand to virtual experts: e → (e·split … e·split+split-1)
        sub = torch.arange(split, dtype=experts.dtype, device=x.device)
        experts = (experts[..., None] * split + sub).reshape(T, k * split)
        weights = torch.repeat_interleave(weights, split, dim=-1)  # partial sums share w
    E_v, k_v = E * split, k * split

    flat_expert = experts.reshape(-1).to(torch.int32)  # [T·k_v]
    sort_idx = torch.sort(flat_expert, stable=True).indices
    expert_sorted = flat_expert[sort_idx]
    bounds = torch.arange(E_v + 1, dtype=torch.int32, device=x.device)
    group_offsets = torch.searchsorted(expert_sorted, bounds, side="left", out_int32=True)
    C = capacity(T, k, E, cfg.moe_capacity_factor)  # per (virtual) expert

    # each (virtual) expert pulls its slice through a capacity window
    idx = group_offsets[:-1, None] + torch.arange(C, dtype=torch.int32, device=x.device)[None]
    valid = idx < group_offsets[1:, None]  # [E_v, C]
    slot = torch.clamp(idx, max=T * k_v - 1).long()
    token = sort_idx[slot] // k_v  # [E_v, C]
    xe = constrain3(x[token] * valid[..., None].to(x.dtype))  # [E_v, C, D]

    h = constrain3(F.silu(torch.einsum("ecd,edf->ecf", xe, p["w_gate"])) * torch.einsum(
        "ecd,edf->ecf", xe, p["w_up"]
    ))
    ye = constrain3(torch.einsum("ecf,efd->ecd", h, p["w_down"]))  # [E_v, C, D]

    # combine: weighted scatter-add back to token order, row T the dump row
    w_slot = weights.reshape(-1)[sort_idx][slot] * valid  # [E_v, C]
    contrib = (ye * w_slot[..., None]).reshape(E_v * C, D)
    tok_flat = torch.where(valid, token, T).reshape(E_v * C)
    y = torch.zeros((T + 1, D), dtype=contrib.dtype, device=x.device)
    y = y.index_add_(0, tok_flat, contrib)[:T]
    if cfg.dispatch_spec is not None:  # the token-sharded combine output
        y = sharding.constrain(y, sharding.P(cfg.dispatch_spec[1], None), "dispatch_spec")

    if cfg.num_shared_experts:
        y = y + _shared(x, p)
    return y.to(x.dtype)


def moe_ffn_dense_oracle(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """Every expert computes every token; exact combine (tests only)."""
    E, k = cfg.num_experts, cfg.top_k
    logits = x.float() @ p["router"].float()
    weights, experts = _route(logits, k)
    h = F.silu(torch.einsum("td,edf->etf", x, p["w_gate"])) * torch.einsum(
        "td,edf->etf", x, p["w_up"]
    )
    ye = torch.einsum("etf,efd->etd", h, p["w_down"])
    oh = F.one_hot(experts.long(), E).float()  # float32, as jax.nn.one_hot
    y = torch.einsum("tke,etd,tk->td", oh, ye.float(), weights).to(x.dtype)
    if cfg.num_shared_experts:
        y = y + _shared(x, p)
    return y
