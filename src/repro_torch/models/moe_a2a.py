"""Explicit all-to-all MoE dispatch (port of ``repro/models/moe_a2a.py``).

The reference routes tokens with a ``shard_map`` body instead of letting
GSPMD lower the dispatch gather as all-gathers of the activations.  The
port runs that body once a mesh position, in a loop, each on its
position's device — the same single-controller pattern as
``core/distributed.py``'s a2a routing, applied to experts:

  * tokens are split over every mesh axis (row-major over the positions);
  * the router is replicated; ``w_gate``/``w_up``/``w_down`` are split
    over ``model`` (expert parallelism), one block a (device, expert
    block), so a token on position (d, m) only ever needs positions
    (d, ·) — the all-to-all runs along ``model`` within each data row;
  * each position sorts its local token-slots by expert (the sorted
    batch), slices per-destination ranges by searchsorted (the fence
    pull), and exchanges fixed-capacity buffers; experts compute locally;
    results return through the inverse all-to-all.

Capacity contract, kept exactly: the per-(src, dst) buffer is
``ceil(T_loc · k / n_exp_shards · factor)`` rounded up to 8 (``C_pair``);
each receiving position pulls ``C_loc`` rows a local expert; overflow rows
are dropped.  Clamped gathers and the scatter through a dump row are the
reference's ``jnp.minimum`` / ``.at[].add`` with a dump slot cut off.
Routing is ``kernels/moe_dispatch.py``'s ``_route`` (``jax.lax.top_k``'s
tie order).  Gradients flow through the per-position lists by autograd.
The exchanged buffers are counted as ``all-to-all`` bytes
(``repro_torch.sharding``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_dispatch import _route
from repro_torch.sharding import count_collective


def _local_capacity(t_loc: int, k: int, n_shards: int, factor: float) -> int:
    c = math.ceil(t_loc * k / n_shards * factor)
    return max(8, math.ceil(c / 8) * 8)


def _a2a(bufs: dict, positions, ep_dim: int, devs: dict) -> dict:
    """``jax.lax.all_to_all(buf, "model", 0, 0)``: position ``q`` with model
    coordinate ``m`` receives row ``m`` of every buffer of its data row,
    stacked by the sender's model coordinate."""
    out, nbytes = {}, 0
    for q in positions:
        m = q[ep_dim]
        row = [q[:ep_dim] + (j,) + q[ep_dim + 1:] for j in range(len(bufs[q]))]
        out[q] = torch.stack([bufs[r][m].to(devs[q]) for r in row])
        nbytes += out[q].numel() * out[q].element_size()
    count_collective("all-to-all", nbytes)
    return out


def moe_ffn_a2a(x: torch.Tensor, p: dict, cfg, mesh) -> torch.Tensor:
    """x: [T, D] (token-sharded over all mesh axes) → [T, D], on ``x``'s
    device."""
    E, k, split = cfg.num_experts, cfg.top_k, cfg.moe_split
    E_v, k_v = E * split, k * split
    ep_dim = mesh.axis_names.index("model")
    n_ep = int(mesh.shape["model"])
    T, D = x.shape
    if T % mesh.size or E_v % n_ep:
        raise ValueError(f"{T} tokens over {mesh.size} positions, {E_v} experts over "
                         f"{n_ep}: each must divide")
    e_loc = E_v // n_ep
    t_loc = T // mesh.size
    C_pair = _local_capacity(t_loc, k_v, n_ep, cfg.moe_capacity_factor)
    R = n_ep * C_pair  # received slots per position
    C_loc = min(R, _local_capacity(R, 1, e_loc, cfg.moe_capacity_factor))
    positions = mesh.positions()
    devs = {q: mesh.devices[q] for q in positions}

    memo: dict = {}

    def on(name, dev, m=None):
        """A weight's block on ``dev``: the router whole, an expert weight's
        ``m``-th block of ``e_loc`` experts; one tensor a (device, block)."""
        key = (name, dev, m)
        if key not in memo:
            w = p[name] if m is None else p[name][m * e_loc:(m + 1) * e_loc]
            memo[key] = w.to(dev)
        return memo[key]

    # --- route, sort and slice: each position's send buffers -------------
    send_x, send_e, keep = {}, {}, {}
    for i, q in enumerate(positions):
        dev = devs[q]
        x_loc = x[i * t_loc:(i + 1) * t_loc].to(dev)
        tl = x_loc.shape[0]
        logits = x_loc.float() @ on("router", dev).float()
        weights, experts = _route(logits, k)
        if split > 1:
            sub = torch.arange(split, dtype=experts.dtype, device=dev)
            experts = (experts[..., None] * split + sub).reshape(tl, k_v)
            weights = torch.repeat_interleave(weights, split, dim=-1)

        # sort the batch by expert (the FliX sorted batch)
        flat_e = experts.reshape(-1).to(torch.int32)  # [tl*k_v]
        order = torch.sort(flat_e, stable=True).indices
        e_sorted = flat_e[order]
        tok_sorted = order // k_v
        w_sorted = weights.reshape(-1)[order]

        # per-destination slices (fence searchsorted): shard s owns experts
        # [s * e_loc, (s + 1) * e_loc)
        fences = torch.arange(1, n_ep + 1, dtype=torch.int32, device=dev) * e_loc
        ends = torch.searchsorted(e_sorted, fences, side="left")
        starts = torch.cat([torch.zeros(1, dtype=ends.dtype, device=dev), ends[:-1]])
        idx = starts[:, None] + torch.arange(C_pair, device=dev)[None]
        valid = idx < ends[:, None]  # [n_ep, C]
        idx_c = torch.clamp(idx, max=tl * k_v - 1)
        send_x[q] = torch.where(valid[..., None], x_loc[tok_sorted[idx_c]],
                                torch.zeros((), dtype=x_loc.dtype, device=dev))
        send_e[q] = torch.where(valid, e_sorted[idx_c], -1)  # the local tag
        keep[q] = (tl, valid, idx_c, tok_sorted, w_sorted, x_loc.dtype)

    # --- all-to-all along the EP axis --------------------------------------
    recv_x = _a2a(send_x, positions, ep_dim, devs)
    recv_e = _a2a(send_e, positions, ep_dim, devs)
    del send_x, send_e

    # --- local expert compute: sort received rows by local expert and pull
    #     per-expert capacity windows (FliX again, one level down) ---------
    ys = {}
    for q in positions:
        dev, m = devs[q], q[ep_dim]
        rx = recv_x[q].reshape(R, D)
        re_raw = recv_e[q].reshape(R)
        re = torch.where(re_raw >= 0, re_raw - m * e_loc, e_loc)  # pad → end
        order2 = torch.sort(re, stable=True).indices
        rx_s = rx[order2]
        bounds = torch.arange(e_loc + 1, dtype=re.dtype, device=dev)
        offs = torch.searchsorted(re[order2].contiguous(), bounds, side="left")
        idx2 = offs[:-1, None] + torch.arange(C_loc, device=dev)[None]
        valid2 = idx2 < offs[1:, None]  # [e_loc, C_loc]
        idx2_c = torch.clamp(idx2, max=R - 1)
        xe = torch.where(valid2[..., None], rx_s[idx2_c],
                         torch.zeros((), dtype=rx.dtype, device=dev))  # [e_loc, C_loc, D]
        h = F.silu(torch.einsum("ecd,edf->ecf", xe, on("w_gate", dev, m))) * torch.einsum(
            "ecd,edf->ecf", xe, on("w_up", dev, m)
        )
        ye = torch.einsum("ecf,efd->ecd", h, on("w_down", dev, m))  # [e_loc, C_loc, D]
        # scatter back to received-slot order (each row owned by one expert)
        dest = torch.where(valid2, order2[idx2_c], R).reshape(-1)
        y = torch.zeros((R + 1, D), dtype=ye.dtype, device=dev).index_add(
            0, dest, ye.reshape(e_loc * C_loc, D))[:R]
        ys[q] = y.reshape(n_ep, C_pair, D)
    del recv_x, recv_e

    # --- return all-to-all + weighted combine ------------------------------
    back = _a2a(ys, positions, ep_dim, devs)
    outs = []
    for q in positions:
        tl, valid, idx_c, tok_sorted, w_sorted, dtype = keep[q]
        bq = back[q]
        w = torch.where(valid, w_sorted[idx_c], 0.0).reshape(-1, 1).to(bq.dtype)
        contrib = bq.reshape(n_ep * C_pair, D) * w
        tok = torch.where(valid, tok_sorted[idx_c], tl).reshape(-1)
        out = torch.zeros((tl + 1, D), dtype=contrib.dtype, device=devs[q]).index_add(
            0, tok, contrib)[:tl]
        outs.append(out.to(dtype).to(x.device))
    y = torch.cat(outs)
    if cfg.num_shared_experts:  # dense, position-wise: no routing needed
        hs = F.silu(x @ p["shared_gate"]) * (x @ p["shared_up"])
        y = y + hs @ p["shared_down"]
    return y
