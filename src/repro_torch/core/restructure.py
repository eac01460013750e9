"""Restructuring (port of ``repro/core/restructure.py``; paper §3.5).

Flattens every bucket's chain, and re-emits a uniform half-full structure
aligned to the current key distribution: one global sort plus the standard
build.  The host only chooses the new static geometry: the build's own
(``restructure_auto``), one sized for an overflowing batch
(``restructure_grow``) or the smallest for the live set
(``restructure_shrink``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import trace
from repro_torch.core.build import build_from_sorted, plan_geometry
from repro_torch.core.state import EMPTY, FliXState


def restructure(
    state: FliXState,
    *,
    num_buckets: int,
    nodes_per_bucket: int | None = None,
    node_size: int | None = None,
    fill: float = 0.5,
) -> FliXState:
    """Rebuild into the given geometry from the current live contents.

    An expiry plane comes along: the same build with the deadlines in the
    value slot lands the same layout, since build positions depend on keys
    only.  The successor cache does not (a new state, a new cache).
    """
    npb = nodes_per_bucket or state.nodes_per_bucket
    ns = node_size or state.node_size
    flat_k = state.keys.reshape(-1)
    flat_v = state.vals.reshape(-1)
    order = torch.argsort(flat_k, stable=True)  # EMPTY sentinels sort last
    sorted_k = flat_k[order]
    geometry = dict(
        num_buckets=num_buckets, nodes_per_bucket=npb, node_size=ns, fill=fill
    )
    built = build_from_sorted(sorted_k, flat_v[order], **geometry)
    if state.exps is None:
        return built
    from repro_torch.core.expiry import NO_EXPIRY

    built_e = build_from_sorted(sorted_k, state.exps.reshape(-1)[order], **geometry)
    exps = torch.where(built.keys == EMPTY, NO_EXPIRY, built_e.vals)
    return dataclasses.replace(built, exps=exps)


def plan(state: FliXState, *, extra_keys: int = 0, fill: float = 0.5):
    """Host-side geometry planning from the current live count."""
    live = trace.host_int(state.live_keys(), "restructure.live_keys") + extra_keys
    return plan_geometry(
        live,
        node_size=state.node_size,
        nodes_per_bucket=state.nodes_per_bucket,
        fill=fill,
    )


def restructure_auto(state: FliXState, *, fill: float = 0.5) -> FliXState:
    """Restructure to the geometry the initial build would choose now."""
    nb, npb, ns = plan(state, fill=fill)
    return restructure(
        state, num_buckets=nb, nodes_per_bucket=npb, node_size=ns, fill=fill
    )


def restructure_shrink(
    state: FliXState,
    *,
    fill: float = 0.5,
    nodes_per_bucket: int | None = None,
) -> tuple[FliXState, int]:
    """Compact to the smallest geometry for the current live set, reclaiming
    memory (paper §3.5).

    ``restructure_auto`` keeps the old ``nodes_per_bucket``, so a structure
    that once grew wide never gives chain capacity back.  Shrink narrows
    both axes: ``nb = ceil(live / p)`` buckets at ``p = ns * fill`` keys
    each, and the smallest chain depth whose capacity is still ≥ 2p (the
    headroom ``restructure_grow`` relies on), at least 2.

    Returns ``(new_state, reclaimed_bytes)``: the drop in allocated bytes,
    0 when the structure could not shrink.
    """
    live = trace.host_int(state.live_keys(), "restructure.live_keys")
    p = max(1, int(state.node_size * fill))
    nb = max(1, math.ceil(live / p))
    if nodes_per_bucket is None:
        npb = max(2, math.ceil(2 * p / state.node_size))
    else:
        npb = nodes_per_bucket
    new = restructure(
        state,
        num_buckets=nb,
        nodes_per_bucket=npb,
        node_size=state.node_size,
        fill=fill,
    )
    return new, max(0, state.memory_bytes() - new.memory_bytes())


def restructure_grow(
    state: FliXState, *, extra_keys: int, fill: float = 0.5
) -> FliXState:
    """Restructure sized for ``extra_keys`` more keys (overflow recovery).

    With ``fill`` ≤ 1/2 the new buckets are half full, so a following
    insert of ``extra_keys`` keys can at most double any bucket's content.
    Worst-case skew (every new key in one bucket) is covered by widening
    ``nodes_per_bucket`` so that one bucket can absorb the whole batch —
    the reference's sizing, kept as it is (ROADMAP Queue 3 logs what it
    asks for at full size).
    """
    live = trace.host_int(state.live_keys(), "restructure.live_keys")
    p = max(1, int(state.node_size * fill))
    nb = max(1, math.ceil((live + extra_keys) / p))
    cap = state.nodes_per_bucket * state.node_size
    if p + extra_keys > cap:
        npb = math.ceil((p + extra_keys) / state.node_size)
    else:
        npb = state.nodes_per_bucket
    return restructure(
        state,
        num_buckets=nb,
        nodes_per_bucket=npb,
        node_size=state.node_size,
        fill=fill,
    )
