"""Lazy TTL expiry (port of ``repro/core/expiry.py``).

Per-key absolute expiry deadlines live in an optional third state plane
(``FliXState.exps``, the layout of the value plane).  Time is never read
from the wall clock: every engine entry point takes an explicit ``now`` and
a row is expired iff ``exp <= now`` (exactly AT its deadline).
``NO_EXPIRY`` (== EMPTY == int32 max) marks keys without a TTL; since
``now <= MAX_VALID < NO_EXPIRY``, such rows never expire.

Expiry is lazy: ``expire_state`` runs as a pre-pass of ``apply_ops``,
physically reclaiming expired rows with the compaction of ``core.delete``,
so every executor sees a plain state with the expired rows gone.  Buckets
with no expired row keep their bytes.

I6, checked by ``core.invariants.check_invariants``: empty slots hold
``NO_EXPIRY``, and — given the ``now`` the engine last ran at — no live row
holds ``exp <= now``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import trace
from repro_torch.core.state import EMPTY, FliXState, bucket_chunks

# "never expires"; equal to EMPTY, so an all-EMPTY plane is the identity
# under expiry and a reclaimed slot holds the sentinel of an empty one
NO_EXPIRY = EMPTY


def expire_state(state: FliXState, now):
    """Physically reclaim every row with ``exp <= now``.

    Returns ``(state', n_expired)``: the compaction of ``core.delete``
    (in-node shift-left, then chain slot compaction) with the expiry plane
    carried beside keys and vals.  Plain torch, as the reference is plain
    jnp.  Buckets holding no expired row keep their bytes; when no row
    expired at all, the input state comes back as it is.
    """
    if state.exps is None:
        raise ValueError("expire_state needs an expiry plane")
    now = int(now)
    expired = (state.keys != EMPTY) & (state.exps <= now)
    changed = expired.any(dim=2).any(dim=1)  # [nb]
    n_expired = expired.sum(dtype=torch.int32)
    with trace.span(trace.SYNC + "ttl.expired_buckets"):  # nonzero reads the count back
        hit = torch.nonzero(changed)[:, 0]
    if hit.numel() == 0:
        return state, n_expired

    keys = state.keys.clone()
    vals = state.vals.clone()
    exps = state.exps.clone()
    node_count = state.node_count.clone()
    node_max = state.node_max.clone()
    num_nodes = state.num_nodes.clone()
    ns = state.node_size
    for c0, c1 in bucket_chunks(hit.numel(), state.bucket_capacity):
        b = hit[c0:c1]
        dead = expired[b]
        # in-node compaction: survivors shift left, EMPTY fills the tail
        masked = torch.where(dead, EMPTY, state.keys[b])
        masked_e = torch.where(dead, NO_EXPIRY, state.exps[b])
        order = torch.argsort(masked, dim=2, stable=True)
        ck = masked.gather(2, order)
        cv = state.vals[b].gather(2, order)
        ce = masked_e.gather(2, order)
        # chain compaction: drop emptied nodes, keep chain order
        cnt = (ck != EMPTY).sum(dim=2, dtype=torch.int32)
        slot_order = torch.argsort((cnt == 0).to(torch.int32), dim=1, stable=True)
        idx = slot_order[..., None].expand(-1, -1, ns)
        ck, cv, ce = ck.gather(1, idx), cv.gather(1, idx), ce.gather(1, idx)
        cnt = cnt.gather(1, slot_order)
        last = torch.clamp(cnt - 1, min=0).long()[..., None]
        keys[b], vals[b], exps[b] = ck, cv, ce
        node_count[b] = cnt
        node_max[b] = torch.where(cnt > 0, ck.gather(2, last)[..., 0], EMPTY)
        num_nodes[b] = (cnt > 0).sum(dim=1, dtype=torch.int32)
    new_state = FliXState(
        keys=keys,
        vals=vals,
        node_count=node_count,
        node_max=node_max,
        num_nodes=num_nodes,
        mkba=state.mkba,
        needs_restructure=state.needs_restructure,
        exps=exps,
    )
    return new_state, n_expired


def attach_expiry(state: FliXState, exps: torch.Tensor | None = None) -> FliXState:
    """``state`` with an expiry plane attached (all ``NO_EXPIRY`` when not
    given)."""
    if state.exps is not None and exps is None:
        return state
    if exps is None:
        exps = torch.full_like(state.keys, NO_EXPIRY)
    return dataclasses.replace(state, exps=exps)


def bucket_min_exp(state: FliXState) -> torch.Tensor:
    """Per-bucket minimum live expiry deadline ([nb] int32; ``NO_EXPIRY`` for
    a bucket with no deadline-carrying row, and for every bucket of a state
    without an expiry plane)."""
    if state.exps is None:
        return torch.full(
            (state.num_buckets,), NO_EXPIRY, dtype=torch.int32, device=state.device
        )
    live = torch.where(state.keys != EMPTY, state.exps, NO_EXPIRY)
    return live.reshape(state.num_buckets, -1).amin(dim=1).to(torch.int32)
