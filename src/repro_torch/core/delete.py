"""Bulk deletion (port of ``repro/core/delete.py``; paper §4.4).

FliX deletes physically and immediately — no tombstones.  Per bucket: mark
matches against the delete batch, shift survivors left inside each node,
drop empty nodes from the chain, and make their slots available again.
"""

from __future__ import annotations

import torch

from repro_torch.core.insert import _node_metadata
from repro_torch.core.state import EMPTY, FliXState, bucket_chunks


def delete(state: FliXState, sorted_keys: torch.Tensor):
    """Bulk-delete a sorted batch of keys. Returns (state', stats).

    Membership is one binary search of the *whole sorted batch* per stored
    key — the flipped direction (data looks up the batch), with no
    per-bucket tile bound, so arbitrarily skewed batches are handled exactly.
    """
    nb, npb, ns = state.geometry
    dk = sorted_keys.to(torch.int32)
    new_keys = torch.empty_like(state.keys)
    new_vals = torch.empty_like(state.vals)
    n_deleted = torch.zeros((), dtype=torch.int32, device=state.device)
    for c0, c1 in bucket_chunks(nb, npb * ns):
        keys = state.keys[c0:c1]
        if dk.shape[0] == 0:
            deleted = torch.zeros_like(keys, dtype=torch.bool)
        else:
            flat = keys.reshape(-1)
            pos = torch.clamp(torch.searchsorted(dk, flat), max=dk.shape[0] - 1)
            deleted = ((dk[pos] == flat) & (flat != EMPTY)).reshape(keys.shape)
        n_deleted += deleted.sum(dtype=torch.int32)

        # in-node compaction: survivors shift left, EMPTY fills the tail
        masked = torch.where(deleted, EMPTY, keys)
        order = torch.argsort(masked, dim=2, stable=True)
        ck = masked.gather(2, order)
        cv = state.vals[c0:c1].gather(2, order)

        # chain compaction: drop empty nodes, keep chain order (stable sort
        # by "is-empty"), freeing their slots for future splits
        empty_slot = ((ck != EMPTY).sum(dim=2) == 0).to(torch.int32)
        slot_order = torch.argsort(empty_slot, dim=1, stable=True)
        idx = slot_order[..., None].expand(-1, -1, ns)
        new_keys[c0:c1] = ck.gather(1, idx)
        new_vals[c0:c1] = cv.gather(1, idx)

    node_count, node_max, num_nodes = _node_metadata(new_keys)
    new_state = FliXState(
        keys=new_keys,
        vals=new_vals,
        node_count=node_count,
        node_max=node_max,
        num_nodes=num_nodes,
        mkba=state.mkba,
        needs_restructure=state.needs_restructure,
    )
    stats = {
        "deleted": n_deleted,
        "nodes_freed": (state.num_nodes - num_nodes).sum(dtype=torch.int32),
    }
    return new_state, stats
