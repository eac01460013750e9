"""Bulk deletion (port of ``repro/core/delete.py``; paper §4.4).

FliX deletes physically and immediately — no tombstones.  Per bucket: mark
matches against the delete batch, shift survivors left inside each node,
drop empty nodes from the chain, and make their slots available again.
Deletes leave nodes underfull; :func:`merge_underfull` repacks them.
"""

from __future__ import annotations

import torch

from repro_torch.core.insert import _node_metadata
from repro_torch.core.state import EMPTY, FliXState, bucket_chunks, sort_bucket_rows


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


def merge_underfull(state: FliXState) -> FliXState:
    """Merge underfull *adjacent* nodes within each bucket (the paper's
    suggested deletion-path optimization, §5.4.1): greedily repack each
    bucket's content into half-full-or-better nodes without touching MKBA.

    Equivalent to a bucket-local restructure; O(bucket) like delete itself.
    The expiry plane, when the state has one, follows its keys through the
    same stable row order.  Buckets are sorted and repacked a chunk at a
    time (``bucket_chunks``), so the temporaries stay bounded whatever the
    bucket count.
    """
    nb, npb, ns = state.geometry
    cap = npb * ns
    dev = state.device
    flat_k = state.keys.reshape(nb, cap)
    flat_v = state.vals.reshape(nb, cap)
    flat_e = None if state.exps is None else state.exps.reshape(nb, cap)
    new_keys = torch.empty_like(state.keys)
    new_vals = torch.empty_like(state.vals)
    new_exps = None if flat_e is None else torch.empty_like(state.exps)
    i = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    for c0, c1 in bucket_chunks(nb, cap):
        # each bucket row sorted, EMPTY tail; the expiry plane by the same
        # stable key argsort, so in the same row order
        ck, cv = sort_bucket_rows(flat_k[c0:c1], flat_v[c0:c1])
        ce = None if flat_e is None else sort_bucket_rows(flat_k[c0:c1], flat_e[c0:c1])[1]
        valid = ck != EMPTY
        live = valid.sum(dim=1, dtype=torch.int32)
        # repack into ceil(live/ns) balanced pieces (≥ half full except the last)
        s_r = torch.clamp((live + ns - 1) // ns, min=1)[:, None]
        m_r = torch.clamp(live, min=1)[:, None]
        piece = (i * s_r) // m_r
        piece_start = (piece * m_r + s_r - 1) // s_r
        # one dump column past the stripe takes every EMPTY
        dest = torch.where(valid & (piece < npb), piece * ns + i - piece_start, cap).long()
        for plane, out, fill in (
            (ck, new_keys, EMPTY),
            (cv, new_vals, 0),
            (ce, new_exps, EMPTY),  # EMPTY == NO_EXPIRY
        ):
            if plane is None:
                continue
            buf = torch.full((c1 - c0, cap + 1), fill, dtype=plane.dtype, device=dev)
            buf.scatter_(1, dest, plane)
            out[c0:c1] = buf[:, :cap].reshape(c1 - c0, npb, ns)
    node_count, node_max, num_nodes = _node_metadata(new_keys)
    return FliXState(
        keys=new_keys,
        vals=new_vals,
        node_count=node_count,
        node_max=node_max,
        num_nodes=num_nodes,
        mkba=state.mkba,
        needs_restructure=state.needs_restructure,
        exps=new_exps,
    )
