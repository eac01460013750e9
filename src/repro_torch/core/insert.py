"""Bulk insertion (port of ``repro/core/insert.py``; paper §4.2/4.3).

Per bucket, in one shot: pull the bucket's sublist from the sorted update
batch, upsert-merge it with the bucket's chain content (the incoming value
wins), and re-chunk each *original node region* into ``ceil(m_j /
node_size)`` balanced pieces.  The reference vmaps the per-bucket merge;
here the bucket dimension is written out and processed in bucket chunks
that bound the temporaries.
"""

from __future__ import annotations

import torch

from repro_torch.core.batch import bucket_slices, gather_kv_sublists
from repro_torch.core.state import (
    EMPTY,
    KEY_DTYPE,
    FliXState,
    bucket_chunks,
    sort_bucket_rows,
)


def _merge_buckets(
    ck, cv, ik, iv, onm, onn, *, node_size: int, nodes_per_bucket: int
):
    """Merge each bucket's sorted content (ck/cv [C, cap]) with its sorted
    incoming sublist (ik/iv [C, cap]) — ``_merge_one_bucket`` batched over
    the leading bucket dimension.  Returns new (keys [C, npb, ns], vals,
    overflow [C])."""
    ns, npb = node_size, nodes_per_bucket
    C = ck.shape[0]
    # upsert-dedup before the sort: both sides are sorted with EMPTY tails,
    # so a stored key that reappears in the incoming sublist is found by one
    # binary search and masked out (the incoming value wins)
    pos = torch.searchsorted(ik, ck)
    pos_c = torch.clamp(pos, max=ik.shape[1] - 1)
    dup = (ik.gather(1, pos_c) == ck) & (ck != EMPTY)
    allk = torch.cat([torch.where(dup, EMPTY, ck), ik], dim=1)
    allv = torch.cat([cv, iv], dim=1)
    order = torch.argsort(allk, dim=1, stable=True)  # the single sort pass
    mk = allk.gather(1, order)  # merged keys, EMPTY tail
    mv = allv.gather(1, order)
    L = mk.shape[1]
    valid = mk != EMPTY

    # original node regions: region j covers (onm[j-1], onm[j]]; keys above
    # the last active node's max fall into the last region
    r = torch.searchsorted(onm, mk)
    r = torch.minimum(r, torch.clamp(onn.long() - 1, min=0)[:, None])
    r = torch.where(valid, r, npb - 1)

    m_j = torch.zeros((C, npb), dtype=torch.int32, device=ck.device)
    m_j.scatter_add_(1, r, valid.to(torch.int32))
    s_j = (m_j + ns - 1) // ns  # pieces per region
    f_j = torch.cumsum(m_j, 1, dtype=torch.int32) - m_j  # first rank of region
    base_j = torch.cumsum(s_j, 1, dtype=torch.int32) - s_j  # first output slot
    overflow = s_j.sum(dim=1) > npb

    lane = torch.arange(L, dtype=torch.int32, device=ck.device)[None, :]
    rank = lane - f_j.gather(1, r)
    m_r = torch.clamp(m_j.gather(1, r), min=1)
    s_r = torch.clamp(s_j.gather(1, r), min=1)
    piece = (rank * s_r) // m_r
    piece_start = (piece * m_r + s_r - 1) // s_r
    pos = rank - piece_start
    slot = base_j.gather(1, r) + piece

    dump = npb * ns
    dest = torch.where(valid & (slot < npb), slot * ns + pos, dump).long()
    nk = torch.full((C, dump + 1), EMPTY, dtype=KEY_DTYPE, device=ck.device)
    nv = torch.zeros((C, dump + 1), dtype=cv.dtype, device=ck.device)
    nk.scatter_(1, dest, mk)
    nv.scatter_(1, dest, mv)
    return nk[:, :-1].reshape(C, npb, ns), nv[:, :-1].reshape(C, npb, ns), overflow


def _node_metadata(keys: torch.Tensor):
    """(node_count, node_max, num_nodes) recomputed from [nb, npb, ns] keys."""
    node_count = (keys != EMPTY).sum(dim=2, dtype=torch.int32)
    last = torch.clamp(node_count - 1, min=0).long()[..., None]
    node_max = torch.where(node_count > 0, keys.gather(2, last)[..., 0], EMPTY)
    num_nodes = (node_count > 0).sum(dim=1, dtype=torch.int32)
    return node_count, node_max, num_nodes


def insert_with_slices(
    state: FliXState,
    sorted_keys: torch.Tensor,
    sorted_vals: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
):
    """Bulk-insert with precomputed per-bucket slice boundaries.

    :func:`insert` computes the routing with ``bucket_slices``; the mixed
    batch engine (``core.ops.apply_ops``) derives it from its single routing
    of the whole mixed batch via prefix counts.  Both hit this merge code.
    """
    nb, npb, ns = state.geometry
    cap = state.bucket_capacity
    keys_in = sorted_keys.to(torch.int32)
    vals_in = sorted_vals.to(torch.int32)

    nk = torch.empty_like(state.keys)
    nv = torch.empty_like(state.vals)
    overflow = torch.empty((nb,), dtype=torch.bool, device=state.device)
    flat_k = state.keys.reshape(nb, -1)
    flat_v = state.vals.reshape(nb, -1)
    for c0, c1 in bucket_chunks(nb, 2 * cap):
        ik, iv, _, _ = gather_kv_sublists(
            keys_in, vals_in, starts[c0:c1], ends[c0:c1], cap
        )
        ck, cv = sort_bucket_rows(flat_k[c0:c1], flat_v[c0:c1])
        nk[c0:c1], nv[c0:c1], overflow[c0:c1] = _merge_buckets(
            ck,
            cv,
            ik,
            iv,
            state.node_max[c0:c1],
            state.num_nodes[c0:c1],
            node_size=ns,
            nodes_per_bucket=npb,
        )

    true_counts = (ends - starts).to(torch.int32)
    slice_overflow = true_counts > cap
    any_overflow = overflow.any() | slice_overflow.any()
    node_count, node_max, num_nodes = _node_metadata(nk)

    new_state = FliXState(
        keys=nk,
        vals=nv,
        node_count=node_count,
        node_max=node_max,
        num_nodes=num_nodes,
        mkba=state.mkba,  # fences fixed until restructuring (paper §3.2)
        needs_restructure=state.needs_restructure | any_overflow,
    )
    splits = torch.clamp(num_nodes - state.num_nodes, min=0)
    stats = {
        "inserted": torch.clamp(true_counts, max=cap).sum(dtype=torch.int32),
        "nodes_after": num_nodes.sum(dtype=torch.int32),
        "splits": splits.sum(dtype=torch.int32),
        "overflowed_buckets": (overflow | slice_overflow).sum(dtype=torch.int32),
    }
    return new_state, stats


def insert(state: FliXState, sorted_keys: torch.Tensor, sorted_vals: torch.Tensor):
    """Bulk-insert a sorted, deduplicated batch. Returns (state', stats).

    If any bucket overflows its capacity, the returned state's
    ``needs_restructure`` flag is set and that bucket's contents are not
    trustworthy — callers use :func:`insert_safe`.  ``insert`` never
    writes its input, so a retry is always clean.
    """
    starts, ends = bucket_slices(state, sorted_keys.to(torch.int32))
    return insert_with_slices(state, sorted_keys, sorted_vals, starts, ends)


def insert_safe(state: FliXState, sorted_keys, sorted_vals):
    """Host-level loop: insert, restructure-and-retry on overflow."""
    from repro_torch.core.restructure import restructure_grow

    new_state, stats = insert(state, sorted_keys, sorted_vals)
    if bool(new_state.needs_restructure):
        n_incoming = int((sorted_keys != EMPTY).sum())
        grown = restructure_grow(state, extra_keys=n_incoming)
        new_state, stats = insert(grown, sorted_keys, sorted_vals)
        if bool(new_state.needs_restructure):
            raise RuntimeError("insert overflowed after restructure_grow")
    return new_state, stats
