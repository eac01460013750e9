"""Flipped query execution (port of ``repro/core/query.py``; paper §3.3).

Bucket slice boundaries come from one searchsorted against the fences;
inside a bucket, node location and in-node position are compare-and-count
reductions.  These are the plain-torch oracle forms; the engine's fused
path answers the same reads inside ``kernels/flix_apply``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.state import (
    CHUNK_ELEMS,
    EMPTY,
    NOT_FOUND,
    FliXState,
    flatten_bucket_sorted,
)


def _bucket_index(state: FliXState, q: torch.Tensor) -> torch.Tensor:
    """Owning bucket per query, clamped into range (JAX clamps the gather)."""
    b = torch.searchsorted(state.mkba, q, out_int32=True)
    return torch.clamp(b, max=state.num_buckets - 1)


def _locate(state: FliXState, queries: torch.Tensor):
    """For each query: (bucket, node-slot, in-node position, key-at-position).

    node-slot is the first active node whose maxKey ≥ q (compare-count over
    the node_max row; inactive slots hold EMPTY so they never match first).
    """
    b = _bucket_index(state, queries)
    nmax_rows = state.node_max[b]  # [Q, npb]
    nidx = (nmax_rows < queries[:, None]).sum(dim=1, dtype=torch.int32)
    in_bucket = nidx < state.num_nodes[b]
    nidx_c = torch.clamp(nidx, max=state.nodes_per_bucket - 1)
    rows = state.keys[b, nidx_c]  # [Q, ns]
    pos = (rows < queries[:, None]).sum(dim=1, dtype=torch.int32)
    pos_c = torch.clamp(pos, max=state.node_size - 1)
    key_at = rows.gather(1, pos_c.long()[:, None])[:, 0]
    return b, nidx_c, pos_c, key_at, in_bucket, pos


def point_query(state: FliXState, sorted_queries: torch.Tensor) -> torch.Tensor:
    """Point lookups for a sorted query batch. Misses return NOT_FOUND."""
    q = sorted_queries.to(torch.int32)
    b, nidx, pos, key_at, in_bucket, raw_pos = _locate(state, q)
    hit = in_bucket & (raw_pos < state.node_size) & (key_at == q)
    vals = state.vals[b, nidx, pos]
    return torch.where(hit, vals, NOT_FOUND)


def _suffix_min_with_index(g: torch.Tensor):
    """suffix_min[i] = min(g[i:]), plus the index attaining it.

    Ties go to the *higher* index, as in the reference's associative scan.
    ``torch.cummin`` breaks ties its own way, so the scan runs on one int64
    code per element — the value in the high word, the position in the
    reversed array in the low word — whose minimum is the smallest value
    at its earliest reversed position, i.e. its highest original index.
    """
    n = g.shape[0]
    rev = g.flip(0).to(torch.int64)
    pos = torch.arange(n, dtype=torch.int64, device=g.device)
    code = torch.cummin(rev * (1 << 32) + pos, dim=0).values
    rv = (code >> 32).to(torch.int32)
    ri = (n - 1 - (code & 0xFFFFFFFF)).to(torch.int32)
    return rv.flip(0), ri.flip(0)


def _successor_fence_rows(keys: torch.Tensor, num_nodes: torch.Tensor):
    """Padded suffix-min rows over per-bucket minimum present keys, from the
    key plane [nb, npb, ns] and the per-bucket active-node counts.

    ``smin_pad[b+1]`` is the smallest key stored in any bucket after ``b``
    (EMPTY if none) and ``sidx_pad[b+1]`` the bucket attaining it — the
    successor fallback for queries past their bucket's largest present key.
    """
    bucket_min = torch.where(num_nodes > 0, keys[:, 0, 0], EMPTY)
    smin, sidx = _suffix_min_with_index(bucket_min)
    smin_pad = torch.cat([smin, smin.new_full((1,), EMPTY)])
    sidx_pad = torch.cat([sidx, sidx.new_zeros((1,))])
    return smin_pad, sidx_pad


def with_successor_cache(state: FliXState) -> FliXState:
    """``state`` carrying the successor fence rows (``succ_smin`` /
    ``succ_sidx``), so that every later :func:`successor_query` on it skips
    their O(nb) rebuild.  Mutating operations construct their result state
    without the cache, which is the invalidation rule.  Idempotent."""
    if state.succ_smin is not None:
        return state
    smin_pad, sidx_pad = _successor_fence_rows(state.keys, state.num_nodes)
    return dataclasses.replace(state, succ_smin=smin_pad, succ_sidx=sidx_pad)


def successor_query(state: FliXState, sorted_queries: torch.Tensor):
    """Smallest stored key ≥ q (and its value); (EMPTY, NOT_FOUND) if none.

    In-bucket path: compare-count as in point queries.  Out-of-bucket path
    (bucket's largest present key < q): the suffix-min fence rows give the
    next non-empty bucket in O(1) per query; a state carrying the
    :func:`with_successor_cache` rows reads them instead of rebuilding them.
    """
    q = sorted_queries.to(torch.int32)
    b, nidx_c, pos_c, in_key, in_bucket, pos = _locate(state, q)
    in_val = state.vals[b, nidx_c, pos_c]

    if state.succ_smin is not None:
        smin_pad, sidx_pad = state.succ_smin, state.succ_sidx
    else:
        smin_pad, sidx_pad = _successor_fence_rows(state.keys, state.num_nodes)
    out_key = smin_pad[b + 1]
    out_val = state.vals[sidx_pad[b + 1], 0, 0]

    use_in = in_bucket & (pos < state.node_size)
    succ_key = torch.where(use_in, in_key, out_key)
    succ_val = torch.where(use_in, in_val, out_val)
    found = succ_key != EMPTY
    return succ_key, torch.where(found, succ_val, NOT_FOUND)


# ---------------------------------------------------------------------------
# Dense half-open range machinery (the RANGE batch op)
# ---------------------------------------------------------------------------
#
# A RANGE op carries ``[lo, hi)`` and the batch carries one static
# ``max_results`` output budget.  Per-op full in-range counts are
# exclusive-scanned into densely packed output offsets (earlier sorted ops
# win the budget, each op emits a prefix of its smallest in-range keys), and
# every output slot resolves to one global key rank.


def flat_rank(
    flat_k: torch.Tensor, pref: torch.Tensor, mkba: torch.Tensor, q: torch.Tensor
):
    """Global rank (count of stored keys < q) per query, from per-bucket
    sorted rows ``flat_k`` [nb, cap] and live-count prefix sums ``pref``
    [nb+1].  One searchsorted to the owning bucket + one compare-count row
    (in query chunks, so the [Q, cap] gather stays bounded)."""
    nb, cap = flat_k.shape
    q = q.to(torch.int32)
    b = torch.clamp(torch.searchsorted(mkba, q, out_int32=True), max=nb - 1)
    out = torch.empty_like(q)
    step = max(1, CHUNK_ELEMS // cap)
    for c0 in range(0, q.shape[0], step):
        qc, bc = q[c0 : c0 + step], b[c0 : c0 + step]
        p = (flat_k[bc] < qc[:, None]).sum(dim=1, dtype=torch.int32)
        out[c0 : c0 + step] = pref[bc] + p
    return out


def live_prefix(node_count: torch.Tensor) -> torch.Tensor:
    """Live-count prefix ``pref`` [nb+1] from the node counts: ``pref[b]`` is
    the global rank of bucket ``b``'s first key."""
    live = node_count.sum(1, dtype=torch.int32)
    return torch.cat([live.new_zeros((1,)), torch.cumsum(live, 0, dtype=torch.int32)])


def node_rank(keys, node_count, node_max, mkba, pref, q: torch.Tensor) -> torch.Tensor:
    """Global rank (stored keys < q) per query in a state that holds I1–I4,
    with no per-bucket sort: the owning bucket's rank fence ``pref[b]``,
    plus the keys of its nodes wholly below q, plus q's position in the
    first node that reaches it (keys are packed at the front of each node
    and chain-ordered, so that is a prefix count of the row).  Equal to
    :func:`flat_rank` on the sorted rows."""
    npb = keys.shape[1]
    q = q.to(torch.int32)
    b = torch.clamp(torch.searchsorted(mkba, q, out_int32=True), max=keys.shape[0] - 1)
    below = node_max[b] < q[:, None]
    before = (node_count[b] * below).sum(1, dtype=torch.int32)
    nidx = below.sum(1, dtype=torch.int32)
    row = keys[b, torch.clamp(nidx, max=npb - 1)]
    pos = (row < q[:, None]).sum(1, dtype=torch.int32)
    pos = torch.where(nidx < npb, pos, 0)
    return pref[b] + before + pos


def gather_ranks(g, pref, node_count, keys, vals):
    """The (key, val) of global rank ``g[p]`` per slot, EMPTY / NOT_FOUND
    where ``g[p] < 0``: the owning bucket by ``pref``, then the node by the
    running node counts, then the position in the node."""
    nb, npb, ns = keys.shape
    valid = g >= 0
    gc = torch.where(valid, g, 0)
    b = torch.searchsorted(pref, gc, right=True, out_int32=True) - 1
    b = torch.clamp(b, 0, nb - 1)
    r = gc - pref[b]
    cnt = node_count[b]  # [P, npb]
    incl = torch.cumsum(cnt, 1, dtype=torch.int32)
    node = torch.clamp((incl <= r[:, None]).sum(1), max=npb - 1)[:, None]
    before = (incl.gather(1, node) - cnt.gather(1, node))[:, 0]
    pos = torch.clamp(r - before, 0, ns - 1)
    node = node[:, 0]
    rk = torch.where(valid, keys[b, node, pos], EMPTY)
    rv = torch.where(valid, vals[b, node, pos], NOT_FOUND)
    return rk, rv


def range_offsets(full: torch.Tensor, is_range: torch.Tensor, max_results: int):
    """Deterministic budget split: exclusive-scan the full counts (sorted
    batch order), clamp to the budget.  Returns ``(start, emit, total_emit,
    truncated)`` — op i's results land at ``[start[i], start[i]+emit[i])``,
    segments tile ``[0, total_emit)`` consecutively, and ``truncated`` counts
    the range ops whose full result set did not fit."""
    full = torch.where(is_range, full, 0).to(torch.int32)
    # any count > budget behaves like budget+1 (start/emit are clamped and
    # emit < budget+1 still flags truncation); the clamp also keeps the
    # running sum far from int32 limits
    full = torch.clamp(full, max=max_results + 1)
    start_full = torch.cumsum(full, dim=0, dtype=torch.int64) - full
    start = torch.clamp(start_full, max=max_results).to(torch.int32)
    emit = torch.minimum(full, max_results - start).to(torch.int32)
    total_emit = torch.clamp(full.sum(dtype=torch.int64), max=max_results)
    truncated = ((emit < full) & is_range).sum(dtype=torch.int32)
    return start, emit, total_emit.to(torch.int32), truncated


def range_slot_ranks(
    rank_lo: torch.Tensor,
    start: torch.Tensor,
    total_emit: torch.Tensor,
    max_results: int,
):
    """Per-output-slot global key rank.  Slot p belongs to the last op whose
    (clamped) start ≤ p — zero-width segments share their start with the
    following op, so ``right=True`` lands on the true owner.  Invalid slots
    (≥ total_emit) get rank -1."""
    p = torch.arange(max_results, dtype=torch.int32, device=start.device)
    owner = torch.searchsorted(start, p, right=True, out_int32=True) - 1
    owner = torch.clamp(owner, 0, start.shape[0] - 1)
    g = rank_lo[owner] + (p - start[owner])
    return torch.where(p < total_emit, g, -1)


def dense_range_scan(
    state: FliXState,
    is_range: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    *,
    max_results: int,
):
    """The RANGE oracle: answer every active ``[lo, hi)`` op against
    ``state``, packing results densely at exclusive-scan offsets.

    Returns ``(keys[max_results], vals[max_results], start[N], count[N],
    truncated)``.  Slots beyond the emitted total hold EMPTY / NOT_FOUND.
    """
    flat_k, flat_v = flatten_bucket_sorted(state)
    nb = state.num_buckets
    live = (flat_k != EMPTY).sum(dim=1, dtype=torch.int32)
    pref = torch.cat([live.new_zeros((1,)), torch.cumsum(live, 0, dtype=torch.int32)])
    rank_lo = flat_rank(flat_k, pref, state.mkba, lo)
    rank_hi = flat_rank(flat_k, pref, state.mkba, hi)
    full = torch.clamp(rank_hi - rank_lo, min=0)
    start, emit, total_emit, truncated = range_offsets(full, is_range, max_results)
    g = range_slot_ranks(rank_lo, start, total_emit, max_results)
    valid = g >= 0
    g_c = torch.where(valid, g, 0)
    src_b = torch.searchsorted(pref, g_c, right=True, out_int32=True) - 1
    src_b = torch.clamp(src_b, 0, nb - 1)
    src_p = g_c - pref[src_b]
    rk = torch.where(valid, flat_k[src_b, src_p], EMPTY)
    rv = torch.where(valid, flat_v[src_b, src_p], NOT_FOUND)
    return (
        rk,
        rv,
        torch.where(is_range, start, 0),
        torch.where(is_range, emit, 0),
        truncated,
    )


def range_query(
    state: FliXState, lo: torch.Tensor, hi: torch.Tensor, *, max_results: int = 128
):
    """Keys/vals in the inclusive ``[lo, hi]`` per query pair, padded to
    ``max_results`` per query.  Returns ``(keys [Q, max_results], vals,
    counts [Q])``; slots past a query's count hold EMPTY / NOT_FOUND.

    A walk from the global rank of ``lo``: bucket order is key order
    (I2/I3), so ``node_rank`` gives that rank from the node counts, and
    each following rank maps back to (bucket, node, position) by
    ``gather_ranks`` — no per-bucket sort and no global argsort.
    """
    lo = lo.to(torch.int32)
    hi = hi.to(torch.int32)
    pref = live_prefix(state.node_count)
    total = pref[-1]
    meta = (state.keys, state.node_count, state.node_max, state.mkba, pref)
    rank0 = node_rank(*meta, lo)
    step = torch.arange(max_results, dtype=torch.int32, device=lo.device)
    ranks = rank0[:, None] + step[None, :]
    in_range = ranks < total
    g = torch.where(in_range, ranks, -1).reshape(-1)
    rk, rv = gather_ranks(g, pref, state.node_count, state.keys, state.vals)
    rk = rk.reshape(ranks.shape)
    rv = rv.reshape(ranks.shape)
    valid = in_range & (rk <= hi[:, None]) & (rk != EMPTY)
    return (
        torch.where(valid, rk, EMPTY),
        torch.where(valid, rv, NOT_FOUND),
        valid.sum(1, dtype=torch.int32),
    )
