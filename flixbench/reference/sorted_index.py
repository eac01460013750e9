"""The plain reference of the ordered index: sorted (key, value) arrays.

A batch of raw operations (in submission order) runs as the index's API
defines it: every INSERT (an upsert) and DELETE first, then every read
against the state after them.  POINT answers the stored value or
NOT_FOUND; SUCCESSOR the smallest stored key >= q and its value, or EMPTY
and NOT_FOUND; RANGE the keys of ``[lo, hi)`` in one dense output of
``max_results`` slots, the RANGE ops taking their turns in ascending ``lo``
(ties in submission order), each emitting a prefix of its keys while the
budget lasts.  At most one update op per key and batch.

Plain torch on any device; it imports nothing of the program.
"""

from __future__ import annotations

import torch

from flixbench import opcodes


def _find(keys: torch.Tensor, q: torch.Tensor):
    """Each q's position in the sorted ``keys`` and whether it is stored."""
    pos = torch.searchsorted(keys, q)
    if not keys.numel():
        return pos, torch.zeros_like(q, dtype=torch.bool)
    return pos, (pos < keys.numel()) & (keys[pos.clamp(max=keys.numel() - 1)] == q)


def apply_updates(keys, vals, tags, qk, qv):
    """The state after a batch's INSERTs and DELETEs, and the counts
    ``(inserted, deleted)``: inserted counts INSERT ops, deleted the keys a
    DELETE found."""
    dk = qk[tags == opcodes.DELETE]
    pos, hit = _find(keys, dk)
    keep = torch.ones(keys.numel(), dtype=torch.bool, device=keys.device)
    keep[pos[hit]] = False
    deleted = int(hit.sum())
    keys, vals = keys[keep], vals[keep]
    ins = tags == opcodes.INSERT
    ik, iv = qk[ins], qv[ins]
    pos, hit = _find(keys, ik)
    vals = vals.clone()
    vals[pos[hit]] = iv[hit]
    keys = torch.cat([keys, ik[~hit]])
    vals = torch.cat([vals, iv[~hit]])
    keys, order = torch.sort(keys, stable=True)
    return keys, vals[order], int(ins.sum()), deleted


def answer_reads(keys, vals, tags, qk, qv, max_results: int):
    """Every op's answers, in submission order: ``value``, ``succ_key``,
    ``range_start``, ``range_count``, the dense ``range_key`` /
    ``range_val`` and ``range_truncated``."""
    n, dev = qk.numel(), qk.device
    empty = torch.full((n,), opcodes.EMPTY, dtype=torch.int32, device=dev)
    miss = torch.full((n,), opcodes.NOT_FOUND, dtype=torch.int32, device=dev)
    pos = torch.searchsorted(keys, qk)
    inb = pos < keys.numel()
    pc = pos.clamp(max=max(keys.numel() - 1, 0))
    at_k = torch.where(inb, keys[pc], empty) if keys.numel() else empty
    at_v = torch.where(inb, vals[pc], miss) if keys.numel() else miss
    is_point = tags == opcodes.POINT
    is_succ = tags == opcodes.SUCCESSOR
    value = torch.where(is_point & (at_k == qk), at_v, miss)
    value = torch.where(is_succ, at_v, value)
    succ_key = torch.where(is_succ, at_k, empty)

    # RANGE: full counts, then the budget in ascending lo, ties in submission order
    is_range = tags == opcodes.RANGE
    idx = torch.nonzero(is_range)[:, 0]
    lo, hi = qk[idx], qv[idx]
    order = torch.sort(lo, stable=True).indices
    idx, lo, hi = idx[order], lo[order], hi[order]
    r_lo = torch.searchsorted(keys, lo)
    full = (torch.searchsorted(keys, hi) - r_lo).clamp(min=0)
    before = torch.cumsum(full, 0) - full
    start = before.clamp(max=max_results)
    emit = torch.minimum(full, max_results - start)
    total = int(emit.sum())
    owner = torch.repeat_interleave(torch.arange(idx.numel(), device=dev), emit)
    rank = r_lo[owner] + torch.arange(total, device=dev) - start[owner]
    range_key = torch.full((max_results,), opcodes.EMPTY, dtype=torch.int32, device=dev)
    range_val = torch.full((max_results,), opcodes.NOT_FOUND, dtype=torch.int32, device=dev)
    range_key[:total] = keys[rank]
    range_val[:total] = vals[rank]
    range_start = torch.zeros((n,), dtype=torch.int32, device=dev)
    range_count = torch.zeros((n,), dtype=torch.int32, device=dev)
    range_start[idx] = start.to(torch.int32)
    range_count[idx] = emit.to(torch.int32)
    return {
        "value": value,
        "succ_key": succ_key,
        "range_start": range_start,
        "range_count": range_count,
        "range_key": range_key,
        "range_val": range_val,
        "range_truncated": int((emit < full).sum()),
    }


def run_batch(keys, vals, tags, qk, qv, max_results: int):
    """One batch: ``(keys', vals', answers, stats)``."""
    keys, vals, inserted, deleted = apply_updates(keys, vals, tags, qk, qv)
    answers = answer_reads(keys, vals, tags, qk, qv, max_results)
    stats = {
        "inserted": inserted,
        "deleted": deleted,
        "overflowed_buckets": 0,
        "range_truncated": answers.pop("range_truncated"),
        "restructure_retries": 0,
    }
    return keys, vals, answers, stats
