"""Operation-batch preprocessing (port of ``repro/core/batch.py``).

Every FliX operation consumes a *sorted* batch.  ``bucket_slices`` is the
flipped-indexing primitive: one ``searchsorted`` of the MKBA fences against
the sorted batch gives every bucket its slice of operations.
"""

from __future__ import annotations

import torch

from repro_torch.core.state import EMPTY, FliXState


def sort_batch(keys: torch.Tensor, vals: torch.Tensor | None = None):
    """Sort an operation batch by key (vals, if given, follow their key)."""
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    if vals is None:
        return skeys
    return skeys, vals[order]


def dedup_last_wins(keys: torch.Tensor, vals: torch.Tensor):
    """Deduplicate a *sorted* batch; the last occurrence of a key wins.

    Duplicates are replaced by EMPTY and compacted to the end, preserving
    sortedness of the valid prefix.  Returns (keys, vals, valid_count).
    """
    last = torch.ones((1,), dtype=torch.bool, device=keys.device)
    is_last = torch.cat([keys[1:] != keys[:-1], last])
    keep = is_last & (keys != EMPTY)
    masked = torch.where(keep, keys, EMPTY)
    order = torch.argsort(masked, stable=True)
    return masked[order], vals[order], keep.sum(dtype=torch.int32)


def bucket_slices(state: FliXState, sorted_batch: torch.Tensor):
    """Per-bucket [start, end) boundaries into the sorted batch.

    Bucket b owns keys in (mkba[b-1], mkba[b]]:
      start[b] = searchsorted(batch, mkba[b-1], 'right')
      end[b]   = searchsorted(batch, mkba[b],   'right')
    """
    ends = torch.searchsorted(sorted_batch, state.mkba, right=True, out_int32=True)
    starts = torch.cat([torch.zeros_like(ends[:1]), ends[:-1]])
    return starts, ends


def bucket_of(state: FliXState, keys: torch.Tensor) -> torch.Tensor:
    """Bucket index for each key (the classical direction)."""
    return torch.searchsorted(state.mkba, keys, out_int32=True)


def gather_sublists(
    sorted_batch: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
    max_len: int,
    fill_value=EMPTY,
):
    """Materialize per-bucket sublists as a padded [nb, max_len] tile.

    Entries beyond the slice are ``fill_value``.  Also returns per-bucket
    counts (clamped to max_len) and the true counts for overflow detection.
    """
    true_counts = (ends - starts).to(torch.int32)
    counts = torch.clamp(true_counts, max=max_len)
    pad = sorted_batch.new_full((max_len,), fill_value)
    padded = torch.cat([sorted_batch, pad])
    lane = torch.arange(max_len, dtype=torch.int32, device=starts.device)
    idx = starts[:, None] + lane[None, :]
    idx = torch.clamp(idx, max=sorted_batch.shape[0])  # clamp into the pad region
    tile = padded[idx]
    mask = lane[None, :] < counts[:, None]
    tile = torch.where(mask, tile, fill_value)
    return tile, counts, true_counts


def gather_kv_sublists(
    sorted_keys: torch.Tensor,
    sorted_vals: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
    max_len: int,
):
    """:func:`gather_sublists` for a (key, val) batch: the value tile follows
    its key's slot (0 at EMPTY slots).  Returns (keys, vals, counts,
    true_counts)."""
    tile_k, counts, true_counts = gather_sublists(sorted_keys, starts, ends, max_len)
    padded_v = torch.cat([sorted_vals, sorted_vals.new_zeros((max_len,))])
    lane = torch.arange(max_len, dtype=torch.int32, device=starts.device)
    idx = torch.clamp(starts[:, None] + lane[None, :], max=sorted_keys.shape[0])
    tile_v = torch.where(tile_k != EMPTY, padded_v[idx], 0)
    return tile_k, tile_v, counts, true_counts
