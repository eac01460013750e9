"""GPU Sorted Array baseline: a single sorted (key, val) array (port of
``repro/core/baselines/sorted_array.py``).

Updates are full rebuilds (merge + sort), the classic static-GPU-index
pattern the paper's dynamic structures are measured against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.state import EMPTY, KEY_DTYPE, NOT_FOUND, VAL_DTYPE, resolve_device


@dataclasses.dataclass(frozen=True)
class SortedArrayState:
    keys: torch.Tensor  # [cap] sorted, EMPTY-padded tail
    vals: torch.Tensor  # [cap]

    def live_keys(self) -> torch.Tensor:
        return (self.keys != EMPTY).sum(dtype=torch.int32)

    def memory_bytes(self) -> int:
        # rebuild requires a same-size merge buffer; count it (paper counts
        # LSM auxiliary buffers the same way).
        return 2 * (self.keys.numel() * 4 + self.vals.numel() * 4)


def state_from_numpy(arrays: dict, device) -> SortedArrayState:
    """A state from host arrays ``keys`` and ``vals``."""
    dev = resolve_device(device)
    return SortedArrayState(
        **{f: torch.from_numpy(np.asarray(arrays[f], np.int32).copy()).to(dev)
           for f in ("keys", "vals")}
    )


def _new_keys(batch, device) -> torch.Tensor:
    return torch.as_tensor(batch).to(device=device, dtype=KEY_DTYPE)


def build(sorted_keys, sorted_vals, capacity: int, *, device=None) -> SortedArrayState:
    """A sorted array of ``capacity`` slots holding the batch, on ``device``
    (the card unless named)."""
    dev = resolve_device(device)
    sk = _new_keys(sorted_keys, dev)
    n = sk.shape[0]
    k = torch.full((capacity,), EMPTY, dtype=KEY_DTYPE, device=dev)
    k[:n] = sk
    v = torch.zeros((capacity,), dtype=VAL_DTYPE, device=dev)
    v[:n] = torch.as_tensor(sorted_vals).to(device=dev, dtype=VAL_DTYPE)
    order = torch.argsort(k, stable=True)
    return SortedArrayState(keys=k[order], vals=v[order])


def _find(state: SortedArrayState, q: torch.Tensor) -> torch.Tensor:
    """Each query's lower-bound position, clamped to the last slot."""
    pos = torch.searchsorted(state.keys, q, side="left", out_int32=True)
    return torch.clamp(pos, max=state.keys.shape[0] - 1)


def point_query(state: SortedArrayState, queries) -> torch.Tensor:
    q = _new_keys(queries, state.keys.device)
    pos_c = _find(state, q)
    hit = state.keys[pos_c] == q
    return torch.where(hit, state.vals[pos_c], NOT_FOUND)


def successor_query(state: SortedArrayState, queries):
    q = _new_keys(queries, state.keys.device)
    pos_c = _find(state, q)
    k = state.keys[pos_c]
    found = k != EMPTY
    return torch.where(found, k, EMPTY), torch.where(found, state.vals[pos_c], NOT_FOUND)


def merge_newest(old_k, old_v, new_k, new_v):
    """The sorted union of two runs, the newer run winning on a duplicate
    key: each key's pairs sorted old before new, the last of each key kept,
    the rest EMPTY, then compacted by a second stable sort.  Returns
    ``(keys, vals)`` of the combined length, EMPTY-padded.  The reference
    takes ``lexsort((src, keys))`` with ``src`` 0 for the old run and 1 for
    the new: the concatenation is already in ``src`` order, so one stable
    sort by key is the same order."""
    allk = torch.cat([old_k, new_k])
    allv = torch.cat([old_v, new_v])
    order = torch.argsort(allk, stable=True)
    k_s, v_s = allk[order], allv[order]
    keep = torch.ones_like(k_s, dtype=torch.bool)
    keep[:-1] = k_s[1:] != k_s[:-1]
    keep &= k_s != EMPTY
    masked = torch.where(keep, k_s, EMPTY)
    order2 = torch.argsort(masked, stable=True)
    return masked[order2], v_s[order2]


def insert(state: SortedArrayState, sorted_keys, sorted_vals) -> SortedArrayState:
    """Full rebuild: concat + sort + last-wins dedup (upsert)."""
    dev = state.keys.device
    k, v = merge_newest(
        state.keys,
        state.vals,
        _new_keys(sorted_keys, dev),
        torch.as_tensor(sorted_vals).to(device=dev, dtype=VAL_DTYPE),
    )
    cap = state.keys.shape[0]
    return SortedArrayState(keys=k[:cap], vals=v[:cap])


def delete(state: SortedArrayState, sorted_keys) -> SortedArrayState:
    """Physical removal + compaction (full rebuild)."""
    dq = _new_keys(sorted_keys, state.keys.device)
    if dq.shape[0] == 0:
        return state
    pos = torch.searchsorted(dq, state.keys, side="left", out_int32=True)
    pos_c = torch.clamp(pos, max=dq.shape[0] - 1)
    hit = (dq[pos_c] == state.keys) & (state.keys != EMPTY)
    masked = torch.where(hit, EMPTY, state.keys)
    order = torch.argsort(masked, stable=True)
    return SortedArrayState(keys=masked[order], vals=state.vals[order])
