"""LSMu: the authors' improved GPU LSM-tree (port of
``repro/core/baselines/lsm.py``; paper §2.2.1, §5.1).

Design reproduced:
  * fixed chunk size ``b``; level ``i`` holds a sorted run of ``b * 2**i``
    pairs; a batch insert pushes chunks through the binary-counter cascade
    (merge-and-carry), the Ashkiani et al. scheme.
  * **LSMu deletions**: locate the key's *newest* occurrence and set its
    value to ``TOMBSTONE`` in place — no duplicate tombstone pairs are
    inserted (the authors' improvement over the original GPU LSM).
  * queries search levels newest→oldest; the first occurrence decides
    (a TOMBSTONE value ⇒ miss).
  * successor queries must skip stale/tombstoned keys, degrading toward a
    linear scan as deletions accumulate (Figure 13's 69000× effect) — the
    bounded skip loop below reproduces that behavior.
  * merging is not in place: the auxiliary buffer proportional to the
    largest level is charged to the memory footprint (Figure 7d).

The host drives the cascade chunk by chunk, reading ``occupied`` once a
call, as the reference does (and as the real implementation launches its
merge kernels from the host).  The skip loop is a host loop that stops on
the reference's condition: one host sync a round.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.baselines.sorted_array import merge_newest
from repro_torch.core.state import EMPTY, KEY_DTYPE, NOT_FOUND, VAL_DTYPE, resolve_device

TOMBSTONE = -2  # value sentinel: logically deleted


@dataclasses.dataclass(frozen=True)
class LSMState:
    # level i tensors have shape [b * 2**i]; EMPTY-padded when unoccupied.
    level_keys: tuple[torch.Tensor, ...]
    level_vals: tuple[torch.Tensor, ...]
    occupied: torch.Tensor  # [L] bool

    @property
    def num_levels(self) -> int:
        return len(self.level_keys)

    @property
    def chunk(self) -> int:
        return self.level_keys[0].shape[0]

    def live_keys(self) -> torch.Tensor:
        """Upper bound: occupied slots minus tombstones (stale dups remain)."""
        total = torch.zeros((), dtype=torch.int32, device=self.occupied.device)
        for k, v in zip(self.level_keys, self.level_vals):
            total += ((k != EMPTY) & (v != TOMBSTONE)).sum(dtype=torch.int32)
        return total

    def memory_bytes(self) -> int:
        total = 0
        for k in self.level_keys:
            total += 2 * k.numel() * 4
        # auxiliary merge buffer proportional to the largest level
        total += 2 * self.level_keys[-1].numel() * 4
        return total


def state_from_numpy(arrays: dict, device) -> LSMState:
    """A state from host arrays: lists ``level_keys`` and ``level_vals``,
    and ``occupied``."""
    dev = resolve_device(device)

    def move(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype).copy()).to(dev)

    return LSMState(
        level_keys=tuple(move(a, np.int32) for a in arrays["level_keys"]),
        level_vals=tuple(move(a, np.int32) for a in arrays["level_vals"]),
        occupied=move(arrays["occupied"], np.bool_),
    )


def empty_state(chunk: int, num_levels: int, *, device=None) -> LSMState:
    dev = resolve_device(device)
    sizes = [chunk * 2**i for i in range(num_levels)]
    return LSMState(
        level_keys=tuple(torch.full((s,), EMPTY, dtype=KEY_DTYPE, device=dev) for s in sizes),
        level_vals=tuple(torch.zeros((s,), dtype=VAL_DTYPE, device=dev) for s in sizes),
        occupied=torch.zeros(num_levels, dtype=torch.bool, device=dev),
    )


def _merge_runs(k1, v1, k2, v2):
    """Merge two sorted runs; newer run (k1) wins on duplicate keys."""
    return merge_newest(k2, v2, k1, v1)


def insert(state: LSMState, sorted_keys, sorted_vals) -> LSMState:
    """Push the batch through the cascade, chunk by chunk (host-driven)."""
    b = state.chunk
    dev = state.occupied.device
    sk = torch.as_tensor(sorted_keys).to(device=dev, dtype=KEY_DTYPE)
    sv = torch.as_tensor(sorted_vals).to(device=dev, dtype=VAL_DTYPE)
    n = sk.shape[0]
    lk = list(state.level_keys)
    lv = list(state.level_vals)
    occ = state.occupied.tolist()
    for c0 in range(0, n, b):
        m = min(b, n - c0)
        ck = torch.full((b,), EMPTY, dtype=KEY_DTYPE, device=dev)
        ck[:m] = sk[c0 : c0 + m]
        cv = torch.zeros((b,), dtype=VAL_DTYPE, device=dev)
        cv[:m] = sv[c0 : c0 + m]
        i = 0
        while i < len(lk) and occ[i]:
            # carry is newer than level i's resident run
            ck, cv = _merge_runs(ck, cv, lk[i], lv[i])
            lk[i] = torch.full_like(lk[i], EMPTY)
            occ[i] = False
            i += 1
        if i >= len(lk):
            raise RuntimeError("LSM levels exhausted; increase num_levels")
        # the carry of level i holds b * 2**i pairs: the level's whole run
        lk[i], lv[i] = ck, cv
        occ[i] = True
    return LSMState(
        level_keys=tuple(lk),
        level_vals=tuple(lv),
        occupied=torch.tensor(occ, dtype=torch.bool, device=dev),
    )


def _level_find(lk: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Each query's lower-bound position in a level, clamped to its last slot."""
    pos = torch.searchsorted(lk, q, side="left", out_int32=True)
    return torch.clamp(pos, max=lk.shape[0] - 1)


def point_query(state: LSMState, queries) -> torch.Tensor:
    """Search every level, newest (smallest) first; first hit decides."""
    q = torch.as_tensor(queries).to(device=state.occupied.device, dtype=KEY_DTYPE)
    result = torch.full(q.shape, NOT_FOUND, dtype=VAL_DTYPE, device=q.device)
    decided = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    for i in range(state.num_levels):
        lk, lv = state.level_keys[i], state.level_vals[i]
        pos_c = _level_find(lk, q)
        hit = (lk[pos_c] == q) & state.occupied[i]
        val = lv[pos_c]
        newly = hit & ~decided
        result = torch.where(newly, torch.where(val == TOMBSTONE, NOT_FOUND, val), result)
        decided |= hit
    return result


def delete(state: LSMState, sorted_keys) -> LSMState:
    """In-place tombstone at the key's newest occurrence (LSMu semantics)."""
    dq = torch.as_tensor(sorted_keys).to(device=state.occupied.device, dtype=KEY_DTYPE)
    decided = torch.zeros(dq.shape, dtype=torch.bool, device=dq.device)
    new_vals = []
    for i in range(state.num_levels):
        lk, lv = state.level_keys[i], state.level_vals[i]
        pos_c = _level_find(lk, dq)
        hit = (lk[pos_c] == dq) & state.occupied[i] & ~decided
        # the reference's race-free OR of hits into a mask: every write is
        # True, so repeated positions agree; misses go to a dump slot
        marks = torch.zeros(lk.shape[0] + 1, dtype=torch.bool, device=dq.device)
        marks[torch.where(hit, pos_c, lk.shape[0])] = True
        new_vals.append(torch.where(marks[:-1], TOMBSTONE, lv))
        decided |= hit
    return LSMState(
        level_keys=state.level_keys, level_vals=tuple(new_vals), occupied=state.occupied
    )


def successor_query(state: LSMState, queries, *, max_skips: int = 64):
    """Smallest live key ≥ q.  Each round proposes the min candidate across
    levels, then validates it (newest occurrence not tombstoned).  Dead
    candidates force another round — the per-thread skip scan the paper
    blames for LSMu's successor collapse."""
    q = torch.as_tensor(queries).to(device=state.occupied.device, dtype=KEY_DTYPE)

    def candidate(q):
        best = torch.full(q.shape, EMPTY, dtype=KEY_DTYPE, device=q.device)
        for i in range(state.num_levels):
            lk = state.level_keys[i]
            k = torch.where(state.occupied[i], lk[_level_find(lk, q)], EMPTY)
            best = torch.minimum(best, k)
        return best

    done = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    res = torch.full(q.shape, EMPTY, dtype=KEY_DTYPE, device=q.device)
    it = 0
    while it < max_skips and bool((~done).any()):
        cand = candidate(q)
        exhausted = cand == EMPTY
        val = point_query(state, cand)  # liveness check (newest occurrence)
        live = (val != NOT_FOUND) & ~exhausted
        res = torch.where(~done & live, cand, res)
        res = torch.where(~done & exhausted, EMPTY, res)
        done = done | live | exhausted
        q = torch.where(done, q, cand + 1)
        it += 1
    vals = point_query(state, torch.where(res == EMPTY, 0, res))
    return res, torch.where(res == EMPTY, NOT_FOUND, vals)
