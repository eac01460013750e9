"""Warpcore-style GPU hash table baseline (port of
``repro/core/baselines/hash_table.py``; paper §2.2.3).

Open addressing with linear probing, fixed capacity (initialized at a load
factor, per §5.1 at 80%), tombstone-based deletion (marked, not reclaimed
for probe-chain purposes until reinsertion), no ordered operations.

Batched data-parallel emulation of concurrent insertion: each round, every
unplaced key claims its current probe slot via a scatter-min; losers advance
to the next probe distance.  Tombstone slots are reusable for insertion but
do not terminate probe chains, which is why miss queries slow down after
deletion rounds (paper §6.1).

The reference's ``jax.lax.while_loop`` is a host loop here that stops on
the same condition (every key done, or ``max_probe`` rounds): one host sync
a round.  Its dropped scatters (``mode="drop"`` at index ``cap``) write a
dump slot one past the table, cut off at the end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.state import EMPTY, KEY_DTYPE, NOT_FOUND, VAL_DTYPE, resolve_device

S_EMPTY, S_FULL, S_TOMB = 0, 1, 2  # int8 slot states
_MULT = 2654435761  # Knuth multiplicative hash, taken mod 2^32


@dataclasses.dataclass(frozen=True)
class HashTableState:
    keys: torch.Tensor  # [cap] KEY_DTYPE
    vals: torch.Tensor  # [cap] VAL_DTYPE
    slot: torch.Tensor  # [cap] int8 state

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def live_keys(self) -> torch.Tensor:
        return (self.slot == S_FULL).sum(dtype=torch.int32)

    def memory_bytes(self) -> int:
        return self.keys.numel() * 4 + self.vals.numel() * 4 + self.slot.numel()

    def load_factor(self) -> torch.Tensor:
        """Share of slots not EMPTY, float32: the exact count over the
        capacity (the reference takes a float32 mean, summed in its order)."""
        used = (self.slot != S_EMPTY).sum(dtype=torch.int64)
        return (used.to(torch.float64) / self.capacity).to(torch.float32)


def state_from_numpy(arrays: dict, device) -> HashTableState:
    """A state from host arrays ``keys``, ``vals`` and ``slot``."""
    dev = resolve_device(device)
    return HashTableState(
        keys=torch.from_numpy(np.asarray(arrays["keys"], np.int32).copy()).to(dev),
        vals=torch.from_numpy(np.asarray(arrays["vals"], np.int32).copy()).to(dev),
        slot=torch.from_numpy(np.asarray(arrays["slot"], np.int8).copy()).to(dev),
    )


def empty_state(capacity: int, *, device=None) -> HashTableState:
    dev = resolve_device(device)
    return HashTableState(
        keys=torch.full((capacity,), EMPTY, dtype=KEY_DTYPE, device=dev),
        vals=torch.zeros((capacity,), dtype=VAL_DTYPE, device=dev),
        slot=torch.zeros((capacity,), dtype=torch.int8, device=dev),
    )


def _hash(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    """The reference's ``uint32(key) * 2654435761 mod 2^32 mod capacity``,
    in int64 without overflow: the key's two 16-bit halves multiplied
    apart, the high half's product cut to the 16 bits that survive the
    shift."""
    k = keys.to(torch.int64) & 0xFFFFFFFF
    lo, hi = k & 0xFFFF, k >> 16
    h = (lo * _MULT + (((hi * _MULT) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return h % capacity


def _with_dump(t: torch.Tensor, fill) -> torch.Tensor:
    """``t`` with one dump slot appended (the reference's dropped index)."""
    return torch.cat([t, t.new_full((1,), fill)])


def _drop(mask: torch.Tensor, idx: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.where(mask, idx, cap)


def insert(state: HashTableState, keys, vals, *, max_probe: int = 64):
    """Batched insert/upsert. Batch must be deduplicated.  Returns the new
    state and the count of keys left unplaced after ``max_probe`` rounds."""
    cap = state.capacity
    dev = state.keys.device
    k = torch.as_tensor(keys).to(device=dev, dtype=KEY_DTYPE)
    v = torch.as_tensor(vals).to(device=dev, dtype=VAL_DTYPE)
    h0 = _hash(k, cap)
    valid = k != EMPTY
    tk, tv = _with_dump(state.keys, EMPTY), _with_dump(state.vals, 0)
    ts = _with_dump(state.slot, S_EMPTY)
    placed = ~valid
    dist = 0
    while dist < max_probe and bool((~placed).any()):
        idx = (h0 + dist) % cap
        cur_key = tk[idx]
        cur_state = ts[idx]
        # upsert: same key already resident at this probe slot
        match = (cur_state == S_FULL) & (cur_key == k) & ~placed & valid
        tv[_drop(match, idx, cap)] = v
        placed = placed | match
        # claim empty/tomb slots via scatter-min of the key value
        want = (cur_state != S_FULL) & ~placed & valid
        claims = torch.full((cap + 1,), EMPTY, dtype=KEY_DTYPE, device=dev)
        claims.scatter_reduce_(0, _drop(want, idx, cap), k, "amin", include_self=True)
        won = want & (claims[idx] == k)
        at = _drop(won, idx, cap)
        tk[at] = k
        tv[at] = v
        ts[at] = S_FULL
        placed = placed | won
        dist += 1
    new = HashTableState(keys=tk[:cap], vals=tv[:cap], slot=ts[:cap])
    return new, (~placed & valid).sum(dtype=torch.int32)


def point_query(state: HashTableState, queries, *, max_probe: int = 64) -> torch.Tensor:
    cap = state.capacity
    q = torch.as_tensor(queries).to(device=state.keys.device, dtype=KEY_DTYPE)
    h0 = _hash(q, cap)
    res = torch.full(q.shape, NOT_FOUND, dtype=VAL_DTYPE, device=q.device)
    done = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    dist = 0
    while dist < max_probe and bool((~done).any()):
        idx = (h0 + dist) % cap
        ck, cs = state.keys[idx], state.slot[idx]
        hit = (cs == S_FULL) & (ck == q)
        miss = cs == S_EMPTY  # tombstones do NOT stop the probe chain
        res = torch.where(hit & ~done, state.vals[idx], res)
        done = done | hit | miss
        dist += 1
    return res


def delete(state: HashTableState, keys, *, max_probe: int = 64) -> HashTableState:
    """Tombstone the slot holding each key (marked, not reclaimed)."""
    cap = state.capacity
    k = torch.as_tensor(keys).to(device=state.keys.device, dtype=KEY_DTYPE)
    h0 = _hash(k, cap)
    ts = _with_dump(state.slot, S_EMPTY)
    done = torch.zeros(k.shape, dtype=torch.bool, device=k.device)
    dist = 0
    while dist < max_probe and bool((~done).any()):
        idx = (h0 + dist) % cap
        ck, cs = state.keys[idx], ts[idx]
        hit = (cs == S_FULL) & (ck == k)
        miss = cs == S_EMPTY
        ts[_drop(hit & ~done, idx, cap)] = S_TOMB
        done = done | hit | miss
        dist += 1
    return HashTableState(keys=state.keys, vals=state.vals, slot=ts[:cap])
