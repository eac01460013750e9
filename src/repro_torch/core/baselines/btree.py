"""B-tree baseline (port of ``repro/core/baselines/btree.py``; paper
§2.2.2, Awad et al.'s GPU B-tree).

The *index-layer* counterpoint to FliX: the data layer is identical
(bucketed leaves, the port's ``FliXState``), but every query traverses a
fanout-``f`` separator tree root→leaf with one gather per level (the
warp-cooperative traversal of the paper's Figure 1a), instead of one
searchsorted over the batch.  Updates reuse the leaf-level bulk machinery
(``core.insert``, ``core.insert_safe``, ``core.delete``) and then *repair
the index layer* (separator arrays rebuilt from leaf maxes) — the
maintenance cost the flipped paradigm eliminates.

Honesty note (the reference's): Awad et al. split nodes proactively in
place; this index repair is a rebuild of the separator arrays.  Traversal
cost — what the paper's query comparisons measure — is faithful; update
cost is a structurally-honest stand-in.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.build import build as _flix_build
from repro_torch.core.delete import delete as _flix_delete
from repro_torch.core.insert import insert as _flix_insert
from repro_torch.core.insert import insert_safe as _flix_insert_safe
from repro_torch.core.state import (
    KEY_DTYPE,
    MAX_VALID,
    NOT_FOUND,
    FliXState,
    resolve_device,
)
from repro_torch.core.state import state_from_numpy as _flix_from_numpy

FANOUT = 16  # paper uses 15 keys + pointers per 128B node; we use 16 lanes


@dataclasses.dataclass(frozen=True)
class BTreeState:
    data: FliXState  # leaves (bucket chains)
    # levels[0] = root separators ... levels[-1] = lowest internal level.
    # level tensors: [n_nodes_at_level * FANOUT] separator keys, MAX_VALID-padded.
    levels: tuple[torch.Tensor, ...]

    def live_keys(self) -> torch.Tensor:
        return self.data.live_keys()

    def memory_bytes(self) -> int:
        total = self.data.memory_bytes()
        for lv in self.levels:
            total += lv.numel() * 4
        return total


def state_from_numpy(arrays: dict, device) -> BTreeState:
    """A state from host arrays: ``data``, a dict of the ``FliXState``
    fields (``core.state.state_from_numpy``'s), and the list ``levels``."""
    dev = resolve_device(device)
    return BTreeState(
        data=_flix_from_numpy(arrays["data"], dev),
        levels=tuple(
            torch.from_numpy(np.asarray(a, np.int32).copy()).to(dev) for a in arrays["levels"]
        ),
    )


def _build_index(mkba: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Separator levels over the leaf fences, bottom-up, fanout FANOUT."""
    levels = []
    cur = mkba
    while cur.shape[0] > 1:
        n_nodes = math.ceil(cur.shape[0] / FANOUT)
        padded = torch.full((n_nodes * FANOUT,), MAX_VALID, dtype=KEY_DTYPE, device=mkba.device)
        padded[: cur.shape[0]] = cur
        levels.append(padded)
        cur = padded.view(n_nodes, FANOUT)[:, -1]
    return tuple(reversed(levels))  # root first


def build(
    keys, vals, *, node_size: int = 16, nodes_per_bucket: int = 16, device=None
) -> BTreeState:
    data = _flix_build(
        keys, vals, node_size=node_size, nodes_per_bucket=nodes_per_bucket, device=device
    )
    return BTreeState(data=data, levels=_build_index(data.mkba))


def point_query(state: BTreeState, queries) -> torch.Tensor:
    """Root→leaf traversal: one gather + compare-count per level per query.
    A query above its node's last separator (above ``MAX_VALID``) steps to
    child ``FANOUT``, past the next level's nodes: each gather clamps its
    node index, as JAX clamps an out-of-bounds gather, while the traversal
    carries the node on unclamped."""
    d = state.data
    q = torch.as_tensor(queries).to(device=d.device, dtype=KEY_DTYPE)
    node = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    for lv in state.levels:
        rows = lv.view(-1, FANOUT)
        seps = rows[torch.clamp(node, max=rows.shape[0] - 1)]  # [Q, FANOUT] gather
        child = (seps < q[:, None]).sum(1)  # compare-count
        node = node * FANOUT + child
    leaf = torch.clamp(node, max=d.num_buckets - 1)

    # leaf probe (same data layer as FliX)
    nmax_rows = d.node_max[leaf]
    nidx = (nmax_rows < q[:, None]).sum(1, dtype=torch.int32)
    in_leaf = nidx < d.num_nodes[leaf]
    nidx_c = torch.clamp(nidx, max=d.nodes_per_bucket - 1)
    rows = d.keys[leaf, nidx_c]
    pos = (rows < q[:, None]).sum(1, dtype=torch.int32)
    pos_c = torch.clamp(pos, max=d.node_size - 1)
    hit = in_leaf & (pos < d.node_size) & (rows.gather(1, pos_c[:, None].long())[:, 0] == q)
    vals = d.vals[leaf, nidx_c, pos_c]
    return torch.where(hit, vals, NOT_FOUND)


def insert(state: BTreeState, sorted_keys, sorted_vals) -> BTreeState:
    dev = state.data.device
    k = torch.as_tensor(sorted_keys).to(device=dev, dtype=KEY_DTYPE)
    v = torch.as_tensor(sorted_vals).to(device=dev, dtype=torch.int32)
    data, _ = _flix_insert(state.data, k, v)
    if bool(data.needs_restructure):
        data, _ = _flix_insert_safe(state.data, k, v)
    return BTreeState(data=data, levels=_build_index(data.mkba))


def delete(state: BTreeState, sorted_keys) -> BTreeState:
    k = torch.as_tensor(sorted_keys).to(device=state.data.device, dtype=KEY_DTYPE)
    data, _ = _flix_delete(state.data, k)
    return BTreeState(data=data, levels=_build_index(data.mkba))
