"""Initial build (port of ``repro/core/build.py``; paper §3.2, Figure 3a).

The sorted build keys are grouped into partitions of ``p = node_size * fill``
(default fill = 1/2 → nodes start half full).  Each partition becomes one
bucket holding a single node; its largest key is that bucket's MKBA entry.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.state import (
    EMPTY,
    KEY_DTYPE,
    MAX_VALID,
    VAL_DTYPE,
    FliXState,
    resolve_device,
)


def plan_geometry(
    n_keys: int,
    *,
    node_size: int = 32,
    nodes_per_bucket: int = 16,
    fill: float = 0.5,
) -> tuple[int, int, int]:
    """Host-side geometry: (num_buckets, nodes_per_bucket, node_size)."""
    p = max(1, int(node_size * fill))
    num_buckets = max(1, math.ceil(n_keys / p))
    return num_buckets, nodes_per_bucket, node_size


def build_from_sorted(
    sorted_keys: torch.Tensor,
    sorted_vals: torch.Tensor,
    *,
    num_buckets: int,
    nodes_per_bucket: int = 16,
    node_size: int = 32,
    fill: float = 0.5,
) -> FliXState:
    """Build from a sorted, deduplicated key/val batch (EMPTY-padded ok),
    on the batch's device.  Keys beyond the first ``num_buckets * p`` valid
    entries must not exist (geometry comes from ``plan_geometry``)."""
    nb, npb, ns = num_buckets, nodes_per_bucket, node_size
    p = max(1, int(ns * fill))
    dev = sorted_keys.device

    take = min(sorted_keys.shape[0], nb * p)
    k = torch.full((nb * p,), EMPTY, dtype=KEY_DTYPE, device=dev)
    k[:take] = sorted_keys[:take]
    v = torch.zeros((nb * p,), dtype=VAL_DTYPE, device=dev)
    v[:take] = sorted_vals[:take]

    bkeys = k.reshape(nb, p)  # partition i → bucket i
    bvals = v.reshape(nb, p)

    keys = torch.full((nb, npb, ns), EMPTY, dtype=KEY_DTYPE, device=dev)
    vals = torch.zeros((nb, npb, ns), dtype=VAL_DTYPE, device=dev)
    keys[:, 0, :p] = bkeys
    vals[:, 0, :p] = bvals

    counts0 = (bkeys != EMPTY).sum(dim=1, dtype=torch.int32)  # [nb]
    node_count = torch.zeros((nb, npb), dtype=torch.int32, device=dev)
    node_count[:, 0] = counts0
    last = torch.clamp(counts0 - 1, min=0).long()
    nmax0 = torch.where(counts0 > 0, bkeys.gather(1, last[:, None])[:, 0], EMPTY)
    node_max = torch.full((nb, npb), EMPTY, dtype=KEY_DTYPE, device=dev)
    node_max[:, 0] = nmax0
    num_nodes = (counts0 > 0).to(torch.int32)

    # MKBA: bucket i's fence is its largest build key; the final bucket (and
    # any empty trailing buckets) extend to MAX_VALID so the fences cover the
    # whole key space.  A running max keeps them ascending.
    mkba = torch.where(counts0 > 0, nmax0, MAX_VALID).to(KEY_DTYPE)
    mkba[-1] = MAX_VALID
    mkba = torch.cummax(mkba, dim=0).values

    return FliXState(
        keys=keys,
        vals=vals,
        node_count=node_count,
        node_max=node_max,
        num_nodes=num_nodes,
        mkba=mkba,
        needs_restructure=torch.zeros((), dtype=torch.bool, device=dev),
    )


def build(
    keys,
    vals,
    *,
    node_size: int = 32,
    nodes_per_bucket: int = 16,
    fill: float = 0.5,
    device=None,
) -> FliXState:
    """Convenience build: sorts, dedups, plans geometry, builds.

    ``keys``/``vals`` are numpy arrays or tensors.  The state lives on
    ``device``: the card unless the caller names another (``"cpu"``).
    """
    from repro_torch.core.batch import dedup_last_wins, sort_batch

    dev = resolve_device(device)
    keys = torch.as_tensor(keys).to(device=dev, dtype=KEY_DTYPE)
    vals = torch.as_tensor(vals).to(device=dev, dtype=VAL_DTYPE)
    skeys, svals = sort_batch(keys, vals)
    skeys, svals, count = dedup_last_wins(skeys, svals)
    n = int(count)
    nb, npb, ns = plan_geometry(
        n, node_size=node_size, nodes_per_bucket=nodes_per_bucket, fill=fill
    )
    return build_from_sorted(
        skeys, svals, num_buckets=nb, nodes_per_bucket=npb, node_size=ns, fill=fill
    )
