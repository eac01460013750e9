"""TL-Bulk deletion kernel (port of ``repro/kernels/flix_delete.py``; paper
§4.4).

:func:`flix_delete` keeps the TPU wrapper's pre-filter: the batch is cut to
the keys that a point query finds (``flix_query``'s kernel on the card) and
re-sorted with EMPTY in place of the rest.  :func:`flix_delete_pass` then
runs ``csrc/flix_delete.cu``: persistent warps, one bucket at a time each
(the paper's mapping), with a two-slot ``cp.async`` ring per warp that
stages the next bucket's rows that hold keys (``num_nodes`` of them) and
its slice of the filtered batch.  The slice bounds come from one
``torch.searchsorted`` of the fences in the batch; a slice is cut at
``cap`` entries.  A bucket marks its stored keys by binary search of its
slice, compacts survivors inside their nodes and emptied nodes out of the
chain (the delete half of the update path it shares with the staged stripe
kernel, ``csrc/flix_warp.cuh``), and writes the new stripe (freed slots
hold EMPTY and value 0) with its metadata.  On the CPU it runs
:func:`flix_delete_reference`, the same phases in torch
(``kernels/_phases.py``) over whole stripes.

What the pre-filter and the cut at ``cap`` keep from the reference, against
``core.delete``'s exact membership (ROADMAP Queue 3): a stored key whose
value is NOT_FOUND is never deleted, and a bucket whose slice holds more
than ``cap`` entries (present keys repeated in the batch) deletes only the
keys of its first ``cap`` entries.
"""

from __future__ import annotations

import torch

from repro_torch.core.state import EMPTY, NOT_FOUND, FliXState, bucket_chunks
from repro_torch.kernels._launch import check, check_smem, launch
from repro_torch.kernels._phases import compact_chunk, slice_hits
from repro_torch.kernels.flix_query import flix_point_query

_INPUTS = ("num_nodes", "keys", "vals", "mkba", "sorted_del_keys")


def flix_delete_pass(num_nodes, keys, vals, mkba, sorted_del_keys):
    """Delete every bucket's keys found in its slice of a sorted batch (cut
    at ``cap``).  The CUDA kernel on the card, :func:`flix_delete_reference`
    on the CPU.  ``num_nodes`` [nb] tells the kernel which rows hold keys.
    Returns ``(keys, vals, node_count, node_max, num_nodes)``.
    """
    nb, npb, ns = keys.shape
    args = (num_nodes, keys, vals, mkba, sorted_del_keys)
    dev = keys.device
    check(dev, _INPUTS, args)
    if vals.shape != keys.shape or mkba.shape != (nb,) or num_nodes.shape != (nb,):
        raise ValueError("keys, vals, mkba and num_nodes disagree in geometry")
    if sorted_del_keys.dim() != 1:
        raise ValueError("sorted_del_keys must be one-dimensional")
    if dev.type == "cpu":
        return flix_delete_reference(*args)

    check_smem("flix_delete", "flix_delete_smem_bytes", npb, ns, dev)
    outs = (
        torch.empty_like(keys),
        torch.empty_like(vals),
        torch.empty((nb, npb), dtype=torch.int32, device=dev),
        torch.empty((nb, npb), dtype=torch.int32, device=dev),
        torch.empty((nb,), dtype=torch.int32, device=dev),
    )
    ends = torch.searchsorted(sorted_del_keys, mkba, right=True, out_int32=True)
    launch(
        "flix_delete",
        "flix_delete_launch",
        dev,
        keys,
        vals,
        num_nodes,
        ends,
        sorted_del_keys,
        *outs,
        nb,
        npb,
        ns,
    )
    return outs


def flix_delete_reference(num_nodes, keys, vals, mkba, sorted_del_keys):
    """Plain torch version of the delete pass: same inputs and outputs as
    :func:`flix_delete_pass`, run in bucket chunks over whole stripes, as
    the Pallas kernel reads them (``num_nodes`` is not read)."""
    nb, npb, ns = keys.shape
    S = npb * ns
    de = torch.searchsorted(sorted_del_keys, mkba, right=True, out_int32=True)
    ds = torch.cat([torch.zeros_like(de[:1]), de[:-1]])
    de = ds + torch.clamp(de - ds, max=S)  # the slice cut at cap
    out_k, out_v = torch.empty_like(keys), torch.empty_like(vals)
    cnt = torch.empty((nb, npb), dtype=torch.int32, device=keys.device)
    mx = torch.empty_like(cnt)
    nn = torch.empty((nb,), dtype=torch.int32, device=keys.device)
    for c0, c1 in bucket_chunks(nb, 4 * S):
        A = keys[c0:c1].reshape(c1 - c0, S)
        hit = slice_hits(sorted_del_keys, A, ds[c0:c1], de[c0:c1])
        part = compact_chunk(A, vals[c0:c1].reshape(c1 - c0, S), hit, npb, ns)
        for out, p in zip((out_k, out_v, cnt, mx, nn), part):
            out[c0:c1] = p
    return out_k, out_v, cnt, mx, nn


def flix_delete(state: FliXState, sorted_del_keys):
    """TL-Bulk deletion of a sorted batch.  Returns the new state."""
    dk = sorted_del_keys.to(torch.int32).contiguous()
    present = (
        flix_point_query(state.keys, state.vals, state.node_max, state.mkba, dk)
        != NOT_FOUND
    )
    dk = torch.sort(torch.where(present, dk, EMPTY), stable=True).values
    okeys, ovals, ocnt, omax, onn = flix_delete_pass(
        state.num_nodes, state.keys, state.vals, state.mkba, dk
    )
    return FliXState(
        keys=okeys,
        vals=ovals,
        node_count=ocnt,
        node_max=omax,
        num_nodes=onn,
        mkba=state.mkba,
        needs_restructure=state.needs_restructure,
    )
