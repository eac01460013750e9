"""Flipped successor queries (port of ``repro/kernels/flix_successor.py``).

:func:`flix_successor` runs two kernels on the card.  First the fence-row
kernel (``csrc/flix_fence_rows.cu``, :func:`fence_rows`): ``next_key[b]`` /
``next_val[b]``, the smallest key stored in any later bucket and its value,
the rows that the Pallas wrapper computes in jnp beside its kernel.  Then
the successor kernel (``csrc/flix_successor.cu``, :func:`successor_pass`),
in the point-query kernel's design: persistent warps, each owning a run of
buckets, find the run's first query by one 32-ary search of the sorted
batch and answer its queries in windows of 32, a lane per query.  A query
at or below its bucket's largest key takes the in-bucket candidate; a query
past it takes the bucket's fence row.  On the CPU both wrappers run their
plain versions: :func:`flix_successor_reference`, the port of
``repro/kernels/ref.py:flix_successor_ref``, and :func:`next_rows`, the
core's ``_successor_fence_rows``, whose suffix minimum breaks ties toward
the higher bucket as the reference does.
"""

from __future__ import annotations

import torch

from repro_torch.core.query import _successor_fence_rows
from repro_torch.core.state import EMPTY, NOT_FOUND
from repro_torch.kernels._build import load_library
from repro_torch.kernels._launch import _require_cuda, check, launch
from repro_torch.kernels.flix_query import check_raw, query_chunks


def next_rows(keys3d, vals3d, node_max=None, *, num_nodes=None):
    """``(next_key, next_val)`` [nb]: the smallest key stored in any bucket
    after ``b`` (EMPTY if none) and its value, the core's successor fence
    rows shifted by one.  A bucket counts as non-empty where ``num_nodes``
    is positive when it is given (the fused apply's post-update state),
    else where any of its ``node_max`` entries is not EMPTY (the reference
    derives ``num_nodes`` from ``node_max``).  Plain torch: the version of
    :func:`fence_rows` that the CPU runs."""
    if num_nodes is None:
        num_nodes = (node_max != EMPTY).sum(1, dtype=torch.int32)
    smin_pad, sidx_pad = _successor_fence_rows(keys3d, num_nodes)
    return smin_pad[1:], vals3d[sidx_pad[1:].long(), 0, 0]


def fence_rows(keys3d, vals3d, node_max=None, *, num_nodes=None):
    """:func:`next_rows` by the fence-row kernel on the card (two launches,
    counted as one), by :func:`next_rows` itself on the CPU.  Give exactly
    one of ``node_max`` [nb, npb] and ``num_nodes`` [nb]."""
    nb, npb, ns = keys3d.shape
    if (node_max is None) == (num_nodes is None):
        raise ValueError("fence_rows takes exactly one of node_max and num_nodes")
    src, want = ("node_max", (nb, npb)) if num_nodes is None else ("num_nodes", (nb,))
    test = node_max if num_nodes is None else num_nodes
    dev = keys3d.device
    check(dev, ("keys3d", "vals3d", src), (keys3d, vals3d, test))
    if vals3d.shape != keys3d.shape or test.shape != want:
        raise ValueError(f"keys3d, vals3d and {src} disagree in geometry")
    if dev.type == "cpu":
        return next_rows(keys3d, vals3d, node_max, num_nodes=num_nodes)
    _require_cuda("flix_fence_rows", dev)
    scratch = torch.empty((load_library().flix_fence_rows_scratch_ints(nb),),
                          dtype=torch.int32, device=dev)
    next_key = torch.empty((nb,), dtype=torch.int32, device=dev)
    next_val = torch.empty((nb,), dtype=torch.int32, device=dev)
    launch("flix_fence_rows", "flix_fence_rows_launch", dev, keys3d, vals3d,
           node_max, num_nodes, scratch, next_key, next_val, nb, npb, ns)
    return next_key, next_val


def flix_successor(keys3d, vals3d, node_max, mkba, sorted_queries):
    """Smallest stored key >= q and its value, per sorted query:
    ``(succ_key | EMPTY, succ_val | NOT_FOUND)``.  On the card the fence-row
    kernel, then the successor kernel (:func:`successor_pass`); on the CPU
    :func:`flix_successor_reference`."""
    check_raw(keys3d, vals3d, node_max, mkba, sorted_queries)
    planes = (keys3d, vals3d, node_max, mkba)
    if keys3d.device.type == "cpu":
        return flix_successor_reference(*planes, sorted_queries)
    next_key, next_val = fence_rows(keys3d, vals3d, node_max)
    return successor_pass(*planes, next_key, next_val, sorted_queries)


def successor_pass(keys3d, vals3d, node_max, mkba, next_key, next_val, sorted_queries):
    """The successor kernel alone, given the fence rows of :func:`fence_rows`
    (CUDA tensors only: the plain version is :func:`flix_successor_reference`
    on the state's planes).  The kernel writes every output."""
    nb, npb, ns = keys3d.shape
    qn = sorted_queries.shape[0]
    dev = keys3d.device
    check(dev, ("next_key", "next_val"), (next_key, next_val))
    if next_key.shape != (nb,) or next_val.shape != (nb,):
        raise ValueError(f"next_key and next_val must have shape ({nb},)")
    out_key = torch.empty((qn,), dtype=torch.int32, device=dev)
    out_val = torch.empty((qn,), dtype=torch.int32, device=dev)
    launch(
        "flix_successor",
        "flix_successor_launch",
        dev,
        keys3d,
        vals3d,
        node_max,
        mkba,
        next_key,
        next_val,
        sorted_queries,
        out_key,
        out_val,
        qn,
        nb,
        npb,
        ns,
    )
    return out_key, out_val


def flix_successor_reference(keys3d, vals3d, node_max, mkba, sorted_queries):
    """Plain torch version: ``ref.flix_successor_ref``, in query chunks.  A
    query above the last fence (only EMPTY) has no successor either way."""
    nb, npb, ns = keys3d.shape
    q = sorted_queries.to(torch.int32)
    num_nodes = (node_max != EMPTY).sum(1, dtype=torch.int32)
    next_key, next_val = next_rows(keys3d, vals3d, num_nodes=num_nodes)
    succ_key = torch.empty_like(q)
    succ_val = torch.empty_like(q)
    for c0, c1 in query_chunks(q.shape[0], npb + ns):
        qc = q[c0:c1]
        b = torch.clamp(torch.searchsorted(mkba, qc, out_int32=True), max=nb - 1)
        nidx = (node_max[b] < qc[:, None]).sum(1, dtype=torch.int32)
        in_bucket = nidx < num_nodes[b]
        nidx_c = torch.clamp(nidx, max=npb - 1)
        rows = keys3d[b, nidx_c]
        pos = (rows < qc[:, None]).sum(1, dtype=torch.int32)
        pos_c = torch.clamp(pos, max=ns - 1)
        in_key = rows.gather(1, pos_c.long()[:, None])[:, 0]
        in_val = vals3d[b, nidx_c, pos_c]
        use_in = in_bucket & (pos < ns)
        k = torch.where(use_in, in_key, next_key[b])
        v = torch.where(use_in, in_val, next_val[b])
        succ_key[c0:c1] = k
        succ_val[c0:c1] = torch.where(k != EMPTY, v, NOT_FOUND)
    return succ_key, succ_val
