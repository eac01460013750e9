"""Flipped point queries (port of ``repro/kernels/flix_query.py``; paper §3.3).

:func:`flix_point_query` runs ``csrc/flix_query.cu``: persistent warps, each
owning a contiguous run of buckets, find the run's first query by one
32-ary search of the sorted batch, then answer its queries in windows of
32, a lane per query (bucket among the run's fences held in lanes, node and
in-node position by compare-counts of the rows).  The kernel writes every
output.  On the CPU it runs :func:`flix_point_query_reference`, the port of
the reference oracle ``repro/kernels/ref.py:flix_point_query_ref``.

The TPU kernel's tiling knobs ``block_q``/``block_b`` have no counterpart.
"""

from __future__ import annotations

import torch

from repro_torch.core.state import CHUNK_ELEMS, NOT_FOUND
from repro_torch.kernels._launch import check, launch

_INPUTS = ("keys3d", "vals3d", "node_max", "mkba", "sorted_queries")


def check_raw(keys3d, vals3d, node_max, mkba, sorted_queries) -> None:
    """The raw-array inputs of the query kernels: int32, contiguous, one
    device, one geometry."""
    nb, npb, _ = keys3d.shape
    args = (keys3d, vals3d, node_max, mkba, sorted_queries)
    check(keys3d.device, _INPUTS, args)
    same = vals3d.shape == keys3d.shape and node_max.shape == (nb, npb)
    if not same or mkba.shape != (nb,):
        raise ValueError("keys3d, vals3d, node_max and mkba disagree in geometry")
    if sorted_queries.dim() != 1:
        raise ValueError("sorted_queries must be one-dimensional")


def flix_point_query(keys3d, vals3d, node_max, mkba, sorted_queries):
    """Value of each sorted query's key, or NOT_FOUND.  The CUDA kernel on
    the card, :func:`flix_point_query_reference` on the CPU.

    ``keys3d``/``vals3d`` [nb, npb, ns], ``node_max`` [nb, npb] and
    ``mkba`` [nb] are a state's planes; ``sorted_queries`` [Q] ascending.
    A query above ``mkba[-1]`` (only ``EMPTY`` when the fences end at
    ``MAX_VALID``) belongs to no bucket and misses.
    """
    check_raw(keys3d, vals3d, node_max, mkba, sorted_queries)
    planes = (keys3d, vals3d, node_max, mkba)
    if keys3d.device.type == "cpu":
        return flix_point_query_reference(*planes, sorted_queries)
    nb, npb, ns = keys3d.shape
    qn = sorted_queries.shape[0]
    out = torch.empty((qn,), dtype=torch.int32, device=keys3d.device)
    launch(
        "flix_point_query",
        "flix_query_launch",
        keys3d.device,
        keys3d,
        vals3d,
        node_max,
        mkba,
        sorted_queries,
        out,
        qn,
        nb,
        npb,
        ns,
    )
    return out


def query_chunks(qn: int, width: int) -> list[tuple[int, int]]:
    """``[c0, c1)`` query ranges whose ``[Q, width]`` row gathers stay at
    ``CHUNK_ELEMS`` elements."""
    step = max(1, CHUNK_ELEMS // max(width, 1))
    return [(c0, min(c0 + step, qn)) for c0 in range(0, qn, step)]


def flix_point_query_reference(keys3d, vals3d, node_max, mkba, sorted_queries):
    """Plain torch version: ``ref.flix_point_query_ref``'s compare-counts,
    in query chunks.  The reference clamps the bucket index to ``nb - 1``;
    here, as in the TPU kernel and ``core.point_query``, a query above the
    last fence misses (the two differ only at ``q == EMPTY``)."""
    nb, npb, ns = keys3d.shape
    q = sorted_queries.to(torch.int32)
    out = torch.empty_like(q)
    for c0, c1 in query_chunks(q.shape[0], npb + ns):
        qc = q[c0:c1]
        braw = torch.searchsorted(mkba, qc, out_int32=True)
        b = torch.clamp(braw, max=nb - 1)
        nidx = (node_max[b] < qc[:, None]).sum(1, dtype=torch.int32)
        nidx_c = torch.clamp(nidx, max=npb - 1)
        rows = keys3d[b, nidx_c]
        pos = (rows < qc[:, None]).sum(1, dtype=torch.int32)
        pos_c = torch.clamp(pos, max=ns - 1)
        key_at = rows.gather(1, pos_c.long()[:, None])[:, 0]
        hit = (braw < nb) & (pos < ns) & (key_at == qc)
        out[c0:c1] = torch.where(hit, vals3d[b, nidx_c, pos_c], NOT_FOUND)
    return out
