"""Standalone dense RANGE scans (port of ``repro/kernels/flix_range.py``).

A RANGE op is ``[lo, hi)``; a batch of them shares one static
``max_results`` output budget, and the results are packed densely at
exclusive-scan offsets: the contract of ``core.query.dense_range_scan``,
which the fused apply path also keeps.  Two CUDA launches
(``csrc/flix_range.cu``) around a torch seam:

  * **pass 1, count** (``flix_range_count``): a thread per op finds the
    global rank of ``lo`` from its bucket's live-count fence ``pref[b]``,
    the keys of the nodes wholly below it and its position in the node
    that reaches it, and the same for ``hi`` where ``hi > lo`` (the two
    searches in lockstep, one walk of the rows when both bounds share a
    bucket); it writes
    ``rank(lo)`` and the exact int32 count ``max(rank(hi) - rank(lo), 0)``
    of stored keys in ``[lo, hi)``.  An optional ``is_range`` mask gives the
    other ops 0 and 0: the fused path ranks its few RANGE ops so
    (``flix_apply.range_slots``, counted as ``flix_apply_rank``).  Keys are
    packed at the front of each node and chain-ordered (I1/I2), so no
    per-bucket row sort is needed, where the TPU wrapper sorted every
    bucket row (O(nb·cap)) and its kernel voted every stripe against every
    op window.
  * **seam**: the node metadata (:func:`node_metadata`, one search of each
    node row), the live-count prefix ``pref`` (``core.query.live_prefix``),
    then ``range_offsets`` and ``range_slot_ranks``, the formulas every
    executor shares, turn the counts into segments and one global rank per
    output slot.
  * **pass 2, scatter** (``flix_range_scatter``): a thread per 1, 2 or 4
    consecutive output slots finds each slot's bucket by a search of
    ``pref`` (the searches in lockstep), its node by the running node
    counts, and reads the key and value of its rank; the gather kernel of
    the fused apply path's RANGE phase, launched here under its own count.

Each launch wrapper checks its tensors, runs its plain torch version when
they lie on the CPU, and otherwise launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.query import (
    gather_ranks,
    live_prefix,
    node_rank,
    range_offsets,
    range_slot_ranks,
)
from repro_torch.core.state import EMPTY
from repro_torch.kernels._launch import check, launch

_COUNT_INPUTS = ("keys", "node_count", "node_max", "mkba", "pref", "lo", "hi")


def flix_range_count(keys, node_count, node_max, mkba, pref, lo, hi, *, is_range=None,
                     kernel: str = "flix_range_count"):
    """Pass 1: ``(rank_lo, count)`` per op — the global rank of ``lo`` and the
    number of stored keys in ``[lo, hi)``; 0 and 0 for an op outside the
    optional bool mask ``is_range``.  The ops need no order.  The CUDA
    kernel on the card, counted under ``kernel``;
    :func:`flix_range_count_reference` on the CPU."""
    nb, npb, ns = keys.shape
    dev = keys.device
    args = (keys, node_count, node_max, mkba, pref, lo, hi)
    check(dev, _COUNT_INPUTS, args)
    if node_count.shape != (nb, npb) or node_max.shape != (nb, npb):
        raise ValueError("range count: node_count or node_max disagrees with keys")
    if mkba.shape != (nb,) or pref.shape != (nb + 1,):
        raise ValueError("range count: mkba or pref disagrees with keys")
    if lo.shape != hi.shape or lo.dim() != 1:
        raise ValueError("range count: lo and hi must be aligned 1-d columns")
    if is_range is not None:
        check(dev, ("is_range",), (is_range,), dtypes=(torch.bool,))
        if is_range.shape != lo.shape:
            raise ValueError("range count: is_range must be aligned with lo")
    if dev.type == "cpu":
        return flix_range_count_reference(*args, is_range=is_range)
    q = lo.shape[0]
    rank_lo = torch.empty((q,), dtype=torch.int32, device=dev)
    count = torch.empty((q,), dtype=torch.int32, device=dev)
    launch(kernel, "flix_range_count_launch", dev, *args, is_range, rank_lo, count,
           q, nb, npb, ns)
    return rank_lo, count


def flix_range_count_reference(keys, node_count, node_max, mkba, pref, lo, hi, *,
                               is_range=None):
    """Plain torch version of pass 1 (same inputs and outputs)."""
    meta = (keys, node_count, node_max, mkba, pref)
    rank_lo = node_rank(*meta, lo)
    count = torch.clamp(node_rank(*meta, hi) - rank_lo, min=0)
    if is_range is None:
        return rank_lo, count
    return torch.where(is_range, rank_lo, 0), torch.where(is_range, count, 0)


def range_gather(g, pref, node_count, keys, vals, *, kernel: str):
    """Dense RANGE output: slot p holds the (key, val) of global rank
    ``g[p]`` (EMPTY / NOT_FOUND where ``g[p] < 0``).  The CUDA gather kernel
    on the card, counted under ``kernel``; :func:`flix_range_gather_reference`
    on the CPU."""
    nb, npb, ns = keys.shape
    dev = keys.device
    args = (g, pref, node_count, keys, vals)
    check(dev, ("g", "pref", "node_count", "keys", "vals"), args)
    if pref.shape != (nb + 1,) or node_count.shape != (nb, npb):
        raise ValueError("range gather: pref or node_count disagrees with keys")
    if vals.shape != keys.shape:
        raise ValueError("range gather: vals disagree with keys")
    if dev.type == "cpu":
        return flix_range_gather_reference(*args)
    mr = g.shape[0]
    rk = torch.empty((mr,), dtype=torch.int32, device=dev)
    rv = torch.empty((mr,), dtype=torch.int32, device=dev)
    launch(kernel, "flix_range_gather_launch", dev, *args, rk, rv, mr, nb, npb, ns)
    return rk, rv


def flix_range_gather_reference(g, pref, node_count, keys, vals):
    """Plain torch version of the gather (same inputs and outputs)."""
    return gather_ranks(g, pref, node_count, keys, vals)


def flix_range_scatter(g, pref, node_count, keys, vals):
    """Pass 2: the gather, counted as ``flix_range_scatter``."""
    return range_gather(g, pref, node_count, keys, vals, kernel="flix_range_scatter")


def node_metadata(keys3d):
    """``(node_count, node_max)`` [nb, npb] of a key plane whose node rows
    are ascending with EMPTY padding (I1): a row's count is where EMPTY would
    sort into it, one binary search of the row, and its max the key just
    before.  Equal to ``core.insert._node_metadata``'s first two outputs on
    such planes, without its [nb, npb, ns] bool plane."""
    nb, npb, ns = keys3d.shape
    rows = keys3d.reshape(nb * npb, ns)
    empty = torch.full((nb * npb, 1), EMPTY, dtype=keys3d.dtype, device=keys3d.device)
    count = torch.searchsorted(rows, empty, out_int32=True)
    last = rows.gather(1, torch.clamp(count - 1, min=0).long())
    node_max = torch.where(count > 0, last, EMPTY)
    return count.reshape(nb, npb), node_max.reshape(nb, npb)


def flix_range(keys3d, vals3d, mkba, sorted_lo, hi, *, max_results: int):
    """Dense ``[lo, hi)`` scans, the counterpart of ``flix_range_pallas``.

    ``sorted_lo`` [Q] is ascending (the batch's one sort) and ``hi`` [Q]
    aligned with it.  Returns ``(keys [max_results], vals [max_results],
    start [Q], count [Q], truncated)``, equal to ``core.dense_range_scan``
    with every op a RANGE op.  The signature carries only the planes, as the
    reference's does, so the node metadata is derived from ``keys3d`` by
    :func:`node_metadata` (where the TPU wrapper sorted every bucket row).
    """
    node_count, node_max = node_metadata(keys3d)
    lo = sorted_lo.to(torch.int32)
    hi = hi.to(torch.int32)
    pref = live_prefix(node_count)
    rank_lo, full = flix_range_count(keys3d, node_count, node_max, mkba, pref, lo, hi)
    is_range = torch.ones(lo.shape, dtype=torch.bool, device=lo.device)
    start, emit, total_emit, truncated = range_offsets(full, is_range, max_results)
    g = range_slot_ranks(rank_lo, start, total_emit, max_results)
    rk, rv = flix_range_scatter(g, pref, node_count, keys3d, vals3d)
    return rk, rv, start, emit, truncated
