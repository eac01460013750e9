"""Least bytes a batch needs, for ``apply_roofline_pct``, and the table of
peaks.

A batch's bytes, counted from the state before it and the batch alone,
whatever executor runs it:

  * every bucket an op routes to (a RANGE op: every bucket from its lo's
    through its hi's; a NOP slot routes nowhere) has its active node rows'
    keys and its ``node_max`` row read once;
  * a bucket with an INSERT or DELETE also has its active rows' values and
    its ``node_count`` row read once, and its active rows (keys and
    values, as many as it has before or after the batch, whichever is
    more), ``node_count``, ``node_max`` and ``num_nodes`` written once;
  * the ops come in (tag, key, value) and the answers go out (value,
    successor key, RANGE start and count an op, the dense RANGE keys and
    values).

Buckets the batch leaves alone are not counted: rewriting them is work a
functional apply chooses, not work the batch needs.  The fences are not
counted either (a search of them reads a few per op).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from flixbench import opcodes

I32 = 4
PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peak(device_name: str, what: str) -> float | None:
    """A published peak of the card (``peaks.json``), None for a card it
    does not list."""
    with open(PEAKS) as f:
        return json.load(f).get(device_name, {}).get(what)


def apply_bytes(batch, mkba, nn_before, nn_after, npb: int, ns: int, max_results: int) -> int:
    nb = mkba.numel()
    tags, keys, vals = batch.tags, batch.keys, batch.vals

    def bucket(q):
        return torch.searchsorted(mkba, q).clamp(max=nb - 1)

    touched = torch.zeros(nb + 1, dtype=torch.int32, device=mkba.device)
    single = (tags != opcodes.RANGE) & (tags != opcodes.NOP)
    touched.index_fill_(0, bucket(keys[single]), 1)
    is_range = tags == opcodes.RANGE
    lo, hi = bucket(keys[is_range]), bucket(vals[is_range])
    hi = torch.maximum(lo, hi)
    cover = torch.zeros(nb + 1, dtype=torch.int32, device=mkba.device)
    cover.index_add_(0, lo, torch.ones_like(lo, dtype=torch.int32))
    cover.index_add_(0, hi + 1, -torch.ones_like(hi, dtype=torch.int32))
    touched = ((touched + torch.cumsum(cover, 0)) > 0)[:nb]
    upd = torch.zeros(nb, dtype=torch.bool, device=mkba.device)
    is_upd = (tags == opcodes.INSERT) | (tags == opcodes.DELETE)
    upd[bucket(keys[is_upd])] = True

    row = ns * I32
    nn0 = nn_before.to(torch.int64)
    nn_max = torch.maximum(nn0, nn_after.to(torch.int64))
    read = int((nn0 * row + npb * I32)[touched].sum())
    read += int((nn0 * row + npb * I32)[upd].sum())
    written = int((nn_max * 2 * row + 2 * npb * I32 + I32)[upd].sum())
    n = tags.numel()
    return read + written + n * 3 * I32 + n * 4 * I32 + max_results * 2 * I32
