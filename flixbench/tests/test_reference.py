"""The plain references against the program on the CPU, at tiny sizes.

Run from the repository's root: ``PYTHONPATH=src python -m pytest -q
flixbench/tests``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from flixbench import opcodes
from flixbench.reference import sorted_index

def program_batch(state, tags, keys, vals, max_results):
    from repro_torch import core

    ops, perm = core.make_ops(tags, keys, vals, device="cpu")
    cfg = core.ExecConfig(max_results=max_results)
    new, res, stats = core.apply_ops_safe(state, ops, config=cfg)
    out = {k: core.unsort(res[k], perm) for k in ("value", "succ_key", "range_start",
                                                   "range_count")}
    out.update(range_key=res["range_key"], range_val=res["range_val"])
    return new, out, stats


def random_batch(rng, live, space, n):
    """Inserts (fresh and upserts), deletes (live and absent), points,
    successors (past the end too), ranges (empty, reversed, wide) and NOP
    slots, one update op per key."""
    live = np.asarray(sorted(live))
    absent = np.setdiff1d(rng.choice(space, 4 * n, replace=False), live)
    upd = rng.permutation(np.concatenate([live, absent[: n]]))[: n]
    kinds = rng.integers(0, 2, upd.size)
    tags = np.where(kinds == 0, opcodes.INSERT, opcodes.DELETE)
    vals = rng.integers(0, 1 << 30, upd.size)
    reads = rng.integers(0, space + 10, 3 * n)
    rtag = rng.choice([opcodes.POINT, opcodes.SUCCESSOR, opcodes.RANGE], reads.size)
    rval = np.where(rtag == opcodes.RANGE, reads + rng.integers(-5, space // 8, reads.size), 0)
    nops = n // 8
    tags = np.concatenate([tags, rtag, np.full(nops, opcodes.NOP)]).astype(np.int32)
    keys = np.concatenate([upd, reads, np.full(nops, opcodes.EMPTY)]).astype(np.int32)
    vals = np.concatenate([vals, rval, np.zeros(nops)]).astype(np.int32)
    order = rng.permutation(tags.size)
    return tags[order], keys[order], vals[order]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("max_results", [16, 4096])
def test_sorted_index_matches_the_program(seed, max_results):
    from repro_torch import core

    rng = np.random.default_rng(seed)
    space = 1 << 12
    keys0 = np.sort(rng.choice(space, 700, replace=False)).astype(np.int32)
    vals0 = rng.integers(0, 1 << 30, keys0.size).astype(np.int32)
    state = core.build(keys0, vals0, node_size=8, nodes_per_bucket=4, device="cpu")
    rk, rv = torch.from_numpy(keys0), torch.from_numpy(vals0)
    for _ in range(4):
        tags, keys, vals = random_batch(rng, rk.numpy(), space, 200)
        t, k, v = (torch.from_numpy(a) for a in (tags, keys, vals))
        state, out, stats = program_batch(state, t, k, v, max_results)
        rk, rv, ans, ref_stats = sorted_index.run_batch(rk, rv, t, k, v, max_results)
        for name, want in ans.items():
            assert torch.equal(out[name], want), name
        for name, want in ref_stats.items():
            assert int(stats[name]) == want, name
        live = state.keys != opcodes.EMPTY
        got_k, order = torch.sort(state.keys[live])
        assert torch.equal(got_k, rk) and torch.equal(state.vals[live][order], rv)


def test_sorted_index_truncates_in_ascending_lo():
    keys = torch.arange(0, 100, 2, dtype=torch.int32)
    vals = keys * 10
    tags = torch.full((3,), opcodes.RANGE, dtype=torch.int32)
    lo = torch.tensor([50, 10, 10], dtype=torch.int32)
    hi = torch.tensor([60, 20, 14], dtype=torch.int32)
    ans = sorted_index.answer_reads(keys, vals, tags, lo, hi, max_results=7)
    # ascending lo, ties in submission order: [10,20) 5 keys, [10,14) 2, [50,60) none left
    assert ans["range_start"].tolist() == [7, 0, 5]
    assert ans["range_count"].tolist() == [0, 5, 2]
    assert ans["range_key"].tolist() == [10, 12, 14, 16, 18, 10, 12]
    assert ans["range_truncated"] == 1
