"""The port's tile autotuner (``repro_torch.kernels.autotune``) on the CPU:
the counterparts of ``tests/test_autotune.py``'s cases, and tile tables
that load in either package.

The model-mode sweep is a pure function of its inputs; ``ExecConfig.
resolve_blocks`` hands the staged kernel the tuned ``block_b`` (explicit
overrides still winning), and a tuned config computes the same batch
byte for byte as the default one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core.config import TileTable as JTileTable  # noqa: E402
from repro.kernels import autotune as jat  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core.config import ExecConfig, TileTable  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from test_torch_common import assert_same, assert_same_state  # noqa: E402

torch.set_num_threads(1)

BUILDS = (4096, 65536)
BATCHES = (256, 2048)
# the main geometry, a generic one, and wide ones where 8 warps do not fit
GEOMETRIES = ((32, 16), (16, 8), (8, 8), (32, 64), (64, 64))


def test_sweep_is_deterministic():
    a_table, a_rec = at.autotune(BUILDS, BATCHES)
    b_table, b_rec = at.autotune(BUILDS, BATCHES)
    assert a_table == b_table
    assert a_rec == b_rec
    # shuffled/duplicated inputs bucket to the same sweep
    c_table, _ = at.autotune(BUILDS[::-1] + BUILDS, BATCHES[::-1])
    assert c_table == a_table


@pytest.mark.parametrize("ns,npb", GEOMETRIES)
def test_sweep_covers_grid_and_respects_shared_memory(ns, npb):
    table, rec = at.autotune(BUILDS + (1 << 29,), BATCHES + (1 << 20,), node_size=ns,
                             nodes_per_bucket=npb)
    assert len(table.entries) == 3 * 3
    assert rec["vmem_budget_bytes"] == at.SMEM_BUDGET_BYTES == 232_448
    for sweep in rec["sweeps"]:
        assert len(sweep["candidates"]) == len(at.CANDIDATE_BLOCK_Q) * len(at.CANDIDATE_BLOCK_B)
        chosen = next(
            c for c in sweep["candidates"]
            if c["block_q"] == sweep["block_q"] and c["block_b"] == sweep["block_b"]
        )
        assert chosen["feasible"]
        assert chosen["vmem_bytes"] <= at.SMEM_BUDGET_BYTES
        # the winner has the minimum model cost among feasible candidates,
        # the first of them in the sorted candidate order
        feas = [c for c in sweep["candidates"] if c["feasible"]]
        best = min(c["model_cost"] for c in feas)
        assert chosen["model_cost"] == best
        assert chosen is next(c for c in feas if c["model_cost"] == best)
        for c in sweep["candidates"]:
            assert c["feasible"] == (c["vmem_bytes"] <= at.SMEM_BUDGET_BYTES)
            assert (c["model_cost"] is None) == (not c["feasible"])


def test_shared_memory_mirror_and_occupancy_model():
    """The mirror of ``warp_ints<StagedRing>`` at the main geometry (3,492
    ints a warp), what fits, and the resident warps an SM."""
    geo = dict(node_size=32, nodes_per_bucket=16)
    assert at.warp_bytes(**geo) == 3492 * 4
    assert [at.smem_bytes(128, w, **geo) for w in (1, 2, 4, 8)] == [
        13968, 27936, 55872, 111744]
    assert at.smem_bytes(128, 0, **geo) == at.smem_bytes(128, 4, **geo)  # the default: 4
    # shared memory holds 15 one-warp blocks an SM, registers 20 warps (16 at
    # 8 warps a block, whose instantiation takes 128 registers a thread)
    assert [at.blocks_per_sm(w, **geo) * w for w in (1, 2, 4, 8)] == [15, 16, 16, 16]
    generic = dict(node_size=16, nodes_per_bucket=8)
    assert [at.blocks_per_sm(w, **generic) * w for w in (1, 2, 4, 8)] == [20, 20, 20, 16]
    wide = dict(node_size=64, nodes_per_bucket=64)
    assert at.block_warps(0, **wide) == 2
    assert at.blocks_per_sm(2, **wide) == 1 and at.blocks_per_sm(4, **wide) == 0
    small = at.smem_bytes(128, 1, node_size=16, nodes_per_bucket=8)
    big = at.smem_bytes(512, 8, node_size=16, nodes_per_bucket=8)
    assert big > small > 0


def test_model_ranks_resident_warps():
    """At 2^20 buckets of the main geometry: one warp a block holds 15 warps
    an SM and costs more; 2, 4 and 8 tie and the sorted order picks 2.  At
    a geometry where 8 warps do not fit, 8 is infeasible."""
    rec = at.sweep_bucket(1 << 29, 1 << 20, node_size=32, nodes_per_bucket=16)
    cost = {c["block_b"]: c["model_cost"] for c in rec["candidates"]}
    assert cost[1] > cost[2] == cost[4] == cost[8]
    assert rec["block_b"] == 2
    wide = at.sweep_bucket(1 << 29, 1 << 20, node_size=32, nodes_per_bucket=64)
    feas = {c["block_b"]: c["feasible"] for c in wide["candidates"]}
    assert feas == {1: True, 2: True, 4: True, 8: False}


def test_table_roundtrips_artifact_and_execconfig():
    table, rec = at.autotune(BUILDS, BATCHES)
    # artifact round-trip: JSON rows -> identical table
    assert TileTable.from_json(rec["table"]) == table
    # ExecConfig consults the table when blocks are unset...
    cfg = ExecConfig(tile_table=table)
    for build, batch, bq, bb in table.entries:
        assert cfg.resolve_blocks(build, batch) == (bq, bb)
    # ...explicit overrides always win...
    cfg2 = cfg.replace(block_q=64)
    build, batch, _, bb = table.entries[0]
    assert cfg2.resolve_blocks(build, batch) == (64, bb)
    assert cfg.replace(block_b=8).resolve_blocks(build, batch)[1] == 8
    # ...and off-grid sizes fall back to the nearest bucket, deterministically
    got = cfg.resolve_blocks(3 * BUILDS[-1], 3 * BATCHES[-1])
    assert got == cfg.resolve_blocks(3 * BUILDS[-1], 3 * BATCHES[-1])
    assert got[0] in at.CANDIDATE_BLOCK_Q and got[1] in at.CANDIDATE_BLOCK_B


def test_tables_load_in_either_package():
    """Table rows keep the reference's four columns: a table written by
    either package loads in the other's ``TileTable`` and resolves the same
    blocks there; the records share the reference's keys."""
    t_table, t_rec = at.autotune(BUILDS, BATCHES)
    j_table, j_rec = jat.autotune(BUILDS, BATCHES)
    assert JTileTable.from_json(t_rec["table"]).to_json() == t_rec["table"]
    assert TileTable.from_json(j_rec["table"]).to_json() == j_rec["table"]
    for build in (1000, 4096, 70000):
        for batch in (100, 256, 5000):
            assert (JTileTable.from_json(t_rec["table"]).lookup(build, batch)
                    == t_table.lookup(build, batch))
            assert (TileTable.from_json(j_rec["table"]).lookup(build, batch)
                    == j_table.lookup(build, batch))
    assert set(t_rec) == set(j_rec)
    for ts, js in zip(t_rec["sweeps"], j_rec["sweeps"]):
        assert set(js) == set(ts)
        assert set(js["candidates"][0]) <= set(ts["candidates"][0])


def test_measure_mode_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        at.autotune([4096], [256], measure=True, device="cpu")


def test_tuned_config_runs_byte_identical(rng):
    """A tile table changes execution strategy only: apply_ops under the
    tuned config matches the kernel-default config byte for byte, and the
    reference engine (JAX) on the same batch."""
    keys = rng.choice(30000, size=1500, replace=False).astype(np.int32)
    vals = np.arange(1500, dtype=np.int32)
    st = tcore.build(keys, vals, node_size=8, nodes_per_bucket=8, device="cpu")
    table, _ = at.autotune([st.num_buckets * st.bucket_capacity], [256])
    q = np.sort(rng.choice(keys, 200)).astype(np.int32)
    ins = np.setdiff1d(np.arange(0, 30000, 11, dtype=np.int32), keys)[:56]
    tags = np.concatenate(
        [np.full(200, tcore.OP_POINT), np.full(56, tcore.OP_INSERT)]
    ).astype(np.int32)
    args = (tags, np.concatenate([q, ins]), np.concatenate([q, ins]))
    ops, _ = tcore.make_ops(*args, pad_to=256, device="cpu")
    base = tcore.apply_ops(st, ops, config=ExecConfig(impl="fused", pipeline="on"))
    tuned = tcore.apply_ops(
        st, ops, config=ExecConfig(impl="fused", pipeline="on", tile_table=table)
    )
    jst = jcore.build(keys, vals, node_size=8, nodes_per_bucket=8)
    jops, _ = jcore.make_ops(*args, pad_to=256)
    want = jcore.apply_ops(jst, jops, config=jcore.ExecConfig(impl="reference"))
    for got in (base, tuned):
        assert_same_state(want[0], got[0])
        for k in want[1]:
            assert_same(want[1][k], got[1][k], k)
    for k in base[1]:
        assert torch.equal(base[1][k], tuned[1][k]), k
    # a warp count past the staged kernel's launch bounds is refused
    with pytest.raises(ValueError, match="block_b=9"):
        tcore.apply_ops(st, ops, config=ExecConfig(impl="fused", pipeline="on", block_b=9))


def test_block_b_reaches_the_staged_pass(rng, monkeypatch):
    """``ExecConfig.block_b``, else the tile table's pick, else 0 is the
    ``block_b`` the engine hands the staged pass; the single-buffer path
    takes none."""
    from repro_torch.kernels import flix_apply as fa

    seen = []
    orig = fa.flix_apply_staged_pass

    def spy(num_nodes, *args, block_b=0):
        seen.append(block_b)
        return orig(num_nodes, *args, block_b=block_b)

    monkeypatch.setattr(fa, "flix_apply_staged_pass", spy)
    keys = rng.choice(30000, size=1500, replace=False).astype(np.int32)
    st = tcore.build(keys, keys, node_size=8, nodes_per_bucket=8, device="cpu")
    ops, _ = tcore.make_ops(np.full(64, tcore.OP_POINT, np.int32), keys[:64], device="cpu")
    slots = st.num_buckets * st.bucket_capacity
    table = TileTable(entries=((slots, 64, 128, 8),))
    cfg = ExecConfig(impl="fused", pipeline="on")
    for c in (cfg, cfg.replace(block_b=4), cfg.replace(tile_table=table),
              cfg.replace(tile_table=table, block_b=1), cfg.replace(pipeline="off")):
        tcore.apply_ops(st, ops, config=c)
    assert seen == [0, 4, 8, 1]
