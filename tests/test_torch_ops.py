"""Port parity of the mixed-batch engine: ``apply_ops`` with both executors
(``impl="reference"``, and ``impl="fused"`` — the kernel's plain version on
the CPU) against the JAX reference engine, across op mixes incl. RANGE,
single-class batches, the 90/10 read/update shape, overflow and the
``apply_ops_safe`` retry.  Exact: every plane and result is int32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core.config import ExecConfig as JExecConfig  # noqa: E402
from repro.core.config import TileTable as JTileTable  # noqa: E402
from repro.core.state import MAX_VALID  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from test_torch_common import (  # noqa: E402
    EMPTY,
    assert_same,
    assert_same_state,
    build_adversarial,
)

torch.set_num_threads(1)

RESULT_KEYS = ("value", "succ_key", "range_key", "range_val", "range_start", "range_count")


@pytest.fixture(scope="module")
def adversarial():
    return build_adversarial(np.random.default_rng(1234))


def _run_both(js, ts, tags, keys, vals, *, pad_to, max_results):
    """The JAX reference engine and both port executors on one batch; every
    port result is held against the reference's."""
    jops, jperm = jcore.make_ops(tags, keys, vals, pad_to=pad_to)
    tops, tperm = tcore.make_ops(tags, keys, vals, pad_to=pad_to, device="cpu")
    assert_same(jops.tag, tops.tag)
    assert_same(jops.key, tops.key)
    assert_same(jops.val, tops.val)
    assert_same(jperm, tperm)
    want = jcore.apply_ops(
        js, jops, config=JExecConfig(impl="reference", max_results=max_results)
    )
    for impl in ("reference", "fused"):
        cfg = tcore.ExecConfig(impl=impl, max_results=max_results)
        got = tcore.apply_ops(ts, tops, config=cfg)
        assert_same_state(want[0], got[0])
        for k in RESULT_KEYS:
            assert_same(want[1][k], got[1][k], f"{impl}: {k}")
        assert set(want[2]) == set(got[2])
        for k in want[2]:
            assert int(want[2][k]) == int(got[2][k]), f"{impl}: {k}"
        if not bool(got[0].needs_restructure):
            tcore.check_invariants(got[0])
            tcore.check_range_results(tops, got[1], max_results=max_results)
        assert_same(jcore.unsort(want[1]["value"], jperm), tcore.unsort(got[1]["value"], tperm))
    return tops, got


PRESENT = [
    (jcore.OP_INSERT,),
    (jcore.OP_DELETE,),
    (jcore.OP_POINT,),
    (jcore.OP_SUCCESSOR,),
    (jcore.OP_RANGE,),
    (jcore.OP_INSERT, jcore.OP_POINT),
    (jcore.OP_DELETE, jcore.OP_SUCCESSOR),
    (jcore.OP_POINT, jcore.OP_SUCCESSOR),
    (jcore.OP_INSERT, jcore.OP_RANGE),
    (jcore.OP_DELETE, jcore.OP_RANGE),
    (jcore.OP_RANGE, jcore.OP_SUCCESSOR),
]


@pytest.mark.parametrize("present", PRESENT)
def test_apply_ops_partial_mixes(adversarial, present):
    """Every op-mix ratio incl. the single-class extremes: the fused path
    has no per-phase skips, so absent classes must fall out of the math."""
    js, ts, live = adversarial
    rng = np.random.default_rng(sum(present) + 10 * len(present))
    absent_keys = np.setdiff1d(np.arange(0, 130000, 5, dtype=np.int32), live)
    pools = {
        jcore.OP_INSERT: rng.choice(absent_keys, 120, replace=False),
        jcore.OP_DELETE: rng.choice(live, 120, replace=False),
        jcore.OP_POINT: rng.integers(0, 130000, 120),
        jcore.OP_SUCCESSOR: rng.integers(0, 130000, 120),
        jcore.OP_RANGE: np.sort(rng.integers(0, 125000, 40)),
    }
    tags, keys, vals = [], [], []
    for t in present:
        k = pools[t].astype(np.int32)
        tags.append(np.full(len(k), t, np.int32))
        keys.append(k)
        if t == jcore.OP_INSERT:
            vals.append(np.arange(len(k), dtype=np.int32) + 3_000_000)
        elif t == jcore.OP_RANGE:
            vals.append((k + rng.integers(0, 2000, len(k))).astype(np.int32))
        else:
            vals.append(np.zeros(len(k), np.int32))
    _run_both(
        js, ts, np.concatenate(tags), np.concatenate(keys), np.concatenate(vals),
        pad_to=512, max_results=256,
    )


def test_apply_ops_full_mix_adversarial(adversarial):
    """Upserts of stored keys, deletions, duplicate + boundary + emptied-bucket
    reads, ranges spanning emptied and boundary regions (hi up to EMPTY)."""
    js, ts, live = adversarial
    rng = np.random.default_rng(21)
    absent = np.setdiff1d(np.arange(0, 130000, 3, dtype=np.int32), live)
    ins = np.concatenate(
        [rng.choice(absent, 200, replace=False), rng.choice(live, 100, replace=False)]
    ).astype(np.int32)
    iv = rng.integers(0, 1 << 30, 300).astype(np.int32)
    dels = np.setdiff1d(rng.choice(live, 250, replace=False), ins).astype(np.int32)
    reads = np.concatenate([
        np.repeat(rng.choice(live, 30), 4),
        rng.choice(absent, 100),
        [0, int(MAX_VALID) - 1, int(MAX_VALID)],
        np.arange(29000, 61000, 250),
    ]).astype(np.int32)
    rlo = np.concatenate(
        [rng.integers(0, 125000, 24), [0, 29500, int(MAX_VALID) - 5]]
    ).astype(np.int32)
    rhi = np.concatenate(
        [rlo[:24] + rng.integers(0, 3000, 24), [50, 60500, EMPTY]]
    ).astype(np.int32)
    tags = np.concatenate([
        np.full(len(ins), jcore.OP_INSERT),
        np.full(len(dels), jcore.OP_DELETE),
        np.where(np.arange(len(reads)) % 2 == 0, jcore.OP_POINT, jcore.OP_SUCCESSOR),
        np.full(len(rlo), jcore.OP_RANGE),
    ]).astype(np.int32)
    keys = np.concatenate([ins, dels, reads, rlo]).astype(np.int32)
    vals = np.concatenate([iv, np.zeros(len(dels) + len(reads), np.int32), rhi])
    _run_both(js, ts, tags, keys, vals, pad_to=1024, max_results=256)


def test_apply_ops_range_heavy_90_10(adversarial):
    """90% range + point reads, 10% updates, with a budget that fits."""
    js, ts, live = adversarial
    rng = np.random.default_rng(31)
    absent = np.setdiff1d(np.arange(0, 130000, 3, dtype=np.int32), live)
    n, n_upd = 400, 40
    ins = rng.choice(absent, n_upd // 2, replace=False).astype(np.int32)
    dels = rng.choice(live, n_upd // 2, replace=False).astype(np.int32)
    n_rng = (n - n_upd) // 2
    rlo = np.sort(rng.integers(0, 125000, n_rng)).astype(np.int32)
    rhi = (rlo + rng.integers(0, 1500, n_rng)).astype(np.int32)
    points = rng.integers(0, 130000, n - n_upd - n_rng).astype(np.int32)
    tags = np.concatenate([
        np.full(len(ins), jcore.OP_INSERT),
        np.full(len(dels), jcore.OP_DELETE),
        np.full(n_rng, jcore.OP_RANGE),
        np.full(len(points), jcore.OP_POINT),
    ]).astype(np.int32)
    keys = np.concatenate([ins, dels, rlo, points]).astype(np.int32)
    vals = np.concatenate([
        np.arange(len(ins), dtype=np.int32) + 5_000_000,
        np.zeros(len(dels), np.int32),
        rhi,
        np.zeros(len(points), np.int32),
    ])
    _run_both(js, ts, tags, keys, vals, pad_to=512, max_results=4096)


def _flood(node_size=4, nodes_per_bucket=2):
    keys = np.arange(0, 640, 10, dtype=np.int32)
    js = jcore.build(keys, keys, node_size=node_size, nodes_per_bucket=nodes_per_bucket)
    ts = tcore.build(
        keys, keys, node_size=node_size, nodes_per_bucket=nodes_per_bucket, device="cpu"
    )
    flood = np.arange(1, 200, 2, dtype=np.int32)
    rlo = np.array([0, 150, 500], np.int32)
    tags = np.concatenate([
        np.full(len(flood), jcore.OP_INSERT),
        np.full(len(keys), jcore.OP_POINT),
        np.full(len(keys), jcore.OP_SUCCESSOR),
        np.full(len(rlo), jcore.OP_RANGE),
    ]).astype(np.int32)
    bkeys = np.concatenate([flood, keys, keys + 3, rlo]).astype(np.int32)
    bvals = np.concatenate(
        [flood * 7, np.zeros(2 * len(keys), np.int32), rlo + 120]
    ).astype(np.int32)
    return js, ts, tags, bkeys, bvals


def test_apply_ops_overflow_pre_retry_state():
    """An overflowing batch: the pre-retry states (untrustworthy buckets
    included), the restructure flag and the overflow count agree."""
    js, ts, tags, bkeys, bvals = _flood()
    jops, _ = jcore.make_ops(tags, bkeys, bvals, pad_to=256)
    tops, _ = tcore.make_ops(tags, bkeys, bvals, pad_to=256, device="cpu")
    want, _, wstats = jcore.apply_ops(js, jops, config=JExecConfig(impl="reference"))
    assert bool(want.needs_restructure)
    for impl in ("reference", "fused"):
        got, _, gstats = tcore.apply_ops(ts, tops, config=tcore.ExecConfig(impl=impl))
        assert_same_state(want, got)
        for k in ("inserted", "overflowed_buckets"):
            assert int(wstats[k]) == int(gstats[k]), (impl, k)


@pytest.mark.parametrize(
    "impl,pipeline,donate",
    [
        pytest.param("reference", "auto", None, id="reference"),
        pytest.param("fused", "auto", None, id="fused"),
        # the staged kernel's plain version: donated (the driver's default) or not
        pytest.param("fused", "on", None, id="fused-staged-donated"),
        pytest.param("fused", "on", False, id="fused-staged-not-donated"),
    ],
)
def test_apply_ops_safe_retry_matches_reference(impl, pipeline, donate):
    """The retry regrows the pre-batch state and replays the whole batch:
    same geometry, state and results as the reference's apply_ops_safe."""
    js, ts, tags, bkeys, bvals = _flood()
    jops, _ = jcore.make_ops(tags, bkeys, bvals, pad_to=256)
    tops, _ = tcore.make_ops(tags, bkeys, bvals, pad_to=256, device="cpu")
    want = jcore.apply_ops_safe(js, jops, config=JExecConfig(impl="reference"))
    got = tcore.apply_ops_safe(
        ts, tops, config=tcore.ExecConfig(impl=impl, pipeline=pipeline, donate=donate,
                                          validate=True, validate_ranges=True)
    )
    assert got[2]["restructure_retries"] == want[2]["restructure_retries"] == 1
    assert got[0].geometry == want[0].geometry
    assert_same_state(want[0], got[0])
    for k in RESULT_KEYS:
        assert_same(want[1][k], got[1][k], k)


def test_config_surface(adversarial):
    _, ts, live = adversarial
    tops, _ = tcore.make_ops(
        np.array([jcore.OP_INSERT, jcore.OP_POINT], np.int32),
        np.array([1, int(live[0])], np.int32),
        device="cpu",
    )
    with pytest.raises(ValueError):
        tcore.ExecConfig(impl="pallas")
    with pytest.raises(ValueError):
        tcore.ExecConfig(pipeline="maybe")
    # "auto" off the card is the reference engine; donate, the TPU tile
    # knobs and the pipeline change nothing
    base = tcore.apply_ops(ts, tops, config=tcore.ExecConfig(impl="reference"))
    for cfg in (
        tcore.ExecConfig(),
        tcore.ExecConfig(impl="fused", pipeline="off", donate=True, block_q=64, block_b=4),
        tcore.ExecConfig(impl="fused", pipeline="on"),
    ):
        got = tcore.apply_ops(ts, tops, config=cfg)
        for k in ("value", "succ_key"):
            assert torch.equal(base[1][k], got[1][k])
        assert torch.equal(base[0].keys, got[0].keys)
    # a batch with an expiry column takes the TTL path: no deadline, no change
    no_ttl = torch.full_like(tops.key, tcore.NO_EXPIRY)
    got = tcore.apply_ops(ts, tcore.OpBatch(tops.tag, tops.key, tops.val, exp=no_ttl))
    assert torch.equal(base[0].keys, got[0].keys) and int(got[2]["expired"]) == 0
    assert bool((got[0].exps == tcore.NO_EXPIRY).all())
    assert tcore.ExecConfig().resolve_pipeline(torch.device("cuda"))
    assert not tcore.ExecConfig().resolve_pipeline(torch.device("cpu"))
    assert not tcore.ExecConfig(pipeline="off").resolve_pipeline(torch.device("cuda"))
    assert tcore.ExecConfig(pipeline="on").resolve_pipeline(torch.device("cpu"))
    rows = ((1 << 14, 256, 128, 2), (1 << 20, 4096, 512, 4))
    jt, tt = JTileTable(entries=rows), tcore.TileTable(entries=rows)
    for build_size, batch in ((100, 10), (1 << 16, 300), (1 << 24, 1 << 20)):
        assert tt.lookup(build_size, batch) == jt.lookup(build_size, batch)
        cfg = tcore.ExecConfig(tile_table=tt, block_q=32)
        assert cfg.resolve_blocks(build_size, batch) == JExecConfig(
            tile_table=jt, block_q=32
        ).resolve_blocks(build_size, batch)
    assert tcore.TileTable.from_json(tt.to_json()) == tt
