"""The flix_apply port: its plain version against the JAX Pallas kernel
(interpret mode) on one tiny batch, and the launch wrappers' input checks.
The CUDA kernels against their plain versions, on a card only:
``tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.kernels.flix_apply import flix_apply_pallas  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.kernels import flix_apply as fa  # noqa: E402
from test_torch_common import EMPTY, assert_same, assert_same_state, to_port  # noqa: E402

torch.set_num_threads(1)


def _tiny_batch(rng, live):
    """Inserts (fresh and upserts), deletes, reads and ranges on few keys."""
    absent = np.setdiff1d(np.arange(0, 400, dtype=np.int32), live)
    ins = np.concatenate([rng.choice(absent, 10, replace=False), live[:3]])
    dels = np.setdiff1d(rng.choice(live, 6, replace=False), ins)
    reads = rng.integers(0, 420, 16)
    rlo = np.array([0, 50, 200, 390], np.int32)
    tags = np.concatenate([
        np.full(len(ins), tcore.OP_INSERT), np.full(len(dels), tcore.OP_DELETE),
        np.where(np.arange(16) % 2 == 0, tcore.OP_POINT, tcore.OP_SUCCESSOR),
        np.full(len(rlo), tcore.OP_RANGE),
    ]).astype(np.int32)
    keys = np.concatenate([ins, dels, reads, rlo]).astype(np.int32)
    vals = np.concatenate(
        [np.arange(len(ins)) + 900, np.zeros(len(dels) + 16), rlo + [60, 30, 150, EMPTY - 390]]
    ).astype(np.int32)
    return tags, keys, vals


def test_plain_version_matches_the_pallas_kernel():
    """One tiny batch through the JAX kernel in interpret mode and through
    the port's fused path (the plain version on the CPU): same state, vals
    at every slot included (both zero the freed slots), same results."""
    rng = np.random.default_rng(17)
    live = np.sort(rng.choice(400, 40, replace=False)).astype(np.int32)
    js = jcore.build(live, live * 2, node_size=4, nodes_per_bucket=4)
    ts = to_port(js)
    tags, keys, vals = _tiny_batch(rng, live)
    jops, _ = jcore.make_ops(tags, keys, vals, pad_to=64)
    tops, _ = tcore.make_ops(tags, keys, vals, pad_to=64, device="cpu")
    want = flix_apply_pallas(
        js, jops.tag, jops.key, jops.val, max_results=64, interpret=True
    )
    got = fa.flix_apply(ts, tops.tag, tops.key, tops.val, max_results=64)
    assert_same_state(want[0], got[0], live_vals_only=False)
    for k in want[1]:
        assert_same(want[1][k], got[1][k], k)
    for k in want[2]:
        assert int(want[2][k]) == int(got[2][k]), k
    # and the reference engine agrees with both
    ref = jcore.apply_ops(js, jops, config=jcore.ExecConfig(impl="reference", max_results=64))
    assert_same_state(ref[0], got[0])


def test_pipeline_on_matches_the_pipelined_pallas_kernel():
    """``ExecConfig(pipeline="on")`` (the staged kernel's plain version on
    the CPU) against the JAX double-buffered kernel in interpret mode on one
    tiny batch: same state, results and stats."""
    rng = np.random.default_rng(29)
    live = np.sort(rng.choice(400, 40, replace=False)).astype(np.int32)
    js = jcore.build(live, live * 3, node_size=4, nodes_per_bucket=4)
    ts = to_port(js)
    tags, keys, vals = _tiny_batch(rng, live)
    jops, _ = jcore.make_ops(tags, keys, vals, pad_to=64)
    tops, _ = tcore.make_ops(tags, keys, vals, pad_to=64, device="cpu")
    want = flix_apply_pallas(
        js, jops.tag, jops.key, jops.val, max_results=64, interpret=True, pipeline=True
    )
    got = tcore.apply_ops(
        ts, tops, config=tcore.ExecConfig(impl="fused", pipeline="on", max_results=64)
    )
    assert_same_state(want[0], got[0])
    for k in want[1]:
        assert_same(want[1][k], got[1][k], k)
    for k in want[2]:
        assert int(want[2][k]) == int(got[2][k]), k


def _pass_inputs(ts, tops):
    return list(fa.stripe_inputs(ts, tops.tag, tops.key, tops.val)[0])


def test_wrappers_check_their_inputs():
    keys = np.arange(0, 300, 3, dtype=np.int32)
    ts = tcore.build(keys, keys, node_size=4, nodes_per_bucket=4, device="cpu")
    tops, _ = tcore.make_ops(np.full(5, tcore.OP_POINT, np.int32), keys[:5], device="cpu")
    args = _pass_inputs(ts, tops)
    assert len(fa.flix_apply_pass(*args)) == 9
    bad = list(args)
    bad[0] = args[0].to(torch.int64)
    with pytest.raises(TypeError, match="int32"):
        fa.flix_apply_pass(*bad)
    bad = list(args)
    bad[1] = args[1].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flix_apply_pass(*bad)
    bad = list(args)
    bad[5] = args[5][:-1]
    with pytest.raises(ValueError, match="slice bounds"):
        fa.flix_apply_pass(*bad)
    # the staged pass: the same function, with num_nodes beside the inputs
    staged = fa.flix_apply_staged_pass(ts.num_nodes, *args)
    for a, b in zip(fa.flix_apply_pass(*args), staged):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="num_nodes"):
        fa.flix_apply_staged_pass(ts.num_nodes[:-1], *args)
    pref = torch.zeros(ts.num_buckets + 1, dtype=torch.int32)
    g = torch.full((8,), -1, dtype=torch.int32)
    rk, rv = fa.flix_apply_range_pass(g, pref, ts.node_count, ts.keys, ts.vals)
    assert (rk == EMPTY).all() and (rv == -1).all()
    with pytest.raises(ValueError, match="pref"):
        fa.flix_apply_range_pass(g, pref[:-1], ts.node_count, ts.keys, ts.vals)


def test_library_is_keyed_by_its_sources(tmp_path, monkeypatch):
    """An edit to any CUDA source names a new library, so it rebuilds."""
    from repro_torch.kernels import _build

    for f in _build.sources():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    assert before.parent == _build.BUILD_DIR and before == _build.library_path()
    header = tmp_path / "flix_phases.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before
