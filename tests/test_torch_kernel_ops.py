"""The port's kernel entry points (``repro_torch.kernels.ops``) against the
JAX package, exact, on the CPU, where each wrapper runs its kernel's plain
torch version:

  * point and successor queries against the reference oracles
    (``kernels/ref.py``) and ``core``, insert and delete against ``core``,
    on the ``adversarial`` state and batches of ``tests/test_differential.py``;
  * each plain version against its Pallas kernel in interpret mode on a tiny
    case, vals at EMPTY slots included (both write 0 there);
  * a small geometry sweep, the modes, and the wrappers' input checks.

The kernels themselves run only on a card: ``tests/test_torch_kernels_cuda.py``.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core.state import MAX_VALID  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flix_delete import flix_delete_pallas  # noqa: E402
from repro.kernels.flix_insert import flix_insert_pallas  # noqa: E402
from repro.kernels.flix_query import flix_point_query_pallas  # noqa: E402
from repro.kernels.flix_successor import flix_successor_pallas  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops  # noqa: E402
from repro_torch.kernels import flix_delete as fd  # noqa: E402
from repro_torch.kernels import flix_insert as fi  # noqa: E402
from repro_torch.kernels import flix_query as fq  # noqa: E402
from repro_torch.kernels import flix_successor as fs  # noqa: E402
from test_torch_common import (  # noqa: E402
    EMPTY,
    assert_same,
    assert_same_state,
    build_adversarial,
    t32,
    to_port,
)

torch.set_num_threads(1)

QUERY_BATCHES = ["duplicates", "all_miss", "boundary", "empty_buckets", "mixed"]
INSERT_BATCHES = ["upsert_mix", "empty_buckets"]
DELETE_BATCHES = ["all_miss", "duplicates", "boundary", "skewed_range"]


@pytest.fixture(scope="module")
def adversarial():
    return build_adversarial(np.random.default_rng(1234))


def _query_batch(live, name):
    """``tests/test_differential.py:73-87``."""
    rng = np.random.default_rng(5)
    absent = np.setdiff1d(np.arange(0, 130000, 7, dtype=np.int32), live)
    return {
        "duplicates": lambda: np.sort(np.repeat(rng.choice(live, 40), 8)),
        "all_miss": lambda: np.sort(rng.choice(absent, 300)),
        "boundary": lambda: np.array(
            [0, 0, 1, int(MAX_VALID) - 1, int(MAX_VALID), int(MAX_VALID)]
        ),
        "empty_buckets": lambda: np.arange(29000, 61000, 50),
        "mixed": lambda: np.sort(
            np.concatenate([rng.choice(live, 200), rng.choice(absent, 200)])
        ),
    }[name]().astype(np.int32)


def _insert_batch(live, name):
    """``tests/test_differential.py:120-147``: sorted, unique, with values."""
    rng = np.random.default_rng(6)
    absent = np.setdiff1d(np.arange(0, 130000, 11, dtype=np.int32), live)
    b = {
        "upsert_mix": lambda: np.concatenate(
            [rng.choice(live, 150, replace=False), absent[:150], [0, int(MAX_VALID)]]
        ),
        "empty_buckets": lambda: np.arange(31000, 59000, 120),
    }[name]()
    b = np.unique(b).astype(np.int32)
    return b, (np.arange(len(b)) + 7_000_000).astype(np.int32)


def _delete_batch(live, name):
    """``tests/test_differential.py:150-173``."""
    rng = np.random.default_rng(8)
    absent = np.setdiff1d(np.arange(0, 130000, 13, dtype=np.int32), live)
    return {
        "all_miss": lambda: np.sort(absent[:400]),
        "duplicates": lambda: np.sort(np.repeat(rng.choice(live, 60, replace=False), 5)),
        "boundary": lambda: np.array([0, int(MAX_VALID)]),
        "skewed_range": lambda: np.arange(60000, 90000),
    }[name]().astype(np.int32)


def _planes(st):
    return st.keys, st.vals, st.node_max, st.mkba


# ---------------------------------------------------------------------------
# against the JAX oracles and core, on the adversarial state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", QUERY_BATCHES)
def test_point_query_matches_reference(adversarial, batch):
    js, ts, live = adversarial
    q = _query_batch(live, batch)
    got = ops.flix_point_query(ts, t32(q))
    assert got.dtype == torch.int32
    assert_same(jref.flix_point_query_ref(*_planes(js), jnp.asarray(q)), got)
    assert_same(jcore.point_query(js, jnp.asarray(q)), got)


@pytest.mark.parametrize("batch", QUERY_BATCHES)
def test_successor_matches_reference(adversarial, batch):
    js, ts, live = adversarial
    q = _query_batch(live, batch)
    gk, gv = ops.flix_successor(ts, t32(q))
    wk, wv = jref.flix_successor_ref(*_planes(js), jnp.asarray(q))
    assert_same(wk, gk, "succ_key")
    assert_same(wv, gv, "succ_val")
    ck, cv = jcore.successor_query(js, jnp.asarray(q))
    assert_same(ck, gk, "core succ_key")
    assert_same(cv, gv, "core succ_val")


@pytest.mark.parametrize("batch", INSERT_BATCHES)
def test_insert_matches_reference(adversarial, batch):
    js, ts, live = adversarial
    b, v = _insert_batch(live, batch)
    want, stats = jcore.insert(js, jnp.asarray(b), jnp.asarray(v))
    got, overflow = ops.flix_insert(ts, t32(b), t32(v))
    assert_same_state(want, got)
    assert overflow.dtype == torch.int32 and overflow.shape == (ts.num_buckets,)
    assert int((overflow > 0).sum()) == int(stats["overflowed_buckets"]) == 0
    tcore.check_invariants(got)


@pytest.mark.parametrize("batch", DELETE_BATCHES)
def test_delete_matches_reference(adversarial, batch):
    js, ts, live = adversarial
    b = _delete_batch(live, batch)
    want, _ = jcore.delete(js, jnp.asarray(b))
    got = ops.flix_delete(ts, t32(b))
    assert_same_state(want, got)
    tcore.check_invariants(got)


def test_queries_at_the_top_fence(adversarial):
    """The reference oracle clamps the bucket of a query above the last fence
    to the last bucket (``ref.py:25``).  Up to MAX_VALID (= EMPTY - 1) every
    query has a bucket and all forms agree; at EMPTY, which no bucket owns,
    the port misses like the Pallas kernel and ``core.point_query``."""
    js, ts, _ = adversarial
    q = np.array([0, int(MAX_VALID) - 1, int(MAX_VALID), EMPTY - 1, EMPTY], np.int32)
    got = ops.flix_point_query(ts, t32(q))
    want = jref.flix_point_query_ref(*_planes(js), jnp.asarray(q))
    assert_same(np.asarray(want)[:4], got[:4])
    assert_same(flix_point_query_pallas(*_planes(js), jnp.asarray(q), interpret=True), got)
    assert_same(jcore.point_query(js, jnp.asarray(q)), got)
    assert int(got[-1]) == tcore.NOT_FOUND
    gk, gv = ops.flix_successor(ts, t32(q))
    wk, wv = jref.flix_successor_ref(*_planes(js), jnp.asarray(q))
    assert_same(wk, gk)
    assert_same(wv, gv)
    assert (int(gk[-1]), int(gv[-1])) == (EMPTY, tcore.NOT_FOUND)


# ---------------------------------------------------------------------------
# each plain version against its Pallas kernel (interpret mode), tiny cases
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """~60 keys in 4-key nodes, 4 per bucket: multi-node chains from an
    insert, and buckets emptied by a delete."""
    rng = np.random.default_rng(21)
    keys = np.sort(rng.choice(400, 40, replace=False)).astype(np.int32)
    js = jcore.build(keys, keys * 3, node_size=4, nodes_per_bucket=4)
    extra = np.setdiff1d(rng.choice(400, 60, replace=False), keys)[:24].astype(np.int32)
    js, stats = jcore.insert(js, jnp.asarray(np.sort(extra)), jnp.asarray(np.sort(extra) + 1))
    assert int(stats["overflowed_buckets"]) == 0
    js, _ = jcore.delete(js, jnp.arange(100, 200, dtype=jnp.int32))
    live = np.setdiff1d(np.union1d(keys, extra), np.arange(100, 200)).astype(np.int32)
    return js, to_port(js), live


def _tiny_queries(live):
    rng = np.random.default_rng(3)
    q = np.concatenate([rng.choice(live, 12), rng.integers(0, 420, 12), [0, int(MAX_VALID)]])
    return np.sort(q).astype(np.int32)


def test_point_query_plain_matches_pallas(tiny):
    js, ts, live = tiny
    q = _tiny_queries(live)
    want = flix_point_query_pallas(*_planes(js), jnp.asarray(q), interpret=True)
    assert_same(want, fq.flix_point_query_reference(*_planes(ts), t32(q)))


def test_successor_plain_matches_pallas(tiny):
    js, ts, live = tiny
    q = _tiny_queries(live)
    wk, wv = flix_successor_pallas(*_planes(js), jnp.asarray(q), interpret=True)
    gk, gv = fs.flix_successor_reference(*_planes(ts), t32(q))
    assert_same(wk, gk)
    assert_same(wv, gv)


def test_insert_plain_matches_pallas(tiny):
    js, ts, live = tiny
    b = np.unique(np.concatenate([live[::4], np.arange(101, 199, 9), [int(MAX_VALID)]]))
    b = b.astype(np.int32)
    v = (b * 5 + 1).astype(np.int32)
    want, wflow = flix_insert_pallas(js, jnp.asarray(b), jnp.asarray(v), interpret=True)
    got, gflow = ops.flix_insert(ts, t32(b), t32(v))
    assert_same_state(want, got, live_vals_only=False)
    assert_same(wflow, gflow)


def test_insert_overflow_plain_matches_pallas():
    """``tests/test_kernels.py:144-157``: a flood overflows its buckets.  The
    overflow counts and the untrustworthy state agree too."""
    keys = np.arange(0, 640, 10, dtype=np.int32)
    js = jcore.build(keys, np.arange(64, dtype=np.int32), node_size=4, nodes_per_bucket=2)
    ts = to_port(js)
    flood = np.arange(1, 200, 2, dtype=np.int32)
    want, wflow = flix_insert_pallas(js, jnp.asarray(flood), jnp.asarray(flood), interpret=True)
    got, gflow = ops.flix_insert(ts, t32(flood), t32(flood))
    assert int(gflow.sum()) > 0 and int(gflow.max()) == 2  # pieces and slice cut
    assert_same(wflow, gflow)
    assert_same_state(want, got, live_vals_only=False)
    assert bool(got.needs_restructure)


def test_delete_plain_matches_pallas(tiny):
    js, ts, live = tiny
    rng = np.random.default_rng(4)
    b = np.sort(np.concatenate([rng.choice(live, 15), rng.integers(0, 420, 10), [0]]))
    b = b.astype(np.int32)
    want = flix_delete_pallas(js, jnp.asarray(b), interpret=True)
    got = ops.flix_delete(ts, t32(b))
    assert_same_state(want, got, live_vals_only=False)


def test_delete_cuts_duplicate_slices_at_cap():
    """A bucket whose delete slice holds more than ``cap`` present entries
    (its keys repeated) deletes only the keys of the first ``cap``: the
    Pallas kernel's tile, kept by the port (ROADMAP Queue 3).
    ``core.delete`` deletes them all."""
    keys = np.arange(0, 64, dtype=np.int32)
    js = jcore.build(keys, keys + 100, node_size=8, nodes_per_bucket=2, fill=1.0)
    ts = to_port(js)
    b = np.repeat(keys[:16], 3).astype(np.int32)  # bucket 0's 8 keys, bucket 1's 8
    want = flix_delete_pallas(js, jnp.asarray(b), interpret=True)
    got = ops.flix_delete(ts, t32(b))
    assert_same_state(want, got, live_vals_only=False)
    exact, _ = jcore.delete(js, jnp.asarray(b))
    # each bucket's 24 entries are cut to 16 (keys 0-5 of its 8): 2 survive in each
    assert int(got.live_keys()) == int(exact.live_keys()) + 4


def test_delete_keeps_a_key_whose_value_is_not_found():
    """The pre-filter asks a point query whether a key is present, so a key
    stored with value NOT_FOUND (-1) is never deleted: the Pallas wrapper's
    behaviour, kept by the port (ROADMAP Queue 3).  ``core.delete`` deletes
    it."""
    keys = np.arange(0, 40, 2, dtype=np.int32)
    vals = np.where(keys == 10, -1, keys).astype(np.int32)
    js = jcore.build(keys, vals, node_size=4, nodes_per_bucket=2)
    ts = to_port(js)
    b = np.array([8, 10, 12], np.int32)
    want = flix_delete_pallas(js, jnp.asarray(b), interpret=True)
    got = ops.flix_delete(ts, t32(b))
    assert_same_state(want, got, live_vals_only=False)
    assert int(ops.flix_point_query(got, t32([10]))[0]) == -1  # still stored
    assert 10 in np.asarray(got.keys)
    exact, _ = jcore.delete(js, jnp.asarray(b))
    assert 10 not in np.asarray(exact.keys)


# ---------------------------------------------------------------------------
# geometry sweep, modes, wrapper checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ns,npb", [(8, 4), (32, 16), (64, 8)])
def test_geometry_sweep(ns, npb):
    """Insert, delete and both queries at each geometry against ``core``."""
    rng = np.random.default_rng(ns * 100 + npb)
    keys = rng.choice(200000, 3000, replace=False).astype(np.int32)
    js = jcore.build(keys, np.arange(3000, dtype=np.int32), node_size=ns, nodes_per_bucket=npb)
    ts = to_port(js)
    extra = np.setdiff1d(rng.choice(200000, 3000), keys)[:1500].astype(np.int32)
    batch = np.unique(np.concatenate([extra, keys[:200]])).astype(np.int32)
    vals = (np.arange(len(batch)) + 50000).astype(np.int32)
    want, stats = jcore.insert(js, jnp.asarray(batch), jnp.asarray(vals))
    got, overflow = ops.flix_insert(ts, t32(batch), t32(vals))
    assert_same_state(want, got)
    assert int((overflow > 0).sum()) == int(stats["overflowed_buckets"])
    dels = np.sort(np.concatenate([keys[::3], np.arange(50000, 90000, 7)])).astype(np.int32)
    want, _ = jcore.delete(want, jnp.asarray(dels))
    got = ops.flix_delete(got, t32(dels))
    assert_same_state(want, got)
    q = np.sort(np.concatenate([keys[:500], rng.integers(0, 210000, 500)])).astype(np.int32)
    assert_same(jcore.point_query(want, jnp.asarray(q)), ops.flix_point_query(got, t32(q)))
    for w, g in zip(jcore.successor_query(want, jnp.asarray(q)), ops.flix_successor(got, t32(q))):
        assert_same(w, g)


def test_ref_mode_runs_the_core_functions(adversarial):
    _, ts, live = adversarial
    q = t32(_query_batch(live, "mixed"))
    assert torch.equal(ops.flix_point_query(ts, q, mode="ref"), tcore.point_query(ts, q))
    for a, b in zip(ops.flix_successor(ts, q, mode="ref"), tcore.successor_query(ts, q)):
        assert torch.equal(a, b)
    b, v = _insert_batch(live, "upsert_mix")
    st, n_over = ops.flix_insert(ts, t32(b), t32(v), mode="ref")
    want, stats = tcore.insert(ts, t32(b), t32(v))
    assert torch.equal(st.keys, want.keys) and int(n_over) == int(stats["overflowed_buckets"])
    d = t32(_delete_batch(live, "duplicates"))
    assert torch.equal(ops.flix_delete(ts, d, mode="ref").keys, tcore.delete(ts, d)[0].keys)
    # block_q / block_b are TPU tiling knobs: accepted, ignored
    assert torch.equal(
        ops.flix_point_query(ts, q, block_q=256, block_b=4), ops.flix_point_query(ts, q)
    )


def test_apply_entry_point_modes():
    keys = np.arange(0, 300, 3, dtype=np.int32)
    ts = tcore.build(keys, keys, node_size=4, nodes_per_bucket=4, device="cpu")
    tags = np.array([tcore.OP_INSERT, tcore.OP_DELETE, tcore.OP_POINT, tcore.OP_SUCCESSOR,
                     tcore.OP_RANGE], np.int32)
    tops, _ = tcore.make_ops(tags, [7, 9, 3, 10, 20], [70, 0, 0, 0, 90], device="cpu")
    a = ops.flix_apply(ts, tops, max_results=32)
    b = ops.flix_apply(ts, tops, mode="ref", max_results=32)
    for f in ("keys", "node_count", "node_max", "num_nodes"):
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
    for k in b[1]:
        assert torch.equal(a[1][k], b[1][k]), k


@pytest.mark.parametrize("mode", ["pallas", "interpret", "fused"])
def test_tpu_and_unknown_modes_raise(adversarial, mode):
    _, ts, _ = adversarial
    q = t32([1, 2, 3])
    with pytest.raises(ValueError, match="TPU" if mode != "fused" else "unknown mode"):
        ops.flix_point_query(ts, q, mode=mode)
    with pytest.raises(ValueError):
        ops.flix_insert(ts, q, q, mode=mode)
    with pytest.raises(TypeError, match="unexpected keyword"):
        ops.flix_successor(ts, q, block_z=3)


def test_wrappers_check_their_inputs():
    keys = np.arange(0, 300, 3, dtype=np.int32)
    ts = tcore.build(keys, keys, node_size=4, nodes_per_bucket=4, device="cpu")
    q = t32([3, 6, 7])
    with pytest.raises(TypeError, match="int32"):
        fq.flix_point_query(ts.keys, ts.vals, ts.node_max, ts.mkba, q.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        fs.flix_successor(ts.keys.transpose(1, 2), ts.vals, ts.node_max, ts.mkba, q)
    with pytest.raises(ValueError, match="geometry"):
        fq.flix_point_query(ts.keys, ts.vals, ts.node_max, ts.mkba[:-1], q)
    with pytest.raises(ValueError, match="one column"):
        fi.flix_insert_pass(ts.num_nodes, ts.keys, ts.vals, ts.node_max, ts.mkba, q, q[:2])
    with pytest.raises(ValueError, match="geometry"):
        fd.flix_delete_pass(ts.num_nodes, ts.keys, ts.vals[:1], ts.mkba, q)
    # the CPU runs the plain versions and counts no launch
    before = dict(LAUNCHES)
    ops.flix_point_query(ts, q)
    ops.flix_delete(ts, q)
    assert LAUNCHES == before


def test_build_runs_one_nvcc_per_source_then_links(tmp_path, monkeypatch):
    """The kernels build in parallel: one compile per ``.cu``, all started
    together, then one link into the library."""
    from repro_torch.kernels import _build

    calls = []

    def fake_run_all(cmds):
        calls.append(cmds)
        for c in cmds:
            Path(c[c.index("-o") + 1]).write_bytes(b"")
        return [""] * len(cmds)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run_all", fake_run_all)
    path, _ = _build.build()
    cus = sorted(f.name for f in _build.sources() if f.suffix == ".cu")
    assert len(cus) == 10  # the ten .cu sources of csrc/
    compiles, (link,) = calls
    assert sorted(Path(c[-1]).name for c in compiles) == cus
    assert all("-c" in c and "arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert "-shared" in link and link[link.index("-o") + 1].startswith(str(path)[:-3])
    assert path.exists() and not list(tmp_path.glob("obj.*"))
