"""The fused path's donated pass (``ExecConfig.donate``) on the CPU, where it
runs its plain version (``flix_apply.flix_apply_inplace_reference``): the
result written into the input's planes, byte for byte the functional
staged pass's on states the engine makes and the JAX reference engine's
by the parity contract (vals compared at live slots); ``donate=False``
leaving the input whole; an overflow, or an input already flagged for
restructuring, writing nothing, so that ``apply_ops_safe`` reruns and
retries from the intact input.  The CUDA kernels against this plain
version: ``tests/test_torch_kernels_cuda.py -k donated``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core.config import ExecConfig as JExecConfig  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import ops as tops_mod  # noqa: E402
from repro_torch.core.query import _bucket_index  # noqa: E402
from repro_torch.kernels import flix_apply as fa  # noqa: E402
from test_torch_common import EMPTY, assert_same, assert_same_state, to_port  # noqa: E402

torch.set_num_threads(1)

RESULT_KEYS = ("value", "succ_key", "range_key", "range_val", "range_start", "range_count")
PLANES = ("keys", "vals", "node_count", "node_max", "num_nodes", "mkba", "needs_restructure")
NOT_FOUND = int(tcore.NOT_FOUND)
MAX_RESULTS = 64


def staged(donate, **kw):
    return tcore.ExecConfig(impl="fused", pipeline="on", donate=donate,
                            max_results=MAX_RESULTS, **kw)


def planes(st):
    """Copies of every plane of a state."""
    return {f: getattr(st, f).clone() for f in PLANES}


def same_planes(want: dict, st, msg=""):
    for f in PLANES:
        assert torch.equal(want[f], getattr(st, f)), f"{msg}{f}"


def engine_state(n_keys=600, ns=8, npb=4, seed=3):
    """A state as the engine makes them (build, then a fused batch): EMPTY
    keys, 0 values and counts past the live slots.  Returns the JAX state
    beside it and the live keys."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(20000, n_keys, replace=False)).astype(np.int32)
    js = jcore.build(keys, keys * 3, node_size=ns, nodes_per_bucket=npb)
    ts = tcore.build(keys, keys * 3, node_size=ns, nodes_per_bucket=npb, device="cpu")
    return js, ts, keys


def mixed(rng, live, space=20000, n_ins=40, n_del=40, n_read=60, n_range=4):
    """Fresh inserts, upserts of live keys, deletes of live and absent keys,
    POINT / SUCCESSOR reads (hits and misses) and RANGE ops; one update op a
    key."""
    absent = np.setdiff1d(np.arange(space, dtype=np.int32), live)
    fresh = rng.choice(absent, n_ins // 2, replace=False)
    ups = rng.choice(live, n_ins - n_ins // 2, replace=False)
    dels = np.setdiff1d(np.concatenate([rng.choice(live, n_del - 5, replace=False),
                                        rng.choice(absent, 5, replace=False)]),
                        np.concatenate([fresh, ups]))
    reads = np.concatenate([rng.choice(live, n_read // 2), rng.integers(0, space, n_read // 2)])
    lo = rng.integers(0, space, n_range)
    tags = np.concatenate([
        np.full(len(fresh) + len(ups), tcore.OP_INSERT), np.full(len(dels), tcore.OP_DELETE),
        np.where(np.arange(len(reads)) % 2 == 0, tcore.OP_POINT, tcore.OP_SUCCESSOR),
        np.full(n_range, tcore.OP_RANGE),
    ]).astype(np.int32)
    keys = np.concatenate([fresh, ups, dels, reads, lo]).astype(np.int32)
    vals = np.concatenate([np.arange(len(fresh) + len(ups)) + 70000,
                           np.zeros(len(dels) + len(reads)), lo + 300]).astype(np.int32)
    return tags, keys, vals


def empty_a_bucket(st, live):
    """Delete ops for every key of the first bucket that holds at least two,
    plus point and successor reads of them: the bucket ends empty."""
    nn = st.keys != EMPTY
    b = int(torch.nonzero(nn.sum((1, 2)) >= 2)[0])
    ks = st.keys[b][nn[b]].numpy().astype(np.int32)
    tags = np.concatenate([np.full(len(ks), tcore.OP_DELETE),
                           np.full(2, tcore.OP_POINT), np.full(2, tcore.OP_SUCCESSOR)])
    keys = np.concatenate([ks, ks[:2], ks[:2]])
    return tags.astype(np.int32), keys.astype(np.int32), np.zeros(len(keys), np.int32)


def reads_only(rng, live):
    """POINT and SUCCESSOR reads alone: every visited bucket writes nothing."""
    reads = np.concatenate([rng.choice(live, 30), rng.integers(0, 20000, 30)])
    tags = np.where(np.arange(60) % 3 == 0, tcore.OP_SUCCESSOR, tcore.OP_POINT)
    return tags.astype(np.int32), reads.astype(np.int32), np.zeros(60, np.int32)


def upserts(rng, live):
    """YCSB-A: new values for live keys and reads of live keys, a hot one
    many times; every updated bucket only rewrites values."""
    ups = rng.choice(live, 60, replace=False)
    reads = np.concatenate([rng.choice(live, 40), np.full(30, ups[0])])
    tags = np.concatenate([np.full(60, tcore.OP_INSERT), np.full(70, tcore.OP_POINT)])
    vals = np.concatenate([rng.integers(0, 1 << 30, 60), np.zeros(70)])
    return tags.astype(np.int32), np.concatenate([ups, reads]).astype(np.int32), vals.astype(
        np.int32)


BATCHES = {
    "mixed": lambda rng, st, live: mixed(rng, live),
    "upserts_and_reads": lambda rng, st, live: upserts(rng, live),
    "updates_only": lambda rng, st, live: mixed(rng, live, n_read=0, n_range=0),
    "reads_only": lambda rng, st, live: reads_only(rng, live),
    "bucket_deleted_to_empty": lambda rng, st, live: empty_a_bucket(st, live),
    "few_ops_many_empty_buckets": lambda rng, st, live: mixed(rng, live, n_ins=4, n_del=6,
                                                              n_read=4, n_range=1),
}


def run_all(js, ts, tags, keys, vals):
    """The batch through the JAX reference engine, the port's functional
    staged pass (on a copy) and its donated pass (on ``ts``).  Returns the
    three, each ``(state, results, stats)``, and the port's sorted batch."""
    pad = max(256, 1 << (len(keys) - 1).bit_length())
    jops, _ = jcore.make_ops(tags, keys, vals, pad_to=pad)
    tops, _ = tcore.make_ops(tags, keys, vals, pad_to=pad, device="cpu")
    want = jcore.apply_ops(js, jops, config=JExecConfig(impl="reference",
                                                        max_results=MAX_RESULTS))
    copy = dataclasses.replace(ts, **{f: getattr(ts, f).clone() for f in PLANES})
    functional = tcore.apply_ops(copy, tops, config=staged(False))
    donated = tcore.apply_ops(ts, tops, config=staged(True))
    return want, functional, donated, tops


def assert_same_result(a, b, msg=""):
    for k in RESULT_KEYS:
        assert torch.equal(a[1][k], b[1][k]), f"{msg}{k}"
    assert set(a[2]) == set(b[2])
    for k in a[2]:
        assert int(a[2][k]) == int(b[2][k]), f"{msg}{k}"


@pytest.mark.parametrize("kind", list(BATCHES))
def test_donated_pass_matches_functional_and_reference(kind):
    """Three batches of one kind in a row, each state donated to the next:
    every plane, result and stat byte-equal to the functional staged pass,
    and to the JAX reference engine by the parity contract; the donated
    input's planes are the result's and hold it afterwards, its own
    ``num_nodes`` stays the pre-batch one."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    js, ts, live = engine_state()
    live = set(live.tolist())
    for step in range(3):
        tags, keys, vals = BATCHES[kind](rng, ts, np.array(sorted(live), np.int32))
        before_nn = ts.num_nodes.clone()
        want, functional, donated, tops = run_all(js, ts, tags, keys, vals)
        got = donated[0]
        same_planes(planes(functional[0]), got, f"step {step}: ")
        assert_same_result(functional, donated, f"step {step}: ")
        assert_same_state(want[0], got)
        for k in RESULT_KEYS:
            assert_same(want[1][k], donated[1][k], f"step {step}: {k}")
        for k in want[2]:
            assert int(want[2][k]) == int(donated[2][k]), k
        for f in ("keys", "vals", "node_count", "node_max"):
            assert getattr(got, f) is getattr(ts, f), f  # the input's planes, written
        assert got.num_nodes is not ts.num_nodes and torch.equal(ts.num_nodes, before_nn)
        tcore.check_invariants(got)
        tcore.check_range_results(tops, donated[1], max_results=MAX_RESULTS)
        js, ts = want[0], got
        for t, k in zip(tags.tolist(), keys.tolist()):
            if t == tcore.OP_INSERT:
                live.add(k)
            elif t == tcore.OP_DELETE:
                live.discard(k)


def test_donated_pass_on_a_reference_made_state():
    """A JAX-built state whose freed slots keep stale values (the reference
    engine does not clear them): the donated result equals the functional
    one in every key, count, max and live value, and the reference's."""
    rng = np.random.default_rng(41)
    keys = np.sort(rng.choice(50000, 1500, replace=False)).astype(np.int32)
    js = jcore.build(keys, keys + 1, node_size=8, nodes_per_bucket=8)
    js, _ = jcore.delete(js, jnp.asarray(keys[::3]))
    live = np.setdiff1d(keys, keys[::3])
    ts = to_port(js)
    tags, bkeys, bvals = mixed(rng, live, space=50000, n_ins=200, n_del=200, n_read=100)
    want, functional, donated, _ = run_all(js, ts, tags, bkeys, bvals)
    assert_same_state(want[0], donated[0])
    assert_same_state(want[0], functional[0])
    live_slots = donated[0].keys != EMPTY
    assert torch.equal(functional[0].vals[live_slots], donated[0].vals[live_slots])
    assert_same_result(functional, donated)


@pytest.mark.parametrize("entry", ["apply_ops", "apply_ops_safe"])
@pytest.mark.parametrize("donate", [False, None])
def test_no_donation_leaves_the_input_whole(entry, donate):
    """``donate=False`` everywhere, and None (the default) in ``apply_ops``,
    write a new state: the input bit for bit as it was.  (None in
    ``apply_ops_safe`` donates: checked against ``apply_ops_safe`` with
    False.)"""
    rng = np.random.default_rng(7)
    _, ts, live = engine_state()
    tags, keys, vals = mixed(rng, live)
    ops, _ = tcore.make_ops(tags, keys, vals, pad_to=256, device="cpu")
    before = planes(ts)
    fn = getattr(tcore, entry)
    got = fn(ts, ops, config=staged(donate))
    if entry == "apply_ops_safe" and donate is None:
        assert got[0].keys is ts.keys
        want = fn(dataclasses.replace(ts, **before), ops, config=staged(False))
        same_planes(planes(want[0]), got[0])
        assert_same_result(want, got)
    else:
        same_planes(before, ts)
        assert got[0].keys is not ts.keys


def _flood(npb=2, ns=4):
    """A batch of 100 inserts into 64 keys of 4-key nodes, 2 a bucket, with
    reads: several buckets overflow."""
    keys = np.arange(0, 640, 10, dtype=np.int32)
    js = jcore.build(keys, keys, node_size=ns, nodes_per_bucket=npb)
    ts = tcore.build(keys, keys, node_size=ns, nodes_per_bucket=npb, device="cpu")
    flood = np.arange(1, 200, 2, dtype=np.int32)
    tags = np.concatenate([np.full(len(flood), tcore.OP_INSERT),
                           np.full(len(keys), tcore.OP_POINT)]).astype(np.int32)
    bkeys = np.concatenate([flood, keys]).astype(np.int32)
    bvals = np.concatenate([flood * 7, np.zeros(len(keys), np.int32)]).astype(np.int32)
    return js, ts, tags, bkeys, bvals


def test_donated_overflow_writes_nothing():
    """A donated batch that overflows a bucket leaves the input whole and
    returns its planes flagged for restructuring, the reads unanswered, the
    insert and overflow counts those of the functional pass."""
    js, ts, tags, keys, vals = _flood()
    ops, _ = tcore.make_ops(tags, keys, vals, pad_to=256, device="cpu")
    before = planes(ts)
    functional = tcore.apply_ops(ts, ops, config=staged(False))
    got = tcore.apply_ops(ts, ops, config=staged(True))
    same_planes(before, ts)
    assert got[0].keys is ts.keys and bool(got[0].needs_restructure)
    assert torch.equal(got[0].num_nodes, ts.num_nodes)
    assert bool((got[1]["value"] == NOT_FOUND).all())
    assert bool((got[1]["succ_key"] == EMPTY).all())
    for k in ("inserted", "overflowed_buckets"):
        assert int(got[2][k]) == int(functional[2][k]) > 0, k
    assert int(got[2]["deleted"]) == 0


def test_donated_retry_starts_from_the_whole_input(monkeypatch):
    """``apply_ops_safe`` donating an overflowing batch: the state the
    restructure regrows is the input, unchanged, and the retry's result is
    the reference's ``apply_ops_safe``'s."""
    js, ts, tags, keys, vals = _flood()
    jops, _ = jcore.make_ops(tags, keys, vals, pad_to=256)
    ops, _ = tcore.make_ops(tags, keys, vals, pad_to=256, device="cpu")
    before = planes(ts)
    seen = []
    grow = tops_mod.restructure_grow

    def spy(state, **kw):
        seen.append(planes(state))
        return grow(state, **kw)

    monkeypatch.setattr(tops_mod, "restructure_grow", spy)
    want = jcore.apply_ops_safe(js, jops, config=JExecConfig(impl="reference",
                                                             max_results=MAX_RESULTS))
    got = tcore.apply_ops_safe(ts, ops, config=staged(None, validate=True))
    assert len(seen) == 1
    for f in PLANES:
        assert torch.equal(before[f], seen[0][f]), f
    assert got[2]["restructure_retries"] == want[2]["restructure_retries"] == 1
    assert_same_state(want[0], got[0])
    for k in RESULT_KEYS:
        assert_same(want[1][k], got[1][k], k)


@pytest.mark.parametrize("overflow", [False, True])
def test_flagged_input_is_rerun_without_donation(overflow):
    """An input already flagged ``needs_restructure``: the donated call
    writes nothing, and ``apply_ops_safe`` returns what it returns without
    donation (no retry), the input whole."""
    if overflow:
        _, ts, tags, keys, vals = _flood()
    else:
        _, ts, live = engine_state()
        tags, keys, vals = mixed(np.random.default_rng(9), live)
    ts = dataclasses.replace(ts, needs_restructure=torch.ones((), dtype=torch.bool))
    ops, _ = tcore.make_ops(tags, keys, vals, pad_to=256, device="cpu")
    before = planes(ts)
    donated = tcore.apply_ops(ts, ops, config=staged(True))
    same_planes(before, ts)
    assert donated[0].keys is ts.keys and bool(donated[0].needs_restructure)
    want = tcore.apply_ops_safe(ts, ops, config=staged(False))
    got = tcore.apply_ops_safe(ts, ops, config=staged(None))
    same_planes(before, ts)
    same_planes(planes(want[0]), got[0])
    assert_same_result(want, got)
    assert got[2]["restructure_retries"] == 0


@pytest.mark.parametrize("config,runs", [
    (staged(None), [True, False]),
    (staged(False), [False]),
    (tcore.ExecConfig(impl="fused", pipeline="off", max_results=MAX_RESULTS), [False]),
    (tcore.ExecConfig(impl="reference", max_results=MAX_RESULTS), [False]),
], ids=["donated", "not-donated", "pipeline-off", "reference"])
def test_flagged_input_is_rerun_only_after_a_donated_call(monkeypatch, config, runs):
    """``apply_ops_safe`` on an input already flagged ``needs_restructure``
    runs the batch a second time only where its first call donated: a
    call that wrote a new state already holds the answer."""
    _, ts, live = engine_state()
    tags, keys, vals = mixed(np.random.default_rng(11), live)
    ts = dataclasses.replace(ts, needs_restructure=torch.ones((), dtype=torch.bool))
    ops, _ = tcore.make_ops(tags, keys, vals, pad_to=256, device="cpu")
    seen, run = [], tops_mod._apply

    def spy(*args, **kw):
        out, donated = run(*args, **kw)
        seen.append(donated)
        return out, donated

    monkeypatch.setattr(tops_mod, "_apply", spy)
    got = tcore.apply_ops_safe(ts, ops, config=config)
    assert seen == runs
    assert bool(got[0].needs_restructure) and got[2]["restructure_retries"] == 0


def bucket_of(st, ops):
    return _bucket_index(st, ops.key)


def test_plain_inplace_pass_counts():
    """The donated pass's counts: the inserts cut at capacity, the keys
    deleted, the overflowing buckets, the buckets with inserts or deletes
    and those whose overflow the merge's plan decides, as the functional
    pass's stats and the routing give them."""
    rng = np.random.default_rng(12)
    _, ts, live = engine_state()
    tags, keys, vals = mixed(rng, live)
    # six fresh keys into one bucket of 4 slots a node, 4 nodes: nn + m > npb
    lo, hi = int(ts.mkba[10]) + 1, int(ts.mkba[11])
    dense = np.setdiff1d(np.arange(lo, hi + 1), np.concatenate([live, keys]))[:6]
    assert dense.size == 6
    tags = np.concatenate([tags, np.full(6, tcore.OP_INSERT, np.int32)])
    keys = np.concatenate([keys, dense]).astype(np.int32)
    vals = np.concatenate([vals, dense]).astype(np.int32)
    ops, _ = tcore.make_ops(tags, keys, vals, pad_to=256, device="cpu")
    args, r = fa.stripe_inputs(ts, ops.tag, ops.key, ops.val)
    want = fa.flix_apply_staged_pass(ts.num_nodes, *args)
    before = (ts.keys != EMPTY).sum((1, 2))
    nn, value, succ, counts = fa.flix_apply_inplace_pass(
        ts.num_nodes, ts.node_count, ts.needs_restructure, ops.val, bucket_of(ts, ops), *args)
    m, dn = r.ins_ends - r.ins_starts, r.del_ends - r.del_starts
    assert counts.dtype == torch.int32 and counts.shape == (5,)
    assert int(counts[0]) == int(m.sum())
    assert int(counts[1]) == int(want[6].sum())
    assert int(counts[2]) == 0
    fresh = (want[0] != EMPTY).sum((1, 2)) > before - want[6]  # an insert of a new key
    assert int(counts[3]) == int(((dn > 0) | ((m > 0) & fresh)).sum())
    assert 0 < int(counts[4]) < int(counts[3])
    assert torch.equal(nn, want[4])
    assert torch.equal(value, want[7]) and torch.equal(succ, want[8])
    for got_plane, want_plane in zip((ts.keys, ts.vals, ts.node_count, ts.node_max), want[:4]):
        assert torch.equal(got_plane, want_plane)


def test_inplace_pass_input_checks():
    _, ts, live = engine_state()
    ops, _ = tcore.make_ops(np.array([tcore.OP_POINT], np.int32),
                            np.array([int(live[0])], np.int32), device="cpu")
    args, _ = fa.stripe_inputs(ts, ops.tag, ops.key, ops.val)
    b, v = bucket_of(ts, ops), ops.val
    with pytest.raises(ValueError, match="needs_restructure"):
        fa.flix_apply_inplace_pass(ts.num_nodes, ts.node_count,
                                   ts.needs_restructure.to(torch.int32), v, b, *args)
    with pytest.raises(ValueError, match="geometry"):
        fa.flix_apply_inplace_pass(ts.num_nodes[:-1], ts.node_count, ts.needs_restructure, v, b,
                                   *args)
    with pytest.raises(ValueError, match="an entry an op"):
        fa.flix_apply_inplace_pass(ts.num_nodes, ts.node_count, ts.needs_restructure, v,
                                   b[:-1], *args)
    with pytest.raises(ValueError, match="block_b"):
        fa.flix_apply_inplace_pass(ts.num_nodes, ts.node_count, ts.needs_restructure, v, b,
                                   *args, block_b=9)
    with pytest.raises(ValueError, match="staged"):
        fa.flix_apply(ts, ops.tag, ops.key, ops.val, donate=True)
