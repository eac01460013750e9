"""TTL parity: the port's expiry layer (``core/expiry.py``, ``OP_EXPIRE``,
``apply_ops(now=)``, I6) against the JAX reference and against the
mocked-clock dict model of ``tests/clock_model.py``, on seeded numpy inputs
(CPU, exact: all int32, vals compared at live slots only)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clock_model import TTLModel, VirtualClock, check_one_update_op_per_key  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.checkpoint.serialize import state_from_pairs  # noqa: E402
from repro.core.config import ExecConfig as JExecConfig  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from test_torch_common import EMPTY, assert_same, assert_same_state  # noqa: E402

torch.set_num_threads(1)

KEY_SPACE = 2000
PAD = 128
BUDGET = 256
GEOMETRY = dict(node_size=4, nodes_per_bucket=4)
NO_TTL = int(tcore.NO_EXPIRY)
RESULT_KEYS = ("value", "succ_key", "range_key", "range_val", "range_start", "range_count")


def to_port_ttl(jstate) -> "tcore.FliXState":
    """Every field of a JAX state, the expiry plane included, on the CPU."""
    names = tcore.state.STATE_FIELDS + ("exps",)
    arrays = {f: None if getattr(jstate, f) is None else np.asarray(getattr(jstate, f))
              for f in names}
    return tcore.state_from_numpy(arrays, "cpu")


def assert_same_ttl_state(jstate, tstate):
    assert_same_state(jstate, tstate)
    assert (jstate.exps is None) == (tstate.exps is None)
    if jstate.exps is not None:
        assert_same(jstate.exps, tstate.exps, "exps")


def _ttl_pairs(rng, n=300, now=0):
    keys = np.sort(rng.choice(KEY_SPACE, n, replace=False)).astype(np.int32)
    ttl = rng.integers(1, 120, n)
    exps = np.where(rng.random(n) < 0.7, now + ttl, NO_TTL).astype(np.int32)
    return keys, (keys * 7 + 1).astype(np.int32), exps


def _batch(rng, now):
    """One mixed TTL batch: inserts with deadlines (some already past),
    get-or-sets, deletes, and POINT/SUCCESSOR/RANGE reads."""
    upd = rng.choice(KEY_SPACE, 40, replace=False)
    ins, gs, dels = upd[:18], upd[18:30], upd[30:]
    ins_exp = np.where(rng.random(18) < 0.25, NO_TTL, now + rng.integers(-10, 60, 18))
    points = rng.integers(0, KEY_SPACE, 20)
    succs = rng.integers(0, KEY_SPACE, 12)
    rlo = rng.integers(0, KEY_SPACE, 4)
    rhi = rlo + rng.integers(-40, 500, 4)
    tags = np.concatenate([
        np.full(18, tcore.OP_INSERT), np.full(12, tcore.OP_EXPIRE),
        np.full(10, tcore.OP_DELETE), np.full(20, tcore.OP_POINT),
        np.full(12, tcore.OP_SUCCESSOR), np.full(4, tcore.OP_RANGE),
    ]).astype(np.int32)
    keys = np.concatenate([ins, gs, dels, points, succs, rlo]).astype(np.int32)
    vals = np.concatenate([
        ins * 13 + now, gs * 17 + now, np.zeros(10 + 20 + 12), rhi,
    ]).astype(np.int32)
    exps = np.concatenate([
        ins_exp, now + rng.integers(1, 60, 12), np.full(46, NO_TTL),
    ]).astype(np.int32)
    assert check_one_update_op_per_key(tags, keys)
    return tags, keys, vals, exps


def _workload(seed, n_batches=3):
    rng = np.random.default_rng(seed)
    pairs = _ttl_pairs(rng)
    clock = VirtualClock()
    batches = []
    for _ in range(n_batches):
        now = clock.advance(int(rng.integers(0, 40)))
        batches.append((now, *_batch(rng, now)))
    return pairs, batches


@pytest.fixture(scope="module")
def reference_run():
    """The JAX reference engine's trajectory over one seeded TTL workload:
    per batch, (ops arrays, post-state, results, stats)."""
    pairs, batches = _workload(11)
    js = state_from_pairs(*pairs, **GEOMETRY)
    start = js
    out = []
    for now, tags, keys, vals, exps in batches:
        ops, _ = jcore.make_ops(tags, keys, vals, exps=jnp.asarray(exps), pad_to=PAD)
        js, res, stats = jcore.apply_ops_safe(
            js, ops, now=now,
            config=JExecConfig(impl="reference", max_results=BUDGET, validate=True),
        )
        out.append(((now, tags, keys, vals, exps), js, res, stats))
    return start, out


@pytest.mark.parametrize("impl", ["reference", "fused"])
def test_apply_ops_ttl_matches_reference(reference_run, impl):
    """now=, OP_EXPIRE and both planes, batch for batch, on either executor
    (the fused one runs its plain version on the CPU): state with its expiry
    plane, results and stats equal to the JAX reference engine."""
    start, run = reference_run
    ts = to_port_ttl(start)
    for (now, tags, keys, vals, exps), js, jres, jstats in run:
        ops, _ = tcore.make_ops(tags, keys, vals, exps=exps, pad_to=PAD, device="cpu")
        assert ops.exp is not None and ops.exp.shape == (PAD,)
        ts, res, stats = tcore.apply_ops_safe(
            ts, ops, now=now,
            config=tcore.ExecConfig(impl=impl, max_results=BUDGET, validate=True,
                                    validate_ranges=True),
        )
        assert_same_ttl_state(js, ts)
        for k in RESULT_KEYS:
            assert_same(jres[k], res[k], k)
        for k in jstats:
            assert int(jstats[k]) == int(stats[k]), k
        assert int(stats["expired"]) > 0 or now == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_port_matches_the_clock_model(seed):
    """The mocked-clock dict model against the port, batch for batch:
    values in submission order, the expired count, the dense RANGE output
    and the live key set."""
    pairs, batches = _workload(seed, n_batches=4)
    ts = to_port_ttl(state_from_pairs(*pairs, **GEOMETRY))
    model = TTLModel(zip(*(a.tolist() for a in pairs)))
    for now, tags, keys, vals, exps in batches:
        ops, perm = tcore.make_ops(tags, keys, vals, exps=exps, pad_to=PAD, device="cpu")
        ts, res, stats = tcore.apply_ops_safe(
            ts, ops, now=now,
            config=tcore.ExecConfig(impl="fused", max_results=BUDGET, validate=True),
        )
        want, want_expired = model.apply(tags, keys, vals, exps, now=now)
        got = tcore.unsort(res["value"], perm).numpy()[: len(tags)]
        np.testing.assert_array_equal(got, want)
        assert int(stats["expired"]) == want_expired
        dk, dv, starts, counts, truncated = model.range_segments(tags, keys, vals, BUDGET)
        np.testing.assert_array_equal(res["range_key"][: len(dk)].numpy(), dk)
        np.testing.assert_array_equal(res["range_val"][: len(dv)].numpy(), dv)
        rs = tcore.unsort(res["range_start"], perm).numpy()
        rc = tcore.unsort(res["range_count"], perm).numpy()
        for i, s in starts.items():
            assert rs[i] == s and rc[i] == counts[i]
        assert int(stats["range_truncated"]) == truncated
        live = ts.keys[ts.keys != EMPTY].numpy()
        np.testing.assert_array_equal(np.sort(live), np.array(model.live(), np.int32))


def test_expiry_functions_match_reference():
    """expire_state at several clocks, attach_expiry and bucket_min_exp; a
    bucket without an expired row keeps its bytes."""
    rng = np.random.default_rng(5)
    keys, vals, exps = _ttl_pairs(rng)
    js = state_from_pairs(keys, vals, exps, **GEOMETRY)
    ts = to_port_ttl(js)
    assert_same(jcore.bucket_min_exp(js), tcore.bucket_min_exp(ts))
    for now in (0, 30, 80, 200):
        jn, jcount = jcore.expire_state(js, now)
        tn, tcount = tcore.expire_state(ts, now)
        assert int(jcount) == int(tcount)
        assert_same_ttl_state(jn, tn)
        kept = ~(tn.keys != ts.keys).reshape(ts.num_buckets, -1).any(1)
        assert torch.equal(tn.vals[kept], ts.vals[kept])
        assert torch.equal(tn.exps[kept], ts.exps[kept])
        assert_same(jcore.bucket_min_exp(jn), tcore.bucket_min_exp(tn))
        tcore.check_invariants(tn, now=now)
    # nothing expired: the state itself comes back
    assert tcore.expire_state(ts, -1)[0] is ts
    plain = tcore.build(keys, vals, **GEOMETRY, device="cpu")
    jplain = jcore.build(keys, vals, **GEOMETRY)
    assert_same(jcore.bucket_min_exp(jplain), tcore.bucket_min_exp(plain))
    att = tcore.attach_expiry(plain)
    assert_same_ttl_state(jcore.attach_expiry(jplain), att)
    assert tcore.attach_expiry(att) is att
    given = torch.full(plain.keys.shape, 7, dtype=torch.int32)
    assert torch.equal(tcore.attach_expiry(plain, given).exps, given)
    with pytest.raises(ValueError, match="expiry plane"):
        tcore.expire_state(plain, 0)


def test_restructure_and_delete_of_a_ttl_state():
    """restructure carries the expiry plane (the same layout as the keys);
    delete returns its state without it, as the reference's delete does
    (the TTL engine keeps the plane by running the executor on it)."""
    rng = np.random.default_rng(9)
    keys, vals, exps = _ttl_pairs(rng)
    js = state_from_pairs(keys, vals, exps, **GEOMETRY)
    ts = to_port_ttl(js)
    for nb, npb in ((40, 4), (200, 2)):
        want = jcore.restructure(js, num_buckets=nb, nodes_per_bucket=npb)
        got = tcore.restructure(ts, num_buckets=nb, nodes_per_bucket=npb)
        assert_same_ttl_state(want, got)
        tcore.check_invariants(got)
    assert_same_ttl_state(jcore.restructure_grow(js, extra_keys=400),
                          tcore.restructure_grow(ts, extra_keys=400))
    dk = np.sort(rng.choice(keys, 60, replace=False)).astype(np.int32)
    want, wstats = jcore.delete(js, jnp.asarray(dk))
    got, tstats = tcore.delete(ts, torch.as_tensor(dk))
    assert_same_ttl_state(want, got)
    assert int(wstats["deleted"]) == int(tstats["deleted"]) == 60


def test_invariant_i6():
    """Engine states pass I6 at their clock; a live row past its deadline
    and a deadline left on an empty slot both fail."""
    rng = np.random.default_rng(3)
    keys, vals, exps = _ttl_pairs(rng)
    ts = to_port_ttl(state_from_pairs(keys, vals, exps, **GEOMETRY))
    tcore.check_invariants(ts)
    with pytest.raises(AssertionError, match="I6"):
        tcore.check_invariants(ts, now=60)
    expired, _ = tcore.expire_state(ts, 60)
    tcore.check_invariants(expired, now=60)
    dirty = expired.exps.clone()
    dirty[expired.keys == EMPTY] = 5
    bad = tcore.FliXState(**{**expired.__dict__, "exps": dirty})
    with pytest.raises(AssertionError, match="I6"):
        tcore.check_invariants(bad)


def test_same_batch_edge_and_get_or_set():
    """A row written already past its deadline serves its own batch and
    falls to the next batch's pre-pass; OP_EXPIRE returns a stored value
    (NOT_FOUND-valued keys included) and refreshes its deadline."""
    keys = np.array([10, 20, 30], np.int32)
    vals = np.array([100, -1, 300], np.int32)
    ts = tcore.build(keys, vals, **GEOMETRY, device="cpu")
    tags = np.array([tcore.OP_INSERT, tcore.OP_EXPIRE, tcore.OP_EXPIRE, tcore.OP_POINT],
                    np.int32)
    bk = np.array([40, 20, 50, 40], np.int32)
    bv = np.array([400, 9, 500, 0], np.int32)
    be = np.array([5, 70, 80, NO_TTL], np.int32)
    ops, perm = tcore.make_ops(tags, bk, bv, exps=be, device="cpu")
    cfg = tcore.ExecConfig(impl="fused", validate=True)
    ts, res, _ = tcore.apply_ops_safe(ts, ops, now=10, config=cfg)
    assert tcore.unsort(res["value"], perm).tolist() == [-1, -1, -1, 400]
    pq = np.array([20, 40, 50], np.int32)
    ops, _ = tcore.make_ops(np.full(3, tcore.OP_POINT, np.int32), pq, device="cpu")
    ts, res, stats = tcore.apply_ops_safe(ts, ops, now=11, config=cfg)
    assert res["value"].tolist() == [-1, -1, 500] and int(stats["expired"]) == 1
    ops, _ = tcore.make_ops(np.full(1, tcore.OP_POINT, np.int32), [20], device="cpu")
    _, _, stats = tcore.apply_ops_safe(ts, ops, now=70, config=cfg)
    assert int(stats["expired"]) == 1  # 20's deadline was refreshed to 70
