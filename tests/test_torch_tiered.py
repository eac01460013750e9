"""Tiered residency (``repro_torch.core.residency``) against the JAX
reference's ``TieredFliX``, in lockstep on the CPU.

Both packages get the same numpy inputs and run their tiered engines with
``impl="reference"``.  After every batch the two must agree on the
results, the stats (the residency counters ``promoted`` / ``demoted`` /
``resident_bytes`` / ``reclaimed_bytes`` included), ``resident_ids``, the
per-bucket metadata ``h_live`` / ``h_min_exp``, the synced mirror (keys,
node_count, node_max, num_nodes, mkba and exps byte-equal, vals at live
slots) and the canonical bytes of the host view; the port's I7 holds.

Cases: ``touched_buckets`` on random and adversarial batches; the host
build; a budget sweep (unbounded, a tenth, one bucket) over the
reference's adversarial mixed batches; TTL under a moving clock; overflow
with its grow and replay; a read-only batch; ``restructure_shrink`` and
``compact``; I7's negative cases.  Geometry 8 x 8 (nodes of 8 keys, 8 a
bucket) unless a case says otherwise.  The serving path over a tiered
index (``KVPageIndex(device_budget=...)``, durable recovery, the gateway)
is in ``test_torch_tiered_serve.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.checkpoint import serialize as jser  # noqa: E402
from repro.core import residency as jres  # noqa: E402
from repro.core.config import ExecConfig as JExecConfig  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.checkpoint import serialize as tser  # noqa: E402
from repro_torch.core import residency as tres  # noqa: E402
from repro_torch.core.state import STATE_FIELDS  # noqa: E402
from test_tiered import _mixed_batches  # noqa: E402
from test_torch_common import assert_same_state  # noqa: E402

torch.set_num_threads(1)

GEOM = dict(node_size=8, nodes_per_bucket=8)
EMPTY = int(tcore.EMPTY)
NO_EXPIRY = int(tcore.NO_EXPIRY)
REF = JExecConfig(impl="reference")
PORT = tcore.ExecConfig(impl="reference")


def to_port(jstate):
    """The JAX state as a port state on the CPU, its expiry plane too."""
    arrays = {f: np.asarray(getattr(jstate, f)) for f in STATE_FIELDS}
    if jstate.exps is not None:
        arrays["exps"] = np.asarray(jstate.exps)
    return tcore.state_from_numpy(arrays, "cpu")


def host_bytes(view, ser) -> bytes:
    """Canonical bytes of a host view, by the package's own serializer."""
    return ser.pairs_to_bytes(*ser.bucket_segments(view)[1:])


def assert_same_tiered(jt, tt, msg=""):
    """The two tiered engines hold the same residency and the same mirror."""
    np.testing.assert_array_equal(jt.resident_ids, tt.resident_ids, err_msg=f"{msg}:ids")
    for name in ("promoted_total", "demoted_total", "reclaimed_total", "needs_restructure",
                 "budget_buckets", "bucket_bytes", "geometry"):
        assert getattr(jt, name) == getattr(tt, name), f"{msg}:{name}"
    assert jt.memory_bytes_resident() == tt.memory_bytes_resident(), msg
    np.testing.assert_array_equal(jt.h_live, tt.h_live, err_msg=f"{msg}:h_live")
    np.testing.assert_array_equal(jt.h_min_exp, tt.h_min_exp, err_msg=f"{msg}:h_min_exp")
    np.testing.assert_array_equal(jt.last_used, tt.last_used, err_msg=f"{msg}:last_used")
    jv, tv = jt.host_view(), tt.host_view()
    for f in ("keys", "node_count", "node_max", "num_nodes", "mkba"):
        np.testing.assert_array_equal(getattr(jv, f), getattr(tv, f).numpy(), err_msg=f)
    live = jv.keys != EMPTY
    np.testing.assert_array_equal(jv.vals[live], tv.vals.numpy()[live], err_msg=f"{msg}:vals")
    assert (jv.exps is None) == (tv.exps is None), msg
    if jv.exps is not None:
        np.testing.assert_array_equal(jv.exps, tv.exps.numpy(), err_msg=f"{msg}:exps")
    assert host_bytes(jv, jser) == host_bytes(tv, tser), f"{msg}:canonical"


def assert_same_apply(want, got, msg=""):
    """``(results, stats, restructured)`` of both packages' ``apply``."""
    (wr, ws, wre), (gr, gs, gre) = want, got
    assert wre == gre, msg
    assert set(wr) == set(gr), msg
    for k in wr:
        np.testing.assert_array_equal(np.asarray(wr[k]), gr[k].numpy(), err_msg=f"{msg}:{k}")
    assert set(ws) == set(gs), msg
    for k in ws:
        assert int(ws[k]) == int(gs[k]), f"{msg}:stats:{k}"


class Twin:
    """Both packages' ``TieredFliX`` from one JAX state, driven as one."""

    def __init__(self, jstate, budget):
        self.j = jres.TieredFliX.from_state(jstate, budget_bytes=budget)
        self.t = tres.TieredFliX.from_state(to_port(jstate), budget_bytes=budget)
        assert self.t.device.type == "cpu"
        assert_same_tiered(self.j, self.t, "from_state")

    def apply(self, tags, keys, vals, exps=None, *, now=None, commit=True, msg=""):
        jops, _ = jcore.make_ops(tags, keys, vals, exps=exps)
        tops, _ = tcore.make_ops(tags, keys, vals, exps=exps, device="cpu")
        want = self.j.apply(jops, config=REF, now=now, commit=commit)
        got = self.t.apply(tops, config=PORT, now=now, commit=commit)
        assert_same_apply(want, got, msg)
        assert_same_tiered(self.j, self.t, msg)
        tcore.check_tiered_invariants(self.t, now=now)
        return jops, got


@pytest.fixture
def seeded(rng):
    """The reference's adversarial base state (test_tiered.py's fixture):
    boundary keys, chains, 30000 emptied keys."""
    keys = rng.choice(120000, size=2500, replace=False).astype(np.int32)
    keys = np.unique(np.concatenate([keys, [0, int(tcore.MAX_VALID)]])).astype(np.int32)
    st = jcore.build(keys, np.arange(len(keys), dtype=np.int32), **GEOM)
    st, _ = jcore.delete(st, jnp.asarray(np.arange(30000, 60000, dtype=np.int32)))
    live = keys[(keys < 30000) | (keys >= 60000)]
    return st, live


def budgets(state):
    full = state.memory_bytes()
    return {"unbounded": None, "tenth": max(1, full // 10), "one_bucket": 1}


# ---------------------------------------------------------------------------
# the prefetch pre-pass and the host build
# ---------------------------------------------------------------------------


def test_touched_buckets_matches_the_reference(seeded, rng):
    st, live = seeded
    mkba = np.asarray(st.mkba)
    nb = mkba.size
    live_b = np.asarray(st.node_count).sum(axis=1).astype(np.int32)
    assert (live_b == 0).sum() > 20  # an emptied run of buckets
    min_exp = np.where(rng.random(nb) < 0.2, rng.integers(0, 100, nb), NO_EXPIRY).astype(
        np.int32
    )
    ops = [(name, tags, keys, vals) for name, tags, keys, vals in _mixed_batches(rng, live)]
    n = 400
    q = np.sort(rng.integers(0, 130000, n)).astype(np.int32)
    tags = rng.choice(np.array([0, 1, 2, 3, 5, 6], np.int32), n)
    ops.append(("random", tags, q, np.minimum(q + rng.integers(-100, 9000, n), 130000)))
    # successors inside the emptied run, with and without an insert there
    walk = np.array([29500, 31000, 45000, 59990, 61000], np.int32)
    ops.append(("succ_walk", np.full(5, 3, np.int32), walk, np.zeros(5, np.int32)))
    ops.append(("succ_insert", np.array([3, 0, 3, 3, 1], np.int32),
                np.array([30001, 40000, 45000, 59990, 60001], np.int32), np.zeros(5, np.int32)))
    ops.append(("succ_past_end", np.full(2, 3, np.int32),
                np.array([int(tcore.MAX_VALID), EMPTY], np.int32), np.zeros(2, np.int32)))
    checked = 0
    for name, tags, keys, vals in ops:
        for kw in (dict(live=live_b, min_exp=min_exp, now=50), dict(live=live_b),
                   dict(live=None), dict(live=live_b, now=50), dict(min_exp=min_exp, now=50)):
            want = jcore.touched_buckets(mkba, tags, keys, vals, **kw)
            got = tcore.touched_buckets(mkba, tags, keys, vals, **kw)
            assert got.dtype == bool and got.shape == (nb,)
            np.testing.assert_array_equal(want, got, err_msg=f"{name} {sorted(kw)}")
            checked += int(got.sum())
    assert checked > 0
    # an empty batch touches nothing; now alone promotes the condemned
    none = np.zeros(0, np.int32)
    assert not tcore.touched_buckets(mkba, none, none, none).any()
    got = tcore.touched_buckets(mkba, none, none, none, min_exp=min_exp, now=50)
    np.testing.assert_array_equal(got, min_exp <= 50)


def test_host_build_matches_state_from_pairs(rng):
    keys = np.sort(rng.choice(1 << 20, 3001, replace=False)).astype(np.int32)
    vals = rng.integers(-(1 << 30), 1 << 30, keys.size).astype(np.int32)
    exps = np.where(rng.random(keys.size) < 0.3, rng.integers(0, 1000, keys.size),
                    NO_EXPIRY).astype(np.int32)
    for e in (None, exps, np.full(keys.size, NO_EXPIRY, np.int32)):
        for geom in (GEOM, dict(node_size=32, nodes_per_bucket=16), dict(node_size=4,
                                                                         nodes_per_bucket=2)):
            got = tres._host_build(keys, vals, e, **geom)
            want = jres._host_build(keys, vals, e, **geom)
            for g, w, f in zip(got, want, ("keys", "vals", "node_count", "node_max",
                                           "num_nodes", "mkba", "exps")):
                assert (g is None) == (w is None), f
                if w is not None:
                    np.testing.assert_array_equal(w, g, err_msg=f)
            st = tser.state_from_pairs(keys, vals, e, **geom, device="cpu")
            tt = tres.TieredFliX.from_pairs(keys, vals, e, **geom, device="cpu")
            assert tt.geometry == st.geometry
            for f in ("keys", "vals", "node_count", "node_max", "num_nodes", "mkba"):
                np.testing.assert_array_equal(getattr(st, f).numpy(), getattr(tt, f"h_{f}"))
            assert (st.exps is None) == (tt.h_exps is None)
            if st.exps is not None:
                np.testing.assert_array_equal(st.exps.numpy(), tt.h_exps)
            tcore.check_tiered_invariants(tt)
    assert tres.bucket_device_bytes(16, 32, False) == 4232
    assert tres.bucket_device_bytes(16, 32, True) == 6280


# ---------------------------------------------------------------------------
# the engine in lockstep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", ["unbounded", "tenth", "one_bucket"])
def test_budget_sweep_in_lockstep(seeded, rng, budget):
    st, live = seeded
    b = budgets(st)[budget]
    twin = Twin(st, b)
    oracle = to_port(st)
    for name, tags, keys, vals in _mixed_batches(rng, live):
        twin.apply(tags, keys, vals, msg=f"{budget}/{name}")
        ops, _ = tcore.make_ops(tags, keys, vals, device="cpu")
        oracle, _, _ = tcore.apply_ops(oracle, ops, config=PORT)
    # the logical state is the single-tier engine's
    assert host_bytes(twin.t.host_view(), tser) == tser.canonical_state_bytes(oracle)
    if b is not None:
        assert twin.t.memory_bytes_resident() <= max(b, twin.t.bucket_bytes)
    if budget == "one_bucket":
        assert twin.t.demoted_total > 0 and twin.t.budget_buckets == 1


def test_ttl_with_a_moving_clock(rng):
    keys = np.sort(rng.choice(8192, 500, replace=False)).astype(np.int32)
    vals = (keys * 3 + 1).astype(np.int32)
    exps = np.where(np.arange(500) % 3 == 0, 40 + (keys % 200), NO_EXPIRY).astype(np.int32)
    st = jser.state_from_pairs(keys, vals, exps, **GEOM)
    twin = Twin(st, max(1, st.memory_bytes() // 10))
    for now in (0, 60, 150, 400):
        q = np.sort(rng.choice(8192, 64)).astype(np.int32)
        tags = rng.choice(np.array([6, 2, 3], np.int32), 64, p=[0.4, 0.3, 0.3])
        e = np.where(tags == 6, now + 37 + (q % 50), NO_EXPIRY).astype(np.int32)
        _, (_, stats, _) = twin.apply(tags, q, (q * 5 + now).astype(np.int32), e, now=now,
                                      msg=f"now={now}")
        assert int(stats["expired"]) >= 0
    assert twin.t.expired_buckets(10_000).size > 0


def test_ttl_plane_appears_mid_stream(rng):
    """The first batch with deadlines gives the mirror an expiry plane: the
    bucket's bytes grow and the budget admits fewer buckets."""
    keys = np.arange(0, 4000, 2, dtype=np.int32)
    st = jcore.build(keys, keys // 2, **GEOM)
    twin = Twin(st, st.memory_bytes() // 4)
    before = (twin.t.bucket_bytes, twin.t.budget_buckets)
    twin.apply(np.zeros(8, np.int32), np.arange(1, 17, 2, dtype=np.int32), np.arange(8),
               msg="no ttl")
    q = np.arange(101, 133, 2, dtype=np.int32)
    twin.apply(np.full(16, 6, np.int32), q, q, np.full(16, 50, np.int32), now=10, msg="ttl")
    assert twin.t.h_exps is not None
    assert twin.t.bucket_bytes > before[0] and twin.t.budget_buckets < before[1]
    twin.apply(np.full(4, 2, np.int32), q[:4], np.zeros(4, np.int32), now=60, msg="expired")


def test_overflow_grows_and_replays_in_lockstep(rng):
    keys = np.sort(rng.choice(4096, 400, replace=False)).astype(np.int32)
    st = jcore.build(keys, (keys * 7 + 1).astype(np.int32), node_size=8, nodes_per_bucket=4)
    twin = Twin(st, max(1, st.memory_bytes() // 8))
    oracle = to_port(st)
    grew = 0
    for t in range(6):
        fresh = 1000 + rng.choice(600, 48, replace=False).astype(np.int32)
        tags = np.full(48, 0, np.int32)
        tags[40:] = 2
        vals = (fresh * 13 + t).astype(np.int32)
        _, (_, stats, restructured) = twin.apply(tags, fresh, vals, msg=f"flood{t}")
        ops, _ = tcore.make_ops(tags, fresh, vals, device="cpu")
        oracle, _, ostats = tcore.apply_ops_safe(oracle, ops, config=PORT)
        assert restructured == bool(ostats["restructure_retries"]) == bool(
            stats["restructure_retries"])
        grew += int(restructured)
        assert twin.t.geometry == oracle.geometry
        assert_same_state_tiered(twin.t, oracle)
    assert grew > 0 and twin.t.reclaimed_total == 0


def assert_same_state_tiered(tiered, oracle):
    """A tiered engine's host view against a single-tier port state."""
    view = tiered.host_view()
    for f in ("keys", "node_count", "node_max", "num_nodes", "mkba"):
        assert torch.equal(getattr(view, f), getattr(oracle, f)), f
    live = oracle.keys != EMPTY
    assert torch.equal(view.vals[live], oracle.vals[live])


def test_read_only_batch_leaves_the_mirror_unchanged(seeded, rng):
    st, live = seeded
    twin = Twin(st, max(1, st.memory_bytes() // 10))
    view = twin.t.host_view()
    before = {f: getattr(view, f).clone() for f in ("keys", "vals", "node_count", "mkba")}
    q = np.sort(rng.choice(live, 200)).astype(np.int32)
    tags = np.where(np.arange(200) % 2 == 0, 2, 3).astype(np.int32)
    _, (got, stats, _) = twin.apply(tags, q, np.zeros(200, np.int32), commit=False,
                                    msg="read-only")
    assert stats["promoted"] > 0
    view = twin.t.host_view()
    for f, t in before.items():
        assert torch.equal(getattr(view, f), t), f
    ops, _ = tcore.make_ops(tags, q, np.zeros(200, np.int32), device="cpu")
    _, want, _ = tcore.apply_ops(to_port(st), ops, config=PORT)
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_restructure_shrink_and_compact(rng):
    keys = np.arange(0, 40000, 2, dtype=np.int32)
    st = jcore.build(keys, (keys // 2).astype(np.int32), **GEOM)
    st, _ = jcore.delete(st, jnp.asarray(keys[: int(0.9 * len(keys))]))
    want, want_reclaimed = jcore.restructure_shrink(st)
    got, reclaimed = tcore.restructure_shrink(to_port(st))
    assert reclaimed == want_reclaimed > 0
    assert got.geometry == want.geometry and got.nodes_per_bucket == 2
    assert_same_state(want, got)
    tcore.check_invariants(got)
    assert tser.canonical_state_bytes(got) == jser.canonical_state_bytes(st)
    got8, _ = tcore.restructure_shrink(to_port(st), nodes_per_bucket=8)
    assert got8.nodes_per_bucket == 8

    twin = Twin(st, max(1, st.memory_bytes() // 10))
    q = np.sort(rng.choice(keys, 64)).astype(np.int32)
    twin.apply(np.full(64, 2, np.int32), q, np.zeros(64, np.int32), msg="before compact")
    assert twin.j.compact() == twin.t.compact() == want_reclaimed
    assert_same_tiered(twin.j, twin.t, "compact")
    tcore.check_tiered_invariants(twin.t)
    assert len(twin.t.resident_ids) == 0 and twin.t.geometry == got.geometry
    twin.apply(np.full(64, 2, np.int32), q, np.zeros(64, np.int32), msg="after compact")


def _corrupt_stale_live(t):
    t.h_live[t.resident_ids[0]] += 1


def _corrupt_unsorted_ids(t):
    t.resident_ids = t.resident_ids[::-1].copy()


def _corrupt_unterminated_mkba(t):
    mkba = t._packed.mkba.clone()
    mkba[-1] = mkba[-1] - 1
    t._packed = dataclasses.replace(t._packed, mkba=mkba)


def _corrupt_over_budget(t):
    t.budget_bytes = t.bucket_bytes * (len(t.resident_ids) - 1)


def _corrupt_stale_min_exp(t):
    t.h_min_exp[t.resident_ids[0]] = 7


@pytest.mark.parametrize("corrupt, match", [
    (_corrupt_stale_live, "stale live"),
    (_corrupt_unsorted_ids, "not sorted"),
    (_corrupt_unterminated_mkba, "MAX_VALID"),
    (_corrupt_over_budget, "budget"),
    (_corrupt_stale_min_exp, "min-expiry"),
])
def test_i7_negative_cases(seeded, rng, corrupt, match):
    st, live = seeded
    tt = tres.TieredFliX.from_state(to_port(st), budget_bytes=st.memory_bytes() // 10)
    q = np.sort(rng.choice(live, 300)).astype(np.int32)
    ops, _ = tcore.make_ops(np.full(300, 2, np.int32), q, device="cpu")
    tt.apply(ops, config=PORT)
    tcore.check_tiered_invariants(tt)
    assert len(tt.resident_ids) > 2
    corrupt(tt)
    with pytest.raises(AssertionError, match=match):
        tcore.check_tiered_invariants(tt)
