"""Port parity of the updates — insert, insert_safe, delete, restructure — and
of the vectorised invariant checker, against the JAX reference (exact)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core.invariants import check_invariants as j_check  # noqa: E402
from repro.core.restructure import plan as j_plan  # noqa: E402
from repro.core.state import MAX_VALID  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core.state import STATE_FIELDS  # noqa: E402
from test_torch_common import (  # noqa: E402
    EMPTY,
    assert_same,
    assert_same_state,
    build_adversarial,
    t32,
    to_port,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def adversarial():
    return build_adversarial(np.random.default_rng(1234))


def _insert_batches(rng, live):
    absent = np.setdiff1d(np.arange(0, 130000, 11, dtype=np.int32), live)
    return {
        # upserts of stored keys mixed with fresh keys, incl. boundary keys
        "upsert_mix": np.concatenate(
            [rng.choice(live, 150, replace=False), absent[:150], [0, int(MAX_VALID)]]
        ),
        # aimed at the emptied bucket range
        "empty_buckets": np.arange(31000, 59000, 120, dtype=np.int32),
    }


@pytest.mark.parametrize("batch", ["upsert_mix", "empty_buckets"])
def test_insert_matches_reference(adversarial, batch):
    js, ts, live = adversarial
    b = np.unique(_insert_batches(np.random.default_rng(6), live)[batch]).astype(np.int32)
    v = np.arange(len(b), dtype=np.int32) + 7_000_000
    jk, jv = jcore.sort_batch(jnp.asarray(b), jnp.asarray(v))
    want, wstats = jcore.insert(js, jk, jv)
    got, gstats = tcore.insert(ts, *tcore.sort_batch(t32(b), t32(v)))
    assert_same_state(want, got)
    for k in wstats:
        assert int(wstats[k]) == int(gstats[k]), k
    tcore.check_invariants(got)


def test_insert_safe_through_an_overflow():
    """A flood into one bucket overflows, restructure_grow widens the chain,
    and the retry lands the same state in both packages."""
    keys = np.arange(0, 640, 10, dtype=np.int32)
    js = jcore.build(keys, keys, node_size=4, nodes_per_bucket=2)
    ts = tcore.build(keys, keys, node_size=4, nodes_per_bucket=2, device="cpu")
    flood = np.arange(1, 200, 2, dtype=np.int32)
    vals = flood * 3
    pre_j, _ = jcore.insert(js, jnp.asarray(flood), jnp.asarray(vals))
    pre_t, _ = tcore.insert(ts, t32(flood), t32(vals))
    assert bool(pre_t.needs_restructure)
    assert_same_state(pre_j, pre_t)  # the untrustworthy pre-retry state too
    want, wstats = jcore.insert_safe(js, jnp.asarray(flood), jnp.asarray(vals))
    got, gstats = tcore.insert_safe(ts, t32(flood), t32(vals))
    assert got.geometry == want.geometry
    assert_same_state(want, got)
    for k in wstats:
        assert int(wstats[k]) == int(gstats[k]), k
    tcore.check_invariants(got)


@pytest.mark.parametrize(
    "batch", ["all_miss", "duplicates", "boundary", "skewed_range"]
)
def test_delete_matches_reference(adversarial, batch):
    js, ts, live = adversarial
    rng = np.random.default_rng(8)
    absent = np.setdiff1d(np.arange(0, 130000, 13, dtype=np.int32), live)
    b = {
        "all_miss": np.sort(absent[:400]),
        "duplicates": np.sort(np.repeat(rng.choice(live, 60, replace=False), 5)),
        "boundary": np.array([0, int(MAX_VALID)], np.int32),
        "skewed_range": np.arange(60000, 90000, dtype=np.int32),
    }[batch].astype(np.int32)
    want, wstats = jcore.delete(js, jnp.asarray(b))
    got, gstats = tcore.delete(ts, t32(b))
    assert_same_state(want, got)
    for k in wstats:
        assert int(wstats[k]) == int(gstats[k]), k
    tcore.check_invariants(got)


def test_restructure_matches_reference(adversarial):
    js, ts, _ = adversarial
    for extra in (0, 1, 700):
        want = jcore.restructure_grow(js, extra_keys=extra)
        got = tcore.restructure_grow(ts, extra_keys=extra)
        assert got.geometry == want.geometry
        assert_same_state(want, got)
    assert tcore.plan(ts, extra_keys=5) == j_plan(js, extra_keys=5)
    want, got = jcore.restructure_auto(js), tcore.restructure_auto(ts)
    assert got.geometry == want.geometry
    assert_same_state(want, got)
    tcore.check_invariants(got)
    want = jcore.restructure(js, num_buckets=40, nodes_per_bucket=16, fill=0.25)
    got = tcore.restructure(ts, num_buckets=40, nodes_per_bucket=16, fill=0.25)
    assert_same_state(want, got)


def _corruptions(js):
    """(name, numpy planes) pairs, each breaking one invariant of a bucket
    with a multi-node chain whose first node has 2..ns-1 keys."""
    base = {f: np.array(getattr(js, f)) for f in STATE_FIELDS}
    cnt, nn = base["node_count"], base["num_nodes"]
    ns = base["keys"].shape[2]
    b = int(np.argwhere((nn >= 2) & (cnt[:, 0] >= 2) & (cnt[:, 0] < ns))[0, 0])
    c = int(cnt[b, 0])

    def edit(cells):
        planes = {k: v.copy() for k, v in base.items()}
        for (plane, idx), value in cells.items():
            planes[plane][idx] = value
        return planes

    keys = base["keys"]
    return [
        ("I1", edit({("keys", (b, 0, 1)): keys[b, 0, 0]})),
        ("I1 pad", edit({("keys", (b, 0, c)): 5})),
        ("I4", edit({("node_max", (b, 0)): base["node_max"][b, 0] - 1})),
        ("I2", edit({("keys", (b, 1, 0)): keys[b, 0, 0]})),
        ("I3", edit({("mkba", b): keys[b, 0, 0] - 1})),
        ("inactive dirty", edit({("keys", (b, -1, 0)): 3})),
        ("active empty", edit({("num_nodes", b): nn[b] + 1})),
        ("I5", edit({("mkba", -1): 5})),
    ]


def test_check_invariants_agrees_with_reference(adversarial):
    """The vectorised checker passes where the reference's loop passes and
    raises on each single-invariant corruption the reference rejects."""
    js, ts, _ = adversarial
    j_check(js)
    tcore.check_invariants(ts)
    for name, planes in _corruptions(js):
        jstate = jcore.FliXState(**{k: jnp.asarray(v) for k, v in planes.items()})
        with pytest.raises(AssertionError):
            j_check(jstate)
        with pytest.raises(AssertionError):
            tcore.check_invariants(tcore.state_from_numpy(planes, "cpu"))
        # the carried-over state is the same corruption
        assert_same(planes["keys"], to_port(jstate).keys, name)


def test_empty_state_invariants():
    st = tcore.empty_state(3, 2, 4, device="cpu")
    tcore.check_invariants(st)
    assert int(st.live_keys()) == 0
    assert EMPTY == int(st.node_max.max())
