"""Port parity, shared helpers + state/build/batch: ``repro_torch`` against the
JAX reference ``repro`` on the same numpy inputs (CPU, exact — all int32).

The helpers here are imported by the other ``test_torch_*`` files.  Parity
contract (``tests/test_differential.py``): ``keys``, ``node_count``,
``node_max``, ``num_nodes``, ``mkba`` and ``needs_restructure`` are
byte-equal; ``vals`` are compared at live slots only, since vals at EMPTY
slots are unspecified.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core.state import MAX_VALID  # noqa: E402
from repro.core.state import flatten_bucket_sorted as j_flatten  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core.state import STATE_FIELDS  # noqa: E402
from repro_torch.core.state import flatten_bucket_sorted as t_flatten  # noqa: E402

torch.set_num_threads(1)

EMPTY = int(tcore.EMPTY)
LAYOUT_FIELDS = ("keys", "node_count", "node_max", "num_nodes", "mkba")


def to_port(jstate) -> "tcore.FliXState":
    """The JAX state's seven carry-over fields as a port state on the CPU."""
    arrays = {f: np.asarray(getattr(jstate, f)) for f in STATE_FIELDS}
    return tcore.state_from_numpy(arrays, "cpu")


def assert_same_state(jstate, tstate, *, live_vals_only=True):
    """Exact state parity by the reference's own contract."""
    got = tcore.state_to_numpy(tstate)
    for f in LAYOUT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jstate, f)), got[f], err_msg=f)
    assert bool(jstate.needs_restructure) == bool(got["needs_restructure"])
    want_v = np.asarray(jstate.vals)
    if live_vals_only:
        live = np.asarray(jstate.keys) != EMPTY
        np.testing.assert_array_equal(want_v[live], got["vals"][live], err_msg="vals")
    else:
        np.testing.assert_array_equal(want_v, got["vals"], err_msg="vals")


def assert_same(want, got, msg=""):
    """One result array of each package, compared exactly through numpy."""
    np.testing.assert_array_equal(np.asarray(want), got.cpu().numpy(), err_msg=msg)


def t32(a) -> "torch.Tensor":
    return torch.as_tensor(np.asarray(a, dtype=np.int32))


def build_adversarial(rng):
    """The reference's ``adversarial`` fixture (test_differential.py:49-70):
    boundary keys, multi-node chains and emptied buckets — built by JAX,
    carried over to the port.  Returns (jax_state, port_state, live)."""
    keys = rng.choice(120000, size=2500, replace=False).astype(np.int32)
    keys = np.unique(np.concatenate([keys, [0, int(MAX_VALID)]])).astype(np.int32)
    st = jcore.build(
        keys, np.arange(len(keys), dtype=np.int32), node_size=8, nodes_per_bucket=8
    )
    extra = np.setdiff1d(rng.choice(120000, 5000).astype(np.int32), keys)[:1500]
    sk, sv = jcore.sort_batch(
        jnp.asarray(extra), jnp.asarray(np.arange(1500, dtype=np.int32))
    )
    st, _ = jcore.insert_safe(st, sk, sv)
    st, _ = jcore.delete(st, jnp.asarray(np.arange(30000, 60000, dtype=np.int32)))
    live = np.unique(np.concatenate([keys, extra]))
    live = live[(live < 30000) | (live >= 60000)].astype(np.int32)
    return st, to_port(st), live


# ---------------------------------------------------------------------------
# state / build / batch
# ---------------------------------------------------------------------------


def test_build_and_carry_over_round_trip():
    rng = np.random.default_rng(7)
    keys = rng.choice(1 << 20, 3000, replace=False).astype(np.int32)
    keys = np.concatenate([keys, keys[:100], [0, int(MAX_VALID)]]).astype(np.int32)
    vals = rng.integers(-(1 << 30), 1 << 30, len(keys)).astype(np.int32)
    for ns, npb, fill in ((8, 8, 0.5), (32, 16, 0.5), (4, 2, 1.0)):
        js = jcore.build(keys, vals, node_size=ns, nodes_per_bucket=npb, fill=fill)
        ts = tcore.build(
            keys, vals, node_size=ns, nodes_per_bucket=npb, fill=fill, device="cpu"
        )
        assert ts.geometry == js.geometry
        assert_same_state(js, ts, live_vals_only=False)
        tcore.check_invariants(ts)
        back = tcore.state_to_numpy(tcore.state_from_numpy(tcore.state_to_numpy(ts), "cpu"))
        for f, a in tcore.state_to_numpy(ts).items():
            np.testing.assert_array_equal(a, back[f], err_msg=f)
            assert a.dtype == back[f].dtype
        assert ts.memory_bytes() == js.memory_bytes()
        assert int(ts.live_keys()) == int(js.live_keys())
        assert int(ts.total_nodes()) == int(js.total_nodes())
        assert_same(js.bucket_lower_fence(), ts.bucket_lower_fence())


def test_adversarial_state_carries_over():
    js, ts, _ = build_adversarial(np.random.default_rng(1234))
    assert_same_state(js, ts, live_vals_only=False)
    tcore.check_invariants(ts)
    fk_j, fv_j = j_flatten(js)
    fk_t, fv_t = t_flatten(ts)
    assert_same(fk_j, fk_t)
    live = np.asarray(fk_j) != EMPTY
    np.testing.assert_array_equal(np.asarray(fv_j)[live], fv_t.numpy()[live])


def test_empty_state_and_plan_geometry():
    js = jcore.empty_state(5, 4, 8)
    ts = tcore.empty_state(5, 4, 8, device="cpu")
    assert_same_state(js, ts, live_vals_only=False)
    for n in (0, 1, 15, 16, 17, 1 << 20):
        for ns, fill in ((32, 0.5), (8, 0.25), (3, 1.0)):
            assert tcore.plan_geometry(n, node_size=ns, fill=fill) == jcore.plan_geometry(
                n, node_size=ns, fill=fill
            )


def test_batch_helpers_match_reference():
    rng = np.random.default_rng(3)
    js, ts, live = build_adversarial(rng)
    raw = np.concatenate(
        [rng.integers(0, 130000, 600), rng.choice(live, 200), [EMPTY] * 5]
    ).astype(np.int32)
    vals = rng.integers(0, 1 << 30, len(raw)).astype(np.int32)
    jk, jv = jcore.sort_batch(jnp.asarray(raw), jnp.asarray(vals))
    tk, tv = tcore.sort_batch(t32(raw), t32(vals))
    assert_same(jk, tk)
    assert_same(jv, tv)
    jd = jcore.dedup_last_wins(jk, jv)
    td = tcore.dedup_last_wins(tk, tv)
    for a, b, name in zip(jd, td, ("keys", "vals", "count")):
        assert_same(a, b, name)
    j_starts, j_ends = jcore.bucket_slices(js, jd[0])
    t_starts, t_ends = tcore.bucket_slices(ts, td[0])
    assert_same(j_starts, t_starts)
    assert_same(j_ends, t_ends)
    assert t_starts.dtype == torch.int32
    assert_same(jcore.bucket_of(js, jk), tcore.bucket_of(ts, tk))
    for max_len in (1, 4, 64):
        jt = jcore.gather_kv_sublists(jd[0], jd[1], j_starts, j_ends, max_len)
        tt = tcore.gather_kv_sublists(td[0], td[1], t_starts, t_ends, max_len)
        for a, b, name in zip(jt, tt, ("keys", "vals", "counts", "true_counts")):
            assert_same(a, b, f"{name}@{max_len}")
        jg = jcore.gather_sublists(jk, j_starts, j_ends, max_len, fill_value=-7)
        tg = tcore.gather_sublists(tk, t_starts, t_ends, max_len, fill_value=-7)
        for a, b in zip(jg, tg):
            assert_same(a, b, f"gather_sublists@{max_len}")


def test_entry_points_default_to_the_card():
    keys = np.arange(0, 100, 3, dtype=np.int32)
    if torch.cuda.is_available():
        assert tcore.build(keys, keys).device.type == "cuda"
        assert tcore.make_ops(np.zeros(3, np.int32), keys[:3])[0].key.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcore.build(keys, keys)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcore.make_ops(np.zeros(3, np.int32), keys[:3])
