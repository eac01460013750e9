"""The standalone RANGE scan and the range reads: the port's ``flix_range``
(its plain versions on the CPU) against the JAX ``flix_range_pallas`` in
interpret mode and the port's ``dense_range_scan``; ``range_query`` and
``with_successor_cache`` against the JAX ``core`` (exact, all int32).  The
CUDA kernels against their plain versions: ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.kernels.flix_range import flix_range_pallas  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import flix_range as fr  # noqa: E402
from test_torch_common import (  # noqa: E402
    EMPTY,
    assert_same,
    assert_same_state,
    build_adversarial,
    t32,
    to_port,
)

torch.set_num_threads(1)


def _sorted_ranges(rng, n, space, span=(-50, 600)):
    lo = np.sort(rng.integers(0, space, n)).astype(np.int32)
    hi = (lo + rng.integers(*span, n)).astype(np.int32)
    return lo, hi


def _same_scan(want, got):
    for name, w, g in zip(("keys", "vals", "start", "count", "truncated"), want, got):
        assert_same(w, g, name)


@pytest.mark.parametrize("seed,budget", [(4, 64), (5, 8)])
def test_flix_range_matches_the_pallas_kernel(seed, budget):
    """One small seeded batch (``test_range_property.py``'s shape) on a
    state with emptied buckets, through the Pallas kernel in interpret mode
    and through the port (its plain versions on the CPU); budget 8
    truncates."""
    rng = np.random.default_rng(seed)
    build = np.sort(rng.choice(4000, 110, replace=False)).astype(np.int32)
    js = jcore.build(build, np.arange(110, dtype=np.int32), node_size=4, nodes_per_bucket=4)
    js, _ = jcore.delete(js, jnp.asarray(build[30:50]))
    ts = to_port(js)
    lo, hi = _sorted_ranges(rng, 8, 4000)
    lo[0], hi[0] = int(js.mkba[3]), int(js.mkba[3]) + 1  # a fence
    want = flix_range_pallas(js.keys, js.vals, js.mkba, jnp.asarray(lo), jnp.asarray(hi),
                             max_results=budget, interpret=True)
    got = fr.flix_range(ts.keys, ts.vals, ts.mkba, t32(lo), t32(hi), max_results=budget)
    _same_scan(want, got)
    assert (int(got[4]) > 0) == (budget == 8)


def _boundary_ranges(ts, rng):
    """Ranges on bucket fences (both sides), hi <= lo, ranges over emptied
    buckets, wide ones, and the top of the key space."""
    mk = ts.mkba[:-1].numpy().astype(np.int64)
    mk = mk[(mk > 0) & (mk < 120000)]
    fences = mk[rng.choice(len(mk), 10, replace=False)]
    lo = np.concatenate([
        fences, fences + 1, fences, [40000, 29000, 0, int(tcore.MAX_VALID) - 3],
        rng.integers(0, 130000, 20),
    ])
    hi = np.concatenate([
        fences + 1, fences + 700, fences - 5, [40000, 61000, 130000, EMPTY],
        lo[-20:] + rng.integers(-100, 3000, 20),
    ])
    order = np.argsort(lo, kind="stable")
    return t32(lo[order]), t32(hi[order])


def test_flix_range_matches_dense_range_scan():
    """The port's scan against its own oracle on the adversarial state
    (boundary keys, multi-node chains, emptied buckets): fences, inverted
    and empty ranges, truncating and ample budgets."""
    rng = np.random.default_rng(21)
    _, ts, _ = build_adversarial(rng)
    assert int((ts.num_nodes == 0).sum()) > 0
    lo, hi = _boundary_ranges(ts, rng)
    is_range = torch.ones(lo.shape, dtype=torch.bool)
    for budget in (8, 300, 1 << 14):
        want = tcore.dense_range_scan(ts, is_range, lo, hi, max_results=budget)
        got = fr.flix_range(ts.keys, ts.vals, ts.mkba, lo, hi, max_results=budget)
        for w, g in zip(want, got):
            assert torch.equal(w, g)
        assert (int(got[4]) > 0) == (budget < 1 << 14)
    # the two passes on the CPU are their plain versions and count nothing
    before = dict(LAUNCHES)
    pref = tcore.query.live_prefix(ts.node_count)
    meta = (ts.keys, ts.node_count, ts.node_max, ts.mkba, pref)
    rank_lo, count = fr.flix_range_count(*meta, lo, hi)
    assert LAUNCHES == before
    flat_k, _ = tcore.state.flatten_bucket_sorted(ts)
    assert torch.equal(rank_lo, tcore.query.flat_rank(flat_k, pref, ts.mkba, lo))
    full = tcore.query.flat_rank(flat_k, pref, ts.mkba, hi) - rank_lo
    assert torch.equal(count, torch.clamp(full, min=0))


def test_range_wrappers_check_their_inputs():
    keys = np.arange(0, 300, 3, dtype=np.int32)
    ts = tcore.build(keys, keys, node_size=4, nodes_per_bucket=4, device="cpu")
    pref = tcore.query.live_prefix(ts.node_count)
    lo = t32([0, 10])
    with pytest.raises(TypeError, match="int32"):
        fr.flix_range_count(ts.keys, ts.node_count, ts.node_max, ts.mkba, pref,
                            lo.long(), lo)
    with pytest.raises(ValueError, match="pref"):
        fr.flix_range_count(ts.keys, ts.node_count, ts.node_max, ts.mkba, pref[:-1], lo, lo)
    with pytest.raises(ValueError, match="aligned"):
        fr.flix_range_count(ts.keys, ts.node_count, ts.node_max, ts.mkba, pref, lo, lo[:1])
    with pytest.raises(ValueError, match="pref"):
        fr.flix_range_scatter(t32([-1]), pref[:-1], ts.node_count, ts.keys, ts.vals)


def test_range_query_matches_reference():
    """Inclusive ``[lo, hi]`` per query, padded to max_results: keys, vals
    and counts equal to the JAX ``range_query``."""
    rng = np.random.default_rng(8)
    js, ts, _ = build_adversarial(rng)
    lo, hi = _boundary_ranges(ts, rng)
    for mr in (1, 16, 64):
        want = jcore.range_query(js, jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
                                 max_results=mr)
        got = tcore.range_query(ts, lo, hi, max_results=mr)
        for name, w, g in zip(("keys", "vals", "counts"), want, got):
            assert_same(w, g, f"{name}@{mr}")


def test_successor_cache_parity_idempotence_and_invalidation():
    """``with_successor_cache`` builds the reference's rows, returns its
    input when a cache is there, leaves every successor answer unchanged,
    travels through state_to_numpy, and every mutating function returns a
    state without it."""
    rng = np.random.default_rng(13)
    js, ts, live = build_adversarial(rng)
    jc = jcore.with_successor_cache(js)
    tc = tcore.with_successor_cache(ts)
    assert_same(jc.succ_smin, tc.succ_smin)
    assert_same(jc.succ_sidx, tc.succ_sidx)
    assert tcore.with_successor_cache(tc) is tc
    assert tc.drop_volatile().succ_smin is None and ts.drop_volatile() is ts
    q = t32(np.sort(rng.integers(0, 130000, 500)))
    for a, b in zip(tcore.successor_query(ts, q), tcore.successor_query(tc, q)):
        assert torch.equal(a, b)
    back = tcore.state_from_numpy(tcore.state_to_numpy(tc), "cpu")
    assert torch.equal(back.succ_smin, tc.succ_smin)
    assert tc.memory_bytes() == jc.memory_bytes()

    ins = t32(np.setdiff1d(np.arange(200, 260), live))
    dels = t32(live[:40])
    mutated = [
        tcore.insert(tc, ins, ins)[0],
        tcore.delete(tc, dels)[0],
        tcore.restructure_auto(tc),
    ]
    tags = np.array([tcore.OP_POINT, tcore.OP_SUCCESSOR], np.int32)
    for impl in ("reference", "fused"):
        ops, _ = tcore.make_ops(tags, live[:2], device="cpu")
        mutated.append(tcore.apply_ops(tc, ops, config=tcore.ExecConfig(impl=impl))[0])
    for st in mutated:
        assert st.succ_smin is None and st.succ_sidx is None
    # a read-only batch on the reference engine drops it too, as in JAX
    jops, _ = jcore.make_ops(tags, live[:2])
    jn = jcore.apply_ops(jc, jops, config=jcore.ExecConfig(impl="reference"))[0]
    assert jn.succ_smin is None
    assert_same_state(jn, mutated[-2])
