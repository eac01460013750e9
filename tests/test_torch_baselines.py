"""The port's baselines (``repro_torch.core.baselines``) against the JAX
reference's (``repro.core.baselines``), exactly, on the CPU.

The data are ``tests/test_baselines.py``'s: 2,000 keys and 2,000 more from
a 50,000-key space.  Before every call one reference state is carried
across with the port module's ``state_from_numpy``; the call then runs in
both packages and the results are held equal: the sorted array's keys
byte for byte and its vals at live slots, the hash table's keys, vals and
slot states byte for byte with the unplaced count, every LSM level with
its vals and ``occupied``, the B-tree's separator levels and its data layer
under the parity contract, every query answer, and every
``memory_bytes()``.  The cases cover the reference test's pathologies:
newest-wins upserts, tombstones that keep probe chains reachable, the
successor skip loop and its ``max_skips`` bound, and B-tree queries above
the largest key and at ``MAX_VALID``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.baselines import btree as jbt  # noqa: E402
from repro.core.baselines import hash_table as jht  # noqa: E402
from repro.core.baselines import lsm as jlsm  # noqa: E402
from repro.core.baselines import sorted_array as jsa  # noqa: E402
from repro_torch.core.baselines import btree as tbt  # noqa: E402
from repro_torch.core.baselines import hash_table as tht  # noqa: E402
from repro_torch.core.baselines import lsm as tlsm  # noqa: E402
from repro_torch.core.baselines import sorted_array as tsa  # noqa: E402
from repro_torch.core.state import STATE_FIELDS  # noqa: E402
from test_torch_common import EMPTY, assert_same, assert_same_state  # noqa: E402

torch.set_num_threads(1)

MAX_VALID = EMPTY - 1
MP = 256  # the reference test's probe bound for the 80% load factor


@pytest.fixture
def data(rng):
    universe = rng.permutation(50000).astype(np.int32)
    keys, extra = universe[:2000], universe[2000:4000]
    vals = np.arange(2000, dtype=np.int32)
    return keys, vals, extra


def j32(a):
    return jnp.asarray(np.asarray(a, np.int32))


def queries(keys, extra):
    """Sorted hits, misses and the edges: 0, above the largest key,
    MAX_VALID and EMPTY."""
    hi = int(max(keys.max(), extra.max()))
    q = np.concatenate([keys[:300], extra[:300], np.arange(0, 50000, 997),
                        [0, hi + 1, hi + 50, MAX_VALID, EMPTY]])
    return np.sort(q).astype(np.int32)


# ---------------------------------------------------------------------------
# sorted array
# ---------------------------------------------------------------------------


def sa_arrays(st):
    return {"keys": np.asarray(st.keys), "vals": np.asarray(st.vals)}


def assert_same_sa(jst, tst):
    want = sa_arrays(jst)
    assert_same(want["keys"], tst.keys, "sorted array keys")
    live = want["keys"] != EMPTY
    np.testing.assert_array_equal(want["vals"][live], tst.vals.numpy()[live], "vals")
    assert jst.memory_bytes() == tst.memory_bytes()
    assert int(jst.live_keys()) == int(tst.live_keys())


def sa_step(jst, jfn, tfn, *args):
    """One call in both packages from the same reference state."""
    tst = tsa.state_from_numpy(sa_arrays(jst), "cpu")
    jnew = jfn(jst, *[j32(a) for a in args])
    tnew = tfn(tst, *args)
    assert_same_sa(jnew, tnew)
    return jnew


def sa_reads(jst, q):
    tst = tsa.state_from_numpy(sa_arrays(jst), "cpu")
    assert_same(jsa.point_query(jst, j32(q)), tsa.point_query(tst, q), "sa point")
    for w, g in zip(jsa.successor_query(jst, j32(q)), tsa.successor_query(tst, q)):
        assert_same(w, g, "sa successor")


def test_sorted_array_matches_reference(data):
    keys, vals, extra = data
    sk, sv = np.sort(keys), vals[np.argsort(keys)]
    jst = jsa.build(j32(sk), j32(sv), capacity=8192)
    assert_same_sa(jst, tsa.build(sk, sv, 8192, device="cpu"))
    q = queries(keys, extra)
    sa_reads(jst, q)
    ik = np.sort(extra)
    jst = sa_step(jst, jsa.insert, tsa.insert, ik, ik)
    # newest wins: live keys upserted with new values, beside fresh ones
    up = np.sort(np.concatenate([sk[:300], np.arange(50000, 50100)])).astype(np.int32)
    jst = sa_step(jst, jsa.insert, tsa.insert, up, np.full(up.size, 777, np.int32))
    sa_reads(jst, q)
    dels = np.sort(np.concatenate([ik[:500], sk[::3], [7, 49999, MAX_VALID]])).astype(np.int32)
    jst = sa_step(jst, jsa.delete, tsa.delete, np.unique(dels))
    sa_reads(jst, q)


def test_sorted_array_full_capacity_successor_clamp(data):
    """A full array (no EMPTY tail): a query above the largest key clamps
    to the last slot in both packages."""
    keys, vals, extra = data
    sk, sv = np.sort(keys), vals[np.argsort(keys)]
    jst = jsa.build(j32(sk), j32(sv), capacity=sk.size)
    assert_same_sa(jst, tsa.build(sk, sv, sk.size, device="cpu"))
    sa_reads(jst, np.array([0, int(sk[-1]), int(sk[-1]) + 1, MAX_VALID], np.int32))


# ---------------------------------------------------------------------------
# hash table
# ---------------------------------------------------------------------------


def ht_arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in ("keys", "vals", "slot")}


def assert_same_ht(jst, tst):
    for f, want in ht_arrays(jst).items():
        assert_same(want, getattr(tst, f), f"hash table {f}")
    assert jst.memory_bytes() == tst.memory_bytes()
    # a float32 mean: the reference sums 0/1 in float32, the port divides
    # the exact count, so they may differ in the last bits of float32
    assert float(tst.load_factor()) == pytest.approx(float(jst.load_factor()), rel=1e-6)
    assert int(jst.live_keys()) == int(tst.live_keys())


def ht_insert(jst, keys, vals, max_probe=MP):
    tst = tht.state_from_numpy(ht_arrays(jst), "cpu")
    jnew, jfail = jht.insert(jst, j32(keys), j32(vals), max_probe=max_probe)
    tnew, tfail = tht.insert(tst, keys, vals, max_probe=max_probe)
    assert_same_ht(jnew, tnew)
    assert int(jfail) == int(tfail)
    return jnew, int(jfail)


def ht_reads(jst, q, max_probe=MP):
    tst = tht.state_from_numpy(ht_arrays(jst), "cpu")
    got = tht.point_query(tst, q, max_probe=max_probe)
    assert_same(jht.point_query(jst, j32(q), max_probe=max_probe), got, "ht point")
    return got.numpy()


def test_hash_function_matches_uint32_wraparound():
    k = np.array([0, 1, 2**16 - 1, 2**16, 2**31 - 2, EMPTY, 123456789, 48611], np.int32)
    for cap in (2500, 41943040, 7):
        want = np.asarray(jht._hash(j32(k), cap))
        assert_same(want, tht._hash(torch.as_tensor(k), cap), f"cap {cap}")


def test_hash_table_matches_reference(data):
    keys, vals, extra = data
    jst = jht.empty_state(capacity=int(len(keys) / 0.8))
    assert_same_ht(jst, tht.empty_state(int(len(keys) / 0.8), device="cpu"))
    jst, fails = ht_insert(jst, keys, vals)
    assert fails == 0
    model = dict(zip(keys.tolist(), vals.tolist()))
    got = ht_reads(jst, keys)
    assert all(got[i] == model[int(keys[i])] for i in range(len(keys)))
    ht_reads(jst, extra)  # misses walk probe chains at 80% load
    # deletes tombstone; the rest of each probe chain stays reachable
    tst = tht.state_from_numpy(ht_arrays(jst), "cpu")
    jdel = jht.delete(jst, j32(keys[:500]), max_probe=MP)
    assert_same_ht(jdel, tht.delete(tst, keys[:500], max_probe=MP))
    jst = jdel
    assert (ht_reads(jst, keys[:500]) == -1).all()
    ht_reads(jst, keys[500:])
    # tombstone slots are reusable; an upsert rewrites a resident key's value
    jst, fails = ht_insert(jst, extra[:500], extra[:500])
    assert fails == 0
    jst, _ = ht_insert(jst, keys[600:700], np.full(100, 555, np.int32))
    assert (ht_reads(jst, keys[600:700]) == 555).all()
    ht_reads(jst, extra, max_probe=3)  # probe-bounded misses


def test_hash_table_unplaced_count_matches_reference(data):
    """A probe bound too short for an 80% load leaves keys unplaced: the
    count and the partial table agree."""
    keys, vals, extra = data
    jst = jht.empty_state(capacity=int(len(keys) / 0.8))
    jst, fails = ht_insert(jst, keys, vals, max_probe=2)
    assert fails > 0
    ht_reads(jst, keys, max_probe=2)


# ---------------------------------------------------------------------------
# LSM
# ---------------------------------------------------------------------------


def lsm_arrays(st):
    return {
        "level_keys": [np.asarray(a) for a in st.level_keys],
        "level_vals": [np.asarray(a) for a in st.level_vals],
        "occupied": np.asarray(st.occupied),
    }


def assert_same_lsm(jst, tst):
    want = lsm_arrays(jst)
    assert len(tst.level_keys) == len(want["level_keys"])
    for i, (k, v) in enumerate(zip(want["level_keys"], want["level_vals"])):
        assert_same(k, tst.level_keys[i], f"level {i} keys")
        assert_same(v, tst.level_vals[i], f"level {i} vals")
    assert_same(want["occupied"], tst.occupied, "occupied")
    assert jst.memory_bytes() == tst.memory_bytes()
    assert int(jst.live_keys()) == int(tst.live_keys())


def lsm_step(jst, jfn, tfn, *args):
    tst = tlsm.state_from_numpy(lsm_arrays(jst), "cpu")
    jnew = jfn(jst, *[j32(a) for a in args])
    assert_same_lsm(jnew, tfn(tst, *args))
    return jnew


def lsm_reads(jst, q, max_skips=64):
    tst = tlsm.state_from_numpy(lsm_arrays(jst), "cpu")
    assert_same(jlsm.point_query(jst, j32(q)), tlsm.point_query(tst, q), "lsm point")
    want = jlsm.successor_query(jst, j32(q), max_skips=max_skips)
    got = tlsm.successor_query(tst, q, max_skips=max_skips)
    for w, g in zip(want, got):
        assert_same(w, g, f"lsm successor, max_skips={max_skips}")
    return got[0].numpy()


def test_lsm_matches_reference(data):
    keys, vals, extra = data
    sk, sv = np.sort(keys), vals[np.argsort(keys)]
    jst = jlsm.empty_state(chunk=128, num_levels=12)
    assert_same_lsm(jst, tlsm.empty_state(128, 12, device="cpu"))
    jst = lsm_step(jst, jlsm.insert, tlsm.insert, sk, sv)  # 15 full chunks and a part
    q = queries(keys, extra)
    lsm_reads(jst, q)
    # newest occurrence wins, across levels
    up = sk[:200]
    jst = lsm_step(jst, jlsm.insert, tlsm.insert, up, np.full(200, 777, np.int32))
    lsm_reads(jst, up)
    ik = np.sort(extra[:700])
    jst = lsm_step(jst, jlsm.insert, tlsm.insert, ik, ik)
    # in-place tombstones at the newest occurrence, repeated keys in the batch
    dels = np.sort(np.concatenate([sk[::2], sk[:10], ik[:50], [3, 49999]])).astype(np.int32)
    jst = lsm_step(jst, jlsm.delete, tlsm.delete, dels)
    lsm_reads(jst, q)
    # the successor skip loop over runs of dead keys, and its bound
    live = np.setdiff1d(np.concatenate([sk, ik]), dels)
    got = lsm_reads(jst, np.sort(dels[:300]))
    for i, qq in enumerate(np.sort(dels[:300])):
        j = np.searchsorted(live, qq)
        assert got[i] == (live[j] if j < len(live) else EMPTY)
    lsm_reads(jst, np.sort(dels[:300]), max_skips=1)


def test_lsm_levels_exhausted_raises_in_both():
    k = np.arange(0, 2048, 2, dtype=np.int32)
    jst, tst = jlsm.empty_state(chunk=128, num_levels=2), tlsm.empty_state(128, 2, device="cpu")
    with pytest.raises(RuntimeError, match="exhausted"):
        jlsm.insert(jst, j32(k), j32(k))
    with pytest.raises(RuntimeError, match="exhausted"):
        tlsm.insert(tst, k, k)


# ---------------------------------------------------------------------------
# B-tree
# ---------------------------------------------------------------------------


def bt_arrays(st):
    return {
        "data": {f: np.asarray(getattr(st.data, f)) for f in STATE_FIELDS},
        "levels": [np.asarray(a) for a in st.levels],
    }


def assert_same_bt(jst, tst):
    assert len(jst.levels) == len(tst.levels)
    for i, (w, g) in enumerate(zip(jst.levels, tst.levels)):
        assert_same(w, g, f"separator level {i}")
    assert_same_state(jst.data, tst.data)
    assert jst.memory_bytes() == tst.memory_bytes()


def bt_step(jst, jfn, tfn, *args):
    tst = tbt.state_from_numpy(bt_arrays(jst), "cpu")
    jnew = jfn(jst, *[j32(a) for a in args])
    assert_same_bt(jnew, tfn(tst, *args))
    return jnew


def bt_reads(jst, q):
    tst = tbt.state_from_numpy(bt_arrays(jst), "cpu")
    got = tbt.point_query(tst, q)
    assert_same(jbt.point_query(jst, j32(q)), got, "btree point")
    return got.numpy()


def test_btree_matches_reference(data):
    keys, vals, extra = data
    jst = jbt.build(keys, vals, node_size=16, nodes_per_bucket=8)
    assert_same_bt(jst, tbt.build(keys, vals, node_size=16, nodes_per_bucket=8, device="cpu"))
    assert len(jst.levels) >= 2
    sk = np.sort(keys)
    model = dict(zip(keys.tolist(), vals.tolist()))
    got = bt_reads(jst, sk)
    assert all(got[i] == model[int(sk[i])] for i in range(len(sk)))
    q = queries(keys, extra)  # above the largest key, MAX_VALID, EMPTY
    bt_reads(jst, q)
    ik = np.sort(extra)
    jst = bt_step(jst, jbt.insert, tbt.insert, ik, ik)
    # a flood into one leaf's range overflows it: insert_safe regrows
    mk = np.asarray(jst.data.mkba)
    lo, hi = int(mk[9]) + 1, int(mk[10])
    live = np.concatenate([keys, extra])
    flood = np.setdiff1d(np.arange(lo, hi + 1), live)[:140].astype(np.int32)
    assert flood.size == 140
    nb = jst.data.num_buckets
    jst = bt_step(jst, jbt.insert, tbt.insert, flood, flood)
    assert jst.data.num_buckets > nb
    bt_reads(jst, np.sort(np.concatenate([q, flood])))
    dels = np.sort(np.concatenate([ik[:700], sk[::4], flood[:70]])).astype(np.int32)
    jst = bt_step(jst, jbt.delete, tbt.delete, dels)
    bt_reads(jst, np.sort(np.concatenate([q, flood])))
