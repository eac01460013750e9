"""The identity the staged stripe kernel's update path relies on
(``csrc/flix_apply_staged.cu``): in a state that holds I1-I4, every stored
key ``a`` of row ``j`` lies in a row below ``num_nodes`` and in region ``j``,
``region_of(node_max, onn_c, a) == j`` (``csrc/flix_phases.cuh``: the first
node whose max is at or above ``a``, clamped to the last active node
``onn_c``).  So the kernel takes a kept key's region from its row and
binary-searches ``node_max`` for the inserts only.

Checked on states from the JAX reference's ``build`` and ``apply_ops``:
mixed batches that grow multi-node chains, a delete-heavy batch that
empties buckets, and an overflow with its ``apply_ops_safe`` retry.  The
port's own ``build`` and ``apply_ops`` on the CPU must give the same states
(exact: all int32)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core.config import ExecConfig as JExecConfig  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from test_torch_common import EMPTY, assert_same_state  # noqa: E402

torch.set_num_threads(1)

CASES = ("build", "mixed", "delete_heavy", "overflow_retry")
GEOMETRIES = [(8, 8), (4, 4)]


PLANES = ("keys", "node_max", "num_nodes")


def assert_regions_are_rows(keys, nmax, nn):
    """Every stored key lies in a row below num_nodes, and region_of of it
    is its row."""
    npb = keys.shape[1]
    stored = keys != EMPTY
    rows = np.broadcast_to(np.arange(npb)[None, :, None], keys.shape)
    assert (rows < nn[:, None, None])[stored].all(), "a key past num_nodes"
    first_at_or_above = (nmax[:, None, None, :] < keys[..., None]).sum(-1)
    region = np.minimum(first_at_or_above, np.maximum(nn - 1, 0)[:, None, None])
    np.testing.assert_array_equal(region[stored], rows[stored])


def _apply_both(js, ts, tags, keys, vals, *, safe=False):
    """One batch through the JAX reference engine and the port's fused
    engine (its plain version on the CPU); the states must agree."""
    jops, _ = jcore.make_ops(tags, keys, vals)
    tops, _ = tcore.make_ops(tags, keys, vals, device="cpu")
    if safe:
        jout = jcore.apply_ops_safe(js, jops, config=JExecConfig(impl="reference"))
        tout = tcore.apply_ops_safe(ts, tops, config=tcore.ExecConfig(impl="fused"))
        assert jout[2]["restructure_retries"] == tout[2]["restructure_retries"] == 1
    else:
        jout = jcore.apply_ops(js, jops, config=JExecConfig(impl="reference"))
        tout = tcore.apply_ops(ts, tops, config=tcore.ExecConfig(impl="fused"))
    assert_same_state(jout[0], tout[0])
    return jout[0], tout[0]


def _grow(rng, js, ts, live, ns, npb):
    """A mixed batch whose inserts are packed into ~6 buckets, so that their
    chains grow several nodes; returns the states, the live keys and the
    packed key window [a, a + width)."""
    width = (1 << 20) // len(live) * ns // 2 * 6
    a = int(rng.integers(0, (1 << 20) - width))
    pool = np.setdiff1d(np.arange(a, a + width), sorted(live))
    ins = rng.choice(pool, 2 * ns * npb, replace=False)
    dels = rng.choice(sorted(live), 200, replace=False)
    k = np.concatenate([ins, dels, rng.integers(0, 1 << 20, 200)]).astype(np.int64)
    t = np.repeat(np.array([jcore.OP_INSERT, jcore.OP_DELETE, jcore.OP_POINT], np.int32),
                  [len(ins), 200, 200])
    k, first = np.unique(k, return_index=True)
    t = t[first]
    js, ts = _apply_both(js, ts, t, k.astype(np.int32), (k + 1).astype(np.int32))
    assert not bool(js.needs_restructure)
    live = (live | set(k[t == jcore.OP_INSERT].tolist())) - set(k[t == jcore.OP_DELETE].tolist())
    return js, ts, live, (a, a + width)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("ns,npb", GEOMETRIES)
def test_stored_keys_lie_in_the_region_of_their_row(ns, npb, case):
    rng = np.random.default_rng(17 * ns + npb + len(case))
    keys = np.unique(rng.choice(1 << 20, 3000, replace=False)).astype(np.int32)
    vals = (keys ^ 0x5A5A).astype(np.int32)
    js = jcore.build(keys, vals, node_size=ns, nodes_per_bucket=npb)
    ts = tcore.build(keys, vals, node_size=ns, nodes_per_bucket=npb, device="cpu")
    assert_same_state(js, ts)
    live = set(keys.tolist())
    if case == "mixed":
        for _ in range(3):
            js, ts, live, _ = _grow(rng, js, ts, live, ns, npb)
        assert int(np.asarray(js.num_nodes).max()) >= 3
    elif case == "delete_heavy":  # on grown chains; a run of keys empties whole buckets
        js, ts, live, (a, b) = _grow(rng, js, ts, live, ns, npb)
        srt = np.array(sorted(live), np.int32)
        srt = srt[(srt < a) | (srt >= b)]  # the grown chains keep their keys
        dels = np.unique(np.concatenate([srt[500:1100], rng.choice(srt, 300, replace=False)]))
        js, ts = _apply_both(js, ts, np.full(len(dels), jcore.OP_DELETE, np.int32), dels,
                             np.zeros(len(dels), np.int32))
        assert int((np.asarray(js.num_nodes) == 0).sum()) >= 10
        assert int(np.asarray(js.num_nodes).max()) >= 2
    elif case == "overflow_retry":  # a flood into one bucket, then the retry
        b = len(np.asarray(js.mkba)) // 2
        mk = np.asarray(js.mkba)
        pool = np.setdiff1d(np.arange(mk[b - 1] + 1, mk[b] + 1), keys)
        flood = np.sort(rng.choice(pool, ns * npb + 5, replace=False)).astype(np.int32)
        js, ts = _apply_both(js, ts, np.full(len(flood), jcore.OP_INSERT, np.int32), flood,
                             flood + 1, safe=True)
        assert int(np.asarray(js.num_nodes).max()) >= 2
    assert_regions_are_rows(*(np.asarray(getattr(js, f)) for f in PLANES))
    assert_regions_are_rows(*(getattr(ts, f).numpy() for f in PLANES))
