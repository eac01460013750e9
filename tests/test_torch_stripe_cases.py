"""The stripe kernels' edge cases (``stripe_case`` of
``tests/test_torch_kernels_cuda.py``, which holds the single-buffer and the
staged kernel to each other and to the plain version on the card) on the
CPU: the port's fused apply (``kernels.flix_apply.flix_apply``, whose
stripe pass runs its plain version here) against the JAX reference engine
(``core.apply_ops`` with ``impl="reference"``: the Pallas kernel in
interpret mode would take minutes on these states' thousands of buckets),
by the contract of ``tests/test_differential.py``: state byte-equal, vals
equal at live slots, results equal.  Where a batch overflows a bucket
(the "flood" and "full_bucket" cases), both engines flag the state for a
restructure, and an overflowed bucket's contents are left to that
restructure (the two engines need not agree on them), so the comparison
covers every other bucket, and every result of the ops those buckets own;
JAX's restructure and retry on the CPU would take half a minute a case.
Each case asserts its premise on the outputs of the stripe pass that the
port's apply ran.  This pins the inputs the card tests hold the CUDA
kernels to."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core.config import ExecConfig as JExecConfig  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core.state import STATE_FIELDS  # noqa: E402
from repro_torch.kernels import flix_apply as fa  # noqa: E402
from test_torch_common import EMPTY, assert_same, assert_same_state  # noqa: E402
from test_torch_kernels_cuda import EDGE_GEOMETRIES, STAGED_CASES, stripe_case  # noqa: E402

torch.set_num_threads(1)

# the JAX engine's batches padded with NOPs to one length, so that it
# compiles once per state geometry
PAD = 4096
MAX_RESULTS = 8192
PER_OP = ("value", "succ_key", "range_start", "range_count")  # one entry an op


def _to_jax(st):
    arrays = tcore.state_to_numpy(st)
    return jcore.FliXState(**{f: jnp.asarray(arrays[f]) for f in STATE_FIELDS})


def _spy(monkeypatch, seen, name):
    """Record in ``seen[name]`` what ``fa.<name>`` returns."""
    fn = getattr(fa, name)

    def call(*args, **kwargs):
        seen[name] = out = fn(*args, **kwargs)
        return out

    monkeypatch.setattr(fa, name, call)


@pytest.mark.parametrize("case", STAGED_CASES)
@pytest.mark.parametrize("ns,npb", EDGE_GEOMETRIES)
def test_stripe_case_matches_jax(ns, npb, case, monkeypatch):
    st, ops, premise = stripe_case(ns, npb, case, "cpu")
    seen = {}
    _spy(monkeypatch, seen, "stripe_inputs")
    _spy(monkeypatch, seen, "flix_apply_pass")
    got = fa.flix_apply(st, ops.tag, ops.key, ops.val, max_results=MAX_RESULTS)
    outs, r = seen["flix_apply_pass"], seen["stripe_inputs"][1]
    premise(outs, r)

    cols = [c.numpy() for c in (ops.tag, ops.key, ops.val)]
    n = len(cols[0])
    assert n <= PAD
    jops, _ = jcore.make_ops(*cols, pad_to=PAD)
    want = jcore.apply_ops(_to_jax(st), jops,
                           config=JExecConfig(impl="reference", max_results=MAX_RESULTS))
    assert set(want[1]) == set(got[1]) == {*PER_OP, "range_key", "range_val"}
    flow = outs[5].numpy() > 0
    assert bool(want[0].needs_restructure) == bool(got[0].needs_restructure) == flow.any()
    if not flow.any():
        assert_same_state(want[0], got[0])
        for k in want[1]:
            w = np.asarray(want[1][k])
            assert_same(w[:n] if k in PER_OP else w, got[1][k], f"result {k} ({case})")
        return
    assert case in ("flood", "full_bucket")
    assert not (cols[0] == tcore.OP_RANGE).any()  # no range reads an overflowed bucket
    ok = ~flow  # the buckets that did not overflow, and the ops they own
    owner = np.searchsorted(r.ends.numpy(), np.arange(n), side="right")
    mine = ~flow[np.minimum(owner, len(flow) - 1)] & (owner < len(flow))
    gs, ws = tcore.state_to_numpy(got[0]), want[0]
    for f in ("keys", "node_count", "node_max", "num_nodes"):
        np.testing.assert_array_equal(np.asarray(getattr(ws, f))[ok], gs[f][ok], err_msg=f)
    live = gs["keys"][ok] != EMPTY
    np.testing.assert_array_equal(np.asarray(ws.vals)[ok][live], gs["vals"][ok][live])
    for k in want[1]:
        w = np.asarray(want[1][k])
        if k in PER_OP:
            assert_same(w[:n][mine], got[1][k][torch.as_tensor(mine)], f"result {k} ({case})")
        else:
            assert_same(w, got[1][k], f"result {k} ({case})")
