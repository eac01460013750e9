"""The range kernels' edge cases (``range_case`` of
``tests/test_torch_kernels_cuda.py``, which runs them on the card) on the
CPU, exact:

  * the port's plain ``flix_range`` against the JAX ``flix_range_pallas`` in
    interpret mode and the JAX ``core.dense_range_scan``;
  * the count with an ``is_range`` mask against the count without one,
    which must give the same slot ranks, and the masked scan against
    ``dense_range_scan`` under that mask;
  * the port's fused path (``ExecConfig(impl="fused")``, whose
    ``range_slots`` ranks the RANGE ops by the masked count) on a batch of
    the case's RANGE ops among point reads, against the JAX reference
    engine.

Every JAX function compiles anew for each state size and budget, so the
file keeps to two geometries (``CPU_GEOMETRIES``: the main path's 32 x 16
and the smallest, 4 x 2) to stay near 30 s on one worker; the card test
runs all of ``EDGE_GEOMETRIES``.  The Pallas scan in interpret mode costs in
proportion to its budget times the state's slots, so it runs at the case's
budget capped at ``PALLAS_BUDGET`` (the odd budget is below it), and not on
the ``nb_*`` cases, whose states differ only in their number of buckets
(``dense_range_scan`` holds those); ``dense_range_scan`` runs at the case's
own budget.  The fused path runs on the cases of ``FUSED_CASES``.  This
pins the inputs the card test holds the CUDA kernels to."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.kernels.flix_range import flix_range_pallas  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core.query import live_prefix, range_offsets, range_slot_ranks  # noqa: E402
from repro_torch.core.state import STATE_FIELDS  # noqa: E402
from repro_torch.kernels import flix_range as fr  # noqa: E402
from test_torch_common import EMPTY, assert_same, assert_same_state, t32  # noqa: E402
from test_torch_kernels_cuda import EDGE_GEOMETRIES, RANGE_CASES, range_case  # noqa: E402

torch.set_num_threads(1)

# every batch padded with empty ranges to one length, so that each JAX
# function compiles once per geometry and budget
PAD = 1024
PALLAS_BUDGET = 1024
CPU_GEOMETRIES = [(32, 16), (4, 2)]
# the fused path's RANGE forms: a 1% mask, truncation, an emptied run, the
# int32 edges
FUSED_CASES = ("masked", "odd_budget", "emptied_run", "edge_keys")
NAMES = ("keys", "vals", "start", "count", "truncated")


def _to_jax(st):
    arrays = tcore.state_to_numpy(st)
    return jcore.FliXState(**{f: jnp.asarray(arrays[f]) for f in STATE_FIELDS})


def _same(want, got, n, what):
    """A JAX scan on the padded batch against the port's on the real one:
    the per-op outputs over the real ops, the rest whole."""
    for name, w, g in zip(NAMES, want, got):
        w = np.asarray(w)[:n] if name in ("start", "count") else w
        assert_same(w, g, f"{what} {name}")


@pytest.mark.parametrize("case", RANGE_CASES)
@pytest.mark.parametrize("ns,npb", CPU_GEOMETRIES)
def test_range_case_matches_jax(ns, npb, case):
    st, lo, hi, budget, mask, premise = range_case(ns, npb, case, "cpu")
    premise(st, lo, hi, budget, mask)
    n = len(lo)
    assert n <= PAD
    js = _to_jax(st)
    # padding: empty ranges [EMPTY, 0) after the real ops, still ascending
    jlo = jnp.asarray(np.concatenate([lo, np.full(PAD - n, EMPTY, np.int32)]))
    jhi = jnp.asarray(np.concatenate([hi, np.zeros(PAD - n, np.int32)]))
    every = np.arange(PAD) < n

    for mr in sorted({min(budget, PALLAS_BUDGET), budget}):
        got = fr.flix_range(st.keys, st.vals, st.mkba, t32(lo), t32(hi), max_results=mr)
        if mr <= PALLAS_BUDGET and not case.startswith("nb_"):
            want = flix_range_pallas(js.keys, js.vals, js.mkba, jlo, jhi, max_results=mr,
                                     interpret=True)
            _same(want, got, n, f"pallas @ {mr} ({case})")
        if mr == budget:
            want = jcore.dense_range_scan(js, jnp.asarray(every), jlo, jhi, max_results=mr)
            _same(want, got, n, f"dense_range_scan @ {mr} ({case})")

    # the fused path's form: RANGE ops under a mask (the case's, or every
    # op but each third), counted with and without it
    m = mask if mask is not None else np.arange(n) % 3 != 1
    m_t = torch.as_tensor(m)
    pref = live_prefix(st.node_count)
    meta = (st.keys, st.node_count, st.node_max, st.mkba, pref, t32(lo), t32(hi))
    rl_m, c_m = fr.flix_range_count(*meta, is_range=m_t)
    rl_u, c_u = fr.flix_range_count(*meta)
    assert not bool(rl_m[~m_t].any()) and not bool(c_m[~m_t].any())
    assert torch.equal(rl_m[m_t], rl_u[m_t]) and torch.equal(c_m[m_t], c_u[m_t])
    start, emit, total, trunc = range_offsets(c_m, m_t, budget)
    assert torch.equal(start, range_offsets(c_u, m_t, budget)[0])
    g = range_slot_ranks(rl_m, start, total, budget)
    assert torch.equal(g, range_slot_ranks(rl_u, start, total, budget))
    rk, rv = fr.flix_range_scatter(g, pref, st.node_count, st.keys, st.vals)
    start, emit = torch.where(m_t, start, 0), torch.where(m_t, emit, 0)  # as flix_apply
    want = jcore.dense_range_scan(js, jnp.asarray(np.concatenate([m, np.zeros(PAD - n, bool)])),
                                  jlo, jhi, max_results=budget)
    _same(want, (rk, rv, start, emit, trunc), n, f"masked scan ({case})")


@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("ns,npb", CPU_GEOMETRIES)
def test_fused_range_ops_match_the_jax_engine(ns, npb, case):
    """The case's RANGE ops (those under its mask), with a point read at
    each op outside it, through the port's fused path against the JAX
    reference engine at the case's budget: the same state and results."""
    st, lo, hi, budget, mask, premise = range_case(ns, npb, case, "cpu")
    m = np.ones(len(lo), bool) if mask is None else mask
    tags = np.where(m, tcore.OP_RANGE, tcore.OP_POINT).astype(np.int32)
    vals = np.where(m, hi, 0).astype(np.int32)
    js = _to_jax(st)
    jops, _ = jcore.make_ops(tags, lo, vals, pad_to=PAD)
    tops, _ = tcore.make_ops(tags, lo, vals, pad_to=PAD, device="cpu")
    want = jcore.apply_ops(js, jops, config=jcore.ExecConfig(impl="reference",
                                                             max_results=budget))
    got = tcore.apply_ops(st, tops, config=tcore.ExecConfig(impl="fused", max_results=budget))
    assert_same_state(want[0], got[0])
    for k in want[1]:
        assert_same(want[1][k], got[1][k], f"{case} {k}")
    for k in want[2]:
        assert int(want[2][k]) == int(got[2][k]), (case, k)
    assert int(got[1]["range_count"].sum()) > 0


@pytest.mark.parametrize("ns,npb", EDGE_GEOMETRIES)
def test_node_metadata_matches_the_engine_pass(ns, npb):
    """flix_range's node metadata (one search of each node row) equals
    core.insert._node_metadata's count and max on states with emptied nodes
    and emptied buckets."""
    from repro_torch.core.insert import _node_metadata

    for case in ("emptied_run", "empty_state", "bucket_fences"):
        st = range_case(ns, npb, case, "cpu")[0]
        # a few keys of every fifth bucket deleted too: nodes that lose keys
        k = st.keys[::5].reshape(-1)
        k = torch.sort(k[k != EMPTY][::3]).values
        st = tcore.delete(st, k)[0]
        want = _node_metadata(st.keys)
        got = fr.node_metadata(st.keys)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), case
        assert torch.equal(got[0], st.node_count) and torch.equal(got[1], st.node_max), case
