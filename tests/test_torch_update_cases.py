"""The insert and delete kernels' edge cases (``update_case`` of
``tests/test_torch_kernels_cuda.py``, which runs them on the card) on the
CPU: the port's plain versions against the Pallas kernels in interpret mode
(``flix_insert_pallas``, ``flix_delete_pallas``) and JAX ``core.insert`` /
``core.delete``, exact.  This pins the inputs the card test holds the CUDA
kernels to."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.kernels.flix_delete import flix_delete_pallas  # noqa: E402
from repro.kernels.flix_insert import flix_insert_pallas  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core.state import STATE_FIELDS  # noqa: E402
from repro_torch.kernels import flix_delete as fd  # noqa: E402
from repro_torch.kernels import flix_insert as fi  # noqa: E402
from test_torch_common import EMPTY, assert_same, assert_same_state, t32  # noqa: E402
from test_torch_kernels_cuda import (  # noqa: E402
    EDGE_GEOMETRIES,
    UPDATE_CASES,
    _per_bucket,
    prefilter,
    update_case,
)

torch.set_num_threads(1)

# every batch padded with EMPTY (which no bucket's slice holds) to one
# length, so that each JAX function compiles once per geometry
PAD = 4096
# the cases whose delete the pre-filter keeps from core.delete's exact
# membership (ROADMAP Queue 3), besides those that the cut at cap holds
# back: core deletes more
CORE_DELETES_MORE = ("not_found_value",)


def _to_jax(st):
    arrays = tcore.state_to_numpy(st)
    return jcore.FliXState(**{f: jnp.asarray(arrays[f]) for f in STATE_FIELDS})


def _pad(a, fill):
    assert len(a) <= PAD
    return jnp.asarray(np.concatenate([a, np.full(PAD - len(a), fill, np.int32)]))


def _as_state(st, outs, overflow=None):
    """A pass's outputs as a state (an insert ORs its overflow into the
    restructure flag, as flix_insert does)."""
    flag = st.needs_restructure
    if overflow is not None:
        flag = flag | (overflow > 0).any()
    return tcore.FliXState(*outs[:5], st.mkba, flag)


@pytest.mark.parametrize("case", UPDATE_CASES)
@pytest.mark.parametrize("ns,npb", EDGE_GEOMETRIES)
def test_update_case_matches_jax(ns, npb, case):
    st, (ik, iv), dk, premise = update_case(ns, npb, case, "cpu")
    js = _to_jax(st)

    ins = fi.flix_insert_pass(st.num_nodes, st.keys, st.vals, st.node_max, st.mkba, t32(ik),
                              t32(iv))
    want, wflow = flix_insert_pallas(js, _pad(ik, EMPTY), _pad(iv, 0), interpret=True)
    got = _as_state(st, ins, ins[5])
    assert_same_state(want, got, live_vals_only=False)
    assert_same(wflow, ins[5], f"overflow ({case})")
    if not bool((ins[5] > 0).any()):  # core's overflowed buckets are not to be trusted
        exact, _ = jcore.insert(js, _pad(ik, EMPTY), _pad(iv, 0))
        assert_same_state(exact, got)

    dkf = prefilter(st, t32(dk))
    dele = fd.flix_delete_pass(st.num_nodes, st.keys, st.vals, st.mkba, dkf)
    got = _as_state(st, dele)
    assert_same_state(flix_delete_pallas(js, _pad(dk, EMPTY), interpret=True), got,
                      live_vals_only=False)
    exact, _ = jcore.delete(js, _pad(dk, EMPTY))
    if case in CORE_DELETES_MORE or (_per_bucket(st, dkf.numpy()) > ns * npb).any():
        assert int(exact.live_keys()) < int(got.live_keys())
    else:
        assert_same_state(exact, got)
    premise(st, ik, dkf, ins, dele)
