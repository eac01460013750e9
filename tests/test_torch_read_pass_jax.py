"""The read-only pass (``kernels.flix_apply.flix_apply_read``, its plain
version on the CPU) against the JAX reference engine
(``repro.core.apply_ops(impl="reference")``) on the cases of
``test_torch_read_pass.py``, each state and sorted batch carried over
through numpy: every result and stat equal by the parity contract, and the
state returned unwritten."""

import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core.config import ExecConfig as JExecConfig  # noqa: E402
from repro_torch.core.state import STATE_FIELDS  # noqa: E402
from repro_torch.kernels import flix_apply as fa  # noqa: E402
from test_torch_common import assert_same, assert_same_state  # noqa: E402
from test_torch_read_pass import CASES, MAX_RESULTS, RESULT_KEYS, read_case  # noqa: E402


def to_jax(st):
    """The port state's seven carry-over fields as a JAX state, with the
    JAX package's own successor cache where the port state carries one."""
    js = jcore.FliXState(**{f: jnp.asarray(getattr(st, f).numpy()) for f in STATE_FIELDS})
    if st.succ_smin is not None:
        js = jcore.with_successor_cache(js)
        assert_same(js.succ_smin, st.succ_smin, "succ_smin")
        assert_same(js.succ_sidx, st.succ_sidx, "succ_sidx")
    return js


@pytest.mark.parametrize("case", list(CASES))
def test_read_pass_matches_the_jax_reference_engine(case):
    st, ops = read_case(case)
    js = to_jax(st)
    jops = jcore.OpBatch(tag=jnp.asarray(ops.tag.numpy()), key=jnp.asarray(ops.key.numpy()),
                         val=jnp.asarray(ops.val.numpy()))
    want = jcore.apply_ops(js, jops, config=JExecConfig(impl="reference",
                                                        max_results=MAX_RESULTS))
    got = fa.flix_apply_read(st, ops.tag, ops.key, ops.val, max_results=MAX_RESULTS)
    assert got[0] is st
    assert_same_state(want[0], st)
    for k in RESULT_KEYS:
        assert_same(want[1][k], got[1][k], k)
    assert set(want[2]) == set(got[2])
    for k in want[2]:
        assert int(want[2][k]) == int(got[2][k]), k
