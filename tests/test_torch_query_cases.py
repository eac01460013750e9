"""The point-query kernel's edge cases (``query_case`` of
``tests/test_torch_kernels_cuda.py``, which runs them on the card) on the
CPU: the port's plain version against the Pallas kernel in interpret mode
and the JAX reference oracle, exact.  This pins the inputs the card test
holds the CUDA kernel to."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flix_query import flix_point_query_pallas  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.kernels import flix_query as fq  # noqa: E402
from test_torch_common import EMPTY, assert_same, t32  # noqa: E402
from test_torch_kernels_cuda import EDGE_GEOMETRIES, QUERY_CASES, query_case  # noqa: E402

torch.set_num_threads(1)

# every batch padded with EMPTY to one length, so that each JAX function
# compiles once per geometry
PAD = 1024


@pytest.mark.parametrize("case", QUERY_CASES)
@pytest.mark.parametrize("ns,npb", EDGE_GEOMETRIES)
def test_query_case_matches_jax(ns, npb, case):
    st, q, premise = query_case(ns, npb, case, "cpu")
    premise(st, q)
    planes = (st.keys, st.vals, st.node_max, st.mkba)
    got = fq.flix_point_query(*planes, t32(q))
    assert len(q) <= PAD
    jplanes = tuple(jnp.asarray(t.numpy()) for t in planes)
    padded = jnp.asarray(np.concatenate([q, np.full(PAD - len(q), EMPTY, np.int32)]))
    want = flix_point_query_pallas(*jplanes, padded, interpret=True)
    assert_same(np.asarray(want)[: len(q)], got, f"pallas ({case})")
    # the oracle clamps a query above the last fence to the last bucket
    # (ref.py:25); below EMPTY every query has a bucket and the forms agree
    below = q < EMPTY
    oracle = np.asarray(jref.flix_point_query_ref(*jplanes, padded))[: len(q)]
    assert_same(oracle[below], got[torch.as_tensor(below)], f"oracle ({case})")
    assert bool((got[torch.as_tensor(~below)] == tcore.NOT_FOUND).all())
