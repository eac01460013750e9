"""The successor kernel's edge cases (``successor_case`` of
``tests/test_torch_kernels_cuda.py``, which runs them on the card) on the
CPU: the port's plain version against the Pallas kernel in interpret mode
and the JAX reference oracle, exact.  Then the fence rows: ``next_rows``,
the fence-row kernel's plain version, against the rows that the Pallas
wrapper computes beside its kernel, on the inputs of ``fence_case``.  This
pins the inputs the card tests hold the CUDA kernels to."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.query import _suffix_min_with_index  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flix_successor import flix_successor_pallas  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.kernels import flix_successor as fs  # noqa: E402
from test_torch_common import EMPTY, assert_same, t32  # noqa: E402
from test_torch_kernels_cuda import (  # noqa: E402
    EDGE_GEOMETRIES,
    FENCE_CASES,
    SUCCESSOR_CASES,
    fence_case,
    successor_case,
)

torch.set_num_threads(1)

# every batch padded with EMPTY to one length, so that each JAX function
# compiles once per geometry
PAD = 1024


@pytest.mark.parametrize("case", SUCCESSOR_CASES)
@pytest.mark.parametrize("ns,npb", EDGE_GEOMETRIES)
def test_successor_case_matches_jax(ns, npb, case):
    st, q, premise = successor_case(ns, npb, case, "cpu")
    premise(st, q)
    planes = (st.keys, st.vals, st.node_max, st.mkba)
    got = fs.flix_successor(*planes, t32(q))
    assert len(q) <= PAD
    jplanes = tuple(jnp.asarray(t.numpy()) for t in planes)
    padded = jnp.asarray(np.concatenate([q, np.full(PAD - len(q), EMPTY, np.int32)]))
    for name, want in (("pallas", flix_successor_pallas(*jplanes, padded, interpret=True)),
                       ("oracle", jref.flix_successor_ref(*jplanes, padded))):
        for w, g, part in zip(want, got, ("key", "val")):
            assert_same(np.asarray(w)[: len(q)], g, f"{name} {part} ({case})")
    want = tcore.successor_query(st, t32(q))
    for w, g in zip(want, got):
        assert torch.equal(w, g), case


def pallas_rows(keys3d, vals3d, node_max):
    """The fence rows as ``flix_successor_pallas`` computes them beside its
    kernel (``repro/kernels/flix_successor.py:154-159``), in jnp."""
    keys3d, vals3d, node_max = (jnp.asarray(t.numpy()) for t in (keys3d, vals3d, node_max))
    bucket_min = jnp.where(node_max[:, 0] != EMPTY, keys3d[:, 0, 0], EMPTY)
    head_val = vals3d[:, 0, 0]
    smin, sidx = _suffix_min_with_index(bucket_min)
    next_key = jnp.concatenate([smin[1:], jnp.array([EMPTY], jnp.int32)])
    next_idx = jnp.concatenate([sidx[1:], jnp.array([0], jnp.int32)])
    return next_key, head_val[next_idx]


@pytest.mark.parametrize("case", FENCE_CASES)
@pytest.mark.parametrize("ns,npb", [(4, 2), (3, 5)])
def test_next_rows_match_pallas_rows(ns, npb, case):
    """next_rows, from node_max and from num_nodes, and the fence-row
    wrapper on the CPU, equal the Pallas wrapper's rows: ties toward the
    higher bucket, (EMPTY, the last bucket's head value) over an all-empty
    suffix, (EMPTY, bucket 0's head value) for the last bucket."""
    keys, vals, nm, nn = fence_case(case, ns, npb, "cpu")
    want = pallas_rows(keys, vals, nm)
    heads = keys[:, 0, 0][nn > 0]
    if case == "equal_heads":
        assert len(torch.unique(heads)) < len(heads)
    if case != "all_empty" and case != "nb_1":  # non-monotone heads
        assert bool((heads[1:] < heads[:-1]).any())
    for got in (fs.next_rows(keys, vals, nm), fs.next_rows(keys, vals, num_nodes=nn),
                fs.fence_rows(keys, vals, nm), fs.fence_rows(keys, vals, num_nodes=nn)):
        for w, g, part in zip(want, got, ("next_key", "next_val")):
            assert_same(w, g, f"{part} ({case})")


def test_fence_rows_checks_its_inputs():
    """fence_rows takes exactly one non-empty test, int32 and of the planes'
    geometry."""
    keys, vals, nm, nn = fence_case("random", 4, 2, "cpu")
    with pytest.raises(ValueError, match="exactly one"):
        fs.fence_rows(keys, vals)
    with pytest.raises(ValueError, match="exactly one"):
        fs.fence_rows(keys, vals, nm, num_nodes=nn)
    with pytest.raises(ValueError, match="geometry"):
        fs.fence_rows(keys, vals, num_nodes=nn[:-1])
    with pytest.raises(ValueError, match="geometry"):
        fs.fence_rows(keys, vals[:-1], nm)
    with pytest.raises(TypeError, match="int32"):
        fs.fence_rows(keys, vals, num_nodes=nn.to(torch.int64))

