"""The port's flipped MoE dispatch path against the JAX package, on the CPU,
where ``grouped_matmul`` runs its plain torch version:

  * ``grouped_matmul_reference`` (the CUDA kernel's semantics) against
    ``grouped_matmul_pallas`` in interpret mode, in float32, bfloat16 and
    both mixes, with empty groups and with rows outside every group;
  * ``grouped_matmul_ref`` against ``ref.grouped_matmul_ref``, and the rows
    where the two plain functions differ;
  * ``ops.grouped_matmul``'s modes; ``make_plan``, ``dispatch``, ``combine``
    and ``moe_ffn_reference``; ``examples/moe_routing.py``'s walk;
  * the configurations, field for field, and ``params_from_numpy``.

Tolerances: the GEMMs on both sides sum float32 products in float32, in
different orders, so they agree to ``1e-5``; ``make_plan``'s indices are
exact and its weights within ``1e-6`` (two softmax implementations).  The
CUDA kernel itself runs only on a card: ``tests/test_torch_kernels_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import moe_dispatch as jmd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.grouped_matmul import grouped_matmul_pallas  # noqa: E402
from repro.models import config as jmodel_config  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops  # noqa: E402
from repro_torch.kernels import grouped_matmul as tg  # noqa: E402
from repro_torch.kernels import moe_dispatch as tmd  # noqa: E402
from repro_torch.models import config as tmodel_config  # noqa: E402

GEMM_TOL = dict(rtol=1e-5, atol=1e-5)
MIXES = [
    (jnp.float32, jnp.float32),
    (jnp.bfloat16, jnp.bfloat16),
    (jnp.float32, jnp.bfloat16),
    (jnp.bfloat16, jnp.float32),
]


def _to_torch(**arrays):
    return tmd.params_from_numpy({k: np.asarray(v) for k, v in arrays.items()}, device="cpu")


def _gemm_case(rng, T, D, F, E, dx, dw):
    sizes = rng.multinomial(T, np.ones(E) / E)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    x = jnp.asarray(rng.normal(size=(T, D)), dtype=dx)
    w = jnp.asarray(rng.normal(size=(E, D, F)) * 0.1, dtype=dw)
    return x, w, jnp.asarray(offs)


@pytest.mark.parametrize("T,D,F,E", [(256, 128, 256, 4), (512, 64, 128, 8)])
@pytest.mark.parametrize("dx,dw", MIXES)
def test_reference_matches_pallas_kernel(T, D, F, E, dx, dw):
    rng = np.random.default_rng(T + D + E)
    x, w, offs = _gemm_case(rng, T, D, F, E, dx, dw)
    want = grouped_matmul_pallas(x, w, offs, block_t=128, block_f=64, interpret=True)
    p = _to_torch(x=x, w=w, offs=offs)
    got = tg.grouped_matmul_reference(p["x"], p["w"], p["offs"])
    assert got.dtype == torch.float32 and got.shape == (T, F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)
    before = dict(LAUNCHES)
    assert torch.equal(tg.grouped_matmul(p["x"], p["w"], p["offs"]), got)
    assert LAUNCHES == before  # a CPU tensor runs the plain version


@pytest.mark.parametrize(
    "offs",
    [
        [0, 0, 128, 128, 128, 256, 256, 256, 256],  # empty groups
        [0, 256, 256, 256, 256, 256, 256, 256, 256],  # one group holds every row
        [37, 60, 60, 130, 131, 131, 200, 210, 222],  # rows outside every group
    ],
)
def test_reference_matches_pallas_kernel_on_uneven_groups(offs):
    rng = np.random.default_rng(len(set(offs)))
    T, D, F, E = 256, 64, 128, 8
    x = jnp.asarray(rng.normal(size=(T, D)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(E, D, F)).astype(np.float32))
    o = jnp.asarray(np.array(offs, np.int32))
    want = np.asarray(grouped_matmul_pallas(x, w, o, interpret=True))
    p = _to_torch(x=x, w=w, offs=o)
    got = tg.grouped_matmul_reference(p["x"], p["w"], p["offs"]).numpy()
    np.testing.assert_allclose(got, want, **GEMM_TOL)
    outside = np.r_[0 : offs[0], offs[-1] : T]
    assert np.all(got[outside] == 0) and np.all(want[outside] == 0)


@pytest.mark.parametrize(
    "offs", [[0, 100, 100, 300, 512], [40, 100, 100, 300, 450], [0, 0, 0, 0, 0]]
)
@pytest.mark.parametrize("dx,dw", MIXES[:3])
def test_ref_matches_reference_oracle(offs, dx, dw):
    rng = np.random.default_rng(7)
    T, D, F, E = 512, 32, 48, 4
    x = jnp.asarray(rng.normal(size=(T, D)), dtype=dx)
    w = jnp.asarray(rng.normal(size=(E, D, F)) * 0.1, dtype=dw)
    o = jnp.asarray(np.array(offs, np.int32))
    want = np.asarray(jref.grouped_matmul_ref(x, w, o))
    p = _to_torch(x=x, w=w, offs=o)
    np.testing.assert_allclose(
        tg.grouped_matmul_ref(p["x"], p["w"], p["offs"]).numpy(), want, **GEMM_TOL
    )


def test_the_two_plain_versions_differ_only_outside_every_group():
    """The Pallas kernel leaves a row outside every group zero;
    ``ref.grouped_matmul_ref`` gives it the clipped group."""
    rng = np.random.default_rng(3)
    T, D, F, E = 300, 16, 24, 3
    offs = torch.tensor([20, 90, 90, 250], dtype=torch.int32)
    x = torch.from_numpy(rng.normal(size=(T, D)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(E, D, F)).astype(np.float32))
    zero = tg.grouped_matmul_reference(x, w, offs)
    clip = tg.grouped_matmul_ref(x, w, offs)
    torch.testing.assert_close(zero[20:250], clip[20:250], rtol=0, atol=0)
    assert torch.all(zero[:20] == 0) and torch.all(zero[250:] == 0)
    torch.testing.assert_close(clip[:20], x[:20] @ w[0], **GEMM_TOL)
    torch.testing.assert_close(clip[250:], x[250:] @ w[2], **GEMM_TOL)


def test_ops_grouped_matmul_modes():
    rng = np.random.default_rng(11)
    T, D, F, E = 1000, 40, 96, 5
    sizes = rng.multinomial(T, np.ones(E) / E)
    sizes[2] = 0
    sizes[0] += T - sizes.sum()
    o = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    x = rng.normal(size=(T, D)).astype(np.float32)
    w = (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32)
    want = np.asarray(jops.grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(o),
                                          mode="ref"))
    p = tmd.params_from_numpy({"x": x, "w": w, "offs": o}, device="cpu")
    for mode in ("auto", "ref"):
        got = ops.grouped_matmul(p["x"], p["w"], p["offs"], mode=mode, block_t=128,
                                 block_f=128, max_span=4)
        np.testing.assert_allclose(got.numpy(), want, **GEMM_TOL)
    for mode in ("pallas", "interpret"):
        with pytest.raises(ValueError):
            ops.grouped_matmul(p["x"], p["w"], p["offs"], mode=mode)
    with pytest.raises(TypeError):
        ops.grouped_matmul(p["x"], p["w"], p["offs"], block_q=8)


def test_grouped_matmul_checks_its_inputs():
    x, w = torch.zeros(8, 4), torch.zeros(2, 4, 6)
    offs = torch.tensor([0, 4, 8], dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tg.grouped_matmul(x.half(), w, offs)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tg.grouped_matmul(x, w.double(), offs)
    with pytest.raises(TypeError, match="int32"):
        tg.grouped_matmul(x, w, offs.long())
    with pytest.raises(ValueError):
        tg.grouped_matmul(x, torch.zeros(2, 5, 6), offs)
    with pytest.raises(ValueError):
        tg.grouped_matmul(x, w, offs[:2])
    with pytest.raises(ValueError, match="contiguous"):
        tg.grouped_matmul(torch.zeros(4, 8).t(), w, offs)


def _logits_with_ties(rng, T, E):
    logits = rng.normal(size=(T, E)).astype(np.float32)
    logits[3] = 0.25  # every expert tied
    logits[7, :3] = 2.0  # three tied at the top
    logits[9, ::2] = -1.0  # ties below the top
    logits[10] = logits[11]  # identical rows
    return logits


@pytest.mark.parametrize("T,E,k", [(64, 8, 2), (96, 16, 6), (33, 4, 1)])
def test_make_plan_matches_jax(T, E, k):
    logits = _logits_with_ties(np.random.default_rng(T), T, E)
    jp = jmd.make_plan(jnp.asarray(logits), k, E)
    tp = tmd.make_plan(torch.from_numpy(logits), k, E)
    for f in ("sort_idx", "unsort_idx", "group_offsets", "expert_sorted"):
        got, want = getattr(tp, f), np.asarray(getattr(jp, f))
        assert got.dtype == torch.int32 and want.dtype == np.int32, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    np.testing.assert_allclose(tp.weights.numpy(), np.asarray(jp.weights), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_dispatch_combine_and_dense_oracle_match_jax(dtype):
    rng = np.random.default_rng(5)
    T, D, F, E, K = 96, 32, 48, 8, 2
    x = jnp.asarray(rng.normal(size=(T, D)), dtype=dtype)
    logits = jnp.asarray(_logits_with_ties(rng, T, E))
    w_up = jnp.asarray(rng.normal(size=(E, D, F)) * 0.05, dtype=dtype)
    w_down = jnp.asarray(rng.normal(size=(E, F, D)) * 0.05, dtype=dtype)
    y = jnp.asarray(rng.normal(size=(T * K, D)).astype(np.float32))
    p = _to_torch(x=x, logits=logits, w_up=w_up, w_down=w_down, y=y)
    jp = jmd.make_plan(logits, K, E)
    tp = tmd.make_plan(p["logits"], K, E)
    xs = tmd.dispatch(p["x"], tp, K)
    assert xs.dtype == p["x"].dtype
    np.testing.assert_array_equal(
        xs.float().numpy(), np.asarray(jmd.dispatch(x, jp, K)).astype(np.float32)
    )
    np.testing.assert_allclose(
        tmd.combine(p["y"], tp, K).numpy(), np.asarray(jmd.combine(y, jp, K)),
        rtol=1e-6, atol=1e-6,
    )
    want = np.asarray(jmd.moe_ffn_reference(x, logits, w_up, w_down, K))
    got = tmd.moe_ffn_reference(p["x"], p["logits"], p["w_up"], p["w_down"], K)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_moe_routing_example_walk_matches_jax():
    """``examples/moe_routing.py`` at its sizes, through both packages."""
    T, D, F, E, K = 512, 256, 512, 8, 2
    rng = np.random.default_rng(0)
    x = rng.normal(size=(T, D)).astype(np.float32)
    logits = rng.normal(size=(T, E)).astype(np.float32)
    w_up = (rng.normal(size=(E, D, F)) * 0.05).astype(np.float32)
    w_down = (rng.normal(size=(E, F, D)) * 0.05).astype(np.float32)

    jplan = jmd.make_plan(jnp.asarray(logits), K, E)
    jxs = jmd.dispatch(jnp.asarray(x), jplan, K)
    jh = jax.nn.silu(jops.grouped_matmul(jxs, jnp.asarray(w_up), jplan.group_offsets,
                                         mode="ref"))
    jys = jops.grouped_matmul(jh, jnp.asarray(w_down), jplan.group_offsets, mode="ref")
    jout = np.asarray(jmd.combine(jys, jplan, K))

    p = tmd.params_from_numpy(
        {"x": x, "logits": logits, "w_up": w_up, "w_down": w_down}, device="cpu"
    )
    plan = tmd.make_plan(p["logits"], K, E)
    np.testing.assert_array_equal(plan.group_offsets.numpy(), np.asarray(jplan.group_offsets))
    xs = tmd.dispatch(p["x"], plan, K)
    for mode in ("auto", "ref"):
        h = torch.nn.functional.silu(ops.grouped_matmul(xs, p["w_up"], plan.group_offsets,
                                                        mode=mode))
        ys = ops.grouped_matmul(h, p["w_down"], plan.group_offsets, mode=mode)
        out = tmd.combine(ys, plan, K)
        np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)
    want = tmd.moe_ffn_reference(p["x"], p["logits"], p["w_up"], p["w_down"], K)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(jconfigs.REGISTRY))
def test_configs_match_field_for_field(name):
    j, t = jconfigs.get(name), tconfigs.get(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    for tp in (1, 4, 16):
        assert dataclasses.asdict(t.padded(tp)) == dataclasses.asdict(j.padded(tp)), tp
    assert (t.resolved_head_dim, t.d_inner, t.ssm_heads) == (
        j.resolved_head_dim, j.d_inner, j.ssm_heads)
    assert tmodel_config.cells_for(name) == jmodel_config.cells_for(name)


def test_config_tables_match():
    assert list(tconfigs.REGISTRY) == list(jconfigs.REGISTRY)
    assert tmodel_config.SHAPES == jmodel_config.SHAPES
    assert tmodel_config.LONG_CONTEXT_ARCHS == jmodel_config.LONG_CONTEXT_ARCHS
    assert [f.name for f in dataclasses.fields(tmodel_config.ModelConfig)] == [
        f.name for f in dataclasses.fields(jmodel_config.ModelConfig)
    ]


def test_params_from_numpy_carries_bfloat16_bit_exact():
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.normal(size=(3, 5, 7)) * 0.02, dtype=jnp.bfloat16)
    x = jnp.asarray(rng.normal(size=(4, 5)).astype(np.float32))
    p = tmd.params_from_numpy({"w_up": np.asarray(w), "x": np.asarray(x)}, device="cpu")
    assert p["w_up"].dtype == torch.bfloat16 and p["w_up"].shape == (3, 5, 7)
    np.testing.assert_array_equal(
        p["w_up"].view(torch.int16).numpy(), np.asarray(w).view(np.int16)
    )
    assert p["x"].dtype == torch.float32
    np.testing.assert_array_equal(p["x"].numpy(), np.asarray(x))
    np.testing.assert_array_equal(
        p["w_up"].float().numpy(), np.asarray(w.astype(jnp.float32))
    )
