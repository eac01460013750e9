"""The port's all-to-all MoE dispatch (``repro_torch.models.moe_a2a``)
against the JAX package on the CPU, on the same numpy inputs:

  * on 4 × 2, 2 × 4 and 2 × 2 × 2 meshes of ``"cpu"`` positions, within
    2e-4 of the reference's ``moe_ffn_dense_oracle`` with and without the
    virtual-expert split (``moe_split=2``), and its gradients within 1e-4
    of each leaf's largest against ``jax.grad`` of the oracle — the
    reference's contract (``tests/test_distributed.py:212-266``), which
    checks only that the gradients are finite and non-zero;
  * on a 1 × 1 mesh against the reference's own ``moe_ffn_a2a`` on a 1 × 1
    JAX mesh at capacity factors that drop rows at the per-pair and the
    per-expert windows: the outputs within 1e-5 and the same (token,
    expert) slots dropped, each token's kept set read off its output as
    the one subset of its top-k contributions that sums to it.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch.mesh import make_mesh_auto as jmesh  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.moe import moe_ffn_dense_oracle as joracle  # noqa: E402
from repro.models.moe_a2a import moe_ffn_a2a as ja2a  # noqa: E402
from repro_torch import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import make_mesh_auto  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.moe_a2a import moe_ffn_a2a  # noqa: E402

torch.set_num_threads(1)

ORACLE_ATOL = 2e-4  # tests/test_distributed.py:249
GRAD_REL = 1e-4
T = 64
MESHES = {
    "4x2": ((4, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}


def configs(shared: int = 1, factor: float = 8.0):
    out = []
    for m in (jmodel, tmodel):
        cfg = m.get_config("deepseek-moe-16b").reduced(dtype="float32",
                                                       moe_capacity_factor=factor)
        out.append(dataclasses.replace(cfg, num_experts=4, top_k=2, num_shared_experts=shared))
    return out


def inputs(cfg, seed=4):
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": rng.normal(size=(D, E)) * 0.1,
        "w_gate": rng.normal(size=(E, D, F)) * 0.05,
        "w_up": rng.normal(size=(E, D, F)) * 0.05,
        "w_down": rng.normal(size=(E, F, D)) * 0.05,
    }
    if cfg.num_shared_experts:
        p.update(shared_gate=rng.normal(size=(D, F)) * 0.05,
                 shared_up=rng.normal(size=(D, F)) * 0.05,
                 shared_down=rng.normal(size=(F, D)) * 0.05)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, rng.normal(size=(T, D)).astype(np.float32)


def split_experts(p, E):
    """The reference test's virtual-expert split: expert e's FFN columns in
    two halves, experts 2e and 2e + 1."""
    def split(w, axis):
        a, b = np.split(w, 2, axis=axis)
        return np.stack([a, b], axis=1).reshape((E * 2,) + a.shape[1:])

    return dict(p, w_gate=split(p["w_gate"], 2), w_up=split(p["w_up"], 2),
                w_down=split(p["w_down"], 1))


def cpu_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh_auto(shape, axes, ["cpu"] * int(np.prod(shape)))


def tt(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_a2a_matches_reference_dense_oracle(mesh, split):
    jcfg, tcfg = configs()
    p, x = inputs(jcfg)
    want = np.asarray(joracle(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, jcfg))
    pp = split_experts(p, jcfg.num_experts) if split == 2 else p
    tsh.reset_collectives()
    got = moe_ffn_a2a(torch.from_numpy(x), tt(pp), dataclasses.replace(tcfg, moe_split=split),
                      cpu_mesh(mesh))
    assert float(np.abs(got.numpy() - want).max()) < ORACLE_ATOL
    # three exchanges: tokens and their expert tags out, results back
    assert tsh.collective_counts()["all-to-all"]["count"] == 3


@pytest.mark.parametrize("mesh", ["4x2", "2x2x2"])
def test_a2a_gradients_match_reference_oracle(mesh):
    jcfg, tcfg = configs()
    p, x = inputs(jcfg, seed=7)

    def jloss(p, x):
        return jnp.sum(joracle(x, p, jcfg) ** 2)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()},
                                              jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    loss = torch.sum(moe_ffn_a2a(tx, tp, tcfg, cpu_mesh(mesh)) ** 2)
    grads = torch.autograd.grad(loss, [tx] + [tp[k] for k in sorted(tp)])
    want = [np.asarray(jgx)] + [np.asarray(jg[k]) for k in sorted(tp)]
    for name, g, w in zip(["x"] + sorted(tp), grads, want):
        scale = float(np.abs(w).max())
        assert scale > 0 and np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_REL * scale, err_msg=name)


def contributions(p, x, cfg):
    """Each token's top-k experts and their weighted outputs, in float64."""
    logits = x.astype(np.float64) @ p["router"].astype(np.float64)
    gate = np.exp(logits - logits.max(-1, keepdims=True))
    gate /= gate.sum(-1, keepdims=True)
    experts = np.argsort(-gate, axis=-1, kind="stable")[:, :cfg.top_k]
    w = np.take_along_axis(gate, experts, -1)
    w /= w.sum(-1, keepdims=True)
    f = {k: v.astype(np.float64) for k, v in p.items()}
    c = np.zeros(experts.shape + (x.shape[1],))
    for t, j in itertools.product(range(x.shape[0]), range(cfg.top_k)):
        e = experts[t, j]
        hg = x[t] @ f["w_gate"][e]
        h = hg / (1 + np.exp(-hg)) * (x[t] @ f["w_up"][e])
        c[t, j] = w[t, j] * (h @ f["w_down"][e])
    return experts, c


def kept_slots(y, experts, c):
    """The (token, expert) slots each token's output is the sum of."""
    kept = set()
    for t in range(y.shape[0]):
        errs = []
        for mask in itertools.product((0, 1), repeat=c.shape[1]):
            errs.append((float(np.abs(y[t] - (np.array(mask)[:, None] * c[t]).sum(0)).max()),
                         mask))
        errs.sort()
        assert errs[0][0] < 1e-5 and errs[1][0] > 1e-3, (t, errs[:2])
        kept |= {(t, int(experts[t, j])) for j, m in enumerate(errs[0][1]) if m}
    return kept


@pytest.mark.parametrize("factor", [0.25, 0.5, 1.0])
def test_a2a_drops_what_reference_drops(factor):
    jcfg, tcfg = configs(shared=0, factor=factor)
    p, x = inputs(jcfg, seed=11)
    mesh = jmesh((1, 1), ("data", "model"))
    with mesh:
        want = np.asarray(jax.jit(lambda x, p: ja2a(x, p, jcfg, mesh))(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}))
    got = moe_ffn_a2a(torch.from_numpy(x), tt(p), tcfg,
                      make_mesh_auto((1, 1), ("data", "model"), ["cpu"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    experts, c = contributions(p, x, jcfg)
    got_kept, want_kept = kept_slots(got, experts, c), kept_slots(want, experts, c)
    assert got_kept == want_kept
    assert len(got_kept) < T * jcfg.top_k  # rows were dropped
