"""One and three steps of the port's ``make_train_step`` against the JAX
package's (``jax.jit``, as ``tests/test_models.py``) on the CPU, one
architecture of each family at reduced widths in float32, from the
reference's own ``train_state_init``; ``remat=True`` running
``torch.utils.checkpoint`` a layer (and a group of the hybrid) with
``remat=False``'s loss and gradients (the same ops recomputed: the loss
equal, gradients within 1e-6 of a leaf's max); the SSD's non-finite
gradient at full chunk size (ROADMAP Queue 3); the state a step returns
serving through ``DecoderLM``.  Setup and tolerances of the loss and
gradients: ``tests/test_torch_train.py``.

Tolerances of a step.  The loss and the global norm within ``rtol=1e-6``;
each moment leaf within ``1e-5`` of its largest magnitude after the first
step (observed: under 2e-6), ``1e-4`` after the third, whose gradients are
taken at parameters the first step moved apart as set out below.  A first Adam step moves a parameter by about ``lr * g / (|g| +
eps)``, ``±lr`` where ``|g|`` is well above ``eps``; where ``|g|`` is
within its rounding error of zero, that direction differs between the two
packages' sums, and the parameter by up to ``lr`` a step.  So every
parameter is held within ``lr`` a step, and all but one in a thousand of a
leaf (at least one) within ``1e-3 * lr`` a step (observed: at most 4 of
16,384 beyond it, none beyond ``0.05 * lr``).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train import step as jstep  # noqa: E402
from repro_torch.launch.mesh import make_mesh_auto  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.pytree import flatten_with_names, tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.sharding import P  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from test_torch_train import (  # noqa: E402
    FAMILIES,
    GRAD_REL,
    LOSS_CHUNK,
    assert_grads,
    jbatch,
    port_value_and_grad,
    setup,
    tbatch,
)

torch.set_num_threads(1)

LR, WARMUP, TOTAL = 1e-3, 2, 10  # the schedule ramps, peaks and decays in 3 steps
MOMENT_REL_LATER = 1e-4  # after the parameters the first step moved apart


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_and_three_steps_match_reference(family):
    jcfg, tcfg, js, ts, batch = setup(FAMILIES[family], seed=2)
    kw = dict(lr=LR, warmup=WARMUP, total_steps=TOTAL, loss_chunk=LOSS_CHUNK)
    jtrain = jax.jit(jstep.make_train_step(jcfg, **kw))
    ttrain = tstep.make_train_step(tcfg, **kw)
    names = [n for n, _ in flatten_with_names(ts.params)]
    before = [p.clone() for p in tree_leaves(ts.params)]
    moved = 0.0
    for step in range(1, 4):
        js, jm = jtrain(js, jbatch(batch))
        ts, tm = ttrain(ts, tbatch(batch))
        if step not in (1, 3):
            continue
        assert int(tm["step"]) == int(jm["step"]) == step
        assert tm["step"].dtype == torch.int32 and int(ts.opt.step) == step
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        rel = GRAD_REL if step == 1 else MOMENT_REL_LATER
        assert_grads(tree_leaves(ts.opt.m), jax.tree.leaves(js.opt.m), rel, names)
        assert_grads(tree_leaves(ts.opt.v), jax.tree.leaves(js.opt.v), rel, names)
        for n, got, want in zip(names, tree_leaves(ts.params), jax.tree.leaves(js.params)):
            d = np.abs(got.numpy() - np.asarray(want))
            assert d.max() <= LR * step, (n, float(d.max()))
            off = int((d > 1e-3 * LR * step).sum())
            assert off <= max(1, d.size // 1000), (n, off, d.size)
        moved = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(ts.params), before))
    assert moved > LR  # the parameters did move, by more than the tolerance


@pytest.mark.parametrize("family", ["dense-swa", "moe", "ssm", "hybrid", "vlm"])
def test_remat_runs_checkpoint_and_matches(family, monkeypatch):
    _, tcfg, _, ts, batch = setup(FAMILIES[family], seed=1)
    calls = []

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(ttf, "checkpoint", counted)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(ts.params)]
    on_loss = tstep.make_loss_fn(tcfg, remat=True, loss_chunk=LOSS_CHUNK)(
        tree_unflatten(ts.params, leaves), tbatch(batch))
    forward_calls = list(calls)  # the backward pass calls them again to recompute
    on_g = torch.autograd.grad(on_loss, leaves)
    calls.clear()
    L = tcfg.num_layers
    if tcfg.family == "hybrid":  # each group checkpointed, and its SSM layers inside
        expect = ["group_step"] + ["ssm_step"] * tcfg.attn_every
        assert forward_calls == expect * (L // tcfg.attn_every)
    else:
        assert forward_calls == ["ssm_step" if tcfg.family == "ssm" else "step"] * L
    off_loss, off_g = port_value_and_grad(tstep.make_loss_fn(tcfg, remat=False,
                                                             loss_chunk=LOSS_CHUNK),
                                          ts.params, tbatch(batch))
    assert calls == []
    assert float(on_loss.detach()) == float(off_loss)
    assert_grads(on_g, [g.numpy() for g in off_g], 1e-6)




def test_ssd_full_chunk_gradient_is_non_finite_in_both():
    """At init (``A_log = dt_bias = 0``) a step decays by about softplus(0),
    so ``exp(cum[t] - cum[s])`` above the diagonal of a 256-long chunk
    overflows; the masked ``where`` then back-propagates 0 * inf = NaN
    (``src/repro/models/ssm.py:59``).  The loss itself stays finite."""
    jcfg, tcfg, js, ts, _ = setup("mamba2-1.3b", ssm_chunk=256)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (1, 256)).astype(np.int32)
    batch = {"tokens": toks, "targets": toks}
    jl = jstep.make_loss_fn(jcfg, loss_chunk=64)
    want_loss, want_g = jax.jit(jax.value_and_grad(jl))(js.params, jbatch(batch))
    loss, grads = port_value_and_grad(tstep.make_loss_fn(tcfg, loss_chunk=64), ts.params,
                                      tbatch(batch))
    assert np.isfinite(float(want_loss)) and np.isfinite(float(loss))
    names = [n for n, _ in flatten_with_names(ts.params)]
    jbad = {n for n, g in zip(names, jax.tree.leaves(want_g)) if not np.isfinite(g).all()}
    tbad = {n for n, g in zip(names, grads) if not torch.isfinite(g).all()}
    assert jbad and jbad == tbad, (jbad, tbad)
    # a chunk of 8 on the same tokens keeps every gradient finite
    small = dataclasses.replace(tcfg, ssm_chunk=8)
    _, grads = port_value_and_grad(tstep.make_loss_fn(small, loss_chunk=64), ts.params,
                                   tbatch(batch))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_step_writes_in_place_and_serves():
    """The step returns the state's own tensors, updated; the trained
    parameters serve through ``DecoderLM``; ``act_spec`` is a
    ``PartitionSpec`` that constrains inside a mesh and changes nothing."""
    _, tcfg, _, ts, batch = setup("deepseek-moe-16b", seed=3)
    ids = [id(p) for p in tree_leaves(ts.params)]
    first = tree_leaves(ts.params)[0].clone()
    ts2, m = tstep.make_train_step(tcfg, loss_chunk=LOSS_CHUNK, warmup=1)(ts, tbatch(batch))
    assert [id(p) for p in tree_leaves(ts2.params)] == ids
    assert not torch.equal(tree_leaves(ts2.params)[0], first)
    assert all(not p.requires_grad for p in tree_leaves(ts2.params))
    lm = tmodel.DecoderLM(tcfg, ts2.params)
    toks = tbatch(batch)["tokens"]
    assert torch.equal(lm(toks), ttf.forward(ts2.params, tcfg, toks))
    with pytest.raises(TypeError, match="act_spec"):
        tstep.make_train_step(tcfg, act_spec=("data", None))
    act = P("data", None, None)
    with pytest.raises(RuntimeError, match="needs a mesh"):  # as with_sharding_constraint
        tstep.make_loss_fn(tcfg, act_spec=act, loss_chunk=LOSS_CHUNK)(ts2.params, tbatch(batch))
    with make_mesh_auto((2, 1), ("data", "model"), ["cpu"] * 2):
        loss = tstep.make_loss_fn(tcfg, act_spec=act, loss_chunk=LOSS_CHUNK)(ts2.params,
                                                                             tbatch(batch))
    assert torch.equal(loss, tstep.make_loss_fn(tcfg, loss_chunk=LOSS_CHUNK)(ts2.params,
                                                                              tbatch(batch)))
