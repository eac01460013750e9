"""The port's optimizer stack (``repro_torch.optim``) against the JAX
package on the CPU, on the same numpy inputs drawn from a seed:

  * ``adamw_update`` over 3 steps under ``cosine_schedule`` (and a constant
    rate), parameters, both moments and the step after each;
  * ``clip_by_global_norm`` on both sides of the clip, and its in-place
    form ``clip_by_global_norm_``;
  * ``cosine_schedule`` in warmup, at its end, mid-decay, at and past the
    last step;
  * ``quantize_grads`` and ``decompress_add`` over 3 rounds of error
    feedback.

Tolerances.  Both sides compute in float32, elementwise, in the same order;
XLA and torch may still round a ``pow``, ``sqrt`` or fused multiply-add
differently, so values are held to 2 ulp (``rtol=2.4e-7``) relative to the
leaf's largest magnitude.  The int8 codes must be equal, the scales and the
carried error within 1 ulp of the leaf's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as joptim  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.pytree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

ULP = float(np.finfo(np.float32).eps)  # 2^-23


def _tree(rng, scale=1.0):
    def f(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"w": f(8, 5), "layers": {"a": f(3, 4, 2), "b": f(7)}, "s": f(1)}


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, ulps=2):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        g = g.detach().float().numpy()
        w = np.asarray(w, dtype=np.float32)
        tol = ulps * ULP * max(float(np.max(np.abs(w))), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("lr", ["schedule", 1e-3])
def test_adamw_three_steps(lr):
    rng = np.random.default_rng(0)
    params = _tree(rng, 0.02)
    jp, tp = jax.tree.map(jnp.asarray, params), _t(params)
    js, ts = joptim.adamw_init(jp), toptim.adamw_init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    jlr = joptim.cosine_schedule(1e-2, 2, 5) if lr == "schedule" else lr
    tlr = toptim.cosine_schedule(1e-2, 2, 5) if lr == "schedule" else lr
    for step in range(1, 4):
        grads = _tree(rng)
        jp, js = joptim.adamw_update(jp, jax.tree.map(jnp.asarray, grads), js, jlr)
        tp, ts = toptim.adamw_update(tp, _t(grads), ts, tlr)
        assert int(ts.step) == int(js.step) == step
        _close(ts.m, js.m)
        _close(ts.v, js.v)
        _close(tp, jp)


@pytest.mark.parametrize("max_norm", [1e3, 0.5])
def test_clip_by_global_norm(max_norm):
    grads = _tree(np.random.default_rng(1))
    jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), max_norm)
    tg, tn = toptim.clip_by_global_norm(_t(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=2 * ULP)
    assert (float(jn) > max_norm) == (max_norm == 0.5)  # both sides of the clip
    _close(tg, jg)
    if max_norm > float(jn):
        _close(tg, grads, ulps=0)  # unclipped leaves come back as they were
    inplace = _t(grads)  # the train step's form writes the same values in place
    ids = [id(g) for g in tree_leaves(inplace)]
    assert float(toptim.clip_by_global_norm_(inplace, max_norm)) == float(tn)
    assert [id(g) for g in tree_leaves(inplace)] == ids
    _close(inplace, tg, ulps=0)


def test_cosine_schedule():
    jlr = joptim.cosine_schedule(3e-4, 10, 110)
    tlr = toptim.cosine_schedule(3e-4, 10, 110)
    for step in (0, 1, 9, 10, 11, 60, 109, 110, 200):
        want = float(jlr(jnp.asarray(step, jnp.int32)))
        got = tlr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=2 * ULP, atol=0)


def test_quantize_grads_and_decompress_add():
    rng = np.random.default_rng(2)
    params = _tree(rng)
    js = joptim.compress_init(jax.tree.map(jnp.asarray, params))
    ts = toptim.compress_init(_t(params))
    jacc = jax.tree.map(lambda a: jnp.zeros_like(a), params)
    tacc = toptim.compress_init(_t(params)).error
    for _ in range(3):  # the error carried from one round into the next
        grads = _tree(rng, 0.1)
        jq, jsc, js = joptim.quantize_grads(jax.tree.map(jnp.asarray, grads), js)
        tq, tsc, ts = toptim.quantize_grads(_t(grads), ts)
        for a, b in zip(tree_leaves(tq), jax.tree.leaves(jq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(tsc), jax.tree.leaves(jsc)):
            np.testing.assert_allclose(float(a), float(b), rtol=ULP, atol=0)
        for e, we, s in zip(tree_leaves(ts.error), jax.tree.leaves(js.error),
                            jax.tree.leaves(jsc)):
            np.testing.assert_allclose(e.numpy(), np.asarray(we), rtol=0,
                                       atol=ULP * float(s) * 127)
        jacc = joptim.decompress_add(jacc, jq, jsc)
        tacc = toptim.decompress_add(tacc, tq, tsc)
        _close(tacc, jacc)
