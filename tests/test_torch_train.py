"""The port's training loss (``repro_torch.train``) against the JAX package
on the CPU, at reduced widths in float32, one architecture of each family
(dense with SWA, local:global, moe, ssm, hybrid, vlm with its prefix,
audio), from the reference's own ``train_state_init`` carried across by
``train_state_from_numpy``:

  * ``make_loss_fn``'s loss and gradients against ``jax.value_and_grad``
    of the reference's (``jax.jit``, as ``tests/test_models.py``), the
    gradients named and ordered as the reference's pytree;
  * ``chunked_lm_loss`` with and without a remainder chunk, against the
    reference's and one unchunked cross entropy, gradients included.

``remat``, the SSD's non-finite gradient at full chunk size and one and
three ``make_train_step`` steps: ``tests/test_torch_train_step.py``, which
imports the setup below.

Tolerances.  float32 on both sides, summed in other orders: the loss
within ``rtol=1e-6``; each gradient leaf within ``1e-5`` of its largest
magnitude (observed: under 2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import model as jmodel  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.layers import softmax_cross_entropy_sharded  # noqa: E402
from repro_torch.pytree import flatten_with_names, tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

FAMILIES = {
    "dense-swa": "h2o-danube-3-4b",
    "local-global": "gemma3-12b",
    "moe": "deepseek-moe-16b",
    "ssm": "mamba2-1.3b",
    "hybrid": "zamba2-2.7b",
    "vlm": "paligemma-3b",
    "audio": "musicgen-medium",
}
LOSS_RTOL = 1e-6
GRAD_REL = 1e-5
B, S, LOSS_CHUNK = 2, 32, 8  # 31 shifted positions: 3 chunks and a tail of 7


def setup(arch, seed=0, **overrides):
    """Both configs, the reference's TrainState, the port's copy of it, and
    one numpy batch (targets apart from the tokens, a random prefix)."""
    overrides.setdefault("dtype", "float32")
    jcfg = jmodel.get_config(arch).reduced(**overrides)
    tcfg = tmodel.get_config(arch).reduced(**overrides)
    js = jstep.train_state_init(jax.random.PRNGKey(seed), jcfg)
    ts = tstep.train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    rng = np.random.default_rng(seed)
    text = S - (jcfg.frontend_len if jcfg.frontend else 0)
    batch = {
        "tokens": rng.integers(0, jcfg.vocab_size, (B, text)).astype(np.int32),
        "targets": rng.integers(0, jcfg.vocab_size, (B, text)).astype(np.int32),
    }
    if jcfg.frontend:
        batch["prefix_embeds"] = (rng.normal(size=(B, jcfg.frontend_len, jcfg.d_model))
                                  * 0.02).astype(np.float32)
    return jcfg, tcfg, js, ts, batch


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_value_and_grad(loss_fn, params, batch):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def assert_grads(got, want, rel, names=None):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        scale = max(float(np.max(np.abs(w))), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=rel * scale,
                                   err_msg=names[i] if names else str(i))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference(family):
    jcfg, tcfg, js, ts, batch = setup(FAMILIES[family])
    jl = jstep.make_loss_fn(jcfg, loss_chunk=LOSS_CHUNK)
    want_loss, want_g = jax.jit(jax.value_and_grad(jl))(js.params, jbatch(batch))
    tl = tstep.make_loss_fn(tcfg, loss_chunk=LOSS_CHUNK)
    loss, grads = port_value_and_grad(tl, ts.params, tbatch(batch))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    names = [n for n, _ in flatten_with_names(ts.params)]
    assert names == [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(js.params)[0]]
    assert_grads(grads, jax.tree.leaves(want_g), GRAD_REL, names)


@pytest.mark.parametrize("S_,chunk", [(23, 8), (23, 23), (23, 64), (24, 8), (23, 5)])
def test_chunked_lm_loss_with_remainder(S_, chunk):
    rng = np.random.default_rng(S_ * 100 + chunk)
    D, V = 16, 50
    x = rng.normal(size=(2, S_, D)).astype(np.float32)
    head = (rng.normal(size=(D, V)) * 0.5).astype(np.float32)
    tg = rng.integers(0, V, (2, S_)).astype(np.int32)
    mask = (rng.random((2, S_)) < 0.8).astype(np.float32)

    def jloss(x, head):
        return jstep.chunked_lm_loss(x, head, jnp.asarray(tg), jnp.asarray(mask), chunk=chunk)

    want, (wgx, wgh) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                                 jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    got = tstep.chunked_lm_loss(tx, th, torch.from_numpy(tg), torch.from_numpy(mask),
                                chunk=chunk)
    gx, gh = torch.autograd.grad(got, (tx, th))
    whole = softmax_cross_entropy_sharded(tx.detach() @ th.detach(), torch.from_numpy(tg),
                                          torch.from_numpy(mask))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got.detach()), float(whole), rtol=LOSS_RTOL)
    assert_grads([gx, gh], [wgx, wgh], GRAD_REL)
