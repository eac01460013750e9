"""``repro_torch.launch.steps.build_cell`` on a 4 × 2 mesh of ``"cpu"``
positions, at reduced widths in float32 (the reference's smoke,
``tests/test_distributed.py:160``, shrinks the shapes the same way):
musicgen-medium, and deepseek-moe-16b under ``moe_impl`` "gather" (the
``dispatch_spec`` checks), "a2a" and "auto", with capacity factor 8 so that
neither MoE path drops a row.

  * train: one step of the cell against the port's single-device
    ``train_step`` on the same state and batch (loss within 1e-3, the
    reference's bar, ``tests/test_distributed.py:155``; here also within
    1e-6 relative), and against the reference's jitted unsharded step on
    the reference's own ``train_state_init`` (``tests/test_torch_train_step.py``'s
    tolerances: loss and norm rtol 1e-6, moments 1e-5 of a leaf's max,
    parameters within the rate, all but one in a thousand within 1e-3 of
    it);
  * prefill: the cell's last-position logits against the single-device
    forward (1e-5 of max |logit|: the a2a path sums in another order);
  * decode: 4 steps, the cache donated and written in place, against
    ``decode_step`` on one device.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import model as jmodel  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import make_mesh_auto  # noqa: E402
from repro_torch.launch.steps import build_cell, layer_period  # noqa: E402
from repro_torch.models import config as tmc  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

CASES = {
    "musicgen": ("musicgen-medium", "gather"),
    "deepseek-gather": ("deepseek-moe-16b", "gather"),
    "deepseek-a2a": ("deepseek-moe-16b", "a2a"),
    "deepseek-auto": ("deepseek-moe-16b", "auto"),
}
SHAPES = {"train_4k": (8, 32), "prefill_32k": (8, 32), "decode_32k": (8, 16)}
OVER = dict(dtype="float32", moe_capacity_factor=8.0)
LOSS_CHUNK = 8
LR = 3e-4 / 100  # build_cell's step: lr 3e-4 after a 100-step warmup, at step 1


@pytest.fixture
def cell_for(monkeypatch):
    for name, (B, S) in SHAPES.items():
        monkeypatch.setitem(tmc.SHAPES, name, dict(tmc.SHAPES[name], global_batch=B,
                                                   seq_len=S))
    mesh = make_mesh_auto((4, 2), ("data", "model"), ["cpu"] * 8)

    def make(case, shape):
        arch, impl = CASES[case]
        monkeypatch.setitem(tconfigs.REGISTRY, arch, tconfigs.get(arch).reduced(**OVER))
        return build_cell(arch, shape, mesh, loss_chunk=LOSS_CHUNK, moe_impl=impl)

    return make


def single(cfg):
    return dataclasses.replace(cfg, moe_impl="gather", moe_mesh=None, dispatch_spec=None)


def tokens(rng, cfg, B, S):
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_train_cell_matches_single_device_and_reference(cell_for, case):
    cell = cell_for(case, "train_4k")
    arch, impl = CASES[case]
    want_impl = "a2a" if impl in ("a2a", "auto") and "deepseek" in arch else "gather"
    assert cell.cfg.moe_impl == want_impl
    assert (cell.cfg.dispatch_spec is not None) == (case == "deepseek-gather")
    jcfg = jmodel.get_config(arch).reduced(**OVER).padded(2)
    js = jstep.train_state_init(jax.random.PRNGKey(3), jcfg)
    ts = tstep.train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    rng = np.random.default_rng(3)
    B, S = SHAPES["train_4k"]
    batch = {"tokens": tokens(rng, cell.cfg, B, S), "targets": tokens(rng, cell.cfg, B, S)}

    ref, rm = tstep.make_train_step(single(cell.cfg), loss_chunk=LOSS_CHUNK)(
        tree_map(torch.clone, ts), batch)
    tsh.reset_collectives()
    got, gm = cell.jitted(ts, batch)
    counts = tsh.collective_counts()
    assert set(counts) >= {"all-gather", "reduce-scatter"}
    assert ("all-to-all" in counts) == (want_impl == "a2a")
    assert abs(float(gm["loss"]) - float(rm["loss"])) < 1e-3
    np.testing.assert_allclose(float(gm["loss"]), float(rm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(gm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-5)
    for g, w in zip(tree_leaves(got), tree_leaves(ref)):
        np.testing.assert_allclose(g.tensor().numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * max(float(w.abs().max()), 1e-30))

    js, jm = jax.jit(jstep.make_train_step(jcfg, loss_chunk=LOSS_CHUNK))(
        js, {k: np.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(gm["loss"]), float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(gm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    assert int(gm["step"]) == int(jm["step"]) == 1
    for tree, jtree, rel in ((got.opt.m, js.opt.m, 1e-5), (got.opt.v, js.opt.v, 1e-5)):
        for g, w in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.tensor().numpy(), w, rtol=0,
                                       atol=rel * max(float(np.abs(w).max()), 1e-30))
    for g, w in zip(tree_leaves(got.params), jax.tree.leaves(js.params)):
        d = np.abs(g.tensor().numpy() - np.asarray(w))
        assert d.max() <= LR and int((d > 1e-3 * LR).sum()) <= max(1, d.size // 1000)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_cell_matches_single_device(cell_for, case):
    cell = cell_for(case, "prefill_32k")
    params_abs, batch_abs = cell.abstract_args
    assert params_abs["embed"].dtype == torch.bfloat16  # inference cells: bfloat16 weights
    gen = torch.Generator()
    gen.manual_seed(5)
    params = ttf.init_params(gen, single(cell.cfg), torch.bfloat16, device="cpu")
    B, S = SHAPES["prefill_32k"]
    toks = tokens(np.random.default_rng(5), cell.cfg, B, S)
    got = cell.jitted(params, {"tokens": toks})
    assert got.spec == tsh.P() and got.shape == (B, cell.cfg.vocab_size)
    with torch.no_grad():
        h = ttf.forward_hidden(params, single(cell.cfg), toks)
        want = h[:, -1] @ ttf._head(params, single(cell.cfg), h.dtype)
    np.testing.assert_allclose(got.tensor().numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("case", ["musicgen", "deepseek-gather", "deepseek-a2a"])
def test_decode_cell_matches_single_device(cell_for, case):
    cell = cell_for(case, "decode_32k")
    cfg = single(cell.cfg)
    gen = torch.Generator()
    gen.manual_seed(6)
    params = ttf.init_params(gen, cfg, torch.bfloat16, device="cpu")
    B, L = SHAPES["decode_32k"]
    placed = tsh.place(ttf.init_cache(cfg, B, L, torch.bfloat16, device="cpu"),
                       cell.jitted.in_specs[1], cell.jitted.mesh)
    blocks = [dict(p.blocks) for p in tree_leaves(placed)]
    cache = ttf.init_cache(cfg, B, L, torch.bfloat16, device="cpu")
    toks = tokens(np.random.default_rng(6), cfg, 4, B)
    for t in range(4):
        logits, placed2 = cell.jitted(params, placed, toks[t])
        # donated: the same placed leaves, written in place
        assert all(a is b for a, b in zip(tree_leaves(placed2), tree_leaves(placed)))
        with torch.no_grad():
            want, cache = ttf.decode_step(params, cfg, cache, toks[t])
        np.testing.assert_allclose(logits.tensor().numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    for p, b in zip(tree_leaves(placed), blocks):
        assert all(p.blocks[k] is v for k, v in b.items())
    for p, w in zip(tree_leaves(placed), tree_leaves(cache)):
        assert torch.equal(p.tensor(), w)


def test_layer_period_and_depth_cut(cell_for):
    assert layer_period(tmodel.get_config("gemma3-12b")) == 6
    assert layer_period(tmodel.get_config("zamba2-2.7b")) == tmodel.get_config(
        "zamba2-2.7b").attn_every
    assert layer_period(tmodel.get_config("qwen2.5-32b")) == 1
    cell = cell_for("musicgen", "train_4k")
    assert cell.meta == {"kind": "train", "B": 8, "S": 32}
    state_abs, batch_abs = cell.abstract_args
    assert all(t.device.type == "meta" for t in tree_leaves((state_abs, batch_abs)))
