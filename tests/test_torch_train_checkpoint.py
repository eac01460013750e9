"""The port's pytree checkpoints (``repro_torch.checkpoint.save_pytree``,
``restore_pytree``, ``CheckpointManager``) on the CPU:

  * the cases of ``tests/test_checkpoint.py`` against the port's manager:
    round trip, structure mismatch, atomic commit, async save with
    retention and resume, dotted targets, ``tmp_sibling``, newest-wins,
    ``wait`` before restore, a failed save leaving no scratch;
  * the manifest of a reduced deepseek ``TrainState``: the reference's
    ``_flatten_with_names`` names, in its order, and its ``extra``;
  * a checkpoint written by either package restored in the other, float32
    and bfloat16 leaves bit for bit;
  * the aliasing trap: an async save of CPU tensors, then an in-place
    optimizer step before the writer runs, restores the saved step.
"""

import json
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    restore_pytree,
    save_pytree,
    tmp_sibling,
)
from repro_torch.checkpoint import manager as manager_mod  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.pytree import flatten_with_names, tree_leaves, tree_map  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((5,), dtype=torch.int32)},
    }


def _equal(got, want):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_save_restore_roundtrip(tmp_path, tree):
    save_pytree(tmp_path / "ck", tree, extra={"data_step": 7})
    restored, extra = restore_pytree(tmp_path / "ck", tree, device="cpu")
    assert extra["data_step"] == 7
    _equal(restored, tree)


def test_structure_mismatch_rejected(tmp_path, tree):
    save_pytree(tmp_path / "ck", tree)
    with pytest.raises(AssertionError):
        restore_pytree(tmp_path / "ck", {"wrong": tree["a"]}, device="cpu")


def test_atomic_commit_no_partial_state(tmp_path, tree):
    """A leftover .tmp dir (simulated crash) must not shadow a good ckpt."""
    save_pytree(tmp_path / "ck", tree)
    (tmp_path / "ck2.tmp").mkdir()
    (tmp_path / "ck2.tmp" / "garbage").write_text("crash")
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() is None  # tmp dirs are never listed
    restored, _ = restore_pytree(tmp_path / "ck", tree, device="cpu")
    _equal(restored, tree)


def test_manager_async_save_retention_resume(tmp_path, tree):
    mgr = CheckpointManager(tmp_path / "run", keep=2)
    for step in (10, 20, 30, 40):
        mgr.save(step, tree_map(lambda a: a + step, tree), extra={"data_step": step})
        mgr.wait()
    assert mgr.latest_step() == 40
    assert len(sorted((tmp_path / "run").glob("step_*"))) == 2  # retention
    step, restored, extra = mgr.restore_latest(tree, device="cpu")
    assert step == 40 and extra["data_step"] == 40
    _equal(restored, tree_map(lambda a: a + 40, tree))


def test_dotted_path_save_roundtrip(tmp_path, tree):
    for name in ("step_0.5k", "step_1.5k", "ck.v2.final"):
        save_pytree(tmp_path / name, tree, extra={"name": name})
        _, extra = restore_pytree(tmp_path / name, tree, device="cpu")
        assert extra["name"] == name
    assert [p.name for p in tmp_path.iterdir() if ".tmp" in p.name] == []


def test_tmp_sibling_unique_and_name_preserving(tmp_path):
    a = tmp_sibling(tmp_path / "step_0.5k")
    b = tmp_sibling(tmp_path / "step_0.5k")
    c = tmp_sibling(tmp_path / "step_0.9k")
    assert a != b and len({a, b, c}) == 3
    for t in (a, b, c):
        assert t.parent == tmp_path
        assert t.name.startswith("step_0.") and ".tmp-" in t.name


def test_retention_keeps_exactly_newest(tmp_path, tree):
    mgr = CheckpointManager(tmp_path / "run", keep=3)
    for step in range(1, 8):
        mgr.save(step, tree)
        mgr.wait()
    kept = sorted(p.name for p in (tmp_path / "run").glob("step_*"))
    assert kept == [f"step_{s:08d}" for s in (5, 6, 7)]
    assert mgr.latest_step() == 7


class _GatedSave:
    """A save_pytree stand-in the worker thread blocks on."""

    def __init__(self):
        self.started = threading.Event()
        self.release = threading.Event()
        self.saved = []

    def __call__(self, path, tree, *, extra=None):
        self.started.set()
        assert self.release.wait(timeout=30)
        save_pytree(path, tree, extra=extra)
        self.saved.append(path.name)


def test_async_queue_newest_wins(tmp_path, tree, monkeypatch):
    gate = _GatedSave()
    monkeypatch.setattr(manager_mod, "save_pytree", gate)
    mgr = CheckpointManager(tmp_path / "run", keep=10)
    mgr.save(1, tree)
    assert gate.started.wait(timeout=30)
    for step in (2, 3, 4):  # each supersedes the pending one
        mgr.save(step, tree)
    gate.release.set()
    mgr.wait()
    assert gate.saved == ["step_00000001", "step_00000004"]
    assert mgr.latest_step() == 4


def test_wait_drains_before_restore(tmp_path, tree, monkeypatch):
    gate = _GatedSave()
    monkeypatch.setattr(manager_mod, "save_pytree", gate)
    mgr = CheckpointManager(tmp_path / "run")
    mgr.save(5, tree, extra={"data_step": 5})
    assert gate.started.wait(timeout=30)
    assert mgr.latest_step() is None  # still uncommitted
    gate.release.set()
    mgr.wait()
    step, _, extra = mgr.restore_latest(tree, device="cpu")
    assert step == 5 and extra["data_step"] == 5


def test_failed_save_leaves_no_scratch(tmp_path):
    class Boom:
        def __array__(self, *a, **k):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        save_pytree(tmp_path / "ck", {"a": Boom()})
    assert list(tmp_path.iterdir()) == []


def _states():
    jcfg = jmodel.get_config("deepseek-moe-16b").reduced(dtype="float32")
    js = jstep.train_state_init(jax.random.PRNGKey(4), jcfg)
    return js, tstep.train_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")


def test_train_state_manifest_matches_reference(tmp_path):
    js, ts = _states()
    jnames, _, _ = jmanager._flatten_with_names(js)
    names = [n for n, _ in flatten_with_names(ts)]
    assert names == jnames and len(names) == 49
    assert names[0] == ".params['embed']" and names[-1] == ".opt.v['lm_head']"
    step = dict(flatten_with_names(ts))[".opt.step"]
    assert step.dtype == torch.int32 and step.shape == ()
    jmanager.save_pytree(tmp_path / "ref", js, extra={"data_step": 3})
    save_pytree(tmp_path / "port", ts, extra={"data_step": 3})
    manifests = [json.loads((tmp_path / d / "manifest.json").read_text()) for d in ("ref", "port")]
    assert manifests[0] == manifests[1]


def _bf16_trees():
    rng = np.random.default_rng(6)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    jt = {"w": jnp.asarray(w).astype(jnp.bfloat16), "n": jnp.asarray(w[0]), "k": jnp.arange(3)}
    tt = {"w": torch.from_numpy(w).to(torch.bfloat16), "n": torch.from_numpy(w[0]),
          "k": torch.arange(3, dtype=torch.int32)}
    return jt, tt


def _bits(a) -> bytes:
    return np.asarray(a).tobytes() if not isinstance(a, torch.Tensor) else (
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy().tobytes()


def test_checkpoints_cross_packages_both_ways(tmp_path):
    js, ts = _states()
    jt, tt = _bf16_trees()
    # the reference writes, the port restores
    jmanager.save_pytree(tmp_path / "j", js, extra={"data_step": 9})
    jmanager.save_pytree(tmp_path / "jb", jt)
    got, extra = restore_pytree(tmp_path / "j", ts, device="cpu")
    assert extra == {"data_step": 9}
    for g, w in zip(tree_leaves(got), jax.tree.leaves(js)):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    got, _ = restore_pytree(tmp_path / "jb", tt, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    for k in jt:
        assert _bits(got[k]) == _bits(jt[k].view(jnp.int16) if k == "w" else jt[k])
    # the port writes, the reference restores
    save_pytree(tmp_path / "t", ts, extra={"data_step": 9})
    save_pytree(tmp_path / "tb", tt)
    got, extra = jmanager.restore_pytree(tmp_path / "t", js)
    assert extra == {"data_step": 9}
    for g, w in zip(jax.tree.leaves(got), tree_leaves(ts)):
        assert np.asarray(g).tobytes() == w.numpy().tobytes()
    got, _ = jmanager.restore_pytree(tmp_path / "tb", jt)
    w = np.asarray(got["w"]).view(ml_dtypes.bfloat16)  # the reference's own |V2 leaf
    assert np.array_equal(w, np.asarray(jt["w"]))
    # both packages write the same arrays
    for a, b in (("j", "t"), ("jb", "tb")):
        ja, ta = np.load(tmp_path / a / "arrays.npz"), np.load(tmp_path / b / "arrays.npz")
        assert sorted(ja.files) == sorted(ta.files)
        for f in ja.files:
            assert ja[f].dtype == ta[f].dtype and ja[f].tobytes() == ta[f].tobytes()


def test_async_save_copies_before_an_in_place_step(tmp_path, monkeypatch):
    """On the CPU ``t.numpy()`` shares memory with ``t``: a save that held
    such views while the optimizer wrote the next step in place would
    commit the next step's values."""
    _, ts = _states()
    gate = _GatedSave()
    monkeypatch.setattr(manager_mod, "save_pytree", gate)
    mgr = CheckpointManager(tmp_path / "run")
    saved = [p.clone() for p in tree_leaves(ts)]
    mgr.save(1, ts)  # blocks in the worker until released
    assert gate.started.wait(timeout=30)
    rng = np.random.default_rng(8)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 256, (2, 16)).astype(np.int32))}
    batch["targets"] = batch["tokens"]
    ts2, _ = tstep.make_train_step(tmodel.get_config("deepseek-moe-16b").reduced(),
                                   loss_chunk=8, warmup=1)(ts, batch)
    assert not torch.equal(tree_leaves(ts2.params)[0], saved[0])  # written in place
    gate.release.set()
    mgr.wait()
    _, restored, _ = mgr.restore_latest(ts, device="cpu")
    for g, w in zip(tree_leaves(restored), saved):
        assert torch.equal(g, w)
