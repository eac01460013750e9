"""The port's training driver (``repro_torch.launch.train``) on the CPU at
musicgen-medium ``--reduced``: it trains, checkpoints and resumes (the
port-side counterpart of ``tests/test_system.py::
test_train_driver_resume_cli``, whose reference driver fails under JAX 0.9,
see ROADMAP Queue 3); a crash injected after the step-10 checkpoint and a
rerun with the same arguments end exactly where an uninterrupted run ends;
``--mesh 2x1`` trains at 1 x 1 on the host, as the reference's rule
makes a mesh larger than the devices ``(n, 1)``, and its checkpoint, with
the state's PartitionSpecs, resumes; without ``--device`` it needs a card.
"""

import contextlib
import io
import json
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.pytree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

BASE = ["--arch", "musicgen-medium", "--reduced", "--batch", "4", "--seq", "64",
        "--ckpt-every", "10", "--device", "cpu"]


def run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = train.main(argv)
    return state, buf.getvalue().splitlines()


def test_train_checkpoint_resume(tmp_path):
    argv = BASE + ["--ckpt-dir", str(tmp_path)]
    _, lines = run(argv + ["--steps", "12"])
    assert lines[-1] == "done"
    logged = [line for line in lines if line.startswith("step ")]
    assert [int(line.split()[1]) for line in logged] == [0, 10, 11]
    for line in logged:
        assert re.fullmatch(r"step +\d+ loss \d+\.\d{4} \(\d+\.\ds\)", line), line
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000010",
                                                              "step_00000012"]
    state, lines = run(argv + ["--steps", "16"])
    assert lines[0] == "resumed from step 12" and lines[-1] == "done"
    assert [int(line.split()[1]) for line in lines if line.startswith("step ")] == [15]
    # the reference's loop draws batch 12 before it stops, so the final
    # checkpoint resumes at data step 13: batch 12 is never trained on and
    # the rerun takes 3 steps (ROADMAP Queue 3)
    assert int(state.opt.step) == 15
    _, _, extra = CheckpointManager(tmp_path).restore_latest(state, device="cpu")
    assert extra == {"data_step": 17}


class _Crash(Exception):
    pass


def test_crash_after_checkpoint_then_rerun_ends_exactly(tmp_path, monkeypatch):
    steps = ["--steps", "16"]
    want, _ = run(BASE + steps + ["--ckpt-dir", str(tmp_path / "whole")])
    save = CheckpointManager.save

    def crash_after_step_10(self, step, tree, **kw):
        save(self, step, tree, **kw)
        if step == 10:
            self.wait()  # the checkpoint is committed, then the process dies
            raise _Crash

    argv = BASE + steps + ["--ckpt-dir", str(tmp_path / "crashed")]
    with monkeypatch.context() as m:
        m.setattr(CheckpointManager, "save", crash_after_step_10)
        with pytest.raises(_Crash):
            run(argv)
    got, lines = run(argv)
    assert lines[0] == "resumed from step 10"
    assert int(got.opt.step) == int(want.opt.step) == 16
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)


def test_mesh_other_than_1x1_is_refused(tmp_path):
    """Once refused, ``--mesh 2x1`` now runs: on the host's one device it
    collapses to 1 x 1 (``make_host_mesh``), trains exactly as the default
    mesh does, writes the state's specs into its checkpoints and resumes."""
    argv = BASE + ["--mesh", "2x1", "--ckpt-dir", str(tmp_path)]
    got, lines = run(argv + ["--steps", "12"])
    want, want_lines = run(BASE + ["--steps", "12"])
    assert [line.split("(")[0] for line in lines] == [
        line.split("(")[0] for line in want_lines]
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)
    manifest = json.loads((tmp_path / "step_00000012" / "manifest.json").read_text())
    assert manifest["specs"][:2] == ["PartitionSpec('model', None)", "PartitionSpec(None,)"]
    state, lines = run(argv + ["--steps", "16"])
    assert lines[0] == "resumed from step 12" and lines[-1] == "done"
    assert int(state.opt.step) == 15


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(BASE[:-2] + ["--steps", "1"])


def test_reference_driver_fails_under_its_own_mesh():
    """Why ``tests/test_system.py::test_train_driver_resume_cli`` fails: the
    reference driver dies at the embedding gather under its 1x1 mesh
    (``src/repro/models/transformer.py:224``) with JAX 0.9's
    ``ShardingTypeError``, on the arguments the port's driver trains with
    above (ROADMAP Queue 3)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", *BASE[:-2], "--steps", "2"],
        capture_output=True, text=True, timeout=300, cwd=str(repo),
        env={"PYTHONPATH": f"{repo}/src", "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")},
    )
    assert proc.returncode != 0
    assert "ShardingTypeError" in proc.stderr and "gather" in proc.stderr
