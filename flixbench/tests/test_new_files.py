"""A later cell, mix and metric are new files and new entries only: a copy
of the benchmark in a temporary directory gains a traffic mix, a cell on
it and a per-layer metric read in that cell, and runs them unchanged.
And the entry point refuses to run where it cannot measure."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from flixbench.tests.tiny import INDEX, MIX, run_tiny

ROOT = Path(__file__).resolve().parent.parent.parent


def copy_benchmark(tmp: Path, with_program: bool) -> Path:
    shutil.copytree(ROOT / "flixbench", tmp / "flixbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    if with_program:
        (tmp / "src").symlink_to(ROOT / "src")
    return tmp


def test_a_cell_a_mix_and_a_metric_added_as_files(tmp_path):
    root = copy_benchmark(tmp_path, with_program=True)
    mix = json.loads((root / "flixbench/traffic/ycsba-b14.json").read_text())
    mix.update(batch_ops=512, max_results=48, range_width=1 << 15,
               shares={"insert": 0.1, "delete": 0.1, "update": 0.1, "point_hit": 0.5,
                       "point_miss": 0.1, "successor": 0.05, "range": 0.05})
    (root / "flixbench/traffic/dummy-mix.json").write_text(json.dumps(mix))
    (root / "flixbench/metrics/dummy.steps.py").write_text(
        "def read(run):\n    return float(run.traced_steps)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "u26-dummy", "config": "flix-u26",
                               "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.steps", "unit": "steps", "better": "lower",
                               "source": "program_counter", "layer": "device",
                               "moves": "ops_per_s", "workloads": ["u26-dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    tiny = {"config": INDEX, "traffic": MIX}
    line, _ = run_tiny("u26-dummy", 9, trace=True, root=root, overrides=tiny)
    assert line["correct"]
    assert line["metrics"]["dummy.steps"]["value"] == MIX["trace_steps"]
    assert "dummy.steps" not in run_tiny("u26-mixed", 9, trace=True, root=root)[0]["metrics"]
    line, _ = run_tiny("u26-dummy", 9, root=root, overrides=tiny)
    assert set(line["metrics"]) == {"ops_per_s", "batch_ms_p95", "setup_s"}  # no card: no peak


def run_entry(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "flixbench/run.py", "--workload", "u26-mixed", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_the_entry_refuses_without_the_program(tmp_path):
    out = run_entry(copy_benchmark(tmp_path, with_program=False))
    assert out.returncode != 0 and out.stdout == ""
    assert "src/repro_torch" in out.stderr


def test_the_entry_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        return  # the card is there: nothing to refuse
    out = run_entry(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr
