"""The port stands alone: every ``repro_torch`` module imports with JAX made
unimportable, and none of them loads anything of the reference ``repro``."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"

CHILD = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_neither_jax_nor_the_reference():
    expected = 1 + sum(
        1 for _ in pkgutil.walk_packages([str(SRC / "repro_torch")], "repro_torch.")
    )
    proc = subprocess.run(
        [sys.executable, "-c", CHILD],
        capture_output=True,
        text=True,
        timeout=300,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
        cwd=str(SRC.parent),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.strip()) == expected >= 22
    kernels = {m.name for m in pkgutil.iter_modules([str(SRC / "repro_torch" / "kernels")])}
    assert {"ops", "flix_query", "flix_successor", "flix_insert", "flix_delete"} <= kernels
