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
    assert {
        "ops",
        "flix_query",
        "flix_successor",
        "flix_insert",
        "flix_delete",
        "grouped_matmul",
        "moe_dispatch",
    } <= kernels


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    """``chip_smoke.py`` names no module of JAX or of ``repro`` in any import,
    its function-level ones included, and imports with JAX unimportable."""
    import ast

    script = SRC.parent / "chip_smoke.py"
    names = set()
    for node in ast.walk(ast.parse(script.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots and not roots & {"jax", "jaxlib", "repro"}, roots
    proc = subprocess.run(
        [sys.executable, "-c", 'import sys; sys.modules["jax"] = None; import chip_smoke'],
        capture_output=True,
        text=True,
        timeout=300,
        env={"PYTHONPATH": str(SRC.parent), "PATH": "/usr/bin:/bin"},
        cwd=str(SRC.parent),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
