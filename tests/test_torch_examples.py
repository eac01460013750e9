"""The port's examples against the reference's: ``examples/quickstart_torch.py``
walks ``examples/quickstart.py`` through ``repro_torch`` on the same random
stream and must print the same lines (on the CPU here)."""

import contextlib
import io
import runpy
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _stdout_of(monkeypatch, script: str, *args: str) -> list[str]:
    path = str(EXAMPLES / script)
    monkeypatch.setattr(sys, "argv", [path, *args])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(path, run_name="__main__")
    return out.getvalue().splitlines()


def test_quickstart_prints_the_reference_lines(monkeypatch):
    want = _stdout_of(monkeypatch, "quickstart.py")
    got = _stdout_of(monkeypatch, "quickstart_torch.py", "--device", "cpu")
    assert len(want) == 11 and want[0].startswith("built: ")
    assert got == want
