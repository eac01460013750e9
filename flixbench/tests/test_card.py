"""Each cell at its tiny size on the card, through the port's kernels:
sound runs correct, the control not.  Skips without a card; run on the
card with ``PYTHONPATH=src python -m pytest -q -m cuda flixbench/tests``."""

from __future__ import annotations

import pytest
import torch

from flixbench.tests.tiny import CELLS, run_tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cells_on_the_card(card, cell):
    line, _ = run_tiny(cell, 2**35 + 3, device=card, trace=True)
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
    assert not run_tiny(cell, 2**35 + 3, device=card, fault="control")[0]["correct"]
