"""The check on the CPU, each cell at a tiny size: sound runs come out
correct, the control and every fault a cell can have come out not correct.

The harness runs as on the card, its look for a card skipped, with the
fault planted under the functions the run calls (``flixbench.faults``).
The read-only cell has no state to leave unchanged.
"""

from __future__ import annotations

import pytest

from flixbench.tests.tiny import CELLS, run_tiny

FAULTS = ("control", "unchanged_state", "half_batch", "altered_answer")
CASES = [(c, f) for c in CELLS for f in FAULTS
         if not (c == "u26-ycsbc-zipf" and f == "unchanged_state")]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_sound_runs_are_correct(cell, seed):
    line, info = run_tiny(cell, seed)
    assert line["correct"], line["checks"]
    assert info["checked_steps"] == 3 and line["attempted"] == 8 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", CASES)
def test_the_control_and_each_fault_fail(cell, fault):
    line, _ = run_tiny(cell, 17, fault=fault)
    assert not line["correct"], line["checks"]
    assert line["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_per_layer_metrics(cell):
    line, _ = run_tiny(cell, 5, trace=True)
    assert line["correct"]
    # on the CPU no device op runs: only the spans and counters read
    assert line["metrics"]["launches_per_batch"]["value"] == 0.0
    if cell.startswith("u26"):
        assert line["metrics"]["entry_ms"]["value"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
