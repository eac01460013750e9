"""Each cell at a size the CPU runs in a second, for the tests: the
cell's own configuration and mix with their scale cut, and the harness
driven on the CPU (the card's look skipped), or on the card."""

from __future__ import annotations

import time

from flixbench import faults, harness

# keys above 2^24, where float32 rounds them (the control), as at full size
INDEX = {"build_keys": 4096, "key_space_bits": 26}
MIX = {"warmup_steps": 2, "trace_steps": 3, "sample_steps": 3}
TINY = {
    "u26-mixed": {"config": INDEX, "traffic": {**MIX, "batch_ops": 1024}},
    "u26-mixed-small": {"config": INDEX, "traffic": {**MIX, "batch_ops": 256}},
    "u26-ycsbc-zipf": {"config": INDEX, "traffic": {**MIX, "batch_ops": 1024, "max_results": 1}},
}
CELLS = tuple(TINY)


def run_tiny(cell: str, seed: int, *, trace: bool = False, fault: str | None = None,
             steps: int = 8, root=harness.ROOT, overrides: dict | None = None,
             device: str = "cpu"):
    """``(line, info)`` of a tiny run, with ``fault`` planted."""
    undo = faults.install(fault) if fault else None
    try:
        return harness.run_cell(cell, seed, 1e9, trace, device=device, t0=time.perf_counter(),
                                root=root, overrides=overrides or TINY[cell], max_steps=steps)
    finally:
        if undo:
            undo()
