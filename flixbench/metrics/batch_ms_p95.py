"""The 95th percentile (nearest rank) of the window's step latencies: from
the submission of a step's raw input to its results in submission order on
the card, by CUDA events."""

import math


def read(run):
    ms = sorted(run.step_ms)
    return ms[max(0, math.ceil(0.95 * len(ms)) - 1)]
