"""The program's own spans in a traced window: the ``repro_torch.*``
profiler annotations of the port's ``repro_torch/trace.py``, on the clock
of the card's kernels, and among them the host-sync marks
(``repro_torch.sync.*``), each the host blocked on one device-to-host read.

A program without them (a tree older than its tracing module) leaves none
in the trace; every reader here then gives None.  Times are in the trace's
microseconds.
"""

from __future__ import annotations

PROGRAM = "repro_torch."
SYNC = PROGRAM + "sync."


def spans(trace, prefix: str = PROGRAM) -> list | None:
    """``(start, end)`` of every annotation named ``prefix*`` that starts
    inside the window, in start order; None when the window holds no
    program span at all."""
    if trace is None:
        return None
    w0, w1 = trace.window_us
    inside = [(n, s, s + d) for n, s, d in trace.host_ops
              if n.startswith(PROGRAM) and w0 <= s < w1]
    if not inside:
        return None
    return [(s, e) for n, s, e in inside if n.startswith(prefix)]


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_intervals(trace) -> list:
    """The window less the union of the device intervals (as ``idle_pct``
    reads it), as sorted disjoint intervals."""
    w0, w1 = trace.window_us
    edges = [w0] + [x for iv in trace.busy_intervals() for x in iv] + [w1]
    return [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]


def overlap(a, b) -> float:
    """The length of the intersection of two lists of sorted disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def per_batch(run, value):
    """``value`` over the traced steps, or None where either is missing."""
    if value is None or not run.traced_steps:
        return None
    return value / run.traced_steps
