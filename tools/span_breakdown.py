#!/usr/bin/env python3
"""Run one benchmark cell traced and split its traced window by the
program's own spans (``repro_torch/trace.py``) on the card:

    python3 tools/span_breakdown.py --workload <cell> --seed <n> [--seconds 30]

It runs ``flixbench/run.py`` with ``--trace 1`` (its result line printed
as usual) and then prints, for each ``repro_torch.*`` span name, its calls,
host ms, self host ms (its time less the program spans inside it) and the
ms of idle card under its self time, each a traced batch, and the idle
time outside every program span.  The idle ms of all spans sum to the
run's ``idle_ms.engine``.  Host times under the profiler carry its own cost
of every torch op and annotation, so they are upper bounds.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def self_intervals(spans: list) -> list:
    """``(name, start, end, own)`` for ``spans`` given as ``(name, start,
    end)``: ``own`` the parts of its interval no span nested in it covers."""
    spans = sorted(spans, key=lambda x: (x[1], -x[2]))
    children = defaultdict(list)
    stack: list[int] = []
    for k, (_, s, e) in enumerate(spans):
        while stack and spans[stack[-1]][2] <= s:
            stack.pop()
        if stack:
            children[stack[-1]].append(k)
        stack.append(k)
    out = []
    for k, (name, s, e) in enumerate(spans):
        own, cur = [], s
        for c in children[k]:
            if spans[c][1] > cur:
                own.append((cur, spans[c][1]))
            cur = max(cur, spans[c][2])
        if e > cur:
            own.append((cur, e))
        out.append((name, s, e, own))
    return out


def breakdown(trace, steps: int) -> tuple[dict, float]:
    """``({span: [calls, ms, self ms, idle ms]}, idle ms outside every
    program span)``, each a traced batch, of a ``devtrace.Trace``."""
    from flixbench import program_spans

    w0, w1 = trace.window_us
    spans = [(n.removeprefix(program_spans.PROGRAM), s, s + d) for n, s, d in trace.host_ops
             if n.startswith(program_spans.PROGRAM) and w0 <= s < w1]
    idle = program_spans.idle_intervals(trace)
    rows: dict = defaultdict(lambda: [0.0, 0.0, 0.0, 0.0])
    for name, s, e, own in self_intervals(spans):
        r = rows[name]
        r[0] += 1
        r[1] += (e - s) * 1e-3
        r[2] += sum(b - a for a, b in own) * 1e-3
        r[3] += program_spans.overlap(idle, own) * 1e-3
    outside = sum(e - s for s, e in idle) * 1e-3 - sum(r[3] for r in rows.values())
    return {k: [x / steps for x in v] for k, v in rows.items()}, outside / steps


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from flixbench import devtrace, harness, run

    traces = []
    read = devtrace.Tracer.read

    def keep(self):
        traces.append(read(self))
        return traces[-1]

    devtrace.Tracer.read = keep
    args = run.parse_args(argv)
    rc = run.main([*(argv or sys.argv[1:]), "--trace", "1"])
    if rc or not traces:
        return rc or 1
    steps = harness.Cell.load(args.workload).traffic["trace_steps"]
    rows, outside = breakdown(traces[0], steps)
    print(f"{'span':36s} {'calls':>6s} {'ms':>8s} {'self ms':>8s} {'idle ms':>8s}  (a batch)")
    for name, (calls, ms, own, idle) in sorted(rows.items(), key=lambda kv: -kv[1][2]):
        print(f"{name:36s} {calls:6.2f} {ms:8.4f} {own:8.4f} {idle:8.4f}")
    print(f"{'idle outside the program':36s} {'':6s} {'':8s} {'':8s} {outside:8.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
