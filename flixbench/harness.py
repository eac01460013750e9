"""One run of one cell: set-up, warm-up, the measured window, the check.

The cell's entry in ``BENCHMARK.json`` names its configuration and its
traffic mix.  ``configs/<config>.json`` names the system module
(``systems/<system>.py``), ``traffic/<mix>.json`` the generator
(``generators/<generator>.py``); every metric is ``metrics/<name>.py``.
So a later cell, mix or metric is new files and new entries only.

A closed loop: one caller makes its next step's input on the card, waits
for the card to be idle, submits it and waits for its results.  The window's time covers all of
that; a step's latency runs from the submission to its results, by CUDA
events.  In a traced run the first ``trace_steps`` steps of the window run
under the profiler.  After the window the system frees its state and is
checked against the plain reference on a sample of the window's steps
drawn from the seed, on every step's stats and on its final contents.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from flixbench.clock import Clock, NoSpans, Spans
from flixbench.devtrace import Tracer

ROOT = Path(__file__).resolve().parent.parent


def load_module(path: Path):
    """A benchmark file loaded by its path (metric files have dots in
    their names), under a name made from its folder and file."""
    name = "flixbench_" + "_".join((path.parent.name, path.stem)).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    bench: dict
    config: dict
    traffic: dict
    root: Path

    @classmethod
    def load(cls, name: str, root: Path = ROOT, overrides: dict | None = None) -> "Cell":
        bench = read_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        conf = next(c for c in bench["configs"] if c["name"] == w["config"])
        config = read_json(root / conf["file"])
        traffic = read_json(root / "flixbench" / "traffic" / f"{w['traffic']}.json")
        for part, over in (overrides or {}).items():
            {"config": config, "traffic": traffic}[part].update(over)
        return cls(name, bench, config, traffic, root)

    def metrics(self, trace: bool) -> list[dict]:
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[kind] if self.name in m.get("workloads", [self.name])]

    def module(self, folder: str, name: str):
        return load_module(self.root / "flixbench" / folder / f"{name}.py")


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    device_name: str
    setup_s: float
    window_s: float = 0.0
    steps: int = 0
    ops: int = 0
    step_ms: list = dataclasses.field(default_factory=list)
    peak_bytes: int | None = None
    live_keys: int = 0
    trace: object = None  # flixbench.devtrace.Trace of the traced steps
    traced_steps: int = 0
    spans: dict = dataclasses.field(default_factory=dict)  # name -> ms per traced step
    launches: int | None = None  # the port's kernel launches over the traced steps
    extra: dict = dataclasses.field(default_factory=dict)  # a system's own readings


class Reservoir:
    """A uniform sample of ``k`` steps of a window of unknown length,
    drawn from the seed (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 0x5A3])

    def offer(self, i: int) -> int | None:
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None


def launch_count() -> int:
    from repro_torch.kernels import LAUNCHES

    return sum(LAUNCHES.values())


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device, t0: float,
             root: Path = ROOT, overrides: dict | None = None,
             max_steps: int | None = None) -> tuple[dict, dict]:
    """The result line's fields (the check's ``checks`` last) and what the
    check counted beside them."""
    cell = Cell.load(name, root, overrides)
    dev = torch.device(device)
    clock = Clock(dev)
    gen = cell.module("generators", cell.traffic["generator"]).make(
        cell.traffic, cell.config, seed, dev)
    system = cell.module("systems", cell.config["system"]).make(
        cell.config, cell.traffic, gen, seed, dev)
    system.setup(cell.traffic["trace_steps"] if trace else 0)
    for _ in range(cell.traffic["warmup_steps"]):
        system.record(system.submit(system.next_input(), NoSpans()))
    tracer = Tracer(dev) if trace else None
    clock.sync()
    name_of_device = torch.cuda.get_device_name(dev) if clock.cuda else str(dev)
    run = Run(name_of_device, setup_s=time.perf_counter() - t0)

    reservoir = Reservoir(cell.traffic["sample_steps"], seed)
    n_trace = cell.traffic["trace_steps"] if trace else 0
    spans = Spans(clock)
    marks = []

    def finish_trace():
        tracer.stop()
        run.launches, run.traced_steps = launch_count() - launches0, run.steps

    if clock.cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    while True:
        traced = run.steps < n_trace
        if traced and run.steps == 0:
            tracer.start()
            launches0 = launch_count()
        step_spans = spans if traced else NoSpans()
        with step_spans.span("next_input"):
            inp = system.next_input()
        clock.sync()
        a = clock.mark()
        out = system.submit(inp, step_spans)
        b = clock.mark()
        clock.sync()
        marks.append((a, b))
        system.record(out)
        slot = reservoir.offer(run.steps)
        if slot is not None:
            system.keep(slot, inp, out)
        run.steps += 1
        run.ops += inp.n_ops
        if traced and run.steps == n_trace:
            finish_trace()
        if time.perf_counter() - start >= seconds or run.steps == max_steps:
            break
    run.window_s = time.perf_counter() - start
    if tracer is not None and not run.traced_steps:  # the window closed first
        finish_trace()
    run.step_ms = [x.elapsed_time(y) for x, y in marks]
    if clock.cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    run.live_keys = system.live_keys()
    if trace:
        run.spans = spans.ms()
        run.trace = tracer.read()
        run.extra = system.trace_readings()

    metrics = {}
    for m in cell.metrics(trace):
        value = cell.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t_check = time.perf_counter()
    checks, failed, info = system.check()
    info["check_s"] = round(time.perf_counter() - t_check, 3)
    line = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": run.steps,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if clock.cuda else dev.type, "kind": name_of_device,
                   "count": 1, "memory_peak_bytes": run.peak_bytes},
    }
    if trace:
        line["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return line, info
