"""The traced part of a window: ``torch.profiler`` over a fixed number of
steps, read from its exported trace.

Device activity is every kernel, copy and fill the card ran inside the
window annotation; a kernel of the port is one whose name carries a name
of the port's CUDA kernels (the ``flix_*`` and ``gmm_*`` entries of its
``csrc/``, launched through its ctypes library), everything else ran under
a torch operator.  Busy time is the union of the device intervals, idle
time the rest of the window; each idle gap is put down to the innermost
host operation or annotation that covers its middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
PORT_KERNEL = re.compile(r"\b(flix_\w*kernel|fence_\w*kernel|gmm_\w*kernel)\b")
WINDOW = "flixbench.window"
TOP = 10


@dataclasses.dataclass
class Trace:
    device_ops: list  # (name, start_us, dur_us), clipped to the window
    host_ops: list  # (name, start_us, dur_us)
    window_us: tuple  # (start, end)

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) * 1e-6

    def busy_intervals(self) -> list:
        merged = []
        for _, s, d in sorted(self.device_ops, key=lambda e: e[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], s + d)
            else:
                merged.append([s, s + d])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_s(self, port: bool) -> float:
        return sum(d for n, _, d in self.device_ops if is_port_kernel(n) == port) * 1e-6

    def breakdown(self) -> dict:
        by_op: dict[str, float] = {}
        for n, _, d in self.device_ops:
            by_op[short(n)] = by_op.get(short(n), 0.0) + d * 1e-6
        gaps: dict[str, float] = {}
        edges = [self.window_us[0]] + [x for iv in self.busy_intervals() for x in iv]
        edges.append(self.window_us[1])
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                what = self.host_at((s + e) / 2)
                gaps[what] = gaps.get(what, 0.0) + (e - s) * 1e-6
        top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}

    def host_at(self, t: float) -> str:
        """The innermost (latest started) host event covering ``t``; none
        means the harness's or the program's own Python."""
        i = bisect.bisect_right(self._starts, t)
        while i > 0:
            i -= 1
            n, s, d = self.host_ops[i]
            if s + d >= t:
                return "host: " + n
        return "host: python"

    def __post_init__(self):
        self.host_ops.sort(key=lambda e: e[1])
        self._starts = [s for _, s, _ in self.host_ops]


def is_port_kernel(name: str) -> bool:
    return bool(PORT_KERNEL.search(name))


def short(name: str) -> str:
    m = PORT_KERNEL.search(name)
    if m:
        return m.group(1)
    return name if len(name) <= 96 else name[:93] + "..."


class Tracer:
    """``start()`` before the first traced step, ``stop()`` after the last
    one has synchronized; ``read()`` after the window."""

    def __init__(self, device):
        self.acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            self.acts.append(torch.profiler.ProfilerActivity.CUDA)
        # the profiler's first start sets up its tracing (seconds on the
        # card): done here, in the set-up, and not in the window
        with torch.profiler.profile(activities=self.acts):
            torch.zeros(1, device=device).add_(1)
        self.prof = torch.profiler.profile(activities=self.acts)
        self.window = None

    def start(self):
        self.prof.__enter__()
        self.window = torch.profiler.record_function(WINDOW)
        self.window.__enter__()

    def stop(self):
        self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def read(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="flixbench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return parse(events)


def parse(events: list) -> Trace:
    """A ``Trace`` from chrome-trace events (``ph == "X"``)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    for e in spans:
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            s1, e1 = max(s, w0), min(s + d, w1)
            if e1 > s1:
                dev.append((e["name"], s1, e1 - s1))
        elif e.get("cat") in HOST_CATS and e["name"] != WINDOW:
            host.append((e["name"], s, d))
    return Trace(dev, host, (w0, w1))
