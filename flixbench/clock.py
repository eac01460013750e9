"""Timing of steps and of the spans inside them.

On the card a time is the distance between two CUDA events on the stream.
The first is recorded once the card is idle, so it reads when the host
submits; the second after the last call, so it reads when the card has
finished.  Host gaps inside count, since both are stamps of the card's
clock.  Without a card (CPU tests only) the host's clock stands in; no
number it gives is reported as a device number.
"""

from __future__ import annotations

import contextlib
import time

import torch


class _HostEvent:
    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Clock:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        ev = torch.cuda.Event(enable_timing=True) if self.cuda else _HostEvent()
        ev.record()
        return ev

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


class Spans:
    """Named spans of the traced steps: a CUDA-event pair each (read as ms
    once the window closed) and a profiler annotation of the same name, so
    that the trace can say what the host was doing."""

    traced = True

    def __init__(self, clock: Clock):
        self.clock = clock
        self.pairs: dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        start = self.clock.mark()
        with torch.profiler.record_function(f"flixbench.{name}"):
            yield
        self.pairs.setdefault(name, []).append((start, self.clock.mark()))

    def ms(self) -> dict[str, list[float]]:
        self.clock.sync()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.pairs.items()}


class NoSpans:
    """What an untraced step gets: spans that record nothing."""

    traced = False

    @contextlib.contextmanager
    def span(self, name: str):
        yield
