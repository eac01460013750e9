"""Spans and host-sync marks of the port's batch path, on the profiler's
clock.

``span(name)`` marks a part of the engine: while a ``torch.profiler`` is
recording it is a ``record_function("repro_torch." + name)``, so its host
interval lands in the trace beside the card's kernels, and an idle gap of
the card can be put down to the span the host was in.  Otherwise it is one
shared no-op context: no device work, no sync, no allocation.  Tracing is
on exactly when someone profiles; nothing else switches it.

``host_bool(t, site)`` and ``host_int(t, site)`` are the batch path's
explicit device-to-host reads: ``bool(t)`` and ``int(t)``, inside a span
``sync.<site>`` named after what the read decides.  A trace counts them by
that prefix, and their durations are the host waiting for the card.

``EVENTS``: a caller that installs a list here gets, from every span, a
``(name, start, end)`` triple of CUDA events recorded on the current
stream around it, for a split of one call on the card by events.  None:
no events and no cost.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
SYNC = "sync."

EVENTS: list | None = None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str):
    """The context of one engine span (see the module docstring)."""
    if EVENTS is not None:
        return _event_span(name, EVENTS)
    return _annotation(name)


def _annotation(name: str):
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return NO_SPAN


@contextlib.contextmanager
def _event_span(name: str, events: list):
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    with _annotation(name):
        yield
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    events.append((name, start, end))


def host_bool(t, site: str) -> bool:
    """``bool(t)``: a device-to-host read that decides ``site``."""
    with span(SYNC + site):
        return bool(t)


def host_int(t, site: str) -> int:
    """``int(t)``: a device-to-host read that decides ``site``."""
    with span(SYNC + site):
        return int(t)
