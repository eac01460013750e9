"""The engine's host: the ms a traced batch leaves the card idle while the
host is inside the program, the window's idle gaps (the window less the
union of the device intervals) that the union of the program's
``repro_torch.*`` annotations covers, over the traced steps."""

from flixbench import program_spans


def read(run):
    if run.trace is None or not run.trace.device_ops:  # no card to leave idle
        return None
    inside = program_spans.spans(run.trace)
    if inside is None:
        return None
    us = program_spans.overlap(program_spans.idle_intervals(run.trace),
                               program_spans.merged(inside))
    return program_spans.per_batch(run, us * 1e-3)
