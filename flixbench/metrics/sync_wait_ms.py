"""The engine's host: the ms a traced batch spends blocked on the card at
its device-to-host reads, the summed durations of the program's
``repro_torch.sync.*`` annotations over the traced steps."""

from flixbench import program_spans


def read(run):
    if run.trace is None or not run.trace.device_ops:  # no card to wait on
        return None
    marks = program_spans.spans(run.trace, program_spans.SYNC)
    if marks is None:
        return None
    return program_spans.per_batch(run, sum(e - s for s, e in marks) * 1e-3)
