"""The engine's host: the device-to-host reads a traced batch makes, each a
``repro_torch.sync.*`` annotation of the program (``trace.host_bool`` /
``trace.host_int``), counted over the traced steps."""

from flixbench import program_spans


def read(run):
    marks = program_spans.spans(run.trace, program_spans.SYNC)
    return program_spans.per_batch(run, None if marks is None else float(len(marks)))
