"""Entry and sort (``core/ops.py`` ``make_ops`` + ``unsort``): ms a traced
batch, by CUDA events around the two calls."""


def read(run):
    ms = [a + b for a, b in zip(run.spans.get("make_ops", []), run.spans.get("unsort", []))]
    return sum(ms) / len(ms) if ms else None
