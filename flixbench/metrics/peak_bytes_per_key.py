"""The card's allocated peak over the window (reset at its start), over
the live keys at its end: the memory side of the paper's QTMF."""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / run.live_keys
