"""Operations completed in the window over the window's wall time (host
clock), in millions a second.  The window holds every step: making its
input, submitting it, waiting for its results."""


def read(run):
    return run.ops / run.window_s / 1e6
