"""The device: the share of the traced window in which no kernel, copy or
fill ran (the window less the union of the device intervals), in %."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
