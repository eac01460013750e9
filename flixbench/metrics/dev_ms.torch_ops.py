"""Plain-torch passes (routing, sorts, gathers, the reference engine's
reads, copies and fills): the device time a traced step of
everything but the port's own kernels, in ms, from the profiler's trace."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return run.trace.device_s(port=False) * 1e3 / run.traced_steps
