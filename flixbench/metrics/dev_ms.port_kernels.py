"""The port's fused kernels (``kernels/flix_apply.py`` and the kernels it
launches from ``csrc/``): their device time a traced step, in ms, from the
profiler's trace."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return run.trace.device_s(port=True) * 1e3 / run.traced_steps
