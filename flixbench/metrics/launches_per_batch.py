"""Kernel entry points (``repro_torch.kernels.LAUNCHES``): the port's
kernel launches a traced step, from its own counters."""


def read(run):
    if run.launches is None or not run.traced_steps:
        return None
    return run.launches / run.traced_steps
