"""The engine (``apply_ops_safe``, whichever executor runs): the least time
for the bytes the traced batches need (``roofline.apply_bytes``) at the
card's published HBM rate, over the calls' time by CUDA events, in %."""

from flixbench.roofline import peak


def read(run):
    rate = peak(run.device_name, "hbm_bytes_per_s")
    ms = run.spans.get("apply", [])
    need = run.extra.get("apply_bytes", [])
    if rate is None or not ms or len(ms) != len(need):
        return None
    return 100.0 * sum(need) / rate / (sum(ms) * 1e-3)
