"""Drivers (port of ``repro/launch``): ``serve``, batched decode of a
registry model with the FliX KV-page control plane.  The training driver
and the dry-run / mesh / roofline tools are not ported."""
