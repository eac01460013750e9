"""FliX on PyTorch and CUDA: the port of the JAX package ``repro``.

The port imports ``torch`` and ``numpy`` only — never ``jax`` and nothing
of ``repro``.  Its entry points run on the card unless the caller names
another device.
"""
