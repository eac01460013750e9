"""The benchmark of ``repro_torch``, the PyTorch and CUDA FliX port.

``python3 flixbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Everything that belongs to one configuration, traffic mix
or per-layer metric sits in a file of its own, found by its name:

  configs/<config>.json      sizes, guarantees, the system module to run
  traffic/<mix>.json         parameters read by ``generators/<generator>.py``
  systems/<system>.py        drives the program and checks it against
                             ``reference/``
  metrics/<metric>.py        ``read(run) -> float | None``

Nothing here imports ``jax`` or the JAX package; ``reference/`` imports
nothing of ``repro_torch`` either.
"""
