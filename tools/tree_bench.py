"""The shared start of the ``torch_*_bench.py`` tools, which time a kernel of
the port on one CUDA card for the package under a given ``src`` directory
(default: this checkout's), so that two trees can be compared in one run.

A tool calls ``open_tree`` first, then imports the port's modules (they come
from ``--src``), then calls ``build`` with the module it times.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def open_tree(tool, *options):
    """Parse ``--src DIR``, ``--tag NAME`` and the tool's own ``options``
    (``(flag, keywords)`` pairs for ``add_argument``); exit non-zero without
    a card; import ``chip_smoke`` and put ``DIR`` ahead of this checkout's
    ``src``.  Returns ``(args, chip_smoke)``."""
    ap = argparse.ArgumentParser(prog=tool)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    for flag, keywords in options:
        ap.add_argument(flag, **keywords)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit(f"{tool}: no CUDA device available")
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, args.src)  # after chip_smoke, which puts this checkout's src first
    return args, chip_smoke


def build(args, module, *entries):
    """Check that ``module`` came from ``--src``, build the kernel library,
    and print ptxas's register and spill lines for the entry functions whose
    name holds one of ``entries`` (when it builds)."""
    assert Path(module.__file__).resolve().is_relative_to(Path(args.src).resolve()), \
        module.__file__
    from repro_torch.kernels import _build

    _, log = _build.build()
    lines = log.splitlines() if entries else []
    for i, line in enumerate(lines):  # ptxas names the entry, then its resources
        if "Compiling entry function" in line and any(e in line for e in entries):
            print(f"{args.tag:>8} {line.strip()}", flush=True)
            for info in lines[i + 1 : i + 4]:
                if "registers" in info or "spill" in info:
                    print(f"{args.tag:>8} ptxas: {info.strip()}", flush=True)
