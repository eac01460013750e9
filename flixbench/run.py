"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 flixbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It exits with a code other than 0, and prints no result, when there is no
CUDA card (or fewer than the cell asks for), when the checkout does not
hold the program (``src/repro_torch``), or when ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` is loaded once the window has
closed.  The last line of standard output is the result; the last lines
of standard error the numbers the check compared, each beside its limit.
"""

import sys
import time

T0 = time.perf_counter()  # set-up runs from here

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # not this folder: its module names would shadow others

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}  # top-level names, compared whole


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "not read (nvidia-smi did not answer)"
    return f"card: {out}"


def main(argv=None, fault: str | None = None) -> int:
    args = parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program to run: {ROOT / 'src' / 'repro_torch'} is missing", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    with open(ROOT / "BENCHMARK.json") as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    from flixbench import harness

    if fault is not None:
        from flixbench import faults

        faults.install(fault)
    line, info = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  device="cuda", t0=T0)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"refused: {', '.join(loaded)} loaded in the run's process", file=sys.stderr)
        return 3
    print(card_line(), file=sys.stderr)
    print("checked: " + ", ".join(f"{k} {v}" for k, v in info.items()), file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
