#!/usr/bin/env python3
"""Time the port's two stripe kernels on one CUDA card at chip_smoke.py's
phase-4 shapes, with the package under a given ``src`` directory (default:
this checkout's), so that two trees can be compared in one run:

    python3 tools/torch_stripe_bench.py [--src DIR] [--tag NAME] [--batches N]

It builds phase 4's state (2^24 unique uniform keys of a 2^27 space, 32-key
nodes, 16 a bucket) and its mixed batches of 2^20 ops from ``chip_smoke``'s
``Traffic`` and ``SEED``.  For each batch it holds the staged pass
(``flix_apply_staged_pass``) against the single-buffer pass
(``flix_apply_pass``), exactly, then times both kernels by CUDA events in
turns (single, staged, staged, single) and prints the times beside the
bound; the state then advances by the single-buffer engine.  When it builds
the library it prints ptxas's lines for the staged kernel.  It needs a card
and exits non-zero without one.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

ap = argparse.ArgumentParser()
ap.add_argument("--src", default=str(ROOT / "src"))
ap.add_argument("--tag", default="tree")
ap.add_argument("--batches", type=int, default=3)
ap.add_argument("--reps", type=int, default=5, help="launches per timed turn")
args = ap.parse_args()

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("torch_stripe_bench: no CUDA device available")
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

sys.path.insert(0, args.src)  # after chip_smoke, which puts this checkout's src first
from repro_torch import core  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flix_apply as fa  # noqa: E402

assert Path(fa.__file__).resolve().is_relative_to(Path(args.src).resolve()), fa.__file__
_, log = _build.build()
lines = log.splitlines()
for i, line in enumerate(lines):  # ptxas names the entry, then its resources
    if "Compiling entry function" in line and "flix_apply_staged" in line:
        for info in lines[i + 1 : i + 4]:
            if "registers" in info or "spill" in info:
                print(f"{args.tag:>8} ptxas: {info.strip()}", flush=True)

dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(cs.SEED + 1)
traffic = cs.Traffic(cs.FULL_SPACE, cs.FULL_KEYS, gen)
state = core.build(*traffic.initial())
cfg = core.ExecConfig(max_results=cs.FULL_MAX_RESULTS, impl="fused", pipeline="off")
for i in range(args.batches):
    ops, _ = core.make_ops(*traffic.mixed(cs.FULL_OPS))
    pass_args, r = fa.stripe_inputs(state, ops.tag, ops.key, ops.val)
    single = lambda: fa.flix_apply_pass(*pass_args)  # noqa: E731
    staged = lambda: fa.flix_apply_staged_pass(state.num_nodes, *pass_args)  # noqa: E731
    want, got = single(), staged()
    err = cs.max_abs_err(want, got)
    if err:
        raise AssertionError(f"{args.tag} batch {i}: the staged pass differs ({err})")
    bound = cs.stripe_pass_bytes(state, ops, r, want) / cs.HBM_BYTES_PER_S * 1e3
    del want, got
    times = {"single": [], "staged": []}
    for name, fn in (("single", single), ("staged", staged), ("staged", staged),
                     ("single", single)):
        times[name].append(cs.event_ms(fn, args.reps))
    print(f"{args.tag:>8} batch {i}: staged {times['staged'][0]:.4f}, "
          f"{times['staged'][1]:.4f} ms; single {times['single'][0]:.4f}, "
          f"{times['single'][1]:.4f} ms; bound {bound:.4f} ms "
          f"(staged {min(times['staged']) / bound:.2f}x)", flush=True)
    state = core.apply_ops_safe(state, ops, config=cfg)[0]
