#!/usr/bin/env python3
"""Time the port's two stripe kernels on one CUDA card at chip_smoke.py's
phase-4 shapes, with the package under a given ``src`` directory (default:
this checkout's), so that two trees can be compared in one run:

    python3 tools/torch_stripe_bench.py [--src DIR] [--tag NAME]

It builds phase 4's state (2^24 unique uniform keys of a 2^27 space, 32-key
nodes, 16 a bucket) and three of its mixed batches of 2^20 ops from
``chip_smoke``'s ``Traffic`` and ``SEED``.  For each batch it holds the staged pass
(``flix_apply_staged_pass``) against the single-buffer pass
(``flix_apply_pass``), exactly, then times both kernels by CUDA events in
turns (single, staged, staged, single) and prints the times beside the
bound; the state then advances by the single-buffer engine.  When it builds
the library it prints ptxas's lines for the staged kernel.  It needs a card
and exits non-zero without one.
"""
from tree_bench import build, open_tree

args, cs = open_tree("torch_stripe_bench")

import torch  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.kernels import flix_apply as fa  # noqa: E402

BATCHES, REPS = 3, 5  # batches timed; launches per timed turn
build(args, fa, "flix_apply_staged")

dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(cs.SEED + 1)
traffic = cs.Traffic(cs.FULL_SPACE, cs.FULL_KEYS, gen)
state = core.build(*traffic.initial())
cfg = core.ExecConfig(max_results=cs.FULL_MAX_RESULTS, impl="fused", pipeline="off")
for i in range(BATCHES):
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
        times[name].append(cs.event_ms(fn, REPS))
    print(f"{args.tag:>8} batch {i}: staged {times['staged'][0]:.4f}, "
          f"{times['staged'][1]:.4f} ms; single {times['single'][0]:.4f}, "
          f"{times['single'][1]:.4f} ms; bound {bound:.4f} ms "
          f"(staged {min(times['staged']) / bound:.2f}x)", flush=True)
    state = core.apply_ops_safe(state, ops, config=cfg)[0]
