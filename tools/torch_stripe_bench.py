#!/usr/bin/env python3
"""Time the port's two stripe kernels on one CUDA card at chip_smoke.py's
phase-4 shapes, with the package under a given ``src`` directory (default:
this checkout's), so that two trees can be compared in one run:

    python3 tools/torch_stripe_bench.py [--src DIR] [--tag NAME]

It builds phase 4's state (2^24 unique uniform keys of a 2^27 space, 32-key
nodes, 16 a bucket) and three of its mixed batches of 2^20 ops from
``chip_smoke``'s ``Traffic`` and ``SEED``.  For each batch it holds the
staged pass (``flix_apply_staged_pass``) against the single-buffer pass
(``flix_apply_pass``), exactly, then times both by CUDA events in turns
(single, staged, staged, single) and prints the times beside each kernel's
bound (``chip_smoke.stripe_pass_bytes``); the state then advances by the
single-buffer engine.  Before them: both kernels on an empty batch (every
bucket on the keep path) and on 2^18 fresh inserts (about a fifth of the
buckets on the update path), and the time PyTorch takes to write both
planes whole in place (the write floor no stripe pass can beat).  After
them: one more mixed batch on the same keys built at 16-key nodes, 32 a
bucket (the same stripe size; the single-buffer kernel compiles only 32-key
nodes, 16 a bucket, in as constants, so this runs its generic
instantiation).  When it builds the library it prints ptxas's lines for
both kernels.  It needs a card and exits non-zero without one.
"""
from tree_bench import build, open_tree

args, cs = open_tree("torch_stripe_bench")

import torch  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.kernels import flix_apply as fa  # noqa: E402

BATCHES, REPS = 3, 5  # batches timed; launches per timed turn
build(args, fa, "flix_apply_kernel", "flix_apply_staged_kernel")

dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(cs.SEED + 1)
traffic = cs.Traffic(cs.FULL_SPACE, cs.FULL_KEYS, gen)
state = core.build(*traffic.initial())
cfg = core.ExecConfig(max_results=cs.FULL_MAX_RESULTS, impl="fused", pipeline="off")


def warm_ms(fn):
    """event_ms after one untimed call (the kernel's first load)."""
    fn()
    return cs.event_ms(fn, REPS)


# writing both planes whole in place, one PyTorch call each
out_k, out_v = torch.empty_like(state.keys), torch.empty_like(state.vals)
fill_ms = warm_ms(lambda: (out_k.fill_(core.EMPTY), out_v.zero_()))
del out_k, out_v
print(f"{args.tag:>8} writing both planes by fill_ / zero_: {fill_ms:.4f} ms "
      f"({(state.keys.nbytes + state.vals.nbytes) / fill_ms / 1e9:.4f} TB/s)", flush=True)

# an empty batch (every bucket takes the keep path), and 2^18 fresh inserts
# (about a fifth of the buckets take the update path, the rest keep)
none = torch.zeros(0, dtype=torch.int32, device=dev)
fresh = torch.sort(traffic.perm[cs.FULL_KEYS: cs.FULL_KEYS + (1 << 18)]).values
for name, cols in (("empty batch", (none, none, none)),
                   ("2^18 inserts", (torch.full_like(fresh, core.OP_INSERT), fresh, fresh))):
    ops, _ = core.make_ops(*cols)
    pass_args, _ = fa.stripe_inputs(state, ops.tag, ops.key, ops.val)
    err = cs.max_abs_err(fa.flix_apply_pass(*pass_args),
                         fa.flix_apply_staged_pass(state.num_nodes, *pass_args))
    if err:
        raise AssertionError(f"{args.tag} {name}: the staged pass differs ({err})")
    shown = [f"single {warm_ms(lambda: fa.flix_apply_pass(*pass_args)):.4f}",
             f"staged {warm_ms(lambda: fa.flix_apply_staged_pass(state.num_nodes, *pass_args)):.4f}"]
    print(f"{args.tag:>8} {name}: {', '.join(shown)} ms", flush=True)
del fresh


def timed_batch(state, label):
    """Hold the staged pass to the single-buffer pass on one mixed batch,
    time both in turns, and print the times beside their bounds."""
    ops, _ = core.make_ops(*traffic.mixed(cs.FULL_OPS))
    pass_args, r = fa.stripe_inputs(state, ops.tag, ops.key, ops.val)
    fns = {"single": lambda: fa.flix_apply_pass(*pass_args),
           "staged": lambda: fa.flix_apply_staged_pass(state.num_nodes, *pass_args)}
    want = fns["single"]()
    err = cs.max_abs_err(want, fns["staged"]())
    if err:
        raise AssertionError(f"{args.tag} {label}: staged differs from single ({err})")
    bound = {k: cs.stripe_pass_bytes(state, ops, r, want, staged=k == "staged")
             / cs.HBM_BYTES_PER_S * 1e3 for k in fns}
    del want
    times = {k: [] for k in fns}
    for name in ("single", "staged", "staged", "single"):
        times[name].append(cs.event_ms(fns[name], REPS))
    shown = ", ".join(f"{k} {times[k][0]:.4f}, {times[k][1]:.4f} ms" for k in fns)
    print(f"{args.tag:>8} {label}: {shown}; bounds single {bound['single']:.4f}, staged "
          f"{bound['staged']:.4f} ms (single {min(times['single']) / bound['single']:.2f}x, "
          f"staged {min(times['staged']) / bound['staged']:.2f}x)", flush=True)
    return ops


for i in range(BATCHES):
    ops = timed_batch(state, f"batch {i}")
    state = core.apply_ops_safe(state, ops, config=cfg)[0]

# the same keys at another geometry of the same stripe size: the generic
# instantiation of the single-buffer kernel
del state
state = core.build(*traffic.initial(), node_size=16, nodes_per_bucket=32)
timed_batch(state, "ns=16 npb=32 batch")
