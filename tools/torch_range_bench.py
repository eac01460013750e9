#!/usr/bin/env python3
"""Time the port's range kernels (``csrc/flix_range.cu``) on one CUDA card at
chip_smoke.py's phase-7 and phase-4 shapes, with the package under a given
``src`` directory (default: this checkout's), so that two trees can be
compared in one run:

    python3 tools/torch_range_bench.py [--src DIR] [--tag NAME]

It builds phase 7's state (2^24 unique uniform keys of a 2^27 space, 32-key
nodes, 16 a bucket) from ``chip_smoke``'s ``Traffic`` and ``SEED``, phase
7's sorted batch (2^16 ranges of ~16 keys and 2^12 of ~256, max_results =
2^20), and one phase-4 mixed batch of 2^20 ops (1% RANGE of width 64),
which the reference engine applies to the state; the batch's RANGE ops are
then ranked and gathered against the post-update state under max_results
= 65536.  It calls only entry points whose signatures every tree since the
port's first range kernels shares, so it needs no path for an older tree:

  * ``flix_range_count`` on phase 7's batch (without a mask);
  * ``flix_range_scatter`` on phase 7's slot ranks;
  * ``range_slots`` on phase 4's batch: the fused path's RANGE plumbing, its
    ranks by the count kernel under the RANGE mask (or, in a tree from
    before, by the torch ``node_rank`` pair over every op);
  * ``flix_apply_range_pass``, phase 4's gather;
  * ``flix_range`` end to end on phase 7's batch;
  * an empty kernel (``torch.cuda._sleep(0)``), the floor of a launch.

Each call's outputs are held exactly against their plain versions first
(``range_slots`` against the formulas on the unmasked plain count).  Then
every call is timed in turns (forward, then backward), as a call
(``chip_smoke.event_ms``) and queued behind a sleep of the card
(``chip_smoke.queued_ms``, device time alone), each kernel beside its bound
(``chip_smoke.range_count_bytes``, ``chip_smoke.gather_bytes``).  When it
builds the library it prints ptxas's lines for ``flix_range_count_kernel``
and ``flix_range_gather_kernel``.  The inputs depend on the seed alone, so
every tree sees the same.  It needs a card and exits non-zero without one.
"""
from tree_bench import build, open_tree

args, cs = open_tree("torch_range_bench")

import torch  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core.query import live_prefix, range_offsets, range_slot_ranks  # noqa: E402
from repro_torch.kernels import flix_apply as fa  # noqa: E402
from repro_torch.kernels import flix_range as fr  # noqa: E402

REPS = 10  # launches per timed turn

build(args, fr, "flix_range_count_kernel", "flix_range_gather_kernel")

dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(cs.SEED + 5)
traffic = cs.Traffic(cs.FULL_SPACE, cs.FULL_KEYS, gen)
state = core.build(*traffic.initial())
nb, npb, ns = state.geometry

# phase 7: range_mix's widths under a 2^20 budget
gap = cs.FULL_SPACE // cs.FULL_KEYS
los, his = [], []
for n, span in ((cs.RANGE_NARROW, 16), (cs.RANGE_WIDE, 256)):
    lo = torch.randint(0, cs.FULL_SPACE - span * gap, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    los.append(lo)
    his.append(lo + span * gap)
lo, order = torch.sort(torch.cat(los), stable=True)
hi = torch.cat(his)[order]
mr7 = cs.RANGE_MAX_RESULTS
pref = live_prefix(state.node_count)
meta7 = (state.keys, state.node_count, state.node_max, state.mkba, pref, lo, hi)
every = torch.ones(lo.shape, dtype=torch.bool, device=dev)
want7 = fr.flix_range_count_reference(*meta7)
start, _, total, _ = range_offsets(want7[1], every, mr7)
g7 = range_slot_ranks(want7[0], start, total, mr7)
gargs7 = (g7, pref, state.node_count, state.keys, state.vals)

# phase 4: one mixed batch through the reference engine, then its RANGE ops
ops, _ = core.make_ops(*traffic.mixed(cs.FULL_OPS))
mr4 = cs.FULL_MAX_RESULTS
cfg = core.ExecConfig(impl="reference", max_results=mr4)
new = core.apply_ops(state, ops, config=cfg)[0]
is_range = ops.tag == core.OP_RANGE
pref4 = live_prefix(new.node_count)
meta4 = (new.keys, new.node_count, new.node_max, new.mkba, pref4, ops.key, ops.val)
rl4, full4 = fr.flix_range_count_reference(*meta4)
start4, emit4, total4, trunc4 = range_offsets(full4, is_range, mr4)
g4 = range_slot_ranks(rl4, start4, total4, mr4)
gargs4 = (g4, pref4, new.node_count, new.keys, new.vals)

calls = {
    "count, phase 7": lambda: fr.flix_range_count(*meta7),
    "scatter, phase 7": lambda: fr.flix_range_scatter(*gargs7),
    "range_slots, phase 4": lambda: fa.range_slots(new, is_range, ops.key, ops.val, mr4),
    "gather, phase 4": lambda: fa.flix_apply_range_pass(*gargs4),
    "flix_range, phase 7": lambda: fr.flix_range(state.keys, state.vals, state.mkba, lo, hi,
                                                 max_results=mr7),
    "empty kernel": lambda: torch.cuda._sleep(0),
}
held = {
    "count, phase 7": want7,
    "scatter, phase 7": fr.flix_range_gather_reference(*gargs7),
    "range_slots, phase 4": (g4, pref4, start4, emit4, trunc4),
    "gather, phase 4": fr.flix_range_gather_reference(*gargs4),
    "flix_range, phase 7": core.dense_range_scan(state, every, lo, hi, max_results=mr7),
}
for name, want in held.items():
    err = cs.max_abs_err(want, calls[name]())
    if err:
        raise AssertionError(f"{args.tag} {name}: differs from its plain version ({err})")
del held
bound = {
    "count, phase 7": cs.range_count_bytes(state, lo, hi),
    "scatter, phase 7": cs.gather_bytes(g7, pref, npb),
    "gather, phase 4": cs.gather_bytes(g4, pref4, npb),
}
bound = {k: b / cs.HBM_BYTES_PER_S * 1e3 for k, b in bound.items()}
sizes = {"count, phase 7": f"{lo.numel()} ops", "scatter, phase 7": f"{mr7} slots",
         "range_slots, phase 4": f"{int(is_range.sum())} RANGE of {ops.key.numel()} ops",
         "gather, phase 4": f"{mr4} slots", "flix_range, phase 7": f"{lo.numel()} ops",
         "empty kernel": ""}
order = list(calls)
times = {name: [] for name in order}
queued = {name: [] for name in order}
for name in order + order[::-1]:
    times[name].append(cs.event_ms(calls[name], REPS))
    queued[name].append(cs.queued_ms(calls[name], REPS))
for name in order:
    t, d = times[name], queued[name]
    line = (f"{args.tag:>8} {name} ({sizes[name]}): {t[0]:.4f}, {t[1]:.4f} ms a call; "
            f"queued {d[0]:.5f}, {d[1]:.5f} ms")
    if name in bound:
        line += f"; bound {bound[name]:.5f} ms ({min(d) / bound[name]:.2f}x)"
    print(line, flush=True)
