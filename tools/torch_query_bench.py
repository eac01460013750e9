#!/usr/bin/env python3
"""Time the port's point-query kernel on one CUDA card at chip_smoke.py's
phase-5 shapes, with the package under a given ``src`` directory (default:
this checkout's), so that two trees can be compared in one run:

    python3 tools/torch_query_bench.py [--src DIR] [--tag NAME]

It builds phase 5's state (2^24 unique uniform keys of a 2^27 space,
32-key nodes, 16 a bucket) from ``chip_smoke``'s ``Traffic`` and ``SEED``,
and three sorted batches: 2^24 all-hit queries (live keys drawn with
repeats), 2^24 all-miss queries (distinct absent keys) and 2^22 distinct
live keys, the batch that ``flix_delete``'s pre-filter queries in a delete
round.  Each batch's launch is held exactly against the plain version
(``flix_point_query_reference``); then the batches are timed by CUDA events
in turns (hit, miss, pre-filter, pre-filter, miss, hit) and printed beside
the bound of ``chip_smoke.query_bytes``.  When it builds the library it
prints ptxas's lines for ``flix_query_kernel``.  The inputs depend on the
seed alone, so every tree sees the same.  It needs a card and exits
non-zero without one.
"""
from tree_bench import build, open_tree

args, cs = open_tree("torch_query_bench")

import torch  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.kernels import flix_query as fq  # noqa: E402

REPS = 10  # launches per timed turn
build(args, fq, "flix_query_kernel")

dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(cs.SEED + 2)
traffic = cs.Traffic(cs.FULL_SPACE, cs.FULL_KEYS, gen)
state = core.build(*traffic.initial())
live = torch.nonzero(traffic.alive)[:, 0].to(torch.int32)
pick = torch.randint(0, live.numel(), (cs.FIG9_QUERIES,), generator=gen, device=dev)
hits = torch.sort(live[pick]).values
cand = torch.unique(traffic._rand_keys(2 * cs.FIG9_QUERIES))
cand = cand[~traffic.alive[cand.long()]]
pick = torch.randperm(cand.numel(), generator=gen, device=dev)[: cs.FIG9_QUERIES]
misses = torch.sort(cand[pick]).values
pick = torch.randperm(live.numel(), generator=gen, device=dev)[: cs.FIG9_ROUND]
prefilter = torch.sort(live[pick]).values
del live, cand, pick

planes = (state.keys, state.vals, state.node_max, state.mkba)
batches = {"all-hit": hits, "all-miss": misses, "pre-filter": prefilter}
bound = {}
for name, q in batches.items():
    want = fq.flix_point_query_reference(*planes, q)
    err = cs.max_abs_err([want], [fq.flix_point_query(*planes, q)])
    if err:
        raise AssertionError(f"{args.tag} {name}: the kernel differs from its plain "
                             f"version ({err})")
    bound[name] = cs.query_bytes(state, q, successor=False) / cs.HBM_BYTES_PER_S * 1e3
    del want
times = {name: [] for name in batches}
for name in list(batches) + list(batches)[::-1]:
    q = batches[name]
    times[name].append(cs.event_ms(lambda: fq.flix_point_query(*planes, q), REPS))
for name, q in batches.items():
    t = times[name]
    print(f"{args.tag:>8} {name} ({q.numel()} queries): {t[0]:.4f}, {t[1]:.4f} ms; "
          f"bound {bound[name]:.4f} ms ({min(t) / bound[name]:.2f}x)", flush=True)
