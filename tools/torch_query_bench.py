#!/usr/bin/env python3
"""Time the port's point-query and successor kernels, and the fence-row
kernel, on one CUDA card at chip_smoke.py's phase-5 shapes, with the
package under a given ``src`` directory (default: this checkout's), so that
two trees can be compared in one run:

    python3 tools/torch_query_bench.py [--src DIR] [--tag NAME]

It builds phase 5's state (2^24 unique uniform keys of a 2^27 space,
32-key nodes, 16 a bucket) from ``chip_smoke``'s ``Traffic`` and ``SEED``,
and four sorted batches: 2^24 all-hit queries (live keys drawn with
repeats), 2^24 all-miss queries (distinct absent keys), 2^22 distinct live
keys (the batch that ``flix_delete``'s pre-filter queries in a delete
round) and 2^22 uniform successor queries (phase 5's successor batch).
Each point-query launch is held exactly against its plain version
(``flix_point_query_reference``), the successor kernel against
``flix_successor_reference`` and the fence rows against ``next_rows``.
The successor launch runs on fence rows made beforehand; the fence rows
are timed alone, as the tree makes them (by ``fence_rows`` where the tree
has it, else by the torch passes), once with the non-empty test from
``node_max`` (``flix_successor``'s) and once from ``num_nodes`` (the fused
apply's).  Every launch is timed by CUDA events in turns (hit, miss,
pre-filter, successor, both fence-row forms, then the same backwards),
each as a call (``chip_smoke.event_ms``: the card waits while the host
issues the wrappers' launches) and queued (``chip_smoke.queued_ms``: the
launches queued behind a sleep of the card, device time alone), and
printed beside its bound (``chip_smoke.query_bytes``,
``chip_smoke.fence_bytes``).  Then two yardsticks of the fence rows'
random reads: one torch gather of the 2^20 head keys, and one of the head
keys and head values; and, where the tree has the fence-row kernel, the
device time of each of its launches from a ``torch.profiler`` trace.
When it builds the library it prints ptxas's lines for
``flix_query_kernel``, ``flix_successor_kernel`` and the fence-row
kernels.  The inputs depend on the seed alone, so every tree sees the same.
It needs a card and exits non-zero without one.
"""
import re

from tree_bench import build, open_tree

args, cs = open_tree("torch_query_bench")

import torch  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.kernels import flix_query as fq  # noqa: E402
from repro_torch.kernels import flix_successor as fs  # noqa: E402

REPS = 10  # launches per timed turn


def short(key):
    """A kernel's name from the profiler's signature of it."""
    m = re.search(r"(\w+)\(", key)
    return m.group(1) if m else key


build(args, fq, "flix_query_kernel", "flix_successor_kernel", "fence_")

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
succ = torch.sort(traffic._rand_keys(cs.FIG9_SUCC)).values
del live, cand, pick

planes = (state.keys, state.vals, state.node_max, state.mkba)
nn = state.num_nodes
if hasattr(fs, "fence_rows"):  # the fence rows as the tree makes them: its kernel
    rows = lambda: fs.fence_rows(*planes[:3])  # noqa: E731
    rows_nn = lambda: fs.fence_rows(*planes[:2], num_nodes=nn)  # noqa: E731
else:  # or the torch passes, flix_successor's and the fused apply's
    from repro_torch.core.query import _successor_fence_rows

    def rows():
        return fs.next_rows(*planes[:3])

    def rows_nn():
        smin_pad, sidx_pad = _successor_fence_rows(state.keys, nn)
        return smin_pad[1:], state.vals[sidx_pad[1:].long(), 0, 0]

nxk, nxv = rows()
held = {"fence rows": (fs.next_rows(*planes[:3]), (nxk, nxv)),
        "fence rows, num_nodes": (fs.next_rows(*planes[:3]), rows_nn())}
calls = {"fence rows": rows, "fence rows, num_nodes": rows_nn,
         "successor": lambda: fs.successor_pass(*planes, nxk, nxv, succ)}
bound = {"fence rows": cs.fence_bytes(state, num_nodes=False),
         "fence rows, num_nodes": cs.fence_bytes(state, num_nodes=True),
         "successor": cs.query_bytes(state, succ, successor=True)}
bound = {k: b / cs.HBM_BYTES_PER_S * 1e3 for k, b in bound.items()}
held["successor"] = (fs.flix_successor_reference(*planes, succ), calls["successor"]())
for name, q in (("all-hit", hits), ("all-miss", misses), ("pre-filter", prefilter)):
    held[name] = ([fq.flix_point_query_reference(*planes, q)], [fq.flix_point_query(*planes, q)])
    calls[name] = lambda q=q: fq.flix_point_query(*planes, q)
    bound[name] = cs.query_bytes(state, q, successor=False) / cs.HBM_BYTES_PER_S * 1e3
for name, (want, got) in held.items():
    err = cs.max_abs_err(want, got)
    if err:
        raise AssertionError(f"{args.tag} {name}: the kernel differs from its plain "
                             f"version ({err})")
del held
order = ["all-hit", "all-miss", "pre-filter", "successor", "fence rows",
         "fence rows, num_nodes"]
times = {name: [] for name in order}
queued = {name: [] for name in order}
for name in order + order[::-1]:
    times[name].append(cs.event_ms(calls[name], REPS))
    queued[name].append(cs.queued_ms(calls[name], REPS))
sizes = {"all-hit": hits.numel(), "all-miss": misses.numel(),
         "pre-filter": prefilter.numel(), "successor": succ.numel(),
         "fence rows": state.num_buckets, "fence rows, num_nodes": state.num_buckets}
# yardsticks of the fence rows' random reads: one torch gather of the 2^20
# head keys, and of the head keys and head values (not counted anywhere)
S = state.nodes_per_bucket * state.node_size
heads = torch.arange(state.num_buckets, device=dev) * S
fk, fv = state.keys.view(-1), state.vals.view(-1)
gathers = {"head keys": lambda: fk[heads],
           "head keys and values": lambda: (fk[heads], fv[heads])}
gather_ms = {name: cs.queued_ms(fn, REPS) for name, fn in gathers.items()}
# the fence rows' device time by kernel, from torch.profiler's trace
profiled = {}
if hasattr(fs, "fence_rows"):
    from torch.profiler import ProfilerActivity, profile

    for name in ("fence rows", "fence rows, num_nodes"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                calls[name]()
            torch.cuda.synchronize()
        profiled[name] = {short(e.key): e.device_time_total / e.count
                          for e in prof.key_averages() if e.device_time_total > 0}
for name in order:
    t = times[name]
    what = "buckets" if name.startswith("fence") else "queries"
    d = queued[name]
    print(f"{args.tag:>8} {name} ({sizes[name]} {what}): {t[0]:.4f}, {t[1]:.4f} ms a call; "
          f"queued {d[0]:.4f}, {d[1]:.4f} ms; bound {bound[name]:.4f} ms "
          f"({min(d) / bound[name]:.2f}x)", flush=True)
for name, ms in gather_ms.items():
    print(f"{args.tag:>8} torch gather of the {name}: {ms:.4f} ms queued", flush=True)
for name, kernels in profiled.items():
    print(f"{args.tag:>8} {name}, device time by kernel (torch.profiler): "
          + ", ".join(f"{k} {us:.2f} us" for k, us in kernels.items()), flush=True)
