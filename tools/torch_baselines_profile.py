#!/usr/bin/env python3
"""Where the port's baselines spend a call on one CUDA card, at chip_smoke.py
phase 13's sizes:

    python3 tools/torch_baselines_profile.py [--rows N]

It builds phase 13's structures (``repro_torch.core.baselines``) from
``chip_smoke``'s ``Traffic`` and ``SEED``: 2^24 unique uniform keys of a
2^27 space in the B-tree (16-key leaves, 16 a bucket), LSM (4096-pair
chunks, 15 levels), a hash table of int(2n / 0.8) slots and a sorted array
of 2n.  Then, for each call below, one warm call and one call under
``torch.profiler`` (CPU and CUDA activities): each structure's point query
of 2^24 all-hit keys, LSM's successor query of 2^22 uniform keys, and the
inserts of 2^22 fresh keys into LSM (its per-chunk host loop) and the hash
table (a host sync a probe round).  Printed per call: the host ms (synced),
the profiler's ops by self device time (the top ``--rows``), and its
totals, whose CUDA line over the host ms is the card's busy share.  The
baselines are plain torch emulations of the paper's, so these are the times
of torch emulations.  It needs a card and exits non-zero without one.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

ap = argparse.ArgumentParser(prog="torch_baselines_profile")
ap.add_argument("--rows", type=int, default=8)
args = ap.parse_args()

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("torch_baselines_profile: no CUDA device available")
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.core.baselines import btree, lsm  # noqa: E402
from repro_torch.core.baselines import hash_table as ht  # noqa: E402
from repro_torch.core.baselines import sorted_array as sa  # noqa: E402

dev = torch.device("cuda")
gen = torch.Generator(device=dev)
gen.manual_seed(cs.SEED + 8)
n = cs.FULL_KEYS
traffic = cs.Traffic(cs.FULL_SPACE, n, gen)
keys, vals = traffic.initial()
bt = btree.build(keys, vals)
lsmu = lsm.insert(lsm.empty_state(cs.BASELINE_CHUNK, cs.lsm_levels(2 * n, cs.BASELINE_CHUNK)),
                  keys, vals)
h, _ = ht.insert(ht.empty_state(int(2 * n / cs.BASELINE_LOAD)), keys, vals)
sarr = sa.build(keys, vals, 2 * n)
hits = torch.sort(keys[torch.randint(0, n, (cs.FIG9_QUERIES,), generator=gen,
                                     device=dev)]).values
succ = torch.sort(traffic._rand_keys(cs.FIG9_SUCC)).values
fresh = torch.sort(traffic.perm[n : n + cs.FIG9_ROUND]).values
del keys, vals


def profile(label, fn):
    fn()  # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    print(f"{label}: {host:.3f} ms on the host clock (synced), under the profiler", flush=True)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=args.rows)
    print(table, flush=True)


smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip()
print(f"{smi}; torch {torch.__version__}", flush=True)
profile("btree.point_query, 2^24 hits", lambda: btree.point_query(bt, hits))
profile("lsm.point_query, 2^24 hits", lambda: lsm.point_query(lsmu, hits))
profile("hash_table.point_query, 2^24 hits", lambda: ht.point_query(h, hits))
profile("sorted_array.point_query, 2^24 hits", lambda: sa.point_query(sarr, hits))
profile("lsm.successor_query, 2^22 uniform", lambda: lsm.successor_query(lsmu, succ))
profile("lsm.insert, 2^22 fresh keys", lambda: lsm.insert(lsmu, fresh, fresh))
profile("hash_table.insert, 2^22 fresh keys", lambda: ht.insert(h, fresh, fresh))
