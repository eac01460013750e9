"""Quickstart of the PyTorch port: the FliX index end to end, the walk of
``examples/quickstart.py`` through ``repro_torch``, on the same random
stream and printing the same lines.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # the host
"""

import argparse

import numpy as np
import torch

from repro_torch import core

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default=None, help="cpu, or the card when omitted")
dev = core.state.resolve_device(ap.parse_args().device)
rng = np.random.default_rng(0)


def on_dev(a):
    return torch.as_tensor(np.asarray(a, np.int32), device=dev)


# ---- build: sorted keys → half-full bucketed data layer -------------------
keys = rng.choice(1_000_000, size=50_000, replace=False).astype(np.int32)
row_ids = np.arange(50_000, dtype=np.int32)
index = core.build(keys, row_ids, node_size=32, nodes_per_bucket=16, device=dev)
print(f"built: {index.num_buckets} buckets, {int(index.live_keys())} keys, "
      f"{index.memory_bytes()/2**20:.1f} MiB")

# ---- flipped point queries: sort the batch, buckets pull their slices -----
queries = np.sort(rng.choice(keys, size=10_000))
values = core.point_query(index, on_dev(queries))
assert (values.cpu().numpy() >= 0).all()
print(f"10k point queries: all hits ✓")

misses = np.sort(np.setdiff1d(rng.integers(0, 1_000_000, 10_000), keys)).astype(np.int32)
assert (core.point_query(index, on_dev(misses)).cpu().numpy() == -1).all()
print(f"{len(misses)} point queries: all misses ✓")

# ---- batched insert (TL-Bulk semantics: per-bucket merge + splits) --------
new_keys = np.setdiff1d(rng.integers(0, 1_000_000, 30_000), keys)[:20_000].astype(np.int32)
sk, sv = core.sort_batch(on_dev(new_keys), on_dev(new_keys))
index, stats = core.insert_safe(index, sk, sv)
print(f"inserted {int(stats['inserted'])} keys "
      f"({int(stats['splits'])} node splits), live={int(index.live_keys())}")

# ---- successor queries (ordered-map superpower) ----------------------------
probe = on_dev(np.sort(rng.integers(0, 1_000_000, 5)))
succ_k, succ_v = core.successor_query(index, probe)
for q, k in zip(probe.cpu().numpy(), succ_k.cpu().numpy()):
    print(f"  successor({q}) = {k}")

# ---- batched delete: physical removal, no tombstones -----------------------
live = np.sort(np.concatenate([keys, new_keys]))
dels = on_dev(live[~(np.arange(len(live)) % 3 == 0)])  # delete 2/3
index, dstats = core.delete(index, dels)
print(f"deleted {int(dstats['deleted'])} keys, "
      f"freed {int(dstats['nodes_freed'])} nodes, live={int(index.live_keys())}")

# ---- restructure: flatten chains, merge underfull nodes --------------------
before = int(index.total_nodes())
index = core.restructure_auto(index)
print(f"restructure: {before} → {int(index.total_nodes())} nodes "
      f"(recovered {before - int(index.total_nodes())}, "
      f"{index.memory_bytes()/2**20:.1f} MiB)")
