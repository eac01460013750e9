"""Serving driver: batched decode with the FliX KV-page control plane (port
of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium \
        --reduced --batch 4 --steps 32 --device cpu

Every flag and self-check of the reference's driver, with its printed
lines, plus ``--device`` (default: the card).  The weights are drawn from
``--seed`` by a ``torch.Generator``; parameters are float32 and the cache
float32, the compute dtype the config's.  :func:`main` returns the finished
``KVPageIndex``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.config import ExecConfig
from repro_torch.core.state import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.model import get_config
from repro_torch.serve.kv_index import KVPageIndex

PAGE_TOKENS = 16  # tokens per KV page tracked by the index


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--device",
        default=None,
        help="where the model and the index live (default: the card; "
        "'cpu' runs on the host); with --shards every shard goes there, "
        "and without it the shards take the first N cards",
    )
    ap.add_argument(
        "--index-impl",
        choices=("auto", "reference", "fused"),
        default="auto",
        help="apply_ops executor for the KV page index: the fused CUDA "
        "path, the plain torch reference engine, or auto (fused on the "
        "card, reference elsewhere)",
    )
    ap.add_argument(
        "--shards",
        type=int,
        default=0,
        help="range-partition the KV page index over this many shards and "
        "serve every engine step through shard_apply_ops "
        "(0 = single-device index)",
    )
    ap.add_argument(
        "--index-routing",
        choices=("replicated", "a2a"),
        default="replicated",
        help="distributed batch routing mode for the sharded index "
        "(DESIGN.md §11); ignored without --shards",
    )
    ap.add_argument(
        "--wal-dir",
        default=None,
        help="durability directory for the KV page index: every update "
        "step is write-ahead logged (fsynced) before execution and the "
        "index recovers from this directory on restart (DESIGN.md §12); "
        "default off",
    )
    ap.add_argument(
        "--snapshot-every",
        type=int,
        default=64,
        help="with --wal-dir, snapshot the index every N update steps "
        "(bounds replay-on-restart to at most N batches)",
    )
    ap.add_argument(
        "--snapshot-window",
        type=int,
        default=0,
        help="retain this many committed index versions for pinned "
        "step(as_of=...) snapshot reads (DESIGN.md §14); 0 disables "
        "versioned reads",
    )
    ap.add_argument(
        "--device-budget",
        type=int,
        default=0,
        help="bound the KV page index's device-resident footprint to this "
        "many bytes (tiered residency, DESIGN.md §15); 0 = single-tier. "
        "Incompatible with --shards and --snapshot-window",
    )
    ap.add_argument(
        "--page-ttl",
        type=int,
        default=0,
        help="give each registered KV page an expiry deadline this many "
        "decode steps after its allocation (virtual time = step number); "
        "0 = pages never expire",
    )
    ap.add_argument(
        "--gateway",
        action="store_true",
        help="route index traffic through the multi-tenant batching "
        "gateway (DESIGN.md §13): each sequence submits per-step "
        "micro-requests with idempotency keys; the gateway coalesces "
        "them into the same mixed engine batches, exactly once",
    )
    return ap.parse_args(argv)


def main(argv=None) -> KVPageIndex:
    args = parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = tf.init_params(gen, cfg)
    cache = tf.init_cache(cfg, args.batch, args.max_len, dtype=torch.float32, device=dev)
    kv_index = KVPageIndex(
        config=ExecConfig(impl=args.index_impl, routing=args.index_routing),
        shards=args.shards,
        device=args.device,
        durability_dir=args.wal_dir,
        snapshot_every=args.snapshot_every,
        snapshot_window=args.snapshot_window,
        device_budget=args.device_budget or None,
    )
    if args.wal_dir and kv_index.durable_seq:
        print(
            f"recovered KV index from {args.wal_dir} "
            f"(seq {kv_index.durable_seq}, {kv_index.live_pages()} pages)"
        )

    gateway = None
    if args.gateway:
        from repro_torch.serve.gateway import Gateway, Request

        gateway = Gateway(kv_index, default_rate=1e6, default_burst=1e6)

    token = torch.randint(0, cfg.vocab_size, (args.batch,), generator=gen, device=dev,
                          dtype=torch.int32)
    t0 = time.time()
    with torch.no_grad():
        for i in range(args.steps):
            logits, cache = tf.decode_step(params, cfg, cache, token)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            if i % PAGE_TOKENS == 0:  # new KV page per sequence
                _page_step(args, kv_index, gateway, i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    where = f"{args.shards} shards ({args.index_routing})" if args.shards else "1 device"
    print(
        f"decoded {args.steps} steps × batch {args.batch} "
        f"({args.steps*args.batch/dt:.1f} tok/s); "
        f"kv index tracks {kv_index.live_pages()} pages on {where}"
    )
    _check_index(args, kv_index, gateway)
    return kv_index


def _page_step(args, kv_index, gateway, i: int) -> None:
    page = i // PAGE_TOKENS
    seqs = np.arange(args.batch)
    if gateway is not None:
        from repro_torch.serve.gateway import Request

        # each sequence is its own tenant submitting micro-requests; the
        # gateway coalesces them into ONE mixed engine batch
        lookups = []
        for b in range(args.batch):
            gateway.submit(
                Request(f"seq{b}", f"alloc:{b}:{page}", "alloc", seqs=(b,), pages=(page,),
                        slots=(b * 1000 + page,)),
                now=float(i),
            )
            lookups.append(gateway.submit(
                Request(f"seq{b}", f"lookup:{b}:{i}", "lookup", seqs=(b,), pages=(0,)),
                now=float(i),
            ))
        gateway.pump(now=float(i))
        got = np.array([int(_host(t.result())[0]) for t in lookups])
        assert (got == seqs * 1000).all()
        return
    # one mixed engine step: register the new pages AND resolve each
    # sequence's head page in the same sorted batch
    allocs = (seqs, np.full(args.batch, page), seqs * 1000 + page)
    if args.page_ttl:
        allocs = (*allocs, np.full(args.batch, i + args.page_ttl))
    slots = kv_index.step(
        allocs=allocs,
        lookups=(seqs, np.zeros(args.batch, int)),
        now=i if args.page_ttl else None,
    ).slots
    # head page (deadline = page_ttl) is visible until its deadline
    # passes, then lazily expired
    expect = (
        seqs * 1000 if args.page_ttl == 0 or args.page_ttl > i else np.full(args.batch, -1)
    )
    assert (_host(slots) == expect).all()


def _check_index(args, kv_index, gateway) -> None:
    """The reference driver's self-checks, in its order, with its lines."""
    if args.device_budget:
        rb = kv_index.resident_bytes
        assert rb is not None, "tiered index must report a resident footprint"
        # I7 after commit (one bucket always admitted for tiny budgets)
        state = kv_index._durable.handle if args.wal_dir else kv_index.state
        assert rb <= max(args.device_budget, state.bucket_bytes), (rb, args.device_budget)
        print(f"tiered residency ✓ ({rb} device-resident bytes, budget {args.device_budget})")
    if args.page_ttl == 0:
        # sanity: page lookups resolve
        got = _host(kv_index.lookup(np.arange(args.batch), np.zeros(args.batch, int)))
        assert (got == np.arange(args.batch) * 1000).all()
        print("page table lookups consistent ✓")
        # sanity: in-order page enumeration through the engine's RANGE op
        n_pages = (args.steps - 1) // PAGE_TOKENS + 1
        pages, slots, count = kv_index.pages_of(0, max_pages=max(256, n_pages))
        assert int(count) == n_pages, (int(count), n_pages)
        assert _host(pages)[:n_pages].tolist() == list(range(n_pages))
        assert _host(slots)[:n_pages].tolist() == list(range(n_pages))
        print(f"page enumeration in order ✓ ({n_pages} pages for seq 0)")
    else:
        # every registered page's deadline lies before this horizon, so a
        # read at it sees nothing: TTL follows the explicit virtual clock
        horizon = args.steps + args.page_ttl
        gone = kv_index.step(
            lookups=(np.arange(args.batch), np.zeros(args.batch, int)), now=horizon
        ).slots
        assert (_host(gone) == -1).all()
        print(f"page TTLs honored ✓ (head pages invisible at now={horizon})")
    if args.snapshot_window:
        _check_pinned(args, kv_index)
    if gateway is not None:
        from repro_torch.serve.gateway import Request

        # retrying a committed key resolves from the dedup window, no re-apply
        dup = gateway.submit(
            Request("seq0", "alloc:0:0", "alloc", seqs=(0,), pages=(0,), slots=(0,)),
            now=float(args.steps),
        )
        assert dup.ok and dup.duplicate
        m = gateway.metrics
        print(
            f"gateway exactly-once ✓ ({m['committed_requests']} requests in "
            f"{m['batches']} batches, {m['duplicates']} duplicates deduped)"
        )
    if args.wal_dir:
        kv_index.snapshot()
        if gateway is not None:
            gateway.close(now=float(args.steps))
        else:
            kv_index.close()
        print(f"index durable at seq {kv_index.durable_seq} in {args.wal_dir}")


def _check_pinned(args, kv_index) -> None:
    from repro_torch.serve.kv_index import SnapshotGone

    def range_bytes(out) -> bytes:
        return _host(out["keys"]).tobytes() + _host(out["vals"]).tobytes()

    v = kv_index.version
    lo, hi = 0, args.batch << 12
    pinned = kv_index.step(ranges=([lo], [hi]), as_of=v, range_budget=1024).range_out
    base = range_bytes(pinned)
    for extra in range(3):  # three later update batches
        kv_index.step(allocs=([4000 + extra], [0], [extra]))
    if args.snapshot_window > 3:
        again = kv_index.step(ranges=([lo], [hi]), as_of=v, range_budget=1024).range_out
        assert range_bytes(again) == base
        print(f"pinned snapshot read byte-identical across 3 later batches ✓ (as_of={v})")
    else:
        try:
            kv_index.step(ranges=([lo], [hi]), as_of=v, range_budget=1024)
            raise AssertionError("expected SnapshotGone")
        except SnapshotGone:
            print(f"snapshot window slid past version {v} → SNAPSHOT_GONE ✓")


if __name__ == "__main__":
    main()
