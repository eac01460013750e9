#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FliX (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any mismatch or exception exits non-zero before the last
line, and no phase catches its own failure:

  1. card     — the device name, and nvidia-smi's name and power limit;
  2. build    — nvcc builds the kernel library from ``src/repro_torch/csrc``,
                one process per source, all started together;
  3. kernels  — each CUDA kernel against its plain torch version on the card,
                exactly (all int32).  flix_apply and its range gather: 4 mixed
                batches and a boundary-key batch at 2^18 keys, a long-stripe
                geometry (2048 slots per bucket), and an overflow-then-retry
                case through ``apply_ops_safe``.  flix_point_query,
                flix_successor, flix_insert and flix_delete: at 2^18 keys in
                the default geometry and in 8x8 nodes, and at 2^16 keys in
                64-node stripes, with mixed hit/miss queries, boundary keys,
                emptied buckets, duplicate delete keys and an insert batch
                that overflows a bucket;
  4. main     — the paper's smallest build: 2^24 unique uniform keys from a
                2^27 key space at the default geometry (32-key nodes, 16 per
                bucket, fill 0.5: 2^20 buckets, ~4.4 GB of state), then 8
                batches of 2^20 ops (20% INSERT fresh, 20% DELETE live, 50%
                POINT half hits, 9% SUCCESSOR, 1% RANGE of width 64,
                max_results=65536) through make_ops → apply_ops_safe →
                unsort.  Each batch must launch both flix_apply kernels and
                must not retry; its results and post-state are held against
                the port's plain-torch reference engine on the card, and the
                final state passes the invariant checker;
  5. fig9     — the paper's Fig. 9 round schedule (benchmarks/query_qtmf.py)
                through ``repro_torch.kernels.ops`` on a fresh build of the
                same size: 4 insert rounds of 2^22 fresh keys, then 4 delete
                rounds of those keys; after each round 2^24 all-hit and 2^24
                all-miss point queries and 2^22 uniform successor queries
                (benchmarks/successor.py).  Every call is held against the
                port's core function on the card, every round must launch its
                kernels, no insert may overflow, and the final state passes
                the invariant checker;
  6. the kernels line, the card line, and the result line.

The script needs one card and exits non-zero without one, or when it runs
without the repository's ``src/`` beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from statistics import fmean

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 20260
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
FULL_KEYS = 1 << 24
FULL_SPACE = 1 << 27
FULL_OPS = 1 << 20
FULL_BATCHES = 8
FULL_MAX_RESULTS = 65536
FIG9_ROUND = 1 << 22  # keys per insert / delete round: a quarter of the build
FIG9_QUERIES = 1 << 24  # all-hit and all-miss point queries per round
FIG9_SUCC = 1 << 22  # uniform successor queries per round
APPLY_KERNELS = ("flix_apply", "flix_apply_range")
CSRC = "src/repro_torch/csrc/"
# kernel: (source, the TPU kernel it replaces)
KERNELS = {
    "flix_apply": ("flix_apply.cu", "src/repro/kernels/flix_apply.py:88"),
    "flix_apply_range": ("flix_apply.cu", "src/repro/kernels/flix_apply.py:327"),
    "flix_point_query": ("flix_query.cu", "src/repro/kernels/flix_query.py:54"),
    "flix_successor": ("flix_successor.cu", "src/repro/kernels/flix_successor.py:45"),
    "flix_insert": ("flix_insert.cu", "src/repro/kernels/flix_insert.py:39"),
    "flix_delete": ("flix_delete.cu", "src/repro/kernels/flix_delete.py:48"),
}


def log(*args):
    print(*args, flush=True)


class Traffic:
    """Unique uniform keys of one key space, with the live set tracked on
    the card so that deletes hit live keys and inserts are always fresh."""

    def __init__(self, space: int, n_keys: int, gen: torch.Generator):
        dev = gen.device
        self.space, self.gen = space, gen
        self.perm = torch.randperm(space, generator=gen, device=dev).to(torch.int32)
        self.alive = torch.zeros(space, dtype=torch.bool, device=dev)
        self.alive[self.perm[:n_keys].long()] = True
        self.fresh = n_keys

    def initial(self):
        keys = torch.nonzero(self.alive)[:, 0].to(torch.int32)
        return keys, self._rand_vals(keys.numel())

    def _rand_vals(self, n):
        return torch.randint(0, 1 << 30, (n,), generator=self.gen, device=self.gen.device,
                             dtype=torch.int32)

    def _rand_keys(self, n):
        return torch.randint(0, self.space, (n,), generator=self.gen, device=self.gen.device,
                             dtype=torch.int32)

    def mixed(self, n: int, width: int = 64):
        """20% INSERT fresh, 20% DELETE live, 50% POINT (half hits), 9%
        SUCCESSOR, 1% RANGE [lo, lo+width)."""
        from repro_torch import core

        dev = self.gen.device
        n_ins = n_del = n // 5
        n_succ, n_rng = (n * 9) // 100, n // 100
        n_pt = n - n_ins - n_del - n_succ - n_rng
        ins = self.perm[self.fresh : self.fresh + n_ins]
        self.fresh += n_ins
        live = torch.nonzero(self.alive)[:, 0].to(torch.int32)
        dels = live[torch.randperm(live.numel(), generator=self.gen, device=dev)[:n_del]]
        hits = live[torch.randint(0, live.numel(), (n_pt // 2,), generator=self.gen,
                                  device=dev)]
        rlo = self._rand_keys(n_rng)
        tags = torch.cat([
            torch.full((n_ins,), core.OP_INSERT, dtype=torch.int32, device=dev),
            torch.full((n_del,), core.OP_DELETE, dtype=torch.int32, device=dev),
            torch.full((n_pt,), core.OP_POINT, dtype=torch.int32, device=dev),
            torch.full((n_succ,), core.OP_SUCCESSOR, dtype=torch.int32, device=dev),
            torch.full((n_rng,), core.OP_RANGE, dtype=torch.int32, device=dev),
        ])
        keys = torch.cat([ins, dels, hits, self._rand_keys(n_pt - n_pt // 2),
                          self._rand_keys(n_succ), rlo])
        vals = torch.cat([self._rand_vals(n_ins), torch.zeros_like(keys[: n - n_ins - n_rng]),
                          rlo + width])
        self.alive[ins.long()] = True
        self.alive[dels.long()] = False
        return tags, keys, vals

    def boundary(self):
        """Keys 0 and MAX_VALID, duplicate reads, a deleted run of keys that
        empties whole buckets, and ranges over all three."""
        from repro_torch import core

        dev = self.gen.device
        live = torch.nonzero(self.alive)[:, 0].to(torch.int32)
        a, b = int(live[1000]), int(live[1400])
        dels = live[1000:1400]
        fresh = self.perm[self.fresh : self.fresh + 8]
        self.fresh += 8
        edge = [core.MAX_VALID] + ([] if bool(self.alive[0]) else [0])  # MAX_VALID > space
        ins = torch.cat([torch.tensor(edge, dtype=torch.int32, device=dev), fresh])
        reads = torch.cat([
            live[torch.arange(0, 20 * 97, 97, device=dev)].repeat(4),
            torch.tensor([0, 1, core.MAX_VALID - 1, core.MAX_VALID, core.EMPTY],
                         dtype=torch.int32, device=dev),
            torch.arange(a - 5, b + 5, 7, dtype=torch.int32, device=dev),
        ])
        rlo = torch.tensor([a - 10, 0, core.MAX_VALID - 5, a, a], dtype=torch.int32, device=dev)
        rhi = torch.tensor([b + 10, 50, core.EMPTY, a, b], dtype=torch.int32, device=dev)
        n_r = reads.numel()
        tags = torch.cat([
            torch.full((ins.numel(),), core.OP_INSERT, dtype=torch.int32, device=dev),
            torch.full((dels.numel(),), core.OP_DELETE, dtype=torch.int32, device=dev),
            torch.where(torch.arange(n_r, device=dev) % 2 == 0, core.OP_POINT,
                        core.OP_SUCCESSOR).to(torch.int32),
            torch.full((rlo.numel(),), core.OP_RANGE, dtype=torch.int32, device=dev),
        ])
        keys = torch.cat([ins, dels, reads, rlo])
        vals = torch.cat([self._rand_vals(ins.numel()),
                          torch.zeros(dels.numel() + n_r, dtype=torch.int32, device=dev), rhi])
        self.alive[ins[ins < self.space].long()] = True
        self.alive[dels.long()] = False
        return tags, keys, vals


def max_abs_err(want, got) -> int:
    err = 0
    for i, (w, g) in enumerate(zip(want, got)):
        if w.shape != g.shape:
            raise AssertionError(f"output {i}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        if w.numel():
            err = max(err, int((w.long() - g.long()).abs().max()))
    return err


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


class KernelCheck:
    """Runs both kernels against their plain versions on given inputs and
    keeps the worst error; raises on any disagreement."""

    def __init__(self):
        self.err = {k: 0 for k in KERNELS}

    def hold(self, kernel, want, got, label):
        """One kernel's outputs against its plain version's: keep the worst
        error, raise on any."""
        torch.cuda.synchronize()
        e = max_abs_err(want, got)
        self.err[kernel] = max(self.err[kernel], e)
        if e:
            raise AssertionError(f"{label}: {kernel} disagrees with its plain version ({e})")
        return e

    def run(self, state, ops, max_results, label):
        from repro_torch import core
        from repro_torch.core.state import FliXState
        from repro_torch.kernels import flix_apply as fa

        args, _ = fa.stripe_inputs(state, ops.tag, ops.key, ops.val)
        got = fa.flix_apply_pass(*args)
        torch.cuda.synchronize()
        want = fa.flix_apply_reference(*args)
        e1 = max_abs_err(want, got)
        new = FliXState(*got[:5], mkba=state.mkba, needs_restructure=state.needs_restructure)
        is_range = ops.tag == core.OP_RANGE
        g, pref, *_ = fa.range_slots(new, is_range, ops.key, ops.val, max_results)
        rk = fa.flix_apply_range_pass(g, pref, new.node_count, new.keys, new.vals)
        torch.cuda.synchronize()
        e2 = max_abs_err(fa.flix_apply_range_reference(g, pref, new.node_count, new.keys,
                                                       new.vals), rk)
        self.err["flix_apply"] = max(self.err["flix_apply"], e1)
        self.err["flix_apply_range"] = max(self.err["flix_apply_range"], e2)
        log(f"  {label}: flix_apply max_abs_err={e1}, flix_apply_range max_abs_err={e2}")
        if e1 or e2:
            raise AssertionError(f"{label}: a kernel disagrees with its plain version")
        return args, got


def compare_engines(label, state, ops, config, *, expect_retries=None):
    """The engine on its default path (the kernels) against the port's
    plain-torch reference engine on the card: equal state and results."""
    from repro_torch import core

    fused = core.apply_ops_safe(state, ops, config=config)
    ref = core.apply_ops_safe(state, ops, config=config.replace(impl="reference"))
    check_same(label, fused, ref)
    if expect_retries is not None:
        assert fused[2]["restructure_retries"] == expect_retries, fused[2]
    return fused


def check_same_state(label, gs, ws):
    """The reference's parity contract: every layout field byte-equal, vals
    equal at live slots."""
    from repro_torch.core.state import EMPTY

    assert gs.geometry == ws.geometry, (label, gs.geometry, ws.geometry)
    for f in ("keys", "node_count", "node_max", "num_nodes", "mkba", "needs_restructure"):
        if not torch.equal(getattr(gs, f), getattr(ws, f)):
            raise AssertionError(f"{label}: state field {f} differs from the reference")
    live = ws.keys != EMPTY
    if not torch.equal(gs.vals[live], ws.vals[live]):
        raise AssertionError(f"{label}: live vals differ from the reference")


def check_same(label, got, want):
    gs, gr, gst = got
    ws, wr, wst = want
    check_same_state(label, gs, ws)
    for k in wr:
        if not torch.equal(gr[k], wr[k]):
            raise AssertionError(f"{label}: result {k} differs from the reference")
    for k in wst:
        if int(gst[k]) != int(wst[k]):
            raise AssertionError(f"{label}: stat {k}: {int(gst[k])} != {int(wst[k])}")


def phase_kernels(dev, check: KernelCheck):
    from repro_torch import core

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cfg = core.ExecConfig(max_results=8192)

    log("phase 3a: 2^18 keys, default geometry, 4 mixed batches + a boundary batch")
    traffic = Traffic(1 << 21, 1 << 18, gen)
    state = core.build(*traffic.initial())
    for i in range(5):
        tags, keys, vals = traffic.mixed(1 << 16) if i < 4 else traffic.boundary()
        ops, _ = core.make_ops(tags, keys, vals)
        check.run(state, ops, cfg.max_results, f"batch {i}")
        state = compare_engines(f"batch {i}", state, ops, cfg, expect_retries=0)[0]
    core.check_invariants(state)
    emptied = int((state.num_nodes == 0).sum())
    log(f"  engine == reference engine on all 5 batches; {emptied} emptied buckets")
    assert emptied > 0

    log("phase 3b: long stripes (64 nodes x 32 keys = 2048 slots per bucket)")
    traffic = Traffic(1 << 20, 1 << 14, gen)
    keys, vals = traffic.initial()
    state = core.build(keys, vals, node_size=32, nodes_per_bucket=64)
    ops, _ = core.make_ops(*traffic.mixed(1 << 13))
    check.run(state, ops, cfg.max_results, "long stripes")
    compare_engines("long stripes", state, ops, cfg, expect_retries=0)

    log("phase 3c: overflow then retry through apply_ops_safe (4-key nodes, 2 per bucket)")
    keys = torch.arange(0, 640, 10, dtype=torch.int32, device=dev)
    state = core.build(keys, keys, node_size=4, nodes_per_bucket=2)
    flood = torch.arange(1, 200, 2, dtype=torch.int32, device=dev)
    tags = torch.cat([
        torch.full((flood.numel(),), core.OP_INSERT, dtype=torch.int32, device=dev),
        torch.full((keys.numel(),), core.OP_POINT, dtype=torch.int32, device=dev),
        torch.full((keys.numel(),), core.OP_SUCCESSOR, dtype=torch.int32, device=dev),
        torch.full((2,), core.OP_RANGE, dtype=torch.int32, device=dev),
    ])
    bkeys = torch.cat([flood, keys, keys + 3, torch.tensor([0, 150], device=dev)])
    bvals = torch.cat([flood * 7, torch.zeros(2 * keys.numel(), dtype=torch.int32, device=dev),
                       torch.tensor([120, 400], device=dev)]).to(torch.int32)
    ops, _ = core.make_ops(tags, bkeys.to(torch.int32), bvals, pad_to=256)
    check.run(state, ops, cfg.max_results, "overflowing pass")
    fused = compare_engines("overflow retry", state, ops, cfg, expect_retries=1)
    log(f"  retried once into geometry {fused[0].geometry}")


def phase_main(dev):
    from repro_torch import core
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import flix_apply as fa

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    log(f"phase 4: build {FULL_KEYS} unique uniform keys from a {FULL_SPACE} key space")
    traffic = Traffic(FULL_SPACE, FULL_KEYS, gen)
    keys, vals = traffic.initial()
    state, build_ms = host_ms(lambda: core.build(keys, vals))
    del keys, vals
    nb, npb, ns = state.geometry
    log(f"  geometry nb={nb} npb={npb} ns={ns}, {state.memory_bytes() / 1e9:.3f} GB of state, "
        f"build {build_ms:.1f} ms")
    cfg = core.ExecConfig(max_results=FULL_MAX_RESULTS)
    launches = {k: 0 for k in APPLY_KERNELS}
    k_ms, r_ms, bounds, rbounds = [], [], [], []
    for i in range(FULL_BATCHES):
        tags, keys, vals = traffic.mixed(FULL_OPS)
        torch.cuda.synchronize()

        reset_launches()
        t0 = time.perf_counter()
        ops, perm = core.make_ops(tags, keys, vals)
        new_state, res, stats = core.apply_ops_safe(state, ops, config=cfg)
        value = core.unsort(res["value"], perm)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: LAUNCHES[k] for k in APPLY_KERNELS}
        for k, c in counts.items():
            if c < 1:
                raise AssertionError(f"batch {i}: kernel {k} was not launched on the main path")
            launches[k] += c
        assert stats["restructure_retries"] == 0, stats
        assert value.shape == (FULL_OPS,)

        ref, ref_ms = host_ms(
            lambda: core.apply_ops_safe(state, ops, config=cfg.replace(impl="reference"))
        )
        check_same(f"full batch {i}", (new_state, res, stats), ref)
        del ref

        # the kernels alone, re-launched on this batch's inputs (not counted)
        args, r = fa.stripe_inputs(state, ops.tag, ops.key, ops.val)
        k_ms.append(event_ms(lambda: fa.flix_apply_pass(*args), 3))
        is_range = ops.tag == core.OP_RANGE
        g, pref, *_ = fa.range_slots(new_state, is_range, ops.key, ops.val, cfg.max_results)
        rargs = (g, pref, new_state.node_count, new_state.keys, new_state.vals)
        r_ms.append(event_ms(lambda: fa.flix_apply_range_pass(*rargs), 10))
        n_ins, n_del = int(r.is_ins.sum()), int(r.is_del.sum())
        outs = fa.flix_apply_pass(*args)
        moved = (active_row_bytes(state) + state.node_max.nbytes
                 + 8 * n_ins + 4 * n_del + 6 * 4 * nb + ops.tag.nbytes + ops.key.nbytes
                 + sum(o.nbytes for o in outs))
        bounds.append(moved / HBM_BYTES_PER_S * 1e3)
        valid = int((g >= 0).sum())
        rbounds.append((12 * g.numel() + valid * (4 * npb + 8)) / HBM_BYTES_PER_S * 1e3)
        del outs
        log(f"  batch {i}: {ms:.3f} ms end to end, {FULL_OPS / ms * 1e3:.6g} ops/s; "
            f"flix_apply {k_ms[-1]:.4f} ms (bound {bounds[-1]:.4f} ms, {moved} bytes), "
            f"range gather {r_ms[-1]:.4f} ms; reference engine {ref_ms:.3f} ms; "
            f"launches {counts}; inserted {int(stats['inserted'])} deleted "
            f"{int(stats['deleted'])} range_truncated {int(stats['range_truncated'])}")
        state = new_state

    _, inv_ms = host_ms(lambda: core.check_invariants(state))
    core.check_range_results(ops, res, max_results=cfg.max_results)
    log(f"  invariants I1-I5 hold on the final state ({inv_ms:.0f} ms); "
        f"live keys {int(state.live_keys())}")

    # plain versions at the last batch's shapes: no yardstick of speed, they
    # repeat the kernels' arithmetic
    got = fa.flix_apply_pass(*args)
    want, plain_ms = host_ms(lambda: fa.flix_apply_reference(*args))
    e1 = max_abs_err(want, got)
    del want, got
    rk = fa.flix_apply_range_pass(*rargs)
    rwant, rplain_ms = host_ms(lambda: fa.flix_apply_range_reference(*rargs))
    e2 = max_abs_err(rwant, rk)
    log(f"  plain versions at main-path shapes: flix_apply {plain_ms:.3f} ms "
        f"(max_abs_err {e1}), range gather {rplain_ms:.3f} ms (max_abs_err {e2})")
    if e1 or e2:
        raise AssertionError("a kernel disagrees with its plain version at main-path shapes")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {
        "flix_apply": dict(launches=launches["flix_apply"], ms=fmean(k_ms),
                           plain_ms=plain_ms, bound_ms=fmean(bounds), err=e1),
        "flix_apply_range": dict(launches=launches["flix_apply_range"], ms=fmean(r_ms),
                                 plain_ms=rplain_ms, bound_ms=fmean(rbounds), err=e2),
    }


def active_row_bytes(state) -> int:
    """Bytes of the node rows (keys and vals) that hold keys: all that a
    pass over the stripes must read of them, since ``node_max`` marks the
    rest as empty.  The pass still writes every stripe whole."""
    from repro_torch.core.state import EMPTY

    return 8 * state.node_size * int((state.node_max != EMPTY).sum())


def sorted_i32(*parts):
    return torch.sort(torch.cat([p.to(torch.int32) for p in parts]), stable=True).values


def kernel_ops_case(dev, check: KernelCheck, gen, ns, npb, n_keys):
    """The four single-class kernels against their plain versions on one
    state: a delete batch that empties buckets and repeats keys, queries on
    the emptied state, and an insert batch that floods one bucket."""
    from repro_torch import core
    from repro_torch.kernels import flix_delete as fd
    from repro_torch.kernels import flix_insert as fi
    from repro_torch.kernels import flix_query as fq
    from repro_torch.kernels import flix_successor as fs
    from repro_torch.kernels import ops as kops

    label = f"{n_keys} keys, ns={ns} npb={npb}"
    space = 1 << 28  # sparse, so one bucket's key range can take a flood

    def rand(n, hi=space):
        return torch.randint(0, hi, (n,), generator=gen, device=dev, dtype=torch.int32)

    keys = torch.unique(rand(n_keys))
    state = core.build(keys, rand(keys.numel(), 1 << 30), node_size=ns, nodes_per_bucket=npb)
    cap = npb * ns
    edge = torch.tensor([0, core.MAX_VALID], dtype=torch.int32, device=dev)

    # deletes: a run of live keys that empties whole buckets, live keys three
    # times over, absent keys, the edges
    raw = sorted_i32(keys[1000:1400], keys[5000:5100].repeat(3), rand(2000), edge)
    planes = (state.keys, state.vals, state.node_max, state.mkba)
    present = fq.flix_point_query_reference(*planes, raw) != core.NOT_FOUND
    dk = torch.sort(torch.where(present, raw, core.EMPTY), stable=True).values
    args = (state.keys, state.vals, state.mkba, dk)
    check.hold("flix_delete", fd.flix_delete_reference(*args), fd.flix_delete_pass(*args), label)
    state = kops.flix_delete(state, raw)
    emptied = int((state.num_nodes == 0).sum())
    assert emptied > 0, label

    # queries on the emptied state: hits and misses, the run around the
    # emptied buckets, and the boundary keys
    top = torch.tensor([0, 1, core.MAX_VALID - 1, core.MAX_VALID, core.EMPTY - 1, core.EMPTY],
                       dtype=torch.int32, device=dev)
    q = sorted_i32(keys[rand(20000, keys.numel()).long()], rand(20000), keys[990:1410:3], top)
    planes = (state.keys, state.vals, state.node_max, state.mkba, q)
    check.hold("flix_point_query", [fq.flix_point_query_reference(*planes)],
               [fq.flix_point_query(*planes)], label)
    check.hold("flix_successor", fs.flix_successor_reference(*planes),
               fs.flix_successor(*planes), label)

    # inserts: fresh keys, the edges, and cap + 40 keys into one bucket's range
    b = state.num_buckets // 2
    lo, hi = int(state.mkba[b - 1]) + 1, int(state.mkba[b])
    flood = lo + torch.randperm(hi - lo + 1, generator=gen, device=dev)[: cap + 40]
    ik = torch.unique(torch.cat([rand(20000), flood.to(torch.int32), edge]))
    iv = rand(ik.numel(), 1 << 30)
    args = (state.keys, state.vals, state.node_max, state.mkba, ik, iv)
    got = fi.flix_insert_pass(*args)
    check.hold("flix_insert", fi.flix_insert_reference(*args), got, label)
    assert int(got[5][b]) == 2, (label, int(got[5][b]))  # pieces and the cut at cap
    log(f"  {label}: delete, point, successor and insert kernels equal their plain "
        f"versions; {emptied} emptied buckets, {int((got[5] > 0).sum())} overflowed")


def phase_kernel_ops(dev, check: KernelCheck):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    log("phase 3d: flix_point_query, flix_successor, flix_insert, flix_delete")
    for ns, npb, n_keys in ((32, 16, 1 << 18), (8, 8, 1 << 18), (32, 64, 1 << 16)):
        kernel_ops_case(dev, check, gen, ns, npb, n_keys)


def query_bytes(state, q, successor: bool) -> int:
    """Bytes a query kernel must move for these queries: each query read
    once and each answer written once, the fences, and the node_max rows,
    node key rows and answer values that these queries touch (for a
    successor past its bucket, the bucket's fence-row pair instead)."""
    nb, npb, ns = state.geometry
    b = torch.searchsorted(state.mkba, q)
    own = b < nb
    b, qo = b[own], q[own]
    nidx = (state.node_max[b] < qo[:, None]).sum(1)
    node = torch.clamp(nidx, max=npb - 1)
    pos = (state.keys[b, node] < qo[:, None]).sum(1)
    pos_c = torch.clamp(pos, max=ns - 1)
    moved = 4 * q.numel() + (8 if successor else 4) * q.numel() + 4 * nb
    moved += 4 * npb * torch.unique(b).numel() + 4 * ns * torch.unique(b * npb + node).numel()
    if successor:
        answered = (nidx < state.num_nodes[b]) & (pos < ns)
        moved += 8 * torch.unique(b[~answered]).numel()
    else:
        answered = (pos < ns) & (state.keys[b, node, pos_c] == qo)
    slot = (b * npb + node) * ns + pos_c
    return moved + 4 * torch.unique(slot[answered]).numel()


def phase_fig9(dev, check: KernelCheck):
    """The paper's Fig. 9 round schedule through the kernel entry points."""
    from repro_torch import core
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import flix_delete as fd
    from repro_torch.kernels import flix_insert as fi
    from repro_torch.kernels import flix_query as fq
    from repro_torch.kernels import flix_successor as fs
    from repro_torch.kernels import ops as kops

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    log(f"phase 5: Fig. 9 schedule on {FULL_KEYS} keys from a {FULL_SPACE} key space: "
        f"4 insert + 4 delete rounds of {FIG9_ROUND} keys through repro_torch.kernels.ops")
    traffic = Traffic(FULL_SPACE, FULL_KEYS, gen)
    keys, vals = traffic.initial()
    state = core.build(keys, vals)
    del keys, vals
    nb, npb, ns = state.geometry
    pool = traffic.perm[FULL_KEYS : FULL_KEYS + 4 * FIG9_ROUND]
    names = ("flix_point_query", "flix_successor", "flix_insert", "flix_delete")
    launches = {k: 0 for k in names}
    times = {k: [] for k in names}
    bounds = {k: [] for k in names}
    plain = {}
    for rnd in range(8):
        ins = rnd < 4
        side_ms = {}  # the entry points' torch passes around the kernels
        chunk = pool[(rnd % 4) * FIG9_ROUND : (rnd % 4 + 1) * FIG9_ROUND]
        upd_k, order = torch.sort(chunk, stable=True)
        upd_v = torch.arange(FIG9_ROUND, dtype=torch.int32, device=dev)[order]
        traffic.alive[chunk.long()] = ins
        live = torch.nonzero(traffic.alive)[:, 0].to(torch.int32)
        hits = torch.sort(live[torch.randint(0, live.numel(), (FIG9_QUERIES,), generator=gen,
                                             device=dev)]).values
        # unique absent keys, a uniform draw of them: cutting the sorted
        # candidates would leave the top of the key space without misses
        cand = torch.unique(traffic._rand_keys(2 * FIG9_QUERIES))
        cand = cand[~traffic.alive[cand.long()]]
        assert cand.numel() >= FIG9_QUERIES, cand.numel()
        pick = torch.randperm(cand.numel(), generator=gen, device=dev)[:FIG9_QUERIES]
        misses = torch.sort(cand[pick]).values
        succ = torch.sort(traffic._rand_keys(FIG9_SUCC)).values
        del live, cand
        torch.cuda.synchronize()

        reset_launches()
        t0 = time.perf_counter()
        if ins:
            new_state, overflow = kops.flix_insert(state, upd_k, upd_v)
        else:
            new_state = kops.flix_delete(state, upd_k)
        v_hit = kops.flix_point_query(new_state, hits)
        v_miss = kops.flix_point_query(new_state, misses)
        s_key, s_val = kops.flix_successor(new_state, succ)
        torch.cuda.synchronize()
        round_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: LAUNCHES[k] for k in names}
        expect = {"flix_point_query": 2 if ins else 3, "flix_successor": 1,
                  "flix_insert": int(ins), "flix_delete": int(not ins)}
        if counts != expect:
            raise AssertionError(f"fig9 round {rnd}: launches {counts}, expected {expect}")
        for k, c in counts.items():
            launches[k] += c

        # every call against the port's core function on the card
        if ins:
            (want, stats), core_upd_ms = host_ms(lambda: core.insert(state, upd_k, upd_v))
            if int(overflow.max()) or int(stats["overflowed_buckets"]):
                raise AssertionError(f"fig9 round {rnd}: an insert overflowed")
        else:
            (want, _), core_upd_ms = host_ms(lambda: core.delete(state, upd_k))
        check_same_state(f"fig9 round {rnd}", new_state, want)
        del want
        w_hit, core_q_ms = host_ms(lambda: core.point_query(new_state, hits))
        w_miss = core.point_query(new_state, misses)
        (w_key, w_val), core_s_ms = host_ms(lambda: core.successor_query(new_state, succ))
        for what, w, g in (("all-hit", w_hit, v_hit), ("all-miss", w_miss, v_miss),
                           ("successor key", w_key, s_key), ("successor val", w_val, s_val)):
            if not torch.equal(w, g):
                raise AssertionError(f"fig9 round {rnd}: {what} differs from core")
        if bool((v_hit == core.NOT_FOUND).any()) or bool((v_miss != core.NOT_FOUND).any()):
            raise AssertionError(f"fig9 round {rnd}: a hit missed or a miss hit")
        del w_hit, w_miss, w_key, w_val

        # the kernels alone on this round's inputs (re-launched, not counted)
        if ins:
            upd_name, upd_fn = "flix_insert", fi.flix_insert_pass
            upd_args = (state.keys, state.vals, state.node_max, state.mkba, upd_k, upd_v)
            extra_bytes = 8 * FIG9_ROUND + 4 * nb  # the batch's keys and vals, overflow
        else:
            upd_name, upd_fn = "flix_delete", fd.flix_delete_pass
            planes = (state.keys, state.vals, state.node_max, state.mkba)

            def prefilter():  # flix_delete's cut to present keys, then its re-sort
                present = fq.flix_point_query(*planes, upd_k) != core.NOT_FOUND
                return torch.sort(torch.where(present, upd_k, core.EMPTY), stable=True).values

            dk = prefilter()
            upd_args = (state.keys, state.vals, state.mkba, dk)
            extra_bytes = 4 * FIG9_ROUND  # the batch's keys
            side_ms["delete pre-filter"] = event_ms(prefilter, 3)
        upd_ms = event_ms(lambda: upd_fn(*upd_args), 3)
        # node_max and the rows that hold keys read, stripes written whole,
        # node_count / node_max rows written, the fences read, num_nodes
        # written
        upd_bytes = (active_row_bytes(state) + state.node_max.nbytes + state.keys.nbytes
                     + state.vals.nbytes + 2 * state.node_max.nbytes + 8 * nb + extra_bytes)
        times[upd_name].append(upd_ms)
        bounds[upd_name].append(upd_bytes / HBM_BYTES_PER_S * 1e3)
        planes = (new_state.keys, new_state.vals, new_state.node_max, new_state.mkba)
        q_ms, q_bytes = [], []
        for q in (hits, misses):
            q_ms.append(event_ms(lambda: fq.flix_point_query(*planes, q), 5))
            q_bytes.append(query_bytes(new_state, q, successor=False))
        nxk, nxv = fs.next_rows(*planes[:3])
        s_ms = event_ms(lambda: fs.successor_pass(*planes, nxk, nxv, succ), 5)
        side_ms["successor fence rows"] = event_ms(lambda: fs.next_rows(*planes[:3]), 5)
        s_bytes = query_bytes(new_state, succ, successor=True)
        times["flix_point_query"] += q_ms
        bounds["flix_point_query"] += [b / HBM_BYTES_PER_S * 1e3 for b in q_bytes]
        times["flix_successor"].append(s_ms)
        bounds["flix_successor"].append(s_bytes / HBM_BYTES_PER_S * 1e3)
        log(f"  round {rnd} ({'insert' if ins else 'delete'} {FIG9_ROUND}): "
            f"{round_ms:.3f} ms for the round's five entry-point calls; "
            f"{upd_name} {upd_ms:.4f} ms (bound {bounds[upd_name][-1]:.4f} ms, {upd_bytes} B, "
            f"{FIG9_ROUND / upd_ms * 1e3:.6g} keys/s), core {core_upd_ms:.3f} ms; "
            f"point all-hit {q_ms[0]:.4f} ms (bound {q_bytes[0] / HBM_BYTES_PER_S * 1e3:.4f} ms, "
            f"{q_bytes[0]} B, {FIG9_QUERIES / q_ms[0] * 1e3:.6g} q/s), all-miss {q_ms[1]:.4f} ms "
            f"(bound {q_bytes[1] / HBM_BYTES_PER_S * 1e3:.4f} ms, {q_bytes[1]} B, "
            f"{FIG9_QUERIES / q_ms[1] * 1e3:.6g} q/s), core {core_q_ms:.3f} ms (all-hit); "
            f"successor {s_ms:.4f} ms (bound {s_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
            f"{s_bytes} B, {FIG9_SUCC / s_ms * 1e3:.6g} q/s), core {core_s_ms:.3f} ms; "
            + "".join(f"{k} {v:.4f} ms; " for k, v in side_ms.items())
            + f"launches {counts}")

        # plain versions at this schedule's shapes, once each: no yardstick
        # of speed, they repeat the kernels' arithmetic
        if rnd in (3, 7):
            want, plain[upd_name] = host_ms(lambda: (fi.flix_insert_reference if ins
                                                     else fd.flix_delete_reference)(*upd_args))
            check.hold(upd_name, want, upd_fn(*upd_args), f"fig9 round {rnd}")
            del want
        if rnd == 7:
            want, plain["flix_point_query"] = host_ms(
                lambda: fq.flix_point_query_reference(*planes, hits))
            check.hold("flix_point_query", [want], [v_hit], "fig9 round 7")
            want, plain["flix_successor"] = host_ms(
                lambda: fs.flix_successor_reference(*planes, succ))
            check.hold("flix_successor", want, (s_key, s_val), "fig9 round 7")
            del want
        state = new_state
        del new_state, upd_args

    _, inv_ms = host_ms(lambda: core.check_invariants(state))
    log(f"  invariants I1-I5 hold on the final state ({inv_ms:.0f} ms); live keys "
        f"{int(state.live_keys())}; launches over the schedule {launches}; plain versions "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in plain.items()))
    return {k: dict(launches=launches[k], ms=fmean(times[k]), plain_ms=plain[k],
                    bound_ms=fmean(bounds[k]), err=check.err[k]) for k in names}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"phase 1: card {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"  nvidia-smi: {smi}")

    t0 = time.perf_counter()
    path, nvcc_log = _build.build()
    _build.load_library()
    log(f"phase 2: built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    check = KernelCheck()
    phase_kernels(dev, check)
    phase_kernel_ops(dev, check)
    measured = phase_main(dev)
    measured.update(phase_fig9(dev, check))

    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        m = measured[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": CSRC + source,
            "replaces": replaces,
            "launches": m["launches"],
            "max_abs_err": max(m["err"], check.err[kname]),
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    # the run drives one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
