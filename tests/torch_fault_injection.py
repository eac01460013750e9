"""Crash-injection harness for the port's durability layer
(``repro_torch.checkpoint``), the counterpart of ``fault_injection.py``:
the same workload, geometry, events and hooks, importing only
``repro_torch`` (on the CPU).

Three pieces, shared by ``test_torch_crash_recovery.py`` and runnable
directly as a subprocess child:

* a **deterministic workload** — ``make_batch_host(t, seed)`` is a pure
  function of the batch seq, so an interrupted run, its resumption, and
  the uninterrupted oracle all generate byte-identical op streams;
* an **oracle** — ``oracle_canonical`` runs the same engine with no
  durability layer at all and records the canonical payload after every
  batch; recovery at seq ``s`` must reproduce ``oracle[s]`` exactly;
* **crash hooks** — ``CrashAt`` raises inside the instrumented points of
  ``WriteAheadLog.append`` / ``DurableFliX.snapshot`` (every file write
  there is a raw ``os.write``, so an exception leaves bytes on disk
  identical to a process death at that instruction), and ``KillAt``
  escalates to a genuine uncatchable ``SIGKILL`` for the subprocess
  matrix.

Run as a script it becomes the child process::

    python tests/torch_fault_injection.py --dir D --batches 8 \
        --kill-event wal.append.partial --kill-count 3

printing ``ACK <seq>`` (flushed) after each durably applied batch, so the
parent knows exactly which batches were acknowledged before the kill.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import DurableFliX, LocalEngine  # noqa: E402
from repro_torch.checkpoint.serialize import canonical_state_bytes  # noqa: E402
from repro_torch.core.config import ExecConfig  # noqa: E402
from repro_torch.core.expiry import NO_EXPIRY  # noqa: E402
from repro_torch.core.ops import (  # noqa: E402
    OP_DELETE,
    OP_EXPIRE,
    OP_INSERT,
    OP_POINT,
    OP_RANGE,
    OP_SUCCESSOR,
    OpBatch,
)

# tiny geometry so per-bucket overflow (→ restructure) happens inside a
# short workload, and the whole sweep stays in the fast CI lane
KEY_SPACE = 4096
BATCH = 48
N_INITIAL = 400
GEOMETRY = dict(node_size=8, nodes_per_bucket=4)
SNAPSHOT_EVERY = 3
FULL_EVERY = 2
HEAVY_EVERY = 3  # every 3rd batch is insert-heavy (drives restructure)


def make_engine(**overrides) -> LocalEngine:
    return LocalEngine(**{**GEOMETRY, "device": "cpu", **overrides})


def ops_of(tag, key, val, exp=None) -> OpBatch:
    return OpBatch.from_host(tag, key, val, exp, device="cpu")


def initial_pairs(seed: int = 0):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(KEY_SPACE, N_INITIAL, replace=False)).astype(np.int32)
    vals = (keys * 7 + 1).astype(np.int32)
    return keys, vals


def make_batch_host(t: int, seed: int = 0):
    """Batch ``t`` of the workload: ``(tag, key, val, max_results)``, host
    arrays sorted by key.  Pure function of ``(t, seed)`` — the whole
    harness depends on that."""
    rng = np.random.default_rng((seed + 1) * 10_000 + t)
    if t % HEAVY_EVERY == 0:
        # insert-heavy AND clustered: 40 fresh keys inside a ~600-wide
        # window span only a handful of buckets, so successive heavy
        # batches overflow a chain and force a mid-workload restructure
        base = 1000  # same window every heavy batch: load accumulates
        keys = np.concatenate(
            [
                base + rng.choice(600, 40, replace=False),
                rng.choice(KEY_SPACE, BATCH - 40, replace=False),
            ]
        ).astype(np.int32)
        tag = np.where(np.arange(BATCH) < 40, OP_INSERT, OP_POINT).astype(np.int32)
    else:
        keys = rng.choice(KEY_SPACE, BATCH, replace=False).astype(np.int32)
        tag = rng.choice(
            np.array([OP_INSERT, OP_DELETE, OP_POINT, OP_SUCCESSOR], np.int32),
            BATCH,
            p=[0.3, 0.25, 0.25, 0.2],
        )
        tag[: 2 + t % 3] = OP_RANGE  # a few ranges ride along
    vals = (keys * 13 + t).astype(np.int32)
    is_range = tag == OP_RANGE
    vals[is_range] = np.minimum(keys[is_range] + 200, KEY_SPACE)  # hi bound
    order = np.argsort(keys, kind="stable")
    max_results = 32 if t % 2 else 64
    return tag[order], keys[order], vals[order], max_results


def oracle_canonical(n_batches: int, seed: int = 0, engine=None) -> list[bytes]:
    """Canonical payload after each seq, uninterrupted: ``oracle[s]`` is
    the expected bytes of any recovery that lands on seq ``s``."""
    engine = engine or make_engine()
    handle = engine.rebuild(*initial_pairs(seed))
    out = [canonical_state_bytes(engine.flix(handle))]
    for t in range(1, n_batches + 1):
        tag, key, val, mr = make_batch_host(t, seed)
        handle, _res, _stats, _r = engine.apply(
            handle, ops_of(tag, key, val), max_results=mr
        )
        out.append(canonical_state_bytes(engine.flix(handle)))
    return out


# ---------------------------------------------------------------------------
# the TTL workload: same determinism contract, plus a
# virtual clock that is itself a pure function of the batch seq — batch t
# executes at now = t * TTL_TICK, the WAL logs that now, and recovery
# replays each batch at its LOGGED clock (never the wall clock), so an
# interrupted run, its resumption, and the oracle reach byte-identical
# expiry state no matter when the processes actually ran.
# ---------------------------------------------------------------------------

TTL_TICK = 16  # virtual time elapsing between consecutive batches


def initial_pairs_ttl(seed: int = 0):
    """Initial pairs with a deadline column: ~40% carry TTLs spread over
    the first half of the workload's clock, the rest never expire."""
    keys, vals = initial_pairs(seed)
    rng = np.random.default_rng((seed + 1) * 77_000)
    exps = np.where(
        rng.random(keys.shape) < 0.4,
        rng.integers(1, 10 * TTL_TICK, keys.shape),
        int(NO_EXPIRY),
    ).astype(np.int32)
    return keys, vals, exps


def make_batch_host_ttl(t: int, seed: int = 0):
    """TTL batch ``t``: ``(tag, key, val, exp, now, max_results)``, host
    arrays sorted by key, ``now = t * TTL_TICK``.  Pure function of
    ``(t, seed)`` — clock included."""
    rng = np.random.default_rng((seed + 3) * 10_000 + t)
    now = t * TTL_TICK
    keys = rng.choice(KEY_SPACE, BATCH, replace=False).astype(np.int32)
    tag = rng.choice(
        np.array([OP_INSERT, OP_EXPIRE, OP_DELETE, OP_POINT, OP_SUCCESSOR], np.int32),
        BATCH,
        p=[0.3, 0.2, 0.15, 0.2, 0.15],
    )
    tag[: 2 + t % 3] = OP_RANGE  # a few ranges ride along
    vals = (keys * 13 + t).astype(np.int32)
    is_range = tag == OP_RANGE
    vals[is_range] = np.minimum(keys[is_range] + 200, KEY_SPACE)  # hi bound
    # deadlines cluster around now: some dead-on-arrival, most
    # fall due within the next few batches, EXPIRE always refreshes forward
    writes = (tag == OP_INSERT) | (tag == OP_EXPIRE)
    exp = np.full(BATCH, int(NO_EXPIRY), np.int32)
    exp[writes] = now + rng.integers(
        -TTL_TICK // 2, 5 * TTL_TICK, int(writes.sum())
    ).astype(np.int32)
    order = np.argsort(keys, kind="stable")
    max_results = 32 if t % 2 else 64
    return tag[order], keys[order], vals[order], exp[order], now, max_results


def oracle_canonical_ttl(n_batches: int, seed: int = 0, engine=None) -> list[bytes]:
    """TTL analogue of ``oracle_canonical``: canonical payload (expiry
    column included) after each seq of the uninterrupted TTL run."""
    engine = engine or make_engine()
    handle = engine.rebuild(*initial_pairs_ttl(seed))
    out = [canonical_state_bytes(engine.flix(handle))]
    for t in range(1, n_batches + 1):
        tag, key, val, exp, now, mr = make_batch_host_ttl(t, seed)
        handle, _res, _stats, _r = engine.apply(
            handle, ops_of(tag, key, val, exp), max_results=mr, now=now
        )
        out.append(canonical_state_bytes(engine.flix(handle)))
    return out


def run_workload_ttl(
    directory,
    n_batches: int,
    *,
    seed: int = 0,
    snapshot_every: int = SNAPSHOT_EVERY,
    full_every: int = FULL_EVERY,
    fsync: bool = True,
    crash_hook=None,
    engine=None,
    ack=None,
):
    """TTL analogue of ``run_workload``: create-or-recover in
    ``directory`` and apply TTL batches (each at its own virtual ``now``)
    until seq reaches ``n_batches``."""
    engine = engine or make_engine()
    if DurableFliX.exists(directory):
        dur = DurableFliX.open(
            directory,
            engine=engine,
            snapshot_every=snapshot_every,
            full_every=full_every,
            fsync=fsync,
            crash_hook=crash_hook,
        )
    else:
        dur = DurableFliX.create(
            directory,
            engine.rebuild(*initial_pairs_ttl(seed)),
            engine=engine,
            snapshot_every=snapshot_every,
            full_every=full_every,
            fsync=fsync,
            crash_hook=crash_hook,
        )
    while dur.seq < n_batches:
        tag, key, val, exp, now, mr = make_batch_host_ttl(dur.seq + 1, seed)
        dur.apply(
            ops_of(tag, key, val, exp),
            config=ExecConfig(max_results=mr),
            now=now,
        )
        if ack is not None:
            ack(dur.seq)
    dur.close()
    return dur.seq


# ---------------------------------------------------------------------------
# crash hooks
# ---------------------------------------------------------------------------


class CrashError(BaseException):
    """Simulated process death (BaseException: nothing may catch it)."""


class CrashAt:
    """Fire at the ``count``-th occurrence of ``event``."""

    def __init__(self, event: str, count: int = 1):
        self.event = event
        self.count = count
        self.seen = 0

    def __call__(self, event: str) -> None:
        if event == self.event:
            self.seen += 1
            if self.seen == self.count:
                self.fire()

    def fire(self):
        raise CrashError(f"{self.event}#{self.count}")


class KillAt(CrashAt):
    """Genuine process death: uncatchable, no flushing, no atexit."""

    def fire(self):
        os.kill(os.getpid(), signal.SIGKILL)


# ---------------------------------------------------------------------------
# the workload runner (parent in-process, or subprocess child via __main__)
# ---------------------------------------------------------------------------


def run_workload(
    directory,
    n_batches: int,
    *,
    seed: int = 0,
    snapshot_every: int = SNAPSHOT_EVERY,
    full_every: int = FULL_EVERY,
    fsync: bool = True,
    crash_hook=None,
    engine=None,
    ack=None,
    ret: str = "seq",
):
    """Create-or-recover a durable index in ``directory`` and apply the
    deterministic workload until seq reaches ``n_batches``.  ``ack(seq)``
    fires after each durably applied batch.  Returns the final seq, or the
    still-open instance with ``ret="instance"``."""
    engine = engine or make_engine()
    if DurableFliX.exists(directory):
        dur = DurableFliX.open(
            directory,
            engine=engine,
            snapshot_every=snapshot_every,
            full_every=full_every,
            fsync=fsync,
            crash_hook=crash_hook,
        )
    else:
        dur = DurableFliX.create(
            directory,
            engine.rebuild(*initial_pairs(seed)),
            engine=engine,
            snapshot_every=snapshot_every,
            full_every=full_every,
            fsync=fsync,
            crash_hook=crash_hook,
        )
    while dur.seq < n_batches:
        tag, key, val, mr = make_batch_host(dur.seq + 1, seed)
        dur.apply(ops_of(tag, key, val), config=ExecConfig(max_results=mr))
        if ack is not None:
            ack(dur.seq)
    if ret == "instance":
        return dur
    dur.close()
    return dur.seq


def recover_and_check(
    directory,
    oracle: list[bytes],
    *,
    acked: int = 0,
    engine=None,
    snapshot_every: int = SNAPSHOT_EVERY,
    full_every: int = FULL_EVERY,
    **open_kw,
):
    """THE durability property.  Recover and assert:

    1. no acknowledged batch was lost (``seq >= acked``), and
    2. the recovered state is byte-identical to the uninterrupted run at
       that seq (``canonical == oracle[seq]``).

    Returns the recovered seq."""
    dur = DurableFliX.open(
        directory,
        engine=engine or make_engine(),
        snapshot_every=snapshot_every,
        full_every=full_every,
        **open_kw,
    )
    try:
        seq = dur.seq
        assert seq >= acked, f"lost acked batches: recovered {seq} < acked {acked}"
        assert seq < len(oracle), f"recovered seq {seq} beyond oracle"
        got = canonical_state_bytes(dur.state)
        assert got == oracle[seq], f"recovered state at seq {seq} != oracle"
    finally:
        dur.close()
    return seq


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-event", default=None)
    ap.add_argument("--kill-count", type=int, default=1)
    ap.add_argument("--no-fsync", action="store_true")
    ap.add_argument("--snapshot-every", type=int, default=SNAPSHOT_EVERY)
    args = ap.parse_args()

    hook = KillAt(args.kill_event, args.kill_count) if args.kill_event else None
    seq = run_workload(
        args.dir,
        args.batches,
        seed=args.seed,
        snapshot_every=args.snapshot_every,
        fsync=not args.no_fsync,
        crash_hook=hook,
        ack=lambda s: print(f"ACK {s}", flush=True),
    )
    print(f"DONE {seq}", flush=True)


if __name__ == "__main__":
    main()
