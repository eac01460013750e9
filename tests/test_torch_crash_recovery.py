"""Crash-injection proof of the port's durability contract, the counterpart
of ``test_crash_recovery.py`` on ``tests/torch_fault_injection.py``.

THE property, for every kill point: after recovery, (1) no acknowledged
batch is lost, and (2) the recovered index is byte-identical (canonical
payload) to an uninterrupted run at the recovered seq.  That run, the
port's no-durability oracle, is itself byte-identical to the JAX
reference's at every seq.  Kill points cover a half-written log record,
post-fsync/pre-apply, a half-written snapshot payload, pre-rename and
post-commit/pre-GC, before, during and after the workload's restructure
(batch 9 regrows the geometry).  In-process ``CrashError`` leaves the
bytes a process death at that point would (raw ``os.write`` framing);
three subprocesses die by a genuine SIGKILL.  Negative controls: without
fsync acknowledged batches are lost, and with tail truncation disabled a
torn log is refused.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import fault_injection as jfi  # noqa: E402
import torch_fault_injection as fi  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    DurableFliX,
    SnapshotCorruptionError,
    WALCorruptionError,
    load_snapshot_chain,
)
from repro_torch.checkpoint.serialize import canonical_state_bytes  # noqa: E402
from repro_torch.checkpoint.wal import REC_HEADER_SIZE, WriteAheadLog, replay  # noqa: E402
from repro_torch.core.config import ExecConfig  # noqa: E402

torch.set_num_threads(1)

N_BATCHES = 10  # restructure fires at batch 9 (see the harness)
RESUME_BATCHES = 12  # resume tests run past N_BATCHES; the oracle covers both

KILL_EVENTS = (
    "wal.append.partial",  # half a record on disk, no fsync → torn tail
    "wal.append.written",  # full record on disk, fsync not yet returned
    "wal.append.durable",  # fsynced but never applied → replay must run it
    "apply.done",  # applied, possibly pre-snapshot
    "snap.payload.partial",  # half-written snapshot payload in the tmp dir
    "snap.payload.written",
    "snap.manifest.written",
    "snap.before_rename",  # complete tmp dir, never committed
    "snap.committed",  # renamed, WAL not yet rotated / GC'd
    "snap.gc",
)


@functools.lru_cache(maxsize=1)
def _cached_oracle():
    return fi.oracle_canonical(RESUME_BATCHES)


@pytest.fixture(scope="module")
def oracle():
    """Canonical payload after each seq of the uninterrupted workload."""
    return _cached_oracle()


def _crash_run(tmp, event, count, *, n=N_BATCHES, fsync=True, run=None):
    """Run the workload until the hook fires (or completion); returns
    ``(crashed, acked)``."""
    acked = [0]
    try:
        (run or fi.run_workload)(
            tmp,
            n,
            fsync=fsync,
            crash_hook=fi.CrashAt(event, count),
            ack=lambda s: acked.__setitem__(0, s),
        )
        return False, acked[0]
    except fi.CrashError:
        return True, acked[0]


def _check_recovery(tmp, oracle, acked):
    if not DurableFliX.exists(tmp):
        # killed before the very first snapshot committed: nothing was
        # ever acknowledged, so an empty directory is a correct outcome
        assert acked == 0
        return 0
    return fi.recover_and_check(tmp, oracle, acked=acked)


@pytest.mark.parametrize("kind", ["mixed", "ttl"])
def test_port_oracle_matches_the_jax_oracle(oracle, kind):
    """The port's uninterrupted run lands on the JAX reference's canonical
    bytes at every seq, across the restructure and the expiry clock."""
    if kind == "mixed":
        assert oracle == jfi.oracle_canonical(RESUME_BATCHES)
    else:
        assert fi.oracle_canonical_ttl(8) == jfi.oracle_canonical_ttl(8)


# ---------------------------------------------------------------------------
# the deterministic kill-point matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("event", KILL_EVENTS)
@pytest.mark.parametrize("count", [1, 3])
def test_kill_matrix_recovers_byte_identical(tmp_path, oracle, event, count):
    d = tmp_path / "wal"
    crashed, acked = _crash_run(d, event, count)
    seq = _check_recovery(d, oracle, acked)
    if not crashed:  # hook never fired that often — full run must match
        assert seq == N_BATCHES


@pytest.mark.parametrize(
    "event,count", [("wal.append.partial", 4), ("apply.done", 4), ("snap.before_rename", 3)]
)
def test_ttl_kill_recovers_at_the_logged_clock(tmp_path, event, count):
    """The TTL workload: replay runs each batch at its logged ``now``."""
    oracle = fi.oracle_canonical_ttl(8)
    d = tmp_path / "wal"
    crashed, acked = _crash_run(d, event, count, n=8, run=fi.run_workload_ttl)
    assert crashed
    assert _check_recovery(d, oracle, acked) >= acked


def test_kill_during_restructure_window(tmp_path, oracle):
    """Kill right after the batch that regrows the geometry: recovery
    replays across the restructure (an epoch bump) onto the oracle bytes."""
    d = tmp_path / "wal"
    crashed, acked = _crash_run(d, "apply.done", 9)
    assert crashed and acked >= 8
    assert _check_recovery(d, oracle, acked) >= 9


def test_double_crash_and_resume_to_completion(tmp_path, oracle):
    """Crash → resume → crash again (mid-snapshot) → resume → finish."""
    d = tmp_path / "wal"
    crashed, acked = _crash_run(d, "wal.append.partial", 4)
    assert crashed
    fi.recover_and_check(d, oracle, acked=acked)
    _, acked2 = _crash_run(d, "snap.payload.partial", 1)
    fi.recover_and_check(d, oracle, acked=acked2)
    assert fi.run_workload(d, N_BATCHES) == N_BATCHES
    assert fi.recover_and_check(d, oracle, acked=N_BATCHES) == N_BATCHES


def test_crash_during_recovery_snapshot(tmp_path, oracle):
    """open() snapshots when the replayed tail is long; a crash inside
    recovery leaves the directory recoverable."""
    d = tmp_path / "wal"
    crashed, acked = _crash_run(d, "apply.done", 5)
    assert crashed and acked == 4  # batch 5 applied but ack never ran
    with pytest.raises(fi.CrashError):
        DurableFliX.open(
            d,
            engine=fi.make_engine(),
            snapshot_every=2,
            full_every=fi.FULL_EVERY,
            crash_hook=fi.CrashAt("snap.payload.partial", 1),
        )
    assert fi.recover_and_check(d, oracle, acked=acked) == 5


def test_forced_snapshot_at_committed_seq_is_noop(tmp_path, oracle):
    """A forced snapshot at a seq that already has a committed snapshot is
    an idempotent no-op."""
    d = tmp_path / "wal"
    dur = fi.run_workload(d, 0, ret="instance")
    assert dur.snapshot().name.endswith("0" * 12) and dur.seq == 0
    dur.close()
    final = fi.run_workload(d, fi.SNAPSHOT_EVERY, ret="instance")
    before = sorted(x.name for x in d.iterdir())
    assert final.snapshot().is_dir()
    assert sorted(x.name for x in d.iterdir()) == before
    final.close()
    fi.recover_and_check(d, oracle, acked=fi.SNAPSHOT_EVERY)


def test_replayed_restructure_refreshes_fences_for_deltas(tmp_path, oracle):
    """Recovery that replays the restructure batch refreshes the host fence
    copy, so the same instance's later delta snapshot covers the buckets
    that really changed."""
    d = tmp_path / "wal"
    acked = [0]
    with pytest.raises(fi.CrashError):
        fi.run_workload(
            d,
            9,
            snapshot_every=100,  # the only snapshot on disk stays seq 0
            crash_hook=fi.CrashAt("apply.done", 9),
            ack=lambda s: acked.__setitem__(0, s),
        )
    assert acked[0] == 8
    assert fi.run_workload(d, RESUME_BATCHES) == RESUME_BATCHES
    assert fi.recover_and_check(d, oracle, acked=RESUME_BATCHES) == RESUME_BATCHES


def _boom(*a, **k):
    raise RuntimeError("engine OOM")


@pytest.mark.parametrize("rollback", ["works", "fails"])
def test_engine_failure_rolls_back_or_poisons(tmp_path, oracle, rollback):
    """The engine fails after the WAL ack: the record is rolled back and
    the instance stays usable; if the rollback fails too, the instance is
    poisoned (apply and snapshot refused, close still safe), and reopening
    replays the logged batch."""
    d = tmp_path / "wal"
    dur = fi.run_workload(d, 4, ret="instance")
    tag, key, val, mr = fi.make_batch_host(5)
    cfg = ExecConfig(max_results=mr)
    try:
        real_apply = dur.engine.apply
        dur.engine.apply = _boom
        if rollback == "fails":
            def no_rollback(offset):
                raise OSError("disk gone")

            dur._wal.truncate_to = no_rollback
        with pytest.raises(RuntimeError, match="engine OOM"):
            dur.apply(fi.ops_of(tag, key, val), config=cfg)
        assert dur.seq == 4
        if rollback == "works":
            dur.engine.apply = real_apply
            dur.apply(fi.ops_of(tag, key, val), config=cfg)
            assert dur.seq == 5 and dur.healthy
        else:
            assert not dur.healthy and "rolled back" in dur.poisoned_reason
            with pytest.raises(RuntimeError, match="diverged"):
                dur.apply(fi.ops_of(tag, key, val), config=cfg)
            with pytest.raises(RuntimeError, match="diverged"):
                dur.snapshot()
    finally:
        dur.close()
    # either way the durable history holds batch 5 exactly once
    assert fi.recover_and_check(d, oracle, acked=4) == 5


def test_recovery_snapshot_replaces_corrupt_dir_at_its_seq(tmp_path, oracle):
    """open() falls back past a corrupt newest snapshot, replays to its
    seq, and rewrites it."""
    d = tmp_path / "wal"
    fi.run_workload(d, 6)  # auto-snapshots at 3 and 6
    snap = d / "snap_000000000006"
    blob = bytearray((snap / "payload.bin").read_bytes())
    blob[0] ^= 0xFF
    (snap / "payload.bin").write_bytes(bytes(blob))
    with pytest.raises(SnapshotCorruptionError):
        load_snapshot_chain(d, 6)
    assert fi.recover_and_check(d, oracle, acked=6) == 6
    assert load_snapshot_chain(d, 6)[3]["seq"] == 6


# ---------------------------------------------------------------------------
# file-level WAL properties
# ---------------------------------------------------------------------------


def _fill_wal(d, n=6):
    wal = WriteAheadLog(d)
    wal.open_segment(1)
    ends, off = [], 0
    for s in range(1, n + 1):
        payload = bytes([s]) * (20 + 7 * s)
        wal.append(s, payload)
        off += REC_HEADER_SIZE + len(payload)
        ends.append(off)
    wal.close()
    return ends


SEG = "wal_000000000001.log"


def test_short_os_writes_still_frame_whole_records(tmp_path, monkeypatch):
    """``os.write`` may land fewer bytes than asked; appends loop."""
    from repro_torch.checkpoint import wal as wal_mod

    real_write = os.write
    with monkeypatch.context() as mp:
        mp.setattr(wal_mod.os, "write", lambda fd, b: real_write(fd, bytes(b)[:7]))
        ends = _fill_wal(tmp_path, n=4)
    assert (tmp_path / SEG).stat().st_size == ends[-1]
    assert [s for s, _ in replay(tmp_path)] == [1, 2, 3, 4]


@pytest.mark.parametrize("where", ["mid_log", "tail", "old_segment"])
def test_damage_is_a_tear_only_at_the_newest_tail(tmp_path, where):
    """A damaged record followed by readable ones, or in an older segment,
    is corruption and raises; the same damage in the last record of the
    newest segment is a tear and is truncated."""
    if where == "old_segment":
        wal = WriteAheadLog(tmp_path)
        wal.open_segment(1)
        wal.append(1, b"a" * 30)
        wal.rotate(2)
        wal.append(2, b"b" * 30)
        wal.close()
        (tmp_path / SEG).write_bytes((tmp_path / SEG).read_bytes()[:-5])
        with pytest.raises(WALCorruptionError):
            replay(tmp_path)
        return
    ends = _fill_wal(tmp_path)
    data = bytearray((tmp_path / SEG).read_bytes())
    at = REC_HEADER_SIZE + 3 if where == "mid_log" else ends[-2] + REC_HEADER_SIZE + 1
    data[at] ^= 0xFF
    (tmp_path / SEG).write_bytes(bytes(data))
    if where == "mid_log":
        with pytest.raises(WALCorruptionError):
            replay(tmp_path)
    else:
        assert [s for s, _ in replay(tmp_path)] == [1, 2, 3, 4, 5]


# ---------------------------------------------------------------------------
# negative controls: the suite must CATCH a broken durability boundary
# ---------------------------------------------------------------------------


def test_negative_no_fsync_loses_acked_batches(tmp_path, oracle):
    """With the WAL's fsync off, a crash after acknowledged batches loses
    them: recovery lands BELOW the acked seq."""
    d = tmp_path / "wal"
    crashed, acked = _crash_run(d, "apply.done", 5, fsync=False)
    assert crashed and acked >= 4
    dur = DurableFliX.open(
        d, engine=fi.make_engine(), snapshot_every=fi.SNAPSHOT_EVERY,
        full_every=fi.FULL_EVERY,
    )
    try:
        assert dur.seq < acked, "un-fsynced WAL unexpectedly durable"
        assert canonical_state_bytes(dur.state) != oracle[acked]
        assert canonical_state_bytes(dur.state) == oracle[dur.seq]
    finally:
        dur.close()


def test_negative_truncation_disabled_refuses_torn_tail(tmp_path, oracle):
    """With tail truncation off, recovery raises on a mid-append crash;
    the default policy recovers the same directory."""
    d = tmp_path / "wal"
    crashed, acked = _crash_run(d, "wal.append.partial", 5)
    assert crashed
    with pytest.raises(WALCorruptionError):
        DurableFliX.open(d, engine=fi.make_engine(), truncate_torn=False)
    fi.recover_and_check(d, oracle, acked=acked)


# ---------------------------------------------------------------------------
# subprocess SIGKILL: genuine process death (each child pays a torch import)
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parents[1]
CHILD_BATCHES = 6


@pytest.mark.parametrize(
    "event,count,fsync",
    [("wal.append.partial", 4, True), ("snap.before_rename", 2, True),
     ("apply.done", 5, False)],
)
def test_sigkill_subprocess(tmp_path, oracle, event, count, fsync):
    """A child killed by SIGKILL at the event recovers every acked batch
    onto the oracle; without fsync (the negative control) acked batches are
    genuinely lost."""
    d = tmp_path / "wal"
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_fault_injection.py"),
         "--dir", str(d), "--batches", str(CHILD_BATCHES), "--kill-event", event,
         "--kill-count", str(count), *([] if fsync else ["--no-fsync"])],
        capture_output=True,
        text=True,
        timeout=180,
        env={**os.environ, "PYTHONPATH": f"{REPO}/src"},
        cwd=str(REPO),
    )
    acked = max((int(line.split()[1]) for line in proc.stdout.splitlines()
                 if line.startswith("ACK ")), default=0)
    assert proc.returncode == -9, f"child not SIGKILLed:\n{proc.stderr}"
    if fsync:
        assert _check_recovery(d, oracle, acked) >= acked
        return
    assert acked >= 4
    dur = DurableFliX.open(d, engine=fi.make_engine())
    try:
        assert dur.seq < acked
    finally:
        dur.close()
