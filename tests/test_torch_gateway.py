"""The port's serving gateway (``repro_torch.serve.gateway``) against the
JAX reference's, and on its own, on the CPU.

* **Differential** — the hostile population of ``traffic_replay.py`` runs
  through both packages' gateways in lockstep (``Lockstep`` of
  ``torch_traffic_replay.py``), once durable and once not: after every
  pump the reports, every ticket (values and their dtypes included), the
  metrics and the canonical state bytes are equal, and the durable run
  leaves two byte-identical directories.
* **The contract on the port** — the counterparts of ``test_gateway.py``
  (the soak against the single-client oracle, duplicates through the
  request lifecycle, admission control, degraded modes, the crash matrix
  at the gateway's commit path × the WAL seam, two SIGKILL children of
  ``torch_traffic_replay.py``) and of ``test_system.py``'s pinned-read
  test (``as_of``, SNAPSHOT_GONE, INVALID).
* **Cross-open** — a directory that one package's gateway crashed in
  between commit and ack is reopened by the other's: the retry of the
  crashed batch resolves as a duplicate and the state matches the port's
  oracle.

The gateway soak on the card against the same soak on the CPU is in
``test_torch_kernels_cuda.py``, which imports no JAX.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fault_injection as jfi  # noqa: E402
import torch_fault_injection as fi  # noqa: E402
import torch_traffic_replay as tr  # noqa: E402
import traffic_replay as jtr  # noqa: E402
from repro.checkpoint.serialize import canonical_state_bytes as j_canonical  # noqa: E402
from repro.serve.gateway import Request as JRequest  # noqa: E402
from repro_torch.checkpoint.serialize import canonical_state_bytes  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    DEADLINE_EXCEEDED,
    ENGINE_FAILURE,
    INVALID,
    QUEUE_FULL,
    RATE_LIMITED,
    SNAPSHOT_GONE,
    UNAVAILABLE,
    UNKNOWN_COMMIT,
    Gateway,
    KVPageIndex,
    Request,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
DIFF_TICKS = 12  # the differential's ticks: past the first restructure retry


def _alloc(key, seq, pages=(0,), tenant="t0", deadline=None):
    return Request(
        tenant,
        key,
        "alloc",
        seqs=(seq,) * len(pages),
        pages=tuple(pages),
        slots=tuple(seq * 100 + p for p in pages),
        deadline=deadline,
    )


def _state_bytes(index):
    return canonical_state_bytes(index.state)


def _to_ref(req: Request) -> JRequest:
    return JRequest(**dataclasses.asdict(req))


# ---------------------------------------------------------------------------
# the differential: both packages' gateways, compared after every pump
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("durable", [False, True])
def test_differential_vs_reference_every_pump(tmp_path, durable):
    dirs = (tmp_path / "port", tmp_path / "ref") if durable else (None, None)
    port = tr.make_gateway(tr.make_index(durability_dir=dirs[0]))
    ref = jtr.make_gateway(jtr.make_index(durability_dir=dirs[1]))
    twin = tr.Lockstep(
        port, ref, to_b=_to_ref, bytes_a=canonical_state_bytes, bytes_b=j_canonical
    )
    twin.register_tenant("tenant-hot", rate=24, burst=48, weight=3.0)
    twin.register_tenant("tenant-mid", rate=16, burst=32)
    res = tr.run_traffic(twin, tr.default_population(0), ticks=DIFF_TICKS, seed=0)
    assert twin.pumps == res.end_tick >= DIFF_TICKS
    m = port.metrics
    # the population's misbehaviour and the safe path's retry were exercised
    assert m["duplicates"] > 0 and m["restructure_retries"] >= 1
    assert m["rejected"].get(RATE_LIMITED, 0) > 0
    assert m["rejected"].get(DEADLINE_EXCEEDED, 0) > 0
    lookups = [tk for tk, _ in twin.pairs.values() if tk.ok and tk.request.kind == "lookup"]
    pages = [tk for tk, _ in twin.pairs.values() if tk.ok and tk.request.kind == "pages"]
    assert lookups and pages
    assert all(tk.value.dtype == np.int32 for tk in lookups)
    port.close(now=float(res.end_tick))
    ref.close(now=float(res.end_tick))
    if durable:
        got, want = tr.dir_bytes(dirs[0]), tr.dir_bytes(dirs[1])
        assert got.keys() == want.keys()
        for name in want:
            assert got[name] == want[name], name


# ---------------------------------------------------------------------------
# the contract on the port: counterparts of test_gateway.py
# ---------------------------------------------------------------------------


def test_soak_differential_vs_oracle():
    idx = tr.make_index()
    gw = tr.make_gateway(idx)
    gw.register_tenant("tenant-hot", rate=24, burst=48, weight=3.0)
    gw.register_tenant("tenant-mid", rate=16, burst=32)
    res = tr.run_traffic(gw, tr.default_population(0), ticks=20, seed=0)
    upd = tr.assert_exactly_once(res.requests, res.commit_log)
    assert len(upd) > 50
    assert tr.oracle_state_bytes(res.requests, upd) == _state_bytes(idx)
    m = gw.metrics
    assert m["duplicates"] > 0
    assert m["rejected"].get(RATE_LIMITED, 0) > 0
    assert m["rejected"].get(DEADLINE_EXCEEDED, 0) > 0
    assert m["engine_failures"] == 0
    assert gw.queue_depth <= gw.max_queue_ops
    assert m["restructure_retries"] >= 1


def test_soak_read_results_are_request_scoped():
    idx = tr.make_index()
    gw = tr.make_gateway(idx)
    gw.submit(_alloc("a", seq=5, pages=(0, 1, 2)), now=0.0)
    gw.pump(now=0.0)
    t_lu = gw.submit(
        Request("t0", "lu", "lookup", seqs=(5, 5, 9), pages=(1, 2, 0)), now=1.0
    )
    t_pg = gw.submit(Request("t1", "pg", "pages", seqs=(5,)), now=1.0)
    gw.pump(now=1.0)
    assert list(t_lu.result()) == [501, 502, -1]
    assert t_lu.result().dtype == np.int32
    (pages,) = t_pg.result()
    assert pages["count"] == 3
    assert list(pages["pages"]) == [0, 1, 2] and pages["pages"].dtype == np.int32
    assert list(pages["slots"]) == [500, 501, 502] and pages["slots"].dtype == np.int32


def test_duplicate_before_ack_returns_same_ticket():
    gw = tr.make_gateway(tr.make_index())
    t1 = gw.submit(_alloc("k1", 3), now=0.0)
    t2 = gw.submit(_alloc("k1", 3), now=0.0)
    assert t2 is t1
    assert gw.metrics["duplicates"] == 1
    gw.pump(now=0.0)
    assert t1.ok and not t1.duplicate
    assert gw.metrics["committed_requests"] == 1


def test_duplicate_after_ack_resolves_without_recommit():
    idx = tr.make_index()
    gw = tr.make_gateway(idx)
    t1 = gw.submit(_alloc("k1", 3), now=0.0)
    gw.pump(now=0.0)
    before = _state_bytes(idx)
    t2 = gw.submit(_alloc("k1", 3), now=1.0)
    assert t2.ok and t2.duplicate and t2.commit_seq == t1.commit_seq
    assert gw.pump(now=1.0).n_ops == 0
    assert _state_bytes(idx) == before
    assert gw.metrics["committed_requests"] == 1


def test_duplicate_across_crash_recovery(tmp_path):
    d = tmp_path / "wal"
    idx = tr.make_index(durability_dir=d)
    gw = tr.make_gateway(idx)
    gw.submit(_alloc("k1", 3, pages=(0, 1)), now=0.0)
    gw.pump(now=0.0)
    before = _state_bytes(idx)
    idx2 = tr.make_index(durability_dir=d)  # no clean close: death after the ack
    gw2 = tr.make_gateway(idx2)
    t = gw2.submit(_alloc("k1", 3, pages=(0, 1)), now=0.0)
    assert t.ok and t.duplicate
    assert gw2.pump(now=0.0).n_ops == 0
    assert _state_bytes(idx2) == before
    gw2.submit(_alloc("k2", 4), now=1.0)
    assert gw2.pump(now=1.0).committed_keys == ["k2"]
    gw2.close(now=2.0)


def test_dedup_window_is_bounded():
    gw = tr.make_gateway(tr.make_index(), dedup_window=4)
    for i in range(8):
        gw.submit(_alloc(f"k{i}", i), now=float(i))
        gw.pump(now=float(i))
    assert len(gw._committed) == 4
    assert not gw.submit(_alloc("k0", 0), now=9.0).done  # re-admitted
    assert gw.submit(_alloc("k7", 7), now=9.0).duplicate


def test_deadline_rejected_at_admission_and_expired_at_formation():
    gw = tr.make_gateway(tr.make_index())
    t1 = gw.submit(_alloc("k1", 1, deadline=5.0), now=5.0)
    assert t1.error.code == DEADLINE_EXCEEDED and not t1.error.retryable
    t2 = gw.submit(_alloc("k2", 2, deadline=3.0), now=0.0)
    report = gw.pump(now=4.0)
    assert t2.error.code == DEADLINE_EXCEEDED
    assert report.expired == 1 and report.committed_keys == []
    assert gw.metrics["expired"] == 1
    assert gw.queue_depth == 0


def test_rate_limit_typed_with_retry_after_then_refills():
    gw = tr.make_gateway(tr.make_index())
    gw.register_tenant("t0", rate=1.0, burst=2.0, now=0.0)
    assert not gw.submit(_alloc("a", 1), now=0.0).done
    assert not gw.submit(_alloc("b", 2), now=0.0).done
    t3 = gw.submit(_alloc("c", 3), now=0.0)
    assert t3.error.code == RATE_LIMITED and t3.error.retryable
    assert t3.error.retry_after == pytest.approx(1.0)
    assert not gw.submit(_alloc("c", 3), now=1.0).done


def test_queue_full_sheds_with_bounded_depth_and_burns_no_tokens():
    gw = tr.make_gateway(tr.make_index(), max_batch_ops=4, max_queue_ops=8)
    for i in range(8):
        assert not gw.submit(_alloc(f"k{i}", i, tenant=f"t{i}"), now=0.0).done
    t = gw.submit(_alloc("k8", 8, tenant="t8"), now=0.0)
    assert t.error.code == QUEUE_FULL and t.error.retryable
    assert t.error.retry_after >= 1.0
    assert gw.queue_depth == 8 <= gw.max_queue_ops
    gw.pump(now=0.0)
    assert not gw.submit(_alloc("k8", 8, tenant="t8"), now=0.0).done


def test_oversized_request_is_invalid_not_queued():
    gw = tr.make_gateway(tr.make_index(), max_batch_ops=4, max_pages=8)
    t = gw.submit(Request("t0", "f", "free", seqs=(1,)), now=0.0)  # cost 8
    assert t.error.code == INVALID and not t.error.retryable


def test_weighted_fairness_shares_and_no_starvation():
    gw = tr.make_gateway(tr.make_index(), max_batch_ops=8, max_queue_ops=2048)
    gw.register_tenant("heavy", rate=1e9, burst=1e9, weight=3.0, now=0.0)
    gw.register_tenant("light", rate=1e9, burst=1e9, weight=1.0, now=0.0)
    for i in range(40):
        gw.submit(Request("heavy", f"h{i}", "lookup", seqs=(i,), pages=(0,)), now=0.0)
        gw.submit(Request("light", f"l{i}", "lookup", seqs=(i,), pages=(0,)), now=0.0)
    report = gw.pump(now=0.0)
    assert len(report.committed_keys) == 8
    assert sum(k.startswith("h") for k in report.committed_keys) == 6
    for _ in range(3):
        report = gw.pump(now=0.0)
        assert any(k.startswith("l") for k in report.committed_keys)


def _poison(idx):
    """Drive the real poisoning path: engine failure + failed rollback."""

    def boom(*a, **k):
        raise RuntimeError("engine OOM")

    def no_rollback(offset):
        raise OSError("disk gone")

    idx._durable.engine.apply = boom
    idx._durable._wal.truncate_to = no_rollback


def test_poisoned_update_path_degrades_to_read_only(tmp_path):
    idx = tr.make_index(durability_dir=tmp_path / "wal")
    gw = tr.make_gateway(idx)
    gw.submit(_alloc("a", 5, pages=(0, 1)), now=0.0)
    gw.pump(now=0.0)
    _poison(idx)
    t = gw.submit(_alloc("b", 6), now=1.0)
    rep = gw.pump(now=1.0)
    assert t.error.code == UNKNOWN_COMMIT and t.error.retryable
    assert rep.failed_code == UNKNOWN_COMMIT
    assert not idx.healthy
    t2 = gw.submit(_alloc("c", 7), now=2.0)
    assert t2.error.code == UNAVAILABLE and "degraded" in t2.error.detail
    t3 = gw.submit(Request("t0", "r", "lookup", seqs=(5, 5), pages=(0, 1)), now=2.0)
    gw.pump(now=2.0)
    assert list(t3.result()) == [500, 501]
    assert idx.snapshot() is None
    gw.close(now=3.0)
    gw.close(now=3.0)
    idx.close()
    assert not idx.healthy


def test_engine_failure_without_durability_is_typed_and_recoverable():
    idx = tr.make_index()
    gw = tr.make_gateway(idx)
    real_step = idx.step
    idx.step = lambda **k: (_ for _ in ()).throw(RuntimeError("engine OOM"))
    t = gw.submit(_alloc("a", 1), now=0.0)
    rep = gw.pump(now=0.0)
    assert t.status == "failed" and t.error.code == ENGINE_FAILURE
    assert rep.failed_code == ENGINE_FAILURE
    assert gw.metrics["engine_failures"] == 1
    assert gw.queue_depth == 0
    idx.step = real_step
    gw.submit(_alloc("a", 1), now=1.0)
    assert gw.pump(now=1.0).committed_keys == ["a"]


def test_kernel_refusal_is_an_engine_failure_rolled_back(tmp_path):
    """A stripe kernel refused for its shared memory (``check_smem``'s
    ValueError on the card) fails the durable step like any engine error:
    ENGINE_FAILURE, the WAL record rolled back, the update path healthy,
    and the same key commits once the engine runs again."""
    idx = tr.make_index(durability_dir=tmp_path / "wal")
    gw = tr.make_gateway(idx)
    engine_apply = idx._durable.engine.apply

    def refused(*a, **k):
        raise ValueError(
            "flix_apply_staged: geometry (npb=64, ns=2048) needs 1048576 bytes of "
            "shared memory per block; this card allows 232448"
        )

    idx._durable.engine.apply = refused
    t = gw.submit(_alloc("a", 1), now=0.0)
    rep = gw.pump(now=0.0)
    assert t.status == "failed" and t.error.code == ENGINE_FAILURE
    assert rep.failed_code == ENGINE_FAILURE and idx.healthy
    assert idx.durable_seq == 0 and idx.dedup_seed() == []
    idx._durable.engine.apply = engine_apply
    gw.submit(_alloc("a", 1), now=1.0)
    assert gw.pump(now=1.0).committed_keys == ["a"]
    assert idx.durable_seq == 1 and idx.dedup_seed() == [(1, {"keys": ["a"]})]
    gw.close(now=2.0)


def test_close_rejects_queued_and_is_idempotent(tmp_path):
    idx = tr.make_index(durability_dir=tmp_path / "wal")
    gw = tr.make_gateway(idx)
    t = gw.submit(_alloc("a", 1), now=0.0)
    gw.close(now=1.0)
    assert t.error.code == UNAVAILABLE and t.error.retryable
    gw.close(now=1.0)
    t2 = gw.submit(_alloc("b", 2), now=2.0)
    assert t2.error.code == UNAVAILABLE and "closed" in t2.error.detail


CRASH_POINTS = [(e, 2) for e in fi.GATEWAY_EVENTS] + [
    ("wal.append.partial", 3),
    ("wal.append.durable", 3),
    ("apply.done", 4),
]


def _crash_traffic(d, event, count, *, seed=1, ticks=10):
    hook = fi.CrashAt(event, count)
    idx = tr.make_index(durability_dir=d, crash_hook=hook)
    gw = tr.make_gateway(idx, crash_hook=hook)
    try:
        tr.run_traffic(gw, tr.default_population(seed), ticks=ticks, seed=seed)
        return False
    except fi.CrashError:
        return True


def _recover_and_check(d, *, seed=1, ticks=10):
    """Reopen, resubmit everything, prove exactly-once and the oracle's
    bytes over the full commit order; returns the surviving commits."""
    requests = tr.regen_all_requests(tr.default_population(seed), ticks, seed)
    idx = tr.make_index(durability_dir=d)
    gw = tr.make_gateway(idx)
    surviving = tr.surviving_update_commits(idx, requests)
    res = tr.run_traffic(gw, tr.default_population(seed), ticks=ticks, seed=seed)
    full_log = surviving + tr.committed_update_keys(requests, res.commit_log)
    assert len(set(full_log)) == len(full_log), "a key committed twice"
    assert tr.oracle_state_bytes(requests, full_log) == _state_bytes(idx)
    gw.close(now=float(res.end_tick))
    return len(surviving)


@pytest.mark.parametrize("event,count", CRASH_POINTS)
def test_crash_matrix_gateway_commit_path(tmp_path, event, count):
    d = tmp_path / "wal"
    assert _crash_traffic(d, event, count), f"hook {event}#{count} never fired"
    _recover_and_check(d)


def test_crash_between_commit_and_ack_resolves_as_duplicate(tmp_path):
    d = tmp_path / "wal"
    hook = fi.CrashAt("gateway.step.done", 1)
    idx = tr.make_index(durability_dir=d, crash_hook=hook)
    gw = tr.make_gateway(idx, crash_hook=hook)
    t = gw.submit(_alloc("k1", 3, pages=(0, 1)), now=0.0)
    with pytest.raises(fi.CrashError):
        gw.pump(now=0.0)
    assert not t.done
    idx2 = tr.make_index(durability_dir=d)
    before = _state_bytes(idx2)
    gw2 = tr.make_gateway(idx2)
    t2 = gw2.submit(_alloc("k1", 3, pages=(0, 1)), now=0.0)
    assert t2.ok and t2.duplicate
    assert _state_bytes(idx2) == before
    gw2.close(now=1.0)


SIGKILL_POINTS = [("wal.append.partial", 6), ("gateway.step.done", 8)]


@pytest.mark.parametrize("event,count", SIGKILL_POINTS)
def test_sigkill_subprocess_gateway(tmp_path, event, count):
    d = tmp_path / "wal"
    seed, ticks = 3, 12
    proc = subprocess.run(
        [
            sys.executable,
            str(REPO / "tests" / "torch_traffic_replay.py"),
            "--dir", str(d),
            "--ticks", str(ticks),
            "--seed", str(seed),
            "--kill-event", event,
            "--kill-count", str(count),
        ],
        capture_output=True,
        text=True,
        timeout=600,
        env={**os.environ, "PYTHONPATH": f"{REPO}/src"},
        cwd=str(REPO),
    )
    assert proc.returncode == -9, f"child not SIGKILLed:\n{proc.stderr}"
    requests = tr.regen_all_requests(tr.default_population(seed), ticks, seed)
    acked = []
    for line in proc.stdout.splitlines():
        if line.startswith("COMMIT "):
            acked.extend(k for k in line.split()[1].split(",") if requests[k].is_update)
    idx = tr.make_index(durability_dir=d)
    surviving = tr.surviving_update_commits(idx, requests)
    idx.close()
    missing = [k for k in acked if k not in surviving]
    assert not missing, f"acked updates lost: {missing[:5]}"
    assert _recover_and_check(d, seed=seed, ticks=ticks) == len(surviving)


def test_gateway_snapshot_gone_is_typed_and_final():
    """Per-request ``as_of``: pinned lookups resolve against the pinned
    version; once the window slides past it the rejection is SNAPSHOT_GONE
    and non-retryable; updates with as_of are INVALID."""
    idx = KVPageIndex(snapshot_window=2, device="cpu")
    gw = Gateway(idx, default_rate=1e6, default_burst=1e6)
    gw.submit(Request("a", "al0", "alloc", seqs=(1,), pages=(0,), slots=(10,)), now=0.0)
    gw.pump(now=0.0)
    v = idx.version
    t_pin = gw.submit(Request("a", "r1", "lookup", seqs=(1,), pages=(0,), as_of=v), now=1.0)
    gw.submit(Request("b", "al1", "alloc", seqs=(1,), pages=(1,), slots=(11,)), now=1.0)
    gw.pump(now=1.0)
    assert t_pin.ok and int(t_pin.value[0]) == 10
    t_bad = gw.submit(
        Request("a", "al2", "alloc", seqs=(2,), pages=(0,), slots=(5,), as_of=v), now=2.0
    )
    assert t_bad.error.code == INVALID and not t_bad.error.retryable
    for i in range(3):
        gw.submit(
            Request("b", f"al{3 + i}", "alloc", seqs=(3 + i,), pages=(0,), slots=(i,)),
            now=2.0 + i,
        )
        gw.pump(now=2.0 + i)
    t_gone = gw.submit(Request("a", "r2", "lookup", seqs=(1,), pages=(0,), as_of=v), now=9.0)
    gw.pump(now=9.0)
    assert t_gone.error.code == SNAPSHOT_GONE and not t_gone.error.retryable


# ---------------------------------------------------------------------------
# cross-open: one package crashes between commit and ack, the other reopens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("crashed_by", ["reference", "port"])
def test_cross_open_after_crash_between_commit_and_ack(tmp_path, crashed_by):
    seed, ticks, d = 1, 6, tmp_path / "wal"
    writer, error, reader, state_bytes = {
        "reference": (jtr, jfi.CrashError, tr, canonical_state_bytes),
        "port": (tr, fi.CrashError, jtr, j_canonical),
    }[crashed_by]
    crash_at = (jfi if crashed_by == "reference" else fi).CrashAt("gateway.step.done", 2)
    idx = writer.make_index(durability_dir=d)
    seq_at_formation = []

    def hook(event):
        if event == "gateway.batch.formed":
            seq_at_formation.append(idx.durable_seq)
        crash_at(event)

    gw = writer.make_gateway(idx, crash_hook=hook)
    with pytest.raises(error):
        writer.run_traffic(gw, writer.default_population(seed), ticks=ticks, seed=seed)
    # the crashed pump committed an update batch that no client saw acked
    assert idx.durable_seq == seq_at_formation[-1] + 1

    idx2 = reader.make_index(durability_dir=d)
    gw2 = reader.make_gateway(idx2)
    last_seq, last_meta = idx2.dedup_seed()[-1]
    assert last_seq == idx.durable_seq == idx2.durable_seq
    requests = reader.regen_all_requests(reader.default_population(seed), ticks, seed)
    surviving = reader.surviving_update_commits(idx2, requests)
    res = reader.run_traffic(gw2, reader.default_population(seed), ticks=ticks, seed=seed)
    for key in last_meta["keys"]:
        assert res.tickets[key].ok and res.tickets[key].duplicate, key
    full_log = surviving + reader.committed_update_keys(requests, res.commit_log)
    assert len(set(full_log)) == len(full_log), "a key committed twice"
    port_requests = tr.regen_all_requests(tr.default_population(seed), ticks, seed)
    assert tr.oracle_state_bytes(port_requests, full_log) == state_bytes(idx2.state)
    gw2.close(now=float(res.end_tick))
