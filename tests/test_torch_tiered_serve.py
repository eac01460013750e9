"""Tiered residency on the serving path: ``KVPageIndex(device_budget=...)``,
its durable ``TieredEngine`` and the gateway over it, the port against the
JAX reference in lockstep on the CPU (``test_torch_tiered.py``'s
comparison: results, stats with the residency counters, resident ids, the
metadata, the synced mirror and canonical bytes after every step).

Cases: cold-tier crash recovery with ``TieredFliX.materialize`` rigged to
raise in both packages (the two durable directories byte-identical);
``KVPageIndex(device_budget=...)`` step for step over a serving day with a
TTL plane that appears mid-stream, alone and durable, held also against a
single-tier index; its argument checks; the gateway's residency metrics
through both packages' gateways in lockstep.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_traffic_replay as tr  # noqa: E402
import traffic_replay as jtr  # noqa: E402
from repro.checkpoint import serialize as jser  # noqa: E402
from repro.core import residency as jres  # noqa: E402
from repro.serve.gateway import Request as JRequest  # noqa: E402
from repro.serve.kv_index import KVPageIndex as JIndex  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.checkpoint import serialize as tser  # noqa: E402
from repro_torch.core import residency as tres  # noqa: E402
from repro_torch.serve import KVPageIndex  # noqa: E402
from test_tiered import _serve_workload  # noqa: E402
from test_torch_serve import assert_same_step, serve_day  # noqa: E402
from test_torch_tiered import assert_same_tiered, host_bytes  # noqa: E402

torch.set_num_threads(1)




def test_cold_tier_crash_recovery_in_both_packages(tmp_path, monkeypatch):
    budget = 8192
    dirs = {"ref": tmp_path / "ref", "port": tmp_path / "port"}
    kv_j = JIndex(durability_dir=str(dirs["ref"]), snapshot_every=3, device_budget=budget)
    kv_t = KVPageIndex(durability_dir=dirs["port"], snapshot_every=3, device_budget=budget,
                       device="cpu")
    _serve_workload(kv_j, np.random.default_rng(7), 7)
    _serve_workload(kv_t, np.random.default_rng(7), 7)
    assert tr.dir_bytes(dirs["port"]) == tr.dir_bytes(dirs["ref"])
    oracle = KVPageIndex(device="cpu")
    _serve_workload(oracle, np.random.default_rng(7), 7)
    want = tser.canonical_state_bytes(oracle.state)
    del kv_j, kv_t  # crashes: no close(), recovery replays the WAL tail

    def no_materialize(self):
        raise AssertionError("the whole index materialized during recovery")

    monkeypatch.setattr(jres.TieredFliX, "materialize", no_materialize)
    monkeypatch.setattr(tres.TieredFliX, "materialize", no_materialize)
    kv_j = JIndex(durability_dir=str(dirs["ref"]), snapshot_every=3, device_budget=budget)
    kv_t = KVPageIndex(durability_dir=dirs["port"], snapshot_every=3, device_budget=budget,
                       device="cpu")
    hj, ht = kv_j._durable.handle, kv_t._durable.handle
    assert isinstance(ht, tres.TieredFliX) and kv_t._durable.replayed == kv_j._durable.replayed
    assert host_bytes(ht.host_view(), tser) == want == host_bytes(hj.host_view(), jser)
    assert_same_tiered(hj, ht, "recovered")
    assert kv_t.resident_bytes == kv_j.resident_bytes <= max(budget, ht.bucket_bytes)
    tcore.check_tiered_invariants(ht)
    seqs = np.random.default_rng(7).choice(64, 8, replace=False)
    assert_same_step(kv_j.step(lookups=(seqs, np.zeros(8, np.int64))),
                     kv_t.step(lookups=(seqs, np.zeros(8, np.int64))))
    assert_same_step(kv_j.step(allocs=([99], [0], [4242])), kv_t.step(allocs=([99], [0],
                                                                              [4242])))
    assert int(kv_t.lookup([99], [0])[0]) == 4242
    kv_j.snapshot(), kv_t.snapshot()
    kv_j.close(), kv_t.close()
    assert tr.dir_bytes(dirs["port"]) == tr.dir_bytes(dirs["ref"])


def _ttl_day(day):
    """``serve_day``'s steps with a clock, and every fourth with get-or-sets
    (deadlines two steps ahead) on sequences outside the day's, so that the
    TTL plane appears mid-stream."""
    out = []
    for t, kw in enumerate(day):
        kw = dict(kw, now=t)
        if t % 4 == 3:
            seq = 10_000 + np.arange(3) + t % 7
            kw["getsets"] = (seq, np.full(3, t % 4), seq + t, np.full(3, t + 2))
        out.append(kw)
    return out


@pytest.mark.parametrize("durable", [False, True])
def test_kv_index_device_budget_in_lockstep(tmp_path, durable):
    day = _ttl_day(serve_day(steps=12, seed=3)[0])
    kw = dict(node_size=8, nodes_per_bucket=4, device_budget=2048)
    dirs = {}
    if durable:
        dirs = {"port": tmp_path / "port", "ref": tmp_path / "ref"}
        kw_j = dict(kw, durability_dir=str(dirs["ref"]), snapshot_every=4)
        kw_t = dict(kw, durability_dir=dirs["port"], snapshot_every=4)
    else:
        kw_j, kw_t = kw, kw
    j, t = JIndex(**kw_j), KVPageIndex(**kw_t, device="cpu")
    plain = KVPageIndex(node_size=8, nodes_per_bucket=4, device="cpu")
    for i, step in enumerate(day):
        got = t.step(**step)
        assert_same_step(j.step(**step), got)
        plain_step = plain.step(**step)
        for k in ("slots",):
            assert torch.equal(getattr(plain_step, k), getattr(got, k)), i
        assert t.resident_bytes == j.resident_bytes == got.stats["resident_bytes"]
        assert_same_tiered(j.state, t.state, f"step {i}")
    # read-only steps ran with commit=False and kept the logical content
    before = host_bytes(t.state.host_view(), tser)
    res = t.step(lookups=([0, 1, 2], [0, 0, 0]), ranges=([0], [1 << 20]), now=len(day))
    assert_same_step(j.step(lookups=([0, 1, 2], [0, 0, 0]), ranges=([0], [1 << 20]),
                            now=len(day)), res)
    assert host_bytes(t.state.host_view(), tser) == before
    assert t.live_pages() == j.live_pages() == plain.live_pages()
    assert before == tser.canonical_state_bytes(plain.state)
    assert t.state.h_exps is not None
    if durable:
        j.close(), t.close()
        assert tr.dir_bytes(dirs["port"]) == tr.dir_bytes(dirs["ref"])


def test_kv_index_device_budget_argument_checks():
    with pytest.raises(ValueError, match="snapshot_window"):
        KVPageIndex(device_budget=1 << 20, snapshot_window=2, device="cpu")
    with pytest.raises(ValueError, match="single-device residency bound"):
        KVPageIndex(device_budget=1 << 20, shards=2, device="cpu")
    assert KVPageIndex(device="cpu").resident_bytes is None


def test_gateway_residency_metrics_in_lockstep():
    budget = 2048
    port = tr.make_gateway(tr.make_index(device_budget=budget))
    ref = jtr.make_gateway(jtr.make_index(device_budget=budget))
    twin = tr.Lockstep(
        port, ref, to_b=lambda req: JRequest(**dataclasses.asdict(req)),
        bytes_a=lambda st: host_bytes(st.host_view(), tser),
        bytes_b=lambda st: host_bytes(st.host_view(), jser),
    )
    twin.register_tenant("tenant-hot", rate=24, burst=48, weight=3.0)
    res = tr.run_traffic(twin, tr.default_population(0), ticks=5, seed=0)
    m = port.metrics
    assert m["promoted"] > 0 and m["demoted"] > 0
    assert 0 < m["resident_bytes"] <= max(budget, port.index.state.bucket_bytes)
    assert m["resident_bytes"] == port.index.resident_bytes
    port.close(now=float(res.end_tick))
    ref.close(now=float(res.end_tick))
