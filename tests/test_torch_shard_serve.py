"""The sharded index on the serving path: ``KVPageIndex(shards=...)`` and
its durable ``ShardEngine``, the port against the JAX reference on the CPU
(shards on ``["cpu"] * S``).

Cases: ``test_shard_engine.test_sharded_kv_index_serves_like_local`` step
for step against the reference's local index, under both routings, with
the 600-page burst that regrows through ``shard_restructure``; the serving
day of ``examples/serve_index.py`` with a clock and get-or-sets, alone and
durable; sharded crash recovery onto the single-device oracle's canonical
bytes (``test_crash_recovery.test_sharded_recovery_matches_local_oracle``);
the argument checks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_fault_injection as fi  # noqa: E402
from repro.serve.kv_index import KVPageIndex as JIndex  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.checkpoint import DurableFliX, ShardEngine  # noqa: E402
from repro_torch.checkpoint.serialize import (  # noqa: E402
    bucket_segments,
    canonical_state_bytes,
)
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.serve import KVPageIndex  # noqa: E402
from test_torch_common import assert_same  # noqa: E402
from test_torch_serve import serve_day  # noqa: E402
from test_torch_tiered_serve import _ttl_day  # noqa: E402

torch.set_num_threads(1)

SHARED_STATS = ("inserted", "deleted", "overflowed_buckets", "range_truncated", "expired")


def assert_same_step(want, got, label=""):
    """A sharded step against the reference's local one: slots, the dense
    RANGE output and the stats both engines report."""
    assert_same(want.slots, got.slots, f"{label} slots")
    assert (want.range_out is None) == (got.range_out is None), label
    for k in want.range_out or {}:
        assert_same(want.range_out[k], got.range_out[k], f"{label} {k}")
    for k in SHARED_STATS:
        if k in want.stats:
            assert int(want.stats[k]) == int(got.stats[k]), (label, k)
    if "a2a_overflow" in got.stats:
        assert int(got.stats["a2a_overflow"]) == 0, label


@pytest.mark.parametrize("routing", ["replicated", "a2a"])
def test_sharded_kv_index_serves_like_local(routing):
    kv = KVPageIndex(shards=4, config=tcore.ExecConfig(routing=routing), device="cpu")
    ref = JIndex()
    assert kv.mesh.devices == (torch.device("cpu"),) * 4
    seqs = np.arange(8)
    for page in (0, 1):
        args = (seqs, np.full(8, page), seqs * 100 + page)
        assert_same_step(ref.step(allocs=args), kv.step(allocs=args), f"alloc {page}")
    assert_same(ref.lookup(seqs, np.ones(8, int)), kv.lookup(seqs, np.ones(8, int)))
    pg, sl, cnt = kv.pages_of(3)
    assert int(cnt) == 2 and pg[:2].tolist() == [0, 1] and sl[:2].tolist() == [300, 301]
    assert_same_step(ref.step(free_seqs=[3]), kv.step(free_seqs=[3]), "free")
    assert kv.live_pages() == ref.live_pages() == 14
    assert int(kv.pages_of(3)[2]) == 0
    # a burst past the seed geometry regrows through shard_restructure
    pages = np.arange(600)
    burst = (np.full(600, 50), pages, pages + 9000)
    want, got = ref.step(allocs=burst), kv.step(allocs=burst)
    assert_same_step(want, got, "burst")
    assert got.stats["restructure_retries"] == 1
    assert kv.live_pages() == ref.live_pages() == 614
    pg, sl, cnt = kv.pages_of(50, max_pages=1024)
    assert int(cnt) == 600 and (sl[:600].numpy() == pages + 9000).all()
    assert kv.state.n_shards == 4 and kv.state.geometry[0] % 4 == 0


@pytest.mark.parametrize("routing", ["replicated", "a2a"])
@pytest.mark.parametrize("durable", [False, True])
def test_sharded_serving_day_in_lockstep(tmp_path, routing, durable):
    """``examples/serve_index.py``'s day with a clock and get-or-sets (a TTL
    plane that appears mid-stream), page enumerations and a snapshot-window
    read, step for step against the reference's local index; durable, its
    recovery lands on the local index's canonical bytes."""
    day = _ttl_day(serve_day(steps=12, seed=5)[0])
    kw = dict(node_size=8, nodes_per_bucket=4)
    t_kw = dict(kw, shards=4, config=tcore.ExecConfig(routing=routing), device="cpu")
    if durable:
        t_kw.update(durability_dir=tmp_path / "port", snapshot_every=4)
    else:
        t_kw.update(snapshot_window=2)
    j, t = JIndex(**kw, snapshot_window=0 if durable else 2), KVPageIndex(**t_kw)
    local = KVPageIndex(**kw, device="cpu")
    for i, step in enumerate(day):
        got = t.step(**step)
        assert_same_step(j.step(**step), got, f"step {i}")
        local.step(**step)
        assert t.live_pages() == j.live_pages()
    if not durable:
        v = t.version - 1
        got = t.step(ranges=([0], [1 << 20]), as_of=v, range_budget=512)
        assert_same_step(j.step(ranges=([0], [1 << 20]), as_of=v, range_budget=512), got)
        return
    assert t.durable_seq == t.version
    want = canonical_state_bytes(local.state)
    assert canonical_state_bytes(t._durable.state) == want
    t.close()
    t2 = KVPageIndex(**dict(t_kw, durability_dir=tmp_path / "port"))
    assert t2.durable_seq == t.durable_seq
    assert canonical_state_bytes(dist.shard_union(t2.state, "cpu")) == want
    assert t2.state.n_shards == 4
    seqs = np.arange(6)
    assert_same_step(j.step(lookups=(seqs, np.zeros(6, int))),
                     t2.step(lookups=(seqs, np.zeros(6, int))), "after reopen")
    t2.close()


@pytest.mark.parametrize(
    "n_shards,routing,crash", [(2, "replicated", 4), (2, "replicated", 9), (4, "a2a", 9)]
)
def test_sharded_crash_recovery_matches_local_oracle(tmp_path, n_shards, routing, crash):
    """Crash a sharded durable index at the ``crash``-th ``apply.done`` and
    recover it: the canonical bytes equal the single-device oracle's at the
    recovered seq (the durability layer is engine-blind).  Batch 9 of the
    workload overflows a shard and regrows through ``shard_restructure``;
    a crash there lands after the regrow and before its snapshot, so the
    recovery re-partitions the snapshot at seq 6 and replays 7–9."""
    mesh = dist.make_shard_mesh(n_shards, ["cpu"] * n_shards)
    cfg = tcore.ExecConfig(routing=routing)
    acked = [0]
    with pytest.raises(fi.CrashError):
        fi.run_workload(tmp_path, 10, engine=ShardEngine(mesh, config=cfg, **fi.GEOMETRY),
                        crash_hook=fi.CrashAt("apply.done", crash),
                        ack=lambda s: acked.__setitem__(0, s))
    oracle = fi.oracle_canonical(10)
    dur = DurableFliX.open(tmp_path, engine=ShardEngine(mesh, config=cfg, **fi.GEOMETRY),
                           snapshot_every=fi.SNAPSHOT_EVERY, full_every=fi.FULL_EVERY)
    try:
        last_snap = fi.SNAPSHOT_EVERY * ((crash - 1) // fi.SNAPSHOT_EVERY)
        assert dur.seq == crash == acked[0] + 1 and dur.replayed == crash - last_snap
        assert canonical_state_bytes(dur.state) == oracle[dur.seq]
        assert isinstance(dur.handle, dist.ShardedFliX) and dur.handle.n_shards == n_shards
        # the recovered index goes on to the oracle's end
        while dur.seq < 10:
            tag, key, val, mr = fi.make_batch_host(dur.seq + 1)
            dur.apply(fi.ops_of(tag, key, val), config=cfg.replace(max_results=mr))
        assert canonical_state_bytes(dur.state) == oracle[10]
    finally:
        dur.close()
    # the engine's hooks agree with the union's, bucket for bucket
    eng = ShardEngine(mesh, **fi.GEOMETRY)
    h = eng.rebuild(*fi.initial_pairs())
    u = eng.flix(h)
    assert eng.geometry(h) == u.geometry
    assert (eng.mkba_host(h) == u.mkba.numpy()).all()
    dirty = np.array([0, 3, u.num_buckets // 2, u.num_buckets - 1])
    for bk in (None, dirty, np.zeros(0, np.int64)):
        for a, b in zip(eng.segments(h, bk), bucket_segments(u, bk)):
            assert (a == b).all()


def test_sharded_expired_buckets_and_argument_checks():
    keys, vals, exps = fi.initial_pairs_ttl()
    mesh = dist.make_shard_mesh(4, ["cpu"] * 4)
    eng = ShardEngine(mesh, **fi.GEOMETRY)
    h = eng.rebuild(keys, vals, exps)
    u = eng.flix(h)
    for now in (0, 40, 100, 10_000):
        want = torch.nonzero(((u.exps <= now) & (u.keys != tcore.EMPTY)).any(2).any(1))[:, 0]
        assert eng.expired_buckets(h, now).tolist() == want.tolist()
    assert eng.expired_buckets(h, None) is None
    with pytest.raises(ValueError, match="device_budget"):
        KVPageIndex(shards=2, device_budget=1 << 20, device="cpu")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < 2:
        with pytest.raises(ValueError, match="need 2 CUDA devices"):
            dist.make_shard_mesh(2)
        with pytest.raises(ValueError, match="need 2 CUDA devices"):
            KVPageIndex(shards=2)
    else:
        assert dist.make_shard_mesh(2).devices == (torch.device("cuda", 0),
                                                  torch.device("cuda", 1))
    kv = KVPageIndex(shards=3, device="cpu")
    got = kv.step(lookups=([1, 2, 3], [0, 0, 0]))
    assert got.slots.tolist() == [tcore.NOT_FOUND] * 3
    assert kv.resident_bytes is None and kv.live_pages() == 0
