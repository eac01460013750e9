"""The serving path: the port's ``KVPageIndex`` against the JAX reference's,
step by step on the CPU (exact: slots, RANGE output and stats of every
step, and the index state), plus the snapshot-read properties, the
argument checks, an allocation overflow with its retry, and the durable
index (``durability_dir``): its steps, its files and its recovery."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.kv_index import KVPageIndex as JIndex  # noqa: E402
from repro.serve.kv_index import SnapshotGone as JSnapshotGone  # noqa: E402
from repro.checkpoint import canonical_state_bytes as j_canonical  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.checkpoint import canonical_state_bytes  # noqa: E402
from repro_torch.serve import PAGE_BITS, KVPageIndex, SnapshotGone, StepResult  # noqa: E402
from repro_torch.serve.kv_index import _key, _next_pow2  # noqa: E402
from test_torch_common import assert_same, assert_same_state  # noqa: E402

torch.set_num_threads(1)


def serve_day(steps=50, seed=0):
    """The step arguments of ``examples/serve_index.py``'s serving day:
    admissions, decode allocations, completions freed, and one in-order
    page enumeration per step, all in one mixed engine step."""
    rng = np.random.default_rng(seed)
    next_seq = next_slot = 0
    active: dict[int, int] = {}
    day = []
    for _ in range(steps):
        for _ in range(rng.integers(1, 4)):
            active[next_seq] = 0
            next_seq += 1
        seqs, pages, slots = [], [], []
        for s in list(active):
            if rng.random() < 0.5:
                seqs.append(s)
                pages.append(active[s])
                slots.append(next_slot)
                active[s] += 1
                next_slot += 1
        alloc_set = set(seqs)
        done = [s for s in active
                if active[s] > 0 and s not in alloc_set and rng.random() < 0.15]
        if seqs or done:
            probe = seqs[0] if seqs else done[0]
            day.append(dict(
                allocs=(seqs, pages, slots) if seqs else None,
                lookups=(seqs, pages) if seqs else None,
                free_seqs=done if done else None,
                ranges=([probe << PAGE_BITS], [(probe + 1) << PAGE_BITS]),
            ))
        for s in done:
            del active[s]
    return day, sum(active.values())


def assert_same_step(want, got: StepResult):
    assert isinstance(got, StepResult)
    assert_same(want.slots, got.slots, "slots")
    assert (want.range_out is None) == (got.range_out is None)
    for k in want.range_out or {}:
        assert_same(want.range_out[k], got.range_out[k], k)
    assert set(want.stats) == set(got.stats)
    for k, v in want.stats.items():
        assert int(v) == int(got.stats[k]), k


@pytest.fixture(scope="module")
def reference_day():
    """The JAX index's results over the day, and its final state."""
    day, pages = serve_day()
    idx = JIndex(node_size=32, nodes_per_bucket=8)
    results = [idx.step(**kw) for kw in day]
    assert idx.live_pages() == pages
    return day, results, idx


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_serving_day_matches_the_reference(reference_day, impl):
    """The 50-step day through both packages' ``KVPageIndex``, step by step;
    ``fused`` runs the fused path's plain version on the CPU."""
    day, results, jidx = reference_day
    idx = KVPageIndex(node_size=32, nodes_per_bucket=8,
                      config=tcore.ExecConfig(impl=impl), device="cpu")
    for kw, want in zip(day, results):
        assert_same_step(want, idx.step(**kw))
    assert idx.live_pages() == jidx.live_pages()
    assert idx.version == len(day)
    assert idx.state.geometry == jidx.state.geometry
    assert_same_state(jidx.state, idx.state)
    tcore.check_invariants(idx.state)


def test_ttl_steps_and_getsets_match_the_reference():
    """Allocations with deadlines, get-or-sets (hits refresh, misses
    register) and lookups under an advancing clock, read-only steps
    included, against the JAX index."""
    j, t = JIndex(snapshot_window=3), KVPageIndex(snapshot_window=3, device="cpu")
    seqs = np.arange(6)
    steps = [
        dict(allocs=(seqs, np.zeros(6, int), seqs * 10, np.full(6, 20)), now=0),
        dict(getsets=([0, 1, 7], [0, 0, 0], [91, 92, 97], [50, 50, 30]), now=5),
        dict(lookups=(np.arange(8), np.zeros(8, int)), now=25),
        dict(allocs=([2, 3], [1, 1], [200, 300], [40, 40]), free_seqs=[4], now=25,
             ranges=([0], [8 << PAGE_BITS]), range_budget=16),
        dict(lookups=(np.arange(8), np.zeros(8, int)), getsets=([3], [1], [5], [60]),
             now=45),
        dict(lookups=(np.arange(8), np.zeros(8, int)), as_of=2),
    ]
    for kw in steps:
        assert_same_step(j.step(**kw), t.step(**kw))
    assert t.version == j.version and t.retained_versions == j.retained_versions
    assert_same_state(j.state, t.state)
    assert_same(j.state.exps, t.state.exps, "exps")
    tcore.check_invariants(t.state, now=45)
    got = t.getset([0], [0], [1], [99], now=46)
    assert got.tolist() == j.getset([0], [0], [1], [99], now=46).tolist() == [0]


def _range_bytes(idx, as_of=None, hi=1 << 20):
    rr = idx.step(ranges=([0], [hi]), as_of=as_of, range_budget=512).range_out
    return rr["keys"].numpy().tobytes() + rr["vals"].numpy().tobytes()


def test_pinned_reads():
    """The snapshot-read properties of the reference (test_system.py): a
    pinned RANGE stays byte-identical while later batches commit, pins
    replay at their own clock, and a version past the window is gone."""
    idx = KVPageIndex(snapshot_window=8, device="cpu")
    seqs = np.arange(6)
    idx.allocate(seqs, np.zeros(6, int), seqs * 100)
    v = idx.version
    base = _range_bytes(idx, as_of=v)
    assert base == _range_bytes(idx)
    for extra in range(4):
        idx.step(allocs=([50 + extra], [0], [9000 + extra]))
        assert _range_bytes(idx, as_of=v) == base
        assert _range_bytes(idx) != base
    assert idx.version == v + 4 and v in idx.retained_versions
    with pytest.raises(ValueError):
        idx.step(allocs=([99], [0], [1]), as_of=v)
    with pytest.raises(ValueError):
        idx.step(ranges=([0], [4]), as_of=idx.version + 1)
    with pytest.raises(ValueError, match="now=None"):
        idx.step(ranges=([0], [4]), as_of=v, now=3)
    for extra in range(8):
        idx.step(allocs=([70 + extra], [0], [1]))
    with pytest.raises(SnapshotGone):
        idx.step(ranges=([0], [4]), as_of=v)
    assert v not in idx.retained_versions
    with pytest.raises(ValueError, match="snapshot_window"):
        KVPageIndex(device="cpu").step(ranges=([0], [4]), as_of=0)

    clocked = KVPageIndex(snapshot_window=8, device="cpu")
    seqs = np.arange(4)
    clocked.step(allocs=(seqs, np.zeros(4, int), seqs * 100, np.full(4, 10)), now=0)
    v = clocked.version
    base = _range_bytes(clocked, as_of=v)
    clocked.step(allocs=([9], [0], [900], [999]), now=50)
    assert _range_bytes(clocked, as_of=v) == base
    got = clocked.step(lookups=(seqs, np.zeros(4, int)), now=50).slots
    assert (got == -1).all()

    # the reference types the same miss the same way
    j = JIndex(snapshot_window=1)
    j.allocate([1], [0], [1])
    j.allocate([2], [0], [1])
    with pytest.raises(JSnapshotGone):
        j.step(ranges=([0], [4]), as_of=0)


def test_step_argument_checks():
    idx = KVPageIndex(device="cpu")
    with pytest.raises(ValueError, match="allocs and free_seqs"):
        idx.step(allocs=([1], [0], [5]), free_seqs=[1])
    with pytest.raises(ValueError, match="getsets and free_seqs"):
        idx.step(getsets=([2], [0], [5], [9]), free_seqs=[2])
    with pytest.raises(ValueError, match="allocs and getsets"):
        idx.step(allocs=([3], [0], [5]), getsets=([3], [0], [6], [9]))
    empty = idx.step(allocs=([], [], []), lookups=([], []), free_seqs=[])
    assert empty.slots.numel() == 0 and empty.range_out is None and empty.stats == {}
    with pytest.raises(TypeError):
        slots, range_out, stats = idx.step(lookups=([1], [0]))
    sharded = KVPageIndex(device="cpu", shards=2)
    sharded.allocate([1], [0], [5])
    assert sharded.lookup([1], [0]).tolist() == [5] and sharded.live_pages() == 1
    tiered = KVPageIndex(device="cpu", device_budget=1 << 20)
    assert tiered.resident_bytes == 0  # nothing paged in before a step
    tiered.allocate([1], [0], [5])
    assert 0 < tiered.resident_bytes <= 1 << 20
    assert tiered.lookup([1], [0]).tolist() == [5]
    with pytest.raises(ValueError, match="snapshot_window"):
        KVPageIndex(device="cpu", device_budget=1 << 20, snapshot_window=2)
    k = _key(torch.tensor([1, 2]), torch.tensor([3, 4]))
    assert k.tolist() == [(1 << PAGE_BITS) | 3, (2 << PAGE_BITS) | 4]
    assert [_next_pow2(n) for n in (1, 2, 3, 17)] == [1, 2, 4, 32]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            KVPageIndex()


def test_allocation_overflow_retries_like_the_reference():
    """A prefill far beyond a tiny geometry overflows, restructures and
    replays: the same stats, slots and grown state as the JAX index."""
    j = JIndex(node_size=4, nodes_per_bucket=2)
    t = KVPageIndex(node_size=4, nodes_per_bucket=2, device="cpu")
    retries = []
    for kw in (
        dict(allocs=(np.zeros(40, int), np.arange(40), np.arange(40) + 7)),
        dict(allocs=(np.ones(5, int), np.arange(5), np.arange(5)),
             lookups=(np.zeros(40, int), np.arange(40))),
    ):
        want, got = j.step(**kw), t.step(**kw)
        assert_same_step(want, got)
        retries.append(int(got.stats["restructure_retries"]))
    assert retries[0] == 1  # each step equals the reference, retries included
    assert t.state.geometry == j.state.geometry
    assert_same_state(j.state, t.state)
    pages, slots, count = t.pages_of(0, max_pages=64)
    assert int(count) == 40 and pages[:40].tolist() == list(range(40))
    assert slots[:40].tolist() == list(range(7, 47))


def _files(d) -> dict[str, bytes]:
    d = Path(d)
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def test_durable_serving_day_matches_the_reference(tmp_path):
    """The 50-step day through both packages' ``KVPageIndex`` with
    ``durability_dir`` and ``snapshot_every=4``, some steps carrying meta:
    equal StepResults, durable seqs and dedup seeds, and byte-identical
    directories (snapshots and WAL).  Then each package reopens both
    directories onto the same canonical bytes, seq and seed, and serves
    one more step alike."""
    day, _ = serve_day()
    geo = dict(node_size=32, nodes_per_bucket=8, snapshot_every=4)
    jd, td = tmp_path / "jax", tmp_path / "port"
    j = JIndex(**geo, durability_dir=jd)
    t = KVPageIndex(**geo, durability_dir=td, device="cpu")
    for n, kw in enumerate(day):
        meta = {"step": n} if n % 3 == 0 else None
        assert_same_step(j.step(**kw, meta=meta), t.step(**kw, meta=meta))
        assert t.durable_seq == j.durable_seq == n + 1 == t.version
    assert t.dedup_seed() == j.dedup_seed() and len(t.dedup_seed()) == 17
    assert _files(td) == _files(jd)
    assert t.snapshot().name == j.snapshot().name  # forced, at a fresh seq
    assert _files(td) == _files(jd)
    want = j_canonical(j.state)
    assert canonical_state_bytes(t.state) == want
    for idx in (t, j):
        idx.close()
        idx.close()
        assert not idx.healthy
    extra = dict(allocs=([900], [0], [77]), lookups=([900, 0], [0, 0]))
    for d in (jd, td):
        t2 = KVPageIndex(**geo, durability_dir=d, device="cpu")
        j2 = JIndex(**geo, durability_dir=d)
        assert canonical_state_bytes(t2.state) == j_canonical(j2.state) == want
        assert t2.durable_seq == j2.durable_seq == len(day)
        assert t2.dedup_seed() == j2.dedup_seed() == j.dedup_seed()
        assert t2.version == 0 and t2.healthy
        assert_same_step(j2.step(**extra), t2.step(**extra))
        j2.close()
        t2.close()


def test_durability_off_and_poisoned_like_the_reference(tmp_path):
    """Without ``durability_dir``: no seq, an empty seed, ``snapshot``
    refused, ``close`` a no-op.  A poisoned durable layer (the engine and
    then the WAL rollback fail): unhealthy, ``snapshot`` returns None, the
    update path refuses, ``close`` does not raise — in both packages."""
    for idx in (JIndex(), KVPageIndex(device="cpu")):
        assert idx.durable_seq is None and idx.dedup_seed() == [] and idx.healthy
        with pytest.raises(RuntimeError, match="durability is off"):
            idx.snapshot()
        idx.close()
        assert not idx.healthy

    def boom(*a, **k):
        raise RuntimeError("engine OOM")

    def no_rollback(offset):
        raise OSError("disk gone")

    step = dict(allocs=([1, 2], [0, 0], [5, 6]))
    for idx in (JIndex(durability_dir=tmp_path / "j"),
                KVPageIndex(durability_dir=tmp_path / "t", device="cpu")):
        idx.step(**step)
        idx._durable.engine.apply = boom
        idx._durable._wal.truncate_to = no_rollback
        with pytest.raises(RuntimeError, match="engine OOM"):
            idx.step(allocs=([3], [0], [7]))
        assert not idx.healthy and idx.durable_seq == 1
        assert idx.snapshot() is None
        with pytest.raises(RuntimeError, match="diverged"):
            idx.step(allocs=([4], [0], [8]))
        assert idx.lookup([1], [0]).tolist() == [5]  # reads stay valid
        idx.close()
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
