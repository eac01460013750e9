"""The port's tracing module (``repro_torch/trace.py``): spans that cost
nothing without a profiler, the batch path's spans and host-sync marks
under ``torch.profiler`` (exact names, each inside ``apply_ops_safe``),
the CUDA-event triples of ``trace.EVENTS``, and on the card a batch of
each benchmark cell's kind that makes no device-to-host read but the
marked ones."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from repro_torch import core, trace

torch.set_num_threads(1)

GEOMETRY = dict(node_size=8, nodes_per_bucket=4)
RANGE_BUDGET = 16


def tiny_state(exps=False):
    keys = np.arange(10, 810, 10, dtype=np.int32)
    state = core.build(keys, keys * 3, **GEOMETRY, device="cpu")
    return core.attach_expiry(state) if exps else state


def mixed_batch(exps=None):
    """One op of each kind a mixed batch holds: insert, delete, point,
    successor, range."""
    tags = np.array([core.OP_INSERT, core.OP_DELETE, core.OP_POINT, core.OP_SUCCESSOR,
                     core.OP_RANGE], np.int32)
    keys = np.array([15, 20, 30, 41, 100], np.int32)
    vals = np.array([7, 0, 0, 0, 200], np.int32)
    return core.make_ops(tags, keys, vals, exps=exps, device="cpu")[0]


def ttl_batch():
    """Inserts with deadlines, a get-or-set and a point read."""
    tags = np.array([core.OP_INSERT, core.OP_EXPIRE, core.OP_POINT], np.int32)
    keys = np.array([15, 30, 40], np.int32)
    vals = np.array([7, 9, 0], np.int32)
    exps = np.array([50, 60, core.NO_EXPIRY], np.int32)
    return core.make_ops(tags, keys, vals, exps=exps, device="cpu")[0]


def profiled(fn, tmp_path):
    """The ``repro_torch.*`` annotations of one call under a CPU profiler,
    as ``(name, start_us, end_us)`` in start order (a parent before the
    child that starts with it)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    got = [(e["name"].removeprefix(trace.PREFIX), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith(trace.PREFIX)]
    return sorted(got, key=lambda x: (x[1], -x[2]))


CASES = {
    "reference": (
        lambda: (tiny_state(), mixed_batch(), {}),
        "reference",
        ["apply_ops_safe", "route", "sync.reference.has_insert", "reference.insert",
         "sync.reference.has_delete", "reference.delete", "sync.reference.has_point",
         "reference.point", "sync.reference.has_successor", "reference.successor",
         "sync.reference.has_range", "reference.range", "sync.needs_restructure"],
    ),
    "fused": (
        lambda: (tiny_state(), mixed_batch(), {}),
        "fused",
        ["apply_ops_safe", "route", "fused.successor", "sync.has_ranges", "fused.range",
         "sync.needs_restructure"],
    ),
    "ttl": (
        lambda: (tiny_state(exps=True), ttl_batch(), {"now": 20}),
        "reference",
        ["apply_ops_safe", "ttl.expire", "sync.ttl.expired_buckets", "sync.ttl.has_expire",
         "ttl.probe",
         # the expiry plane, then the value plane: inserts and the lowered
         # get-or-set, then the point read
         "route", "sync.reference.has_insert", "reference.insert",
         "sync.reference.has_delete", "sync.reference.has_point", "reference.point",
         "sync.reference.has_successor", "sync.reference.has_range",
         "route", "sync.reference.has_insert", "reference.insert",
         "sync.reference.has_delete", "sync.reference.has_point", "reference.point",
         "sync.reference.has_successor", "sync.reference.has_range",
         "sync.needs_restructure"],
    ),
}


def test_off_without_a_profiler():
    assert not torch.autograd._profiler_enabled() and trace.EVENTS is None
    assert trace.span("apply_ops_safe") is trace.NO_SPAN is trace.span("sync.x")
    with trace.span("route") as inside:
        assert inside is None
    for t, want in ((torch.tensor(True), True), (torch.tensor(False), False),
                    (torch.tensor([0, 1]).any(), True)):
        got = trace.host_bool(t, "site")
        assert got is want
    got = trace.host_int(torch.tensor(7, dtype=torch.int64), "site")
    assert got == 7 and type(got) is int
    assert trace.host_int(torch.tensor(-3, dtype=torch.int32), "site") == -3
    # a batch runs as before and leaves nothing behind
    state, ops = tiny_state(), mixed_batch()
    core.apply_ops_safe(state, ops, config=core.ExecConfig(impl="reference"))
    assert trace.EVENTS is None


@pytest.mark.parametrize("case", list(CASES))
def test_spans_and_sync_marks_of_one_batch(case, tmp_path):
    make, impl, want = CASES[case]
    state, ops, kw = make()
    cfg = core.ExecConfig(impl=impl, max_results=RANGE_BUDGET, donate=False)
    plain = core.apply_ops_safe(state, ops, config=cfg, **kw)
    out = {}
    got = profiled(lambda: out.setdefault(
        "r", core.apply_ops_safe(state, ops, config=cfg, **kw)), tmp_path)
    assert [n for n, _, _ in got] == want
    _, s0, e0 = got[0]
    for name, s, e in got[1:]:
        assert s0 <= s and e <= e0, name
    # the same answers as untraced
    for k, v in plain[1].items():
        assert torch.equal(v, out["r"][1][k]), k
    assert torch.equal(plain[0].keys, out["r"][0].keys)


def test_restructure_span_holds_the_regrow_and_the_retry(tmp_path):
    keys = np.arange(1000, 33000, 1000, dtype=np.int32)
    state = core.build(keys, keys, **GEOMETRY, device="cpu")
    flood = np.arange(1001, 1041, dtype=np.int32)  # 40 keys into a bucket of 32 slots
    tags = np.full(flood.shape, core.OP_INSERT, np.int32)
    ops, _ = core.make_ops(tags, flood, flood, device="cpu")
    cfg = core.ExecConfig(impl="reference", validate=True)
    got = profiled(lambda: core.apply_ops_safe(state, ops, config=cfg), tmp_path)
    names = [n for n, _, _ in got]
    assert names[:2] == ["apply_ops_safe", "route"]
    i = names.index("restructure")
    assert names[i - 2:i] == ["sync.needs_restructure", "sync.input_needs_restructure"]
    assert names[i + 1:i + 3] == ["sync.restructure.inserts", "sync.restructure.live_keys"]
    assert names[-2:] == ["sync.restructure.retry_overflowed", "validate"]
    _, rs, re = got[i]
    inside = [n for n, s, e in got if rs < s and e <= re]
    assert inside == names[i + 1:-1]


def test_entry_and_unsort_spans(tmp_path):
    out = {}

    def run():
        ops, perm = core.make_ops(np.array([core.OP_POINT] * 3, np.int32),
                                  np.array([30, 10, 20], np.int32), device="cpu")
        out["v"] = core.unsort(ops.key, perm)

    assert [n for n, _, _ in profiled(run, tmp_path)] == ["make_ops", "unsort"]
    assert out["v"].tolist() == [30, 10, 20]


class HostEvent:
    """A stand-in for ``torch.cuda.Event`` on a host without a card."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_events_list_gets_a_triple_a_span(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    state, ops = tiny_state(), mixed_batch()
    cfg = core.ExecConfig(impl="reference", max_results=RANGE_BUDGET)
    monkeypatch.setattr(trace, "EVENTS", [])
    events = trace.EVENTS
    core.apply_ops_safe(state, ops, config=cfg)
    want = CASES["reference"][2]
    # a triple is appended as its span closes: children before parents
    assert sorted(n for n, _, _ in events) == sorted(want)
    assert events[-1][0] == "apply_ops_safe"
    for name, start, end in events:
        assert isinstance(start, HostEvent) and start.t is not None
        assert end.elapsed_time(start) <= 0 <= start.elapsed_time(end), name
    monkeypatch.setattr(trace, "EVENTS", None)
    assert trace.span("route") is trace.NO_SPAN


# --- on the card ---------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def card_batches(dev, n_keys=1 << 16, n_ops=1 << 14, seed=5):
    """A small index on the card, a YCSB-A batch (half point reads of live
    keys, half upserts of distinct live keys) and a YCSB-C one (all point
    reads), both of ``n_ops`` raw unsorted ops."""
    gen = torch.Generator().manual_seed(seed)
    keys = torch.randperm(1 << 22, generator=gen)[:n_keys].to(torch.int32).sort().values
    state = core.build(keys, keys * 2, node_size=32, nodes_per_bucket=16, device=dev)
    half = n_ops // 2
    reads = keys[torch.randint(0, n_keys, (n_ops,), generator=gen)]
    ups = keys[torch.randperm(n_keys, generator=gen)[:half]]
    tags_a = torch.cat([torch.full((half,), core.OP_POINT), torch.full((half,), core.OP_INSERT)])
    keys_a = torch.cat([reads[:half], ups])
    shuffle = torch.randperm(n_ops, generator=gen)
    ycsb_a = (tags_a[shuffle], keys_a[shuffle], torch.arange(n_ops, dtype=torch.int32))
    ycsb_c = (torch.full((n_ops,), core.OP_POINT), reads, torch.zeros(n_ops, dtype=torch.int32))
    as_dev = lambda b: tuple(t.to(torch.int32).to(dev) for t in b)  # noqa: E731
    return state, {"ycsb_a": as_dev(ycsb_a), "ycsb_c": as_dev(ycsb_c)}


CARD_SITES = {
    "ycsb_a": ["has_updates", "has_ranges", "needs_restructure"],
    "ycsb_c": ["has_updates", "reference.has_insert", "reference.has_delete",
               "reference.has_point", "reference.has_successor", "reference.has_range",
               "needs_restructure"],
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(CARD_SITES))
def test_a_batch_reads_the_card_only_at_its_marks(card, kind, monkeypatch):
    """make_ops -> apply_ops_safe -> unsort under ``set_sync_debug_mode
    ("error")``, lifted only inside the marked reads: any other
    device-to-host read raises, so the marks miss none, and the sites hit
    are the ones ``syncs_per_batch`` counts in the cell of this kind."""
    state, batches = card_batches(card)
    batch = batches[kind]
    cfg = core.ExecConfig()

    def run(st, cfg=cfg):
        ops, perm = core.make_ops(*batch, device=card)
        st, res, stats = core.apply_ops_safe(st, ops, config=cfg)
        return st, {k: core.unsort(res[k], perm) for k in ("value", "succ_key")}, stats

    # builds and loads the kernel library, warms the allocator; keeps the state
    run(state, cfg.replace(donate=False))
    torch.cuda.synchronize()
    sites = []

    def lifted(read):
        def marked(t, site):
            sites.append(site)
            torch.cuda.set_sync_debug_mode(0)
            try:
                return read(t, site)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return marked

    monkeypatch.setattr(trace, "host_bool", lifted(trace.host_bool))
    monkeypatch.setattr(trace, "host_int", lifted(trace.host_int))
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, out, stats = run(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sites == CARD_SITES[kind]
    torch.cuda.synchronize()
    assert stats["restructure_retries"] == 0 and not bool(new.needs_restructure)
    point = batch[0] == core.OP_POINT
    assert bool((out["value"][point] != core.NOT_FOUND).all())  # every read hits
