"""Deterministic hostile-traffic replay harness for the port's serving
gateway (``repro_torch.serve.gateway``), the counterpart of
``traffic_replay.py``: the same population, geometry, oracle and commit
log, importing only ``repro_torch`` (on the CPU unless ``make_index`` is
given another device).  Shared by ``test_torch_gateway.py`` and runnable
directly as a subprocess child for the SIGKILL matrix.

Three pieces, mirroring ``torch_fault_injection.py`` one layer up:

* a **deterministic client population** — ``gen_requests(spec, t, seed)``
  is a pure function of (client, tick, seed), so an interrupted run, its
  post-recovery resumption, and the oracle all see byte-identical request
  streams.  Specs model the hostile shapes the gateway must absorb:
  skewed rates, synchronized bursts, duplicate floods (the same
  idempotency key submitted k times), stragglers with already-expired or
  about-to-expire deadlines, and retry storms (every retryable rejection
  is resubmitted with the SAME key);
* a **single-client oracle** — ``oracle_state_bytes`` applies each
  committed *update* request exactly once, one engine step each, in
  commit order, on a fresh dedup-free index; the gateway-served state
  must be byte-identical (``canonical_state_bytes``), which is THE
  exactly-once property: however many duplicates/retries arrived, state
  moved once per logical request;
* a **commit log** — every ``pump`` report's committed keys, in order;
  across a crash the surviving prefix is reconstructed from the durable
  dedup window (``KVPageIndex.dedup_seed``), exactly what recovery
  itself trusts.

Run as a script it becomes the crash child::

    python tests/torch_traffic_replay.py --dir D --ticks 30 \
        --kill-event wal.append.partial --kill-count 4

printing ``COMMIT <key,key,...>`` (flushed) after each committed batch —
an update batch whose COMMIT line was printed is durable, so the parent
asserts it survives recovery.
"""

from __future__ import annotations

import argparse
import sys
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint.serialize import canonical_state_bytes  # noqa: E402
from repro_torch.serve.gateway import Gateway, Request  # noqa: E402
from repro_torch.serve.kv_index import KVPageIndex  # noqa: E402

# tiny geometry: restructures happen inside short workloads and the whole
# soak stays in the fast CI lane
GEOMETRY = dict(node_size=8, nodes_per_bucket=4)
MAX_PAGES = 8  # pages per sequence in the harness (free cost = 8 ops)
SNAPSHOT_EVERY = 4


def make_index(durability_dir=None, crash_hook=None, **kw):
    return KVPageIndex(
        durability_dir=durability_dir,
        snapshot_every=SNAPSHOT_EVERY,
        crash_hook=crash_hook,
        **{**GEOMETRY, "device": "cpu", **kw},
    )


def make_gateway(index, *, crash_hook=None, **kw):
    defaults = dict(
        max_batch_ops=64,
        max_queue_ops=256,
        dedup_window=4096,
        max_pages=MAX_PAGES,
        range_budget=64,
        default_rate=48.0,
        default_burst=96.0,
    )
    return Gateway(index, crash_hook=crash_hook, **{**defaults, **kw})


# ---------------------------------------------------------------------------
# deterministic client populations
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClientSpec:
    """One emulated client: its tenant, rate shape, and misbehavior."""

    name: str
    tenant: str
    rate: float  # mean fresh requests per tick
    seq_base: int  # private sequence-id space [seq_base, seq_base+seq_span)
    seq_span: int = 32
    burst_every: int = 0  # every N ticks, rate spikes by burst_size
    burst_size: int = 0
    dup_copies: int = 1  # duplicate flood: each request submitted k times
    straggler: bool = False  # tight deadlines that expire under backlog
    update_frac: float = 0.6


def default_population(seed: int = 0) -> list[ClientSpec]:
    """Heterogeneous population: one hot tenant, steady mid-rate tenants,
    a duplicate-flooder, and a straggler — FederNet-style uneven clients."""
    return [
        ClientSpec("hot-0", "tenant-hot", 6.0, 0, burst_every=5, burst_size=12),
        ClientSpec("hot-1", "tenant-hot", 4.0, 100),
        ClientSpec("mid-0", "tenant-mid", 2.0, 200),
        ClientSpec("mid-1", "tenant-mid", 2.0, 300, burst_every=7, burst_size=6),
        ClientSpec("dup-0", "tenant-dup", 1.5, 400, dup_copies=4),
        ClientSpec("strag-0", "tenant-strag", 1.0, 500, straggler=True),
    ]


def _client_rng(spec: ClientSpec, t: int, seed: int) -> np.random.Generator:
    # crc32, not hash(): hash() is salted per process and the child/parent
    # of the SIGKILL matrix must generate identical streams
    return np.random.default_rng(
        [seed, zlib.crc32(spec.name.encode()) & 0x7FFFFFFF, t]
    )


def gen_requests(spec: ClientSpec, t: int, seed: int) -> list[Request]:
    """Client ``spec``'s fresh requests at tick ``t`` — a pure function."""
    rng = _client_rng(spec, t, seed)
    rate = spec.rate
    if spec.burst_every and t and t % spec.burst_every == 0:
        rate += spec.burst_size
    n = int(rng.poisson(rate))
    out = []
    for i in range(n):
        key = f"{spec.name}:{t}:{i}"
        deadline = float(t) + (float(rng.integers(0, 3)) if spec.straggler else 20.0)
        r = rng.random()
        seq = int(spec.seq_base + rng.integers(0, spec.seq_span))
        if r < spec.update_frac * 0.75:  # alloc 1-3 pages of one seq
            k = int(rng.integers(1, 4))
            pages = tuple(
                int(p) for p in rng.choice(MAX_PAGES, size=k, replace=False)
            )
            out.append(
                Request(
                    spec.tenant,
                    key,
                    "alloc",
                    seqs=(seq,) * k,
                    pages=pages,
                    slots=tuple(seq * 100 + p for p in pages),
                    deadline=deadline,
                )
            )
        elif r < spec.update_frac:  # free one seq
            out.append(
                Request(spec.tenant, key, "free", seqs=(seq,), deadline=deadline)
            )
        elif r < spec.update_frac + (1 - spec.update_frac) * 0.7:  # lookups
            k = int(rng.integers(1, 4))
            seqs = tuple(
                int(spec.seq_base + s) for s in rng.integers(0, spec.seq_span, k)
            )
            pages = tuple(int(p) for p in rng.integers(0, MAX_PAGES, k))
            out.append(
                Request(
                    spec.tenant, key, "lookup", seqs=seqs, pages=pages,
                    deadline=deadline,
                )
            )
        else:  # enumerate one seq's pages
            out.append(
                Request(spec.tenant, key, "pages", seqs=(seq,), deadline=deadline)
            )
    return out


# ---------------------------------------------------------------------------
# the replay driver
# ---------------------------------------------------------------------------


@dataclass
class TrafficResult:
    requests: dict  # key -> Request (every request generated)
    commit_log: list  # committed keys, in commit order
    tickets: dict  # key -> final Ticket
    latencies: list  # (finished - submitted) per ok queued ticket
    end_tick: int


def run_traffic(
    gateway: Gateway,
    clients: list[ClientSpec],
    *,
    ticks: int,
    seed: int = 0,
    start_tick: int = 0,
    max_retries: int = 30,
    drain_ticks: int = 40,
    on_commit=None,
) -> TrafficResult:
    """Drive the population through the gateway, retrying every retryable
    rejection with the same idempotency key, then drain.  Deterministic:
    submission order is (retries sorted by key, then clients in list
    order), one pump per tick."""
    requests: dict[str, Request] = {}
    tickets: dict[str, object] = {}
    attempts: dict[str, int] = {}
    retry_at: dict[str, float] = {}
    commit_log: list[str] = []
    latencies: list[float] = []
    resolved: set[str] = set()

    def submit(req: Request, now: float):
        requests.setdefault(req.key, req)
        tk = gateway.submit(req, now=now)
        tickets[req.key] = tk
        attempts[req.key] = attempts.get(req.key, 0) + 1
        return tk

    def settle(now: float):
        """Harvest terminal tickets: record latencies, schedule retries."""
        for key, tk in tickets.items():
            if key in resolved or not tk.done:
                continue
            resolved.add(key)
            if tk.ok and not tk.duplicate and tk.finished_at > tk.submitted_at:
                latencies.append(tk.finished_at - tk.submitted_at)
            if (
                tk.status in ("rejected", "failed")
                and tk.error is not None
                and tk.error.retryable
                and attempts[key] <= max_retries
            ):
                wait = tk.error.retry_after
                retry_at[key] = now + max(1.0, float(wait or 1.0))
                resolved.discard(key)  # retried: not terminal yet

    t = start_tick
    end = start_tick + ticks
    while t < end or (
        t < end + drain_ticks and (retry_at or gateway.queue_depth > 0)
    ):
        now = float(t)
        due = sorted(k for k, when in retry_at.items() if when <= now)
        for key in due:
            del retry_at[key]
            submit(requests[key], now)
        if t < end:
            for spec in clients:
                for req in gen_requests(spec, t, seed):
                    for _copy in range(spec.dup_copies):
                        submit(req, now)
        report = gateway.pump(now=now)
        commit_log.extend(report.committed_keys)
        if on_commit is not None:
            on_commit(report)
        settle(now)
        t += 1
    return TrafficResult(requests, commit_log, tickets, latencies, t)


# ---------------------------------------------------------------------------
# the oracle + exactly-once checks
# ---------------------------------------------------------------------------


def committed_update_keys(requests: dict, commit_log: list) -> list:
    return [k for k in commit_log if k in requests and requests[k].is_update]


def oracle_state_bytes(requests: dict, update_keys_in_order: list) -> bytes:
    """Apply each committed update request EXACTLY ONCE, one engine step
    each, in commit order, on a fresh single-client index — the dedup-free
    baseline the gateway-served state must match byte-for-byte."""
    idx = make_index()
    for key in update_keys_in_order:
        req = requests[key]
        if req.kind == "alloc":
            idx.step(allocs=(list(req.seqs), list(req.pages), list(req.slots)))
        elif req.kind == "free":
            idx.step(free_seqs=list(req.seqs), max_pages=MAX_PAGES)
        else:
            raise AssertionError(f"oracle fed a read request: {key}")
    return canonical_state_bytes(idx.state)


def assert_exactly_once(requests: dict, commit_log: list) -> list:
    """No idempotency key commits twice; returns the update keys."""
    seen = set()
    for k in commit_log:
        assert k not in seen, f"idempotency key {k} committed twice"
        seen.add(k)
    return committed_update_keys(requests, commit_log)


def regen_all_requests(clients, ticks: int, seed: int) -> dict:
    """Every request the population generates in [0, ticks) — how the
    crash-test parent reconstructs the child's streams (pure function)."""
    out: dict[str, Request] = {}
    for t in range(ticks):
        for spec in clients:
            for req in gen_requests(spec, t, seed):
                out[req.key] = req
    return out


def surviving_update_commits(index: KVPageIndex, requests: dict) -> list:
    """Committed UPDATE keys that survived into the durable history, in
    commit order — read from the same dedup trail recovery reseeds.  The
    trail logs every key in the batch (reads too, for ack dedup); only
    update kinds move state, so only they feed the oracle."""
    out = []
    for _seq, meta in index.dedup_seed():
        for k in (meta or {}).get("keys", ()):
            if k in requests and requests[k].is_update:
                out.append(k)
    return out


# ---------------------------------------------------------------------------
# lockstep: one submission stream through two gateways, compared per pump
# ---------------------------------------------------------------------------


def dir_bytes(d: Path) -> dict:
    """Every file under ``d``, by relative path, with its bytes."""
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def assert_same_value(va, vb, where: str) -> None:
    """Two ticket values equal, arrays by dtype as well as by content."""
    if isinstance(va, np.ndarray):
        assert isinstance(vb, np.ndarray) and va.dtype == vb.dtype, where
        np.testing.assert_array_equal(va, vb, err_msg=where)
    elif isinstance(va, list):  # page enumerations: one dict per sequence
        assert isinstance(vb, list) and len(va) == len(vb), where
        for da, db in zip(va, vb):
            assert da.keys() == db.keys() and da["count"] == db["count"], where
            for k in ("pages", "slots"):
                assert_same_value(da[k], db[k], f"{where} {k}")
    else:
        assert va == vb, where


def assert_same_ticket(ta, tb) -> None:
    """Status, typed error and retry hint, dedup flag, commit seq, clock
    stamps and value of two tickets of the same request."""
    key = ta.request.key
    assert (ta.status, ta.duplicate, ta.commit_seq) == (
        tb.status, tb.duplicate, tb.commit_seq), key
    assert (ta.submitted_at, ta.finished_at) == (tb.submitted_at, tb.finished_at), key
    assert (ta.error is None) == (tb.error is None), key
    if ta.error is not None:
        assert (ta.error.code, ta.error.retry_after) == (
            tb.error.code, tb.error.retry_after), key
    assert_same_value(ta.value, tb.value, key)


def assert_same_report(ra, rb) -> None:
    assert (ra.committed_keys, ra.n_ops, ra.expired, ra.failed_code, ra.commit_seq) == (
        rb.committed_keys, rb.n_ops, rb.expired, rb.failed_code, rb.commit_seq)
    assert ra.stats.keys() == rb.stats.keys()
    for k, v in ra.stats.items():
        assert int(v) == int(rb.stats[k]), k


class Lockstep:
    """Two gateways driven as one by :func:`run_traffic`: every request
    goes to both (``to_b`` converts it for the second), and after every
    submit and every pump the tickets, the pump reports, the metrics and
    the canonical state bytes (``bytes_a`` / ``bytes_b`` of each index's
    state) must be equal.  The first gateway's tickets drive the run."""

    def __init__(self, a, b, *, bytes_a, bytes_b, to_b=lambda req: req):
        self.a, self.b, self.to_b = a, b, to_b
        self.bytes_a, self.bytes_b = bytes_a, bytes_b
        self.pairs: dict[int, tuple] = {}  # id(ticket of a) -> (a, b)
        self.pumps = 0

    @property
    def queue_depth(self) -> int:
        assert self.a.queue_depth == self.b.queue_depth
        return self.a.queue_depth

    def register_tenant(self, name: str, **kw) -> None:
        self.a.register_tenant(name, **kw)
        self.b.register_tenant(name, **kw)

    def submit(self, req, *, now: float):
        ta = self.a.submit(req, now=now)
        tb = self.b.submit(self.to_b(req), now=now)
        # a duplicate of an in-flight key returns the same ticket on both
        assert self.pairs.setdefault(id(ta), (ta, tb))[1] is tb, req.key
        assert_same_ticket(ta, tb)
        return ta

    def pump(self, *, now: float):
        ra, rb = self.a.pump(now=now), self.b.pump(now=now)
        self.pumps += 1
        assert_same_report(ra, rb)
        for ta, tb in self.pairs.values():
            assert_same_ticket(ta, tb)
        assert self.a.metrics == self.b.metrics
        assert self.bytes_a(self.a.index.state) == self.bytes_b(self.b.index.state)
        return ra


# ---------------------------------------------------------------------------
# subprocess child for the SIGKILL matrix
# ---------------------------------------------------------------------------


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--ticks", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-event", default=None)
    ap.add_argument("--kill-count", type=int, default=1)
    args = ap.parse_args()

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_fault_injection import KillAt

    hook = KillAt(args.kill_event, args.kill_count) if args.kill_event else None
    index = make_index(durability_dir=args.dir, crash_hook=hook)
    gateway = make_gateway(index, crash_hook=hook)

    def on_commit(report):
        if report.committed_keys:
            print(f"COMMIT {','.join(report.committed_keys)}", flush=True)

    result = run_traffic(
        gateway,
        default_population(args.seed),
        ticks=args.ticks,
        seed=args.seed,
        on_commit=on_commit,
    )
    gateway.close(now=float(result.end_tick))
    print(f"DONE {len(result.commit_log)}", flush=True)


if __name__ == "__main__":
    main()
