"""Multi-tenant batching gateway over ``KVPageIndex`` (port of
``repro/serve/gateway.py``; DESIGN.md §13).

The engine consumes one perfectly-formed mixed ``OpBatch`` per step; real
traffic is thousands of small, bursty, retried, duplicated client
requests.  The gateway is the layer between the two, and its headline
contract is robustness, not throughput:

* **exactly-once** — every request carries an idempotency key; a bounded
  dedup window (in-flight tickets + recently-committed keys) makes
  retried or duplicated submissions apply once, including across a
  ``DurableFliX`` crash/recovery boundary (the batch's keys are logged in
  its WAL record and reseeded from :meth:`KVPageIndex.dedup_seed`);
* **admission control** — per-tenant token buckets (rate/burst) and a
  bounded queue depth; whatever cannot be admitted is rejected with a
  TYPED reason and a ``retry_after`` hint instead of queueing unboundedly;
* **deadlines** — a request whose deadline has passed is rejected at
  admission or expired at batch formation, never executed late;
* **weighted fairness** — batch slots are granted by stride scheduling
  over tenant weights, so one hot tenant cannot starve the others;
* **graceful degradation** — when the update path is untrustworthy
  (poisoned durable layer: ``index.healthy`` is False), updates are
  rejected UNAVAILABLE while reads keep flowing (pure-read steps never
  touch the WAL);
* **typed failure mapping** — an engine exception resolves every ticket
  in the batch with ``ENGINE_FAILURE`` (the durable layer rolled the WAL
  back: not applied) or ``UNKNOWN_COMMIT`` (rollback failed: the batch
  may be durable; a retry after reopening resolves via the persisted
  dedup window) — never a lost or double-applied batch.

Everything is driven by an EXPLICIT virtual clock (``now`` arguments):
no threads, no sleeps, deterministic under replay — which is how
``tests/torch_traffic_replay.py`` differential-checks it against a
single-client oracle and how the CI soak stays fast and exact.

The gateway is host numpy: the index's answers cross to the host once per
engine step (the lookup slots, and the four RANGE tensors of the page
enumerations), and every ticket is sliced out of those host copies.  An
engine failure on the card (a kernel refused for its shared memory
included) maps to a typed error like any other; nothing falls back to
another device or path.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from repro_torch.serve.kv_index import PAGE_BITS, SnapshotGone

# ---------------------------------------------------------------------------
# rejection taxonomy (typed, stable strings — they cross process boundaries
# in the traffic-replay harness)
# ---------------------------------------------------------------------------

RATE_LIMITED = "RATE_LIMITED"  # tenant token bucket empty; retry_after set
QUEUE_FULL = "QUEUE_FULL"  # admission shed at bounded depth; retry_after set
DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"  # expired at admission or formation
UNAVAILABLE = "UNAVAILABLE"  # update path degraded / gateway closed
ENGINE_FAILURE = "ENGINE_FAILURE"  # engine raised; WAL rolled back: NOT applied
UNKNOWN_COMMIT = "UNKNOWN_COMMIT"  # rollback failed: MAY be durable; retry
INVALID = "INVALID"  # malformed request (e.g. larger than any batch)
SNAPSHOT_GONE = "SNAPSHOT_GONE"  # pinned version reclaimed; NOT retryable —
# the same as_of can never succeed again; re-issue against a live version

UPDATE_KINDS = ("alloc", "free")
READ_KINDS = ("lookup", "pages")


@dataclass(frozen=True)
class GatewayError:
    code: str
    retry_after: float | None = None
    detail: str = ""

    @property
    def retryable(self) -> bool:
        return self.code in (RATE_LIMITED, QUEUE_FULL, UNKNOWN_COMMIT, UNAVAILABLE)


@dataclass(frozen=True)
class Request:
    """One client micro-request.

    ``kind`` ∈ ``alloc | lookup | free | pages``; the aligned tuples carry
    its payload (``alloc``: seqs/pages/slots, ``lookup``: seqs/pages,
    ``free``/``pages``: seqs).  ``key`` is the idempotency key — client
    retries MUST reuse it; distinct requests MUST NOT share it.

    ``as_of`` pins a READ request to a committed index version
    (``KVPageIndex`` snapshot reads): the result is a consistent cut of
    that version no matter how many batches commit between submit and
    pump.  Updates with ``as_of`` are rejected INVALID, and a pinned
    version that left the retention window rejects SNAPSHOT_GONE
    (non-retryable — re-issue unpinned or against a newer version).
    """

    tenant: str
    key: str
    kind: str
    seqs: tuple
    pages: tuple = ()
    slots: tuple = ()
    deadline: float | None = None
    as_of: int | None = None

    def __post_init__(self):
        if self.kind not in UPDATE_KINDS + READ_KINDS:
            raise ValueError(f"unknown request kind {self.kind!r}")
        if self.kind == "alloc" and not (
            len(self.seqs) == len(self.pages) == len(self.slots)
        ):
            raise ValueError("alloc requires aligned seqs/pages/slots")
        if self.kind == "lookup" and len(self.seqs) != len(self.pages):
            raise ValueError("lookup requires aligned seqs/pages")

    @property
    def is_update(self) -> bool:
        return self.kind in UPDATE_KINDS


class Ticket:
    """Per-request future, resolved by ``pump`` (or synchronously at
    submit for rejections and duplicates).  Single-threaded: ``done``
    flips inside the same virtual-clock turn that resolves it."""

    __slots__ = (
        "request",
        "status",
        "value",
        "error",
        "duplicate",
        "submitted_at",
        "finished_at",
        "commit_seq",
    )

    def __init__(self, request: Request, now: float):
        self.request = request
        self.status = "pending"  # pending | ok | rejected | failed
        self.value = None
        self.error: GatewayError | None = None
        self.duplicate = False
        self.submitted_at = now
        self.finished_at: float | None = None
        self.commit_seq: int | None = None

    @property
    def done(self) -> bool:
        return self.status != "pending"

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def result(self):
        if self.status == "pending":
            raise RuntimeError("ticket not resolved yet — pump the gateway")
        if self.status != "ok":
            raise RuntimeError(f"request failed: {self.error}")
        return self.value

    def _resolve(self, value, *, now: float, seq=None, duplicate=False):
        self.status = "ok"
        self.value = value
        self.commit_seq = seq
        self.duplicate = duplicate
        self.finished_at = now

    def _reject(self, code: str, *, now: float, retry_after=None, detail=""):
        self.status = "rejected"
        self.error = GatewayError(code, retry_after, detail)
        self.finished_at = now

    def _fail(self, code: str, *, now: float, detail=""):
        self.status = "failed"
        self.error = GatewayError(code, detail=detail)
        self.finished_at = now


class _Bucket:
    """Token bucket: ``rate`` tokens/virtual-second, ``burst`` cap."""

    __slots__ = ("rate", "burst", "tokens", "t")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t = now

    def try_take(self, n: float, now: float) -> float | None:
        """Take ``n`` tokens; None on success, else seconds until enough
        tokens accrue (the ``retry_after`` hint)."""
        if now > self.t:
            self.tokens = min(self.burst, self.tokens + (now - self.t) * self.rate)
            self.t = now
        if self.tokens >= n:
            self.tokens -= n
            return None
        if self.rate <= 0:
            return float("inf")
        return (n - self.tokens) / self.rate


@dataclass
class _Tenant:
    name: str
    weight: float
    bucket: _Bucket
    queue: deque = field(default_factory=deque)
    # stride scheduling state: the tenant with the smallest pass goes
    # first; serving `cost` ops advances it by cost/weight
    pass_value: float = 0.0


@dataclass
class PumpReport:
    """What one ``pump`` did — the harness's commit-log record."""

    committed_keys: list
    n_ops: int
    expired: int
    failed_code: str | None
    stats: dict
    commit_seq: int | None


class Gateway:
    """Exactly-once batching frontend over one :class:`KVPageIndex`.

    ``submit`` admits (or rejects) micro-requests; ``pump`` forms ONE
    mixed engine batch under weighted fairness and commits it.  Both take
    the virtual ``now``; nothing in here reads a wall clock.

    ``max_batch_ops`` bounds one engine batch (frees cost ``max_pages``
    ops each — they expand to per-page deletes); ``max_queue_ops`` bounds
    total queued work, the admission-control shed point; ``dedup_window``
    bounds the committed-key memory (a retry older than the window may
    re-apply — clients must not retry past it, and the window is sized
    orders of magnitude above any sane retry horizon).
    """

    def __init__(
        self,
        index,
        *,
        max_batch_ops: int = 256,
        max_queue_ops: int = 2048,
        dedup_window: int = 4096,
        max_pages: int = 64,
        range_budget: int = 256,
        default_rate: float = 64.0,
        default_burst: float = 128.0,
        crash_hook=None,
    ):
        self.index = index
        self.max_batch_ops = int(max_batch_ops)
        self.max_queue_ops = int(max_queue_ops)
        self.dedup_window = int(dedup_window)
        self.max_pages = int(max_pages)
        self.range_budget = int(range_budget)
        self.default_rate = float(default_rate)
        self.default_burst = float(default_burst)
        self._hook = crash_hook or (lambda event: None)
        self._tenants: dict[str, _Tenant] = {}
        self._pending: dict[str, Ticket] = {}  # queued or mid-commit
        self._committed: dict[str, int] = {}  # key -> commit seq (bounded FIFO)
        self._committed_order: deque[str] = deque()
        self._queued_ops = 0
        self._commits = 0
        self._closed = False
        self.metrics = {
            "submitted": 0,
            "admitted": 0,
            "duplicates": 0,
            "committed_ops": 0,
            "committed_requests": 0,
            "batches": 0,
            "expired": 0,
            "engine_failures": 0,
            "restructure_retries": 0,
            "a2a_retries": 0,
            # tiered residency (DESIGN.md §15): page-in/page-out totals and
            # reclaimed bytes accumulate; resident_bytes is a gauge (the
            # latest committed batch's device-tier footprint, 0 single-tier)
            "promoted": 0,
            "demoted": 0,
            "reclaimed_bytes": 0,
            "resident_bytes": 0,
            "rejected": {},
        }
        # recovery: reseed the dedup window from the durable meta trail so
        # a retry of a batch that committed right before the crash (acked
        # or not) resolves as a duplicate instead of re-applying
        for seq, meta in index.dedup_seed():
            for key in (meta or {}).get("keys", ()):
                self._remember(key, int(seq))
        if self._committed_order:
            self._commits = max(self._committed.values())

    # -- tenants ----------------------------------------------------------
    def register_tenant(
        self,
        name: str,
        *,
        rate: float | None = None,
        burst: float | None = None,
        weight: float = 1.0,
        now: float = 0.0,
    ) -> None:
        """Declare a tenant's rate limit and fairness weight.  Unknown
        tenants are auto-registered at defaults on first submit."""
        if weight <= 0:
            raise ValueError("tenant weight must be positive")
        bucket = _Bucket(
            self.default_rate if rate is None else rate,
            self.default_burst if burst is None else burst,
            now,
        )
        # a new tenant starts at the max live pass value, not 0 — joining
        # late must not grant a catch-up burst over everyone else
        floor = max((t.pass_value for t in self._tenants.values()), default=0.0)
        self._tenants[name] = _Tenant(name, float(weight), bucket, pass_value=floor)

    def _tenant(self, name: str, now: float) -> _Tenant:
        if name not in self._tenants:
            self.register_tenant(name, now=now)
        return self._tenants[name]

    # -- admission --------------------------------------------------------
    def _cost(self, req: Request) -> int:
        if req.kind == "free":
            return len(req.seqs) * self.max_pages  # expands to per-page deletes
        return max(1, len(req.seqs))

    def _remember(self, key: str, seq: int) -> None:
        if key not in self._committed:
            self._committed_order.append(key)
        self._committed[key] = seq
        while len(self._committed_order) > self.dedup_window:
            self._committed.pop(self._committed_order.popleft(), None)

    @property
    def queue_depth(self) -> int:
        """Currently queued work in engine ops — bounded by
        ``max_queue_ops`` (the admission-control invariant)."""
        return self._queued_ops

    def submit(self, req: Request, *, now: float) -> Ticket:
        """Admit one request.  Always returns a ticket; rejections and
        duplicate-of-committed resolve synchronously, a duplicate of an
        in-flight key returns THE SAME ticket (one commit, many holders).
        """
        self.metrics["submitted"] += 1
        if req.key in self._pending:
            self.metrics["duplicates"] += 1
            return self._pending[req.key]
        tk = Ticket(req, now)
        if req.key in self._committed:
            self.metrics["duplicates"] += 1
            tk._resolve(
                {"applied": True},
                now=now,
                seq=self._committed[req.key],
                duplicate=True,
            )
            return tk
        if self._closed:
            return self._rejected(tk, UNAVAILABLE, now, detail="gateway closed")
        if req.deadline is not None and req.deadline <= now:
            return self._rejected(tk, DEADLINE_EXCEEDED, now)
        if req.is_update and not self.index.healthy:
            return self._rejected(
                tk,
                UNAVAILABLE,
                now,
                retry_after=None,
                detail="update path degraded (read-only mode)",
            )
        cost = self._cost(req)
        if cost > self.max_batch_ops:
            return self._rejected(
                tk, INVALID, now, detail=f"request cost {cost} > max_batch_ops"
            )
        if req.as_of is not None and req.is_update:
            return self._rejected(
                tk, INVALID, now, detail="as_of pins reads; updates cannot use it"
            )
        if self._queued_ops + cost > self.max_queue_ops:
            # shed BEFORE the bucket so the rejected request's tokens are
            # not burned; retry_after ≈ pumps needed to drain the backlog
            drain = self._queued_ops / max(1, self.max_batch_ops)
            return self._rejected(tk, QUEUE_FULL, now, retry_after=max(1.0, drain))
        tenant = self._tenant(req.tenant, now)
        wait = tenant.bucket.try_take(cost, now)
        if wait is not None:
            return self._rejected(tk, RATE_LIMITED, now, retry_after=wait)
        tenant.queue.append(tk)
        self._pending[req.key] = tk
        self._queued_ops += cost
        self.metrics["admitted"] += 1
        return tk

    def _rejected(self, tk: Ticket, code: str, now, *, retry_after=None, detail=""):
        tk._reject(code, now=now, retry_after=retry_after, detail=detail)
        self.metrics["rejected"][code] = self.metrics["rejected"].get(code, 0) + 1
        return tk

    # -- batch formation + commit ----------------------------------------
    def pump(self, *, now: float) -> PumpReport:
        """Form one mixed batch under weighted fairness and commit it.

        Coalescing rules (the ``apply_ops`` one-update-op-per-key
        precondition, DESIGN.md §8): within a batch an alloc key appears
        at most once, a freed sequence excludes allocs of that sequence
        (and repeat frees of it), in either order.  A conflicting request
        blocks its tenant's queue for THIS pump only (per-tenant FIFO is
        what makes retried updates of one key ordered).
        """
        batch: list[Ticket] = []
        expired = 0
        budget = self.max_batch_ops
        blocked: set[str] = set()
        update_keys: set[int] = set()
        alloc_seqs: set[int] = set()
        free_seqs: set[int] = set()
        while budget > 0:
            live = [
                t
                for t in self._tenants.values()
                if t.queue and t.name not in blocked
            ]
            if not live:
                break
            tn = min(live, key=lambda t: (t.pass_value, t.name))
            tk = tn.queue[0]
            req = tk.request
            cost = self._cost(req)
            if req.deadline is not None and req.deadline <= now:
                tn.queue.popleft()
                self._queued_ops -= cost
                del self._pending[req.key]
                self._rejected(tk, DEADLINE_EXCEEDED, now)
                expired += 1
                self.metrics["expired"] += 1
                continue
            if cost > budget or self._conflicts(
                req, update_keys, alloc_seqs, free_seqs
            ):
                blocked.add(tn.name)  # head-of-line: keep tenant FIFO exact
                continue
            tn.queue.popleft()
            self._queued_ops -= cost
            batch.append(tk)
            budget -= cost
            tn.pass_value += cost / tn.weight
            if req.kind == "alloc":
                alloc_seqs.update(req.seqs)
                update_keys.update(
                    (int(s) << PAGE_BITS) | int(p)
                    for s, p in zip(req.seqs, req.pages)
                )
            elif req.kind == "free":
                free_seqs.update(req.seqs)
        if not batch:
            return PumpReport([], 0, expired, None, {}, None)
        return self._commit(batch, expired, now)

    @staticmethod
    def _conflicts(req, update_keys, alloc_seqs, free_seqs) -> bool:
        if req.kind == "alloc":
            if any(int(s) in free_seqs for s in req.seqs):
                return True
            return any(
                ((int(s) << PAGE_BITS) | int(p)) in update_keys
                for s, p in zip(req.seqs, req.pages)
            )
        if req.kind == "free":
            return any(
                int(s) in alloc_seqs or int(s) in free_seqs for s in req.seqs
            )
        return False

    def _commit(self, batch: list[Ticket], expired: int, now: float) -> PumpReport:
        # pinned reads run as separate read-only steps against their pinned
        # version — they cannot share the main step, which serves the LIVE
        # post-update state (update-then-read); grouping by as_of keeps one
        # engine step per distinct pinned version
        pinned: dict[int, list[Ticket]] = {}
        main: list[Ticket] = []
        for tk in batch:
            if tk.request.as_of is not None:
                pinned.setdefault(int(tk.request.as_of), []).append(tk)
            else:
                main.append(tk)

        al_seq, al_page, al_slot = [], [], []
        lu_seq, lu_page = [], []
        fr_seq = []
        rg_lo, rg_hi = [], []
        slices: list[tuple] = []  # per ticket: (kind, start, length)
        for tk in main:
            req = tk.request
            if req.kind == "alloc":
                slices.append(("alloc", 0, 0))
                al_seq += list(req.seqs)
                al_page += list(req.pages)
                al_slot += list(req.slots)
            elif req.kind == "lookup":
                slices.append(("lookup", len(lu_seq), len(req.seqs)))
                lu_seq += list(req.seqs)
                lu_page += list(req.pages)
            elif req.kind == "free":
                slices.append(("free", 0, 0))
                fr_seq += list(req.seqs)
            else:  # pages
                slices.append(("pages", len(rg_lo), len(req.seqs)))
                for s in req.seqs:
                    rg_lo.append(int(s) << PAGE_BITS)
                    rg_hi.append((int(s) + 1) << PAGE_BITS)
        is_update = bool(al_seq or fr_seq)
        n_ops = len(al_seq) + len(lu_seq) + len(fr_seq) + len(rg_lo)
        meta = {"keys": [tk.request.key for tk in main]} if is_update else None
        self._hook("gateway.batch.formed")

        # pinned groups first — each is its own read-only engine step, so a
        # reclaimed version rejects ONLY its own tickets (SNAPSHOT_GONE)
        pinned_keys: list = []
        n_pinned = 0
        for as_of in sorted(pinned):
            n_pinned += self._pinned_step(pinned[as_of], as_of, now, pinned_keys)

        if not main:
            if pinned_keys:
                self._commits += 1
                self.metrics["batches"] += 1
                self.metrics["committed_ops"] += n_pinned
                self.metrics["committed_requests"] += len(pinned_keys)
            return PumpReport(pinned_keys, n_pinned, expired, None, {}, None)
        try:
            step_res = self.index.step(
                allocs=(al_seq, al_page, al_slot) if al_seq else None,
                lookups=(lu_seq, lu_page) if lu_seq else None,
                free_seqs=fr_seq or None,
                ranges=(rg_lo, rg_hi) if rg_lo else None,
                max_pages=self.max_pages,
                range_budget=self.range_budget,
                meta=meta,
            )
            slots, range_out, stats = step_res.slots, step_res.range_out, step_res.stats
        except Exception as e:  # noqa: BLE001 — mapped to typed errors
            # CrashError/KeyboardInterrupt are BaseException: they pass
            # through like the process death they simulate
            unknown = is_update and not self.index.healthy
            code = UNKNOWN_COMMIT if unknown else ENGINE_FAILURE
            for tk in main:
                self._pending.pop(tk.request.key, None)
                tk._fail(code, now=now, detail=str(e))
            self.metrics["engine_failures"] += 1
            self.metrics["rejected"][code] = (
                self.metrics["rejected"].get(code, 0) + len(main)
            )
            return PumpReport(pinned_keys, n_ops + n_pinned, expired, code, {}, None)
        self._hook("gateway.step.done")  # commit is durable; acks not yet out
        self._commits += 1
        seq = self.index.durable_seq if is_update else None
        if seq is None:
            seq = self._commits
        slots_np = slots.cpu().numpy() if lu_seq else None
        range_np = _to_host(range_out)
        for tk, (kind, start, length) in zip(main, slices):
            if kind == "lookup":
                value = slots_np[start : start + length]
            elif kind == "pages":
                value = self._range_slices(range_np, start, length)
            else:
                value = {"applied": True}
            self._pending.pop(tk.request.key, None)
            self._remember(tk.request.key, seq)
            tk._resolve(value, now=now, seq=seq)
        self._hook("gateway.acked")
        self.metrics["batches"] += 1
        self.metrics["committed_ops"] += n_ops + n_pinned
        self.metrics["committed_requests"] += len(main) + len(pinned_keys)
        self.metrics["restructure_retries"] += int(
            stats.get("restructure_retries", 0)
        )
        self.metrics["a2a_retries"] += int(stats.get("a2a_retries", 0))
        self.metrics["promoted"] += int(stats.get("promoted", 0))
        self.metrics["demoted"] += int(stats.get("demoted", 0))
        self.metrics["reclaimed_bytes"] += int(stats.get("reclaimed_bytes", 0))
        if "resident_bytes" in stats:
            self.metrics["resident_bytes"] = int(stats["resident_bytes"])
        return PumpReport(
            [tk.request.key for tk in main] + pinned_keys,
            n_ops + n_pinned,
            expired,
            None,
            stats,
            seq,
        )

    def _pinned_step(
        self, tks: list[Ticket], as_of: int, now: float, out_keys: list
    ) -> int:
        """Serve one pinned-version group as a read-only ``as_of`` engine
        step; returns the ops served (0 when the whole group rejects)."""
        lu_seq, lu_page = [], []
        rg_lo, rg_hi = [], []
        slices: list[tuple] = []
        for tk in tks:
            req = tk.request
            if req.kind == "lookup":
                slices.append(("lookup", len(lu_seq), len(req.seqs)))
                lu_seq += list(req.seqs)
                lu_page += list(req.pages)
            else:  # pages
                slices.append(("pages", len(rg_lo), len(req.seqs)))
                for s in req.seqs:
                    rg_lo.append(int(s) << PAGE_BITS)
                    rg_hi.append((int(s) + 1) << PAGE_BITS)
        try:
            step_res = self.index.step(
                lookups=(lu_seq, lu_page) if lu_seq else None,
                ranges=(rg_lo, rg_hi) if rg_lo else None,
                max_pages=self.max_pages,
                range_budget=self.range_budget,
                as_of=as_of,
            )
            slots, range_out = step_res.slots, step_res.range_out
        except SnapshotGone as e:
            for tk in tks:
                self._pending.pop(tk.request.key, None)
                self._rejected(tk, SNAPSHOT_GONE, now, detail=str(e))
            return 0
        except ValueError as e:
            # never-committed version / window off: a caller error, typed
            # INVALID so it is visibly non-retryable
            for tk in tks:
                self._pending.pop(tk.request.key, None)
                self._rejected(tk, INVALID, now, detail=str(e))
            return 0
        seq = self._commits + 1
        slots_np = slots.cpu().numpy() if lu_seq else None
        range_np = _to_host(range_out)
        for tk, (kind, start, length) in zip(tks, slices):
            if kind == "lookup":
                value = slots_np[start : start + length]
            else:
                value = self._range_slices(range_np, start, length)
            self._pending.pop(tk.request.key, None)
            self._remember(tk.request.key, seq)
            tk._resolve(value, now=now, seq=seq)
            out_keys.append(tk.request.key)
        return len(lu_seq) + len(rg_lo)

    @staticmethod
    def _range_slices(range_np, start: int, length: int):
        """Per-op page dicts of ops ``[start, start + length)``, sliced
        out of the step's host copy of its RANGE output."""
        out = []
        for i in range(start, start + length):
            s = int(range_np["start"][i])
            c = int(range_np["count"][i])
            out.append(
                {
                    "pages": range_np["keys"][s : s + c] & ((1 << PAGE_BITS) - 1),
                    "slots": range_np["vals"][s : s + c],
                    "count": c,
                }
            )
        return out

    # -- teardown ---------------------------------------------------------
    def drain(self, *, now: float, max_pumps: int = 1_000) -> int:
        """Pump until every queued request resolves (bounded); returns the
        number of pumps.  Deterministic — used by tests and shutdown."""
        pumps = 0
        while self._queued_ops > 0 and pumps < max_pumps:
            report = self.pump(now=now)
            pumps += 1
            if report.n_ops == 0 and report.expired == 0:
                break  # only blocked/conflicting work left and it cannot fit
        return pumps

    def close(self, *, now: float = 0.0) -> None:
        """Reject everything still queued (UNAVAILABLE, retryable after a
        reopen) and close the index.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        for tn in self._tenants.values():
            while tn.queue:
                tk = tn.queue.popleft()
                self._pending.pop(tk.request.key, None)
                self._rejected(tk, UNAVAILABLE, now, detail="gateway closed")
        self._queued_ops = 0
        self.index.close()


def _to_host(range_out):
    """One engine step's RANGE output as host numpy arrays (None without
    ranges): one copy a tensor, whatever number of tickets it answers."""
    if range_out is None:
        return None
    return {k: v.cpu().numpy() for k, v in range_out.items()}
