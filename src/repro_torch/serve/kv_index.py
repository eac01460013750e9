"""FliX-backed KV page index (port of ``repro/serve/kv_index.py``): the
paper's CDS as the page-table control plane of an LLM server.

The control plane maps (sequence_id, page_no) → cache slot under continuous
allocation (prefill, decode) and freeing (completion).  Keys are
``seq_id << PAGE_BITS | page_no``, so one RANGE op enumerates a sequence's
pages in order, and batched frees are physical deletions with immediate
slot reclamation.

Each engine step submits one mixed sorted batch of (allocate | lookup |
get-or-set | free | enumerate) operations through ``core.ops.apply_ops``:
one sort, one bucket routing, one flipped pass.  Batches are padded to the
next power of two, as the reference pads them for its jit cache.

Two time features ride the same batch model:

* **TTL**: ``step(now=...)`` threads the server's virtual clock into the
  engine (rows past their deadline are invisible and reclaimed lazily), and
  ``getsets`` submits get-or-set-with-TTL ops (``OP_EXPIRE``);
* **snapshot reads**: with ``snapshot_window > 0`` every committed update
  step pins its (functional, never written) state with its clock, and
  ``step(as_of=v)`` serves reads against that version at its own clock
  until the window slides past it (:class:`SnapshotGone`).

``durability_dir`` switches on the persistence layer of ``checkpoint``:
every update step is logged (fsynced) before it runs and snapshotted every
``snapshot_every`` steps, and an index built on a directory that already
holds a durable history recovers it instead of starting empty.  Pure-read
steps never touch the log.

``device_budget`` (bytes) switches the engine to tiered residency
(``core.residency.TieredFliX``): the index lives in host memory and may
grow far beyond the budget, each step promotes the buckets its batch
touches onto the device and demotes back under the budget after the
commit.  Results and durable bytes are those of the single-tier index;
step stats also carry the residency counters.

``shards`` range-partitions the index over that many shards
(``core.distributed``): each step runs through ``shard_apply_ops`` (reads)
or ``shard_apply_ops_safe`` (updates) under ``config.routing``, and durable
steps through a ``ShardEngine``.  Results and durable bytes are those of
the single-shard index.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import (
    MAX_VALID,
    NO_EXPIRY,
    OP_DELETE,
    OP_EXPIRE,
    OP_INSERT,
    OP_POINT,
    OP_RANGE,
    ExecConfig,
    apply_ops,
    apply_ops_safe,
    build,
    make_ops,
    unsort,
)
from repro_torch.core.distributed import (
    make_shard_mesh,
    shard_apply_ops,
    shard_apply_ops_safe,
    shard_build,
)
from repro_torch.core.residency import TieredFliX
from repro_torch.core.state import resolve_device

PAGE_BITS = 12  # up to 4096 pages per sequence


@dataclasses.dataclass(frozen=True)
class StepResult:
    """One engine step's outcome (:meth:`KVPageIndex.step`).

    * ``slots``     — resolved cache slots aligned with the ``lookups``
      input order followed by the ``getsets`` input order (NOT_FOUND = -1).
    * ``range_out`` — None without ``ranges``, else the dense ``keys`` /
      ``vals`` tensors plus per-op ``start`` / ``count`` aligned with the
      ``ranges`` input order.
    * ``stats``     — the engine step's stats dict (empty for a no-op step).

    Deliberately not iterable, as in the reference: stale tuple unpacking
    fails loudly.
    """

    slots: torch.Tensor
    range_out: dict | None
    stats: dict


class SnapshotGone(LookupError):
    """The requested pinned version slid out of the retention window; the
    read must be sent again against a live version."""


def _key(seq_ids: torch.Tensor, page_nos: torch.Tensor) -> torch.Tensor:
    return (seq_ids.to(torch.int32) << PAGE_BITS) | page_nos.to(torch.int32)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _len(x) -> int:
    return len(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x))


def _host_ints(x) -> list[int]:
    host = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return host.astype(np.int64).tolist()


class KVPageIndex:
    """Host-driven wrapper around a FliXState on one device, or a
    ``ShardedFliX`` over several.

    ``config`` is the execution strategy of every engine step (the port
    takes ``config=`` only): its ``impl`` picks the ``apply_ops`` executor
    for update steps (``"auto"``: the fused CUDA path on the card, the
    plain reference engine on the CPU) and its ``pipeline`` the fused
    path's stripe kernel.  Read-only steps always run the reference engine,
    allocation and get-or-set steps go through ``apply_ops_safe``
    (restructure and retry on overflow), as in the reference; with
    durability every update step goes through the durable layer, which
    restructures and retries itself.

    ``snapshot_window`` > 0 retains that many recent committed versions for
    ``step(as_of=...)``.  ``device`` is where the index lives: the card
    unless the caller names another (``"cpu"``).

    ``durability_dir`` logs every update step before it runs (fsynced, or
    buffered with ``wal_fsync=False``, which removes the durability
    boundary and exists for the negative crash tests), snapshots every
    ``snapshot_every`` steps, and recovers a history already in the
    directory.  ``crash_hook`` receives the durable layer's named events.

    ``device_budget`` (bytes) makes the index tiered: the local state is a
    ``TieredFliX`` (with durability, behind a ``TieredEngine``), read-only
    steps run it with ``commit=False`` and update steps with
    ``commit=True``, its own grow and replay covering an overflow.  It
    refuses ``snapshot_window``: pinned versions need immutable states,
    and the tiered handle mutates.

    ``shards`` > 0 makes the index sharded (``state`` is then a
    ``ShardedFliX`` over ``mesh``): ``device=d`` places every shard on
    ``d``, and without a device the shards take the first ``shards`` cards,
    raising when there are fewer.  ``config.routing`` picks the routing; a
    step's padded size is rounded up to a multiple of the shard count, so
    that ``"a2a"`` chunks are equal.  It refuses ``device_budget``, a
    single-device residency bound (the reference sizes each shard with
    ``plan_shard_budget`` instead).
    """

    def __init__(
        self,
        *,
        node_size: int = 16,
        nodes_per_bucket: int = 8,
        config: ExecConfig | None = None,
        snapshot_window: int = 0,
        device=None,
        shards: int = 0,
        durability_dir=None,
        snapshot_every: int = 64,
        wal_fsync: bool = True,
        crash_hook=None,
        device_budget: int | None = None,
    ):
        if device_budget is not None and shards:
            raise ValueError(
                "device_budget is a single-device residency bound; "
                "sharded indexes size each shard via plan_shard_budget"
            )
        if device_budget is not None and snapshot_window:
            raise ValueError(
                "device_budget and snapshot_window are incompatible: "
                "pinned versions need immutable functional states"
            )
        self.config = config if config is not None else ExecConfig()
        self.mesh = None
        if shards:
            self.mesh = make_shard_mesh(
                shards, None if device is None else [resolve_device(device)] * shards
            )
            self.device = self.mesh.devices[0]
        else:
            self.device = resolve_device(device)
        self.snapshot_window = int(snapshot_window)
        self._version = 0
        self._pins: dict[int, tuple[object, int | None]] = {}
        self._durable = None
        self._closed = False
        # seed with one sentinel key (outside the (seq, page) space) so the
        # structure is never empty
        seed = torch.tensor([MAX_VALID], dtype=torch.int32)
        if self.mesh is not None:
            self.state = shard_build(
                seed.to(self.device),
                torch.zeros(1, dtype=torch.int32, device=self.device),
                self.mesh,
                node_size=node_size,
                nodes_per_bucket=nodes_per_bucket,
            )
        else:
            self.state = build(
                seed,
                torch.zeros(1, dtype=torch.int32),
                node_size=node_size,
                nodes_per_bucket=nodes_per_bucket,
                device=self.device,
            )
        if device_budget is not None:
            self.state = TieredFliX.from_state(self.state, budget_bytes=device_budget)
        if durability_dir is not None:
            from repro_torch.checkpoint import (
                DurableFliX,
                LocalEngine,
                ShardEngine,
                TieredEngine,
            )

            engine_kw = dict(
                config=self.config,
                node_size=node_size,
                nodes_per_bucket=nodes_per_bucket,
                device=self.device,
            )
            if self.mesh is not None:
                del engine_kw["device"]
                engine = ShardEngine(self.mesh, **engine_kw)
            elif device_budget is not None:
                engine = TieredEngine(budget_bytes=device_budget, **engine_kw)
            else:
                engine = LocalEngine(**engine_kw)
            kw = dict(
                engine=engine,
                snapshot_every=snapshot_every,
                fsync=wal_fsync,
                crash_hook=crash_hook,
            )
            if DurableFliX.exists(durability_dir):
                self._durable = DurableFliX.open(durability_dir, **kw)
            else:
                self._durable = DurableFliX.create(durability_dir, self.state, **kw)
            self.state = self._durable.handle
        if self.snapshot_window:
            self._pins[0] = (self.state, None)

    def _i32(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=torch.int32).reshape(-1)

    # ---- the engine step: one mixed batch ------------------------------
    def step(
        self,
        *,
        allocs=None,
        lookups=None,
        getsets=None,
        free_seqs=None,
        ranges=None,
        max_pages: int = 256,
        range_budget: int = 256,
        meta=None,
        now: int | None = None,
        as_of: int | None = None,
    ) -> StepResult:
        """Submit one engine step's mixed work as a single sorted batch.

        ``allocs``    — (seq_ids, page_nos, slots[, deadlines]): register
                        pages, with an optional absolute expiry deadline each.
        ``lookups``   — (seq_ids, page_nos): resolve pages → slots.
        ``getsets``   — (seq_ids, page_nos, slots, deadlines): get-or-set
                        with TTL (``OP_EXPIRE``): a mapped page returns its
                        existing slot and has its deadline refreshed; an
                        unmapped one is registered and returns NOT_FOUND.
        ``free_seqs`` — sequence ids whose pages ``[0, max_pages)`` are freed.
        ``ranges``    — (lo_keys, hi_keys): half-open ``[lo, hi)`` RANGE ops
                        in raw key space under the static ``range_budget``.

        ``now`` is the step's virtual clock: rows with ``exp <= now`` are
        reclaimed before the batch's updates and invisible to its reads; a
        read-only step computes that view on a throwaway copy and commits
        nothing.  ``as_of`` runs a read-only step against a retained
        committed version at that version's own clock (``now`` must be
        None); a version that left the window raises :class:`SnapshotGone`.

        ``meta`` (JSON-serializable, e.g. a gateway's idempotency keys) is
        logged inside the update batch's WAL record when durability is on
        and ignored otherwise; a pure-read step logs nothing.

        ``allocs``, ``getsets`` and ``free_seqs`` must not overlap in key
        space within one step (``apply_ops``' one-update-op-per-key
        precondition); this is checked here, on the host.
        """
        # empty op lists are the same as absent ones
        if allocs is not None and _len(allocs[0]) == 0:
            allocs = None
        if free_seqs is not None and _len(free_seqs) == 0:
            free_seqs = None
        if lookups is not None and _len(lookups[0]) == 0:
            lookups = None
        if getsets is not None and _len(getsets[0]) == 0:
            getsets = None
        if ranges is not None and _len(ranges[0]) == 0:
            ranges = None
        self._check_overlaps(allocs, getsets, free_seqs)

        pinned = None
        if as_of is not None:
            if allocs is not None or getsets is not None or free_seqs is not None:
                raise ValueError("as_of pins a read-only step; it cannot update")
            if now is not None:
                raise ValueError(
                    "as_of reads run at the pinned version's own clock; pass now=None"
                )
            if self.snapshot_window <= 0:
                raise ValueError("snapshot reads require snapshot_window > 0")
            if not (0 <= as_of <= self._version):
                raise ValueError(
                    f"as_of={as_of} was never committed (version={self._version})"
                )
            if as_of not in self._pins:
                raise SnapshotGone(
                    f"version {as_of} left the {self.snapshot_window}-deep "
                    f"retention window (current version {self._version})"
                )
            pinned, now = self._pins[as_of]

        dev = self.device
        tags, keys, vals, exps = [], [], [], []
        has_ttl = getsets is not None or (allocs is not None and len(allocs) == 4)
        n_alloc = n_lookup = n_getset = 0

        def add(tag, k, v, e=None):
            tags.append(torch.full(k.shape, tag, dtype=torch.int32, device=dev))
            keys.append(k)
            vals.append(v if v is not None else torch.zeros_like(k))
            exps.append(e if e is not None else torch.full_like(k, NO_EXPIRY))

        if allocs is not None:
            k = _key(self._i32(allocs[0]), self._i32(allocs[1]))
            n_alloc = k.shape[0]
            add(OP_INSERT, k, self._i32(allocs[2]),
                self._i32(allocs[3]) if len(allocs) == 4 else None)
        if lookups is not None:
            k = _key(self._i32(lookups[0]), self._i32(lookups[1]))
            n_lookup = k.shape[0]
            add(OP_POINT, k, None)
        if getsets is not None:
            k = _key(self._i32(getsets[0]), self._i32(getsets[1]))
            n_getset = k.shape[0]
            add(OP_EXPIRE, k, self._i32(getsets[2]), self._i32(getsets[3]))
        if free_seqs is not None:
            seq = self._i32(free_seqs)
            page = torch.arange(max_pages, dtype=torch.int32, device=dev)
            k = (seq[:, None] << PAGE_BITS) | page[None, :]
            add(OP_DELETE, k.reshape(-1), None)
        n_before_range = sum(int(k.shape[0]) for k in keys)
        n_range = 0
        if ranges is not None:
            lo = self._i32(ranges[0])
            n_range = lo.shape[0]
            add(OP_RANGE, lo, self._i32(ranges[1]))
        if not keys:
            return StepResult(
                slots=torch.zeros((0,), dtype=torch.int32, device=dev),
                range_out=None,
                stats={},
            )

        key = torch.cat(keys)
        pad_to = _next_pow2(key.shape[0])
        if self.mesh is not None:
            # a2a position-shards the batch: equal chunks need a multiple
            # of the shard count
            pad_to = -(-pad_to // self.mesh.size) * self.mesh.size
        ops, perm = make_ops(
            torch.cat(tags),
            key,
            torch.cat(vals),
            exps=torch.cat(exps) if has_ttl else None,
            pad_to=pad_to,
            device=dev,
        )
        read_only = n_alloc == 0 and n_getset == 0 and free_seqs is None
        has_ranges = n_range > 0
        if read_only:
            # the state is untouched: keep the pre-batch state, and run the
            # reference engine (the fused pass would rewrite every stripe)
            cfg = self.config.replace(impl="reference", max_results=range_budget)
            state = self.state if pinned is None else pinned
            if self.mesh is not None:
                _, results, stats = shard_apply_ops(
                    state, ops, self.mesh, config=cfg, has_ranges=has_ranges, now=now
                )
            elif isinstance(state, TieredFliX):
                # pages buckets in and out, but keeps the logical content
                results, stats, _ = state.apply(ops, config=cfg, now=now, commit=False)
            else:
                _, results, stats = apply_ops(state, ops, config=cfg, now=now)
        elif self._durable is not None:
            # WAL-ahead, with the engine's own restructure and retry
            cfg = self.config.replace(max_results=range_budget)
            results, stats = self._durable.apply(ops, config=cfg, meta=meta, now=now)
            self._commit(self._durable.handle, now)
        elif isinstance(self.state, TieredFliX):
            # the tiered handle mutates in place and grows and replays itself
            cfg = self.config.replace(max_results=range_budget)
            results, stats, _ = self.state.apply(ops, config=cfg, now=now)
            self._commit(self.state, now)
        elif self.mesh is not None:
            # ``shard_apply_ops_safe`` regrows through shard_restructure and retries
            # a2a capacity; only inserts can overflow, so frees skip it
            cfg = self.config.replace(max_results=range_budget)
            run = shard_apply_ops if n_alloc == 0 and n_getset == 0 else shard_apply_ops_safe
            new, results, stats = run(
                self.state, ops, self.mesh, config=cfg, has_updates=True,
                has_ranges=has_ranges, now=now,
            )
            self._commit(new, now)
        elif n_alloc == 0 and n_getset == 0:
            # only inserts can overflow: free steps skip apply_ops_safe.  The
            # old state's planes are donated to the step, unless pinned
            # versions alias them (snapshot_window > 0)
            cfg = self.config.replace(max_results=range_budget, donate=self._donate())
            new, results, stats = apply_ops(
                self.state, ops, config=cfg, has_updates=True, now=now
            )
            self._commit(new, now)
        else:
            cfg = self.config.replace(max_results=range_budget, donate=self._donate())
            new, results, stats = apply_ops_safe(
                self.state, ops, config=cfg, has_updates=True, now=now
            )
            self._commit(new, now)
        values = unsort(results["value"], perm[: key.shape[0]])
        range_out = None
        if n_range:
            sub = perm[n_before_range : n_before_range + n_range]
            range_out = {
                "keys": results["range_key"],
                "vals": results["range_val"],
                "start": unsort(results["range_start"], sub),
                "count": unsort(results["range_count"], sub),
            }
        return StepResult(
            slots=values[n_alloc : n_alloc + n_lookup + n_getset],
            range_out=range_out,
            stats=stats,
        )

    @staticmethod
    def _check_overlaps(allocs, getsets, free_seqs) -> None:
        """Refuse two update ops on one key within one step."""
        if allocs is not None and free_seqs is not None:
            overlap = set(_host_ints(allocs[0])) & set(_host_ints(free_seqs))
            if overlap:
                raise ValueError(
                    f"sequences {sorted(overlap)} appear in both allocs and "
                    "free_seqs within one step; free them the step after "
                    "their last allocation"
                )
        if getsets is None:
            return
        if free_seqs is not None:
            overlap = set(_host_ints(getsets[0])) & set(_host_ints(free_seqs))
            if overlap:
                raise ValueError(
                    f"sequences {sorted(overlap)} appear in both getsets "
                    "and free_seqs within one step"
                )
        if allocs is not None:
            gs = {(s << PAGE_BITS) | p
                  for s, p in zip(_host_ints(getsets[0]), _host_ints(getsets[1]))}
            al = {(s << PAGE_BITS) | p
                  for s, p in zip(_host_ints(allocs[0]), _host_ints(allocs[1]))}
            if gs & al:
                raise ValueError(
                    "the same page appears in both allocs and getsets within one step"
                )

    def _donate(self) -> bool:
        """Whether an update step may write the committed state in place: not
        where pinned versions alias it, nor where the config forbids it."""
        return self.snapshot_window == 0 and self.config.donate is not False

    def _commit(self, new, now: int | None) -> None:
        """Install an update step's state, advance the version, and with a
        retention window pin it with its clock until the window slides past."""
        self.state = new
        self._version += 1
        if self.snapshot_window:
            self._pins[self._version] = (new, now)
            low = self._version - self.snapshot_window
            for v in [v for v in self._pins if v <= low]:
                del self._pins[v]

    # ---- per-type conveniences (each is still one engine step) ---------
    def allocate(self, seq_ids, page_nos, slots):
        """Batch-register pages → slots (an engine allocation step)."""
        return self.step(allocs=(seq_ids, page_nos, slots)).stats

    def lookup(self, seq_ids, page_nos):
        """Batch lookup → cache slots (NOT_FOUND = -1 for unmapped pages)."""
        return self.step(lookups=(seq_ids, page_nos)).slots

    def free_sequences(self, seq_ids, *, max_pages: int = 256):
        """Batch-free every page of the given sequences (physical removal)."""
        return self.step(free_seqs=seq_ids, max_pages=max_pages).stats

    def pages_of(self, seq_id: int, *, max_pages: int = 256):
        """All (page_no, slot) of a sequence, in order (a RANGE engine step)."""
        lo = seq_id << PAGE_BITS
        hi = (seq_id + 1) << PAGE_BITS
        out = self.step(ranges=([lo], [hi]), range_budget=max_pages).range_out
        return out["keys"] & ((1 << PAGE_BITS) - 1), out["vals"], out["count"][0]

    def live_pages(self) -> int:
        # a sharded index sums its shards
        return int(self.state.live_keys()) - 1  # minus the seed key

    def getset(self, seq_ids, page_nos, slots, deadlines, *, now=None):
        """Batch get-or-set with TTL (one ``OP_EXPIRE`` engine step)."""
        return self.step(getsets=(seq_ids, page_nos, slots, deadlines), now=now).slots

    # ---- snapshot versions ----------------------------------------------
    @property
    def version(self) -> int:
        """Count of committed update steps — the newest ``as_of`` value."""
        return self._version

    @property
    def retained_versions(self) -> list[int]:
        """Versions currently answerable via ``step(as_of=...)``."""
        return sorted(self._pins)

    # ---- residency -------------------------------------------------------
    @property
    def resident_bytes(self) -> int | None:
        """Device-tier footprint of a tiered index (None single-tier: the
        whole index is on the device)."""
        if isinstance(self.state, TieredFliX):
            return self.state.memory_bytes_resident()
        return None

    # ---- durability / health -------------------------------------------
    @property
    def durable_seq(self) -> int | None:
        """Last durably committed batch seq (None with durability off)."""
        return self._durable.seq if self._durable is not None else None

    @property
    def healthy(self) -> bool:
        """True while the update path is trustworthy: False once the
        durable layer is poisoned (live and durable state diverged after a
        failed WAL rollback) or the index is closed.  Reads of the live
        state stay valid either way."""
        if self._closed:
            return False
        return self._durable is None or self._durable.healthy

    def dedup_seed(self) -> list[tuple[int, object]]:
        """The durable ``(seq, meta)`` trail of recent update commits
        (empty with durability off) — what a gateway reseeds its dedup
        window from after crash recovery."""
        return self._durable.meta_trail() if self._durable is not None else []

    def snapshot(self):
        """Force a snapshot now (durability on); returns its directory.

        Idempotent — a snapshot at the current seq already on disk is
        revalidated, not rewritten — and returns None on an unhealthy
        instance instead of raising from a teardown path."""
        if self._durable is None:
            raise RuntimeError("durability is off (no durability_dir)")
        if not self._durable.healthy:
            return None
        return self._durable.snapshot()

    def close(self):
        """Flush and close the WAL (no-op with durability off).  Idempotent
        and safe on a poisoned durable layer."""
        if self._closed:
            return
        self._closed = True
        if self._durable is not None:
            self._durable.close()
