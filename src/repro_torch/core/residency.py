"""Tiered residency (port of ``repro/core/residency.py``; DESIGN.md §15):
a FliX index larger than the device budget.

The single-tier engine holds every bucket in one device state, so the
index must fit in device memory.  ``TieredFliX`` splits the same logical
state across two tiers:

  * **host tier** — a mirror of every bucket's rows in host memory, as
    CPU int32 tensors (page-locked when the engine runs on the card, so
    that copies to and from the card run at the link's rate): the
    authoritative copy of every bucket that is not resident;
  * **device tier** — a *packed* ``FliXState`` holding only the resident
    buckets, in fence order, with its last fence forced to ``MAX_VALID`` so
    that the packed state satisfies I5 on its own.

Residency is physical placement only: results, stats and canonical bytes
are those of the single-tier engine (I7, ``core.invariants
.check_tiered_invariants``).

Every ``apply`` runs the host prefetch pre-pass (``core.ops
.touched_buckets``), promotes the buckets the batch can touch (page-in:
mirror rows gathered into a page-locked buffer, then one asynchronous copy
a plane), runs the *unchanged* executors (``apply_ops``: on the card the
fused path's kernels) on the packed working set, and demotes down to the
budget after the commit (LRU page-out: a device ``index_select`` of the
evicted rows, one copy to the host, an ``index_copy_`` into the mirror).
Running the full-state executors on a packed subset is exact because of
fence disjointness: a bucket's rows reach only the ops routed to it, the
rank arithmetic over an interval of buckets (RANGE: the whole interval is
promoted), and the first-non-empty-bucket fallback (SUCCESSOR: the walk
up to a bucket guaranteed to survive the batch is promoted).  Resident
buckets outside the touched set pass through the stripe pass unchanged,
up to vals at EMPTY slots, which no read path reaches.

The policy is the reference's, which bounds its jit shapes: on any miss
every resident row is synced to the mirror and the whole working set
gathered again, and the working set is padded to a power of two with the
lowest cold buckets.  The port has no jit; it keeps both so that residency
and its counters match the reference's step for step.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.build import plan_geometry
from repro_torch.core.config import ExecConfig
from repro_torch.core.expiry import NO_EXPIRY, bucket_min_exp
from repro_torch.core.ops import (
    OP_DELETE,
    OP_EXPIRE,
    OP_INSERT,
    OpBatch,
    apply_ops,
    touched_buckets,
)
from repro_torch.core.restructure import restructure_grow, restructure_shrink
from repro_torch.core.state import EMPTY, MAX_VALID, FliXState, resolve_device

# the per-bucket planes paged between the tiers (never mkba: the packed
# copy's last fence is forced to MAX_VALID, the mirror's is the real one)
ROW_PLANES = ("keys", "vals", "node_count", "node_max", "num_nodes", "exps")


def bucket_device_bytes(nodes_per_bucket: int, node_size: int, has_exps: bool) -> int:
    """Device bytes one bucket occupies across every per-bucket array."""
    cells = nodes_per_bucket * node_size
    per = cells * 4 * (3 if has_exps else 2)  # keys + vals (+ exps)
    per += nodes_per_bucket * 4 * 2  # node_count + node_max
    per += 4 + 4  # num_nodes + mkba
    return per


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _bucket_meta(state: FliXState) -> torch.Tensor:
    """Per-bucket (live row count, minimum live deadline) of the packed
    working set as one [2, nb] int32 tensor, so that the host's metadata
    refresh after a commit is one copy."""
    live = state.node_count.sum(dim=1, dtype=torch.int32)
    return torch.stack([live, bucket_min_exp(state)])


def _take_buckets(state: FliXState, idx: torch.Tensor) -> FliXState:
    """Packed sub-state holding rows ``idx`` (sorted positions on the
    state's device), its fence array closed again at ``MAX_VALID`` (I5)."""
    mkba = state.mkba[idx]  # indexing copies: the input's fences stay
    mkba[-1] = MAX_VALID
    return FliXState(
        keys=state.keys[idx],
        vals=state.vals[idx],
        node_count=state.node_count[idx],
        node_max=state.node_max[idx],
        num_nodes=state.num_nodes[idx],
        mkba=mkba,
        needs_restructure=state.needs_restructure,
        exps=None if state.exps is None else state.exps[idx],
    )


def _host_build(keys, vals, exps=None, *, node_size=32, nodes_per_bucket=16, fill=0.5):
    """Numpy twin of ``checkpoint.serialize.state_from_pairs``: the same
    half-full layout, with the bucket count rounded up to a multiple of 8,
    built on the host.  Returns the planes ``(keys, vals, node_count,
    node_max, num_nodes, mkba, exps)`` (``exps`` None when the column is
    absent or all ``NO_EXPIRY``).

    Recovery of a tiered index builds its mirror with this, so the full
    structure is never allocated on the device.  Byte-equal to the device
    build: canonical triples are clean, so every padding cell is
    EMPTY / 0 / NO_EXPIRY in both.
    """
    keys = np.asarray(keys, np.int32)
    vals = np.asarray(vals, np.int32)
    if exps is not None:
        exps = np.asarray(exps, np.int32)
        if not (exps != int(NO_EXPIRY)).any():
            exps = None
    nb, npb, ns = plan_geometry(
        len(keys), node_size=node_size, nodes_per_bucket=nodes_per_bucket, fill=fill
    )
    nb = -(-nb // 8) * 8
    p = max(1, int(ns * fill))

    def one_plane(col, background):
        flat = np.full((nb * p,), background, np.int32)
        take = min(len(col), nb * p)
        flat[:take] = col[:take]
        plane = np.full((nb, npb, ns), background, np.int32)
        plane[:, 0, :p] = flat.reshape(nb, p)
        return plane

    k3 = one_plane(keys, EMPTY)
    v3 = one_plane(vals, 0)
    bkeys = k3[:, 0, :p]
    counts0 = (bkeys != EMPTY).sum(axis=1).astype(np.int32)
    node_count = np.zeros((nb, npb), np.int32)
    node_count[:, 0] = counts0
    nmax0 = np.where(
        counts0 > 0, bkeys[np.arange(nb), np.maximum(counts0 - 1, 0)], EMPTY
    ).astype(np.int32)
    node_max = np.full((nb, npb), EMPTY, np.int32)
    node_max[:, 0] = nmax0
    num_nodes = (counts0 > 0).astype(np.int32)
    mkba = np.where(counts0 > 0, nmax0, MAX_VALID).astype(np.int32)
    mkba[-1] = MAX_VALID
    mkba = np.maximum.accumulate(mkba)

    e3 = None
    if exps is not None:
        e3 = one_plane(exps, int(NO_EXPIRY))
        e3 = np.where(k3 == EMPTY, int(NO_EXPIRY), e3).astype(np.int32)
    return k3, v3, node_count, node_max, num_nodes, mkba, e3


class TieredFliX:
    """A FliX index whose device footprint is bounded by ``budget_bytes``
    while the whole index lives in host memory.

    A mutating companion class (methods change ``self`` and return
    results), like ``checkpoint.durable.DurableFliX``.  The authority
    split (I7):

      * buckets in ``resident_ids`` are authoritative on the device (their
        mirror rows may be stale until ``sync()``);
      * every other bucket is authoritative in the mirror;
      * the per-bucket metadata ``h_live`` / ``h_min_exp`` is fresh for all
        buckets at all times.

    ``budget_bytes=None`` is unbounded: buckets are still paged in on
    demand, never out.  ``device`` is where the packed working set lives:
    the card unless the caller names another.  The mirror's planes are
    CPU tensors; ``h_keys`` and its siblings are numpy views of them.
    ``last_timings`` holds the parts of the last ``apply`` (ms).
    """

    def __init__(
        self,
        keys,
        vals,
        node_count,
        node_max,
        num_nodes,
        mkba,
        exps=None,
        *,
        budget_bytes: int | None = None,
        needs_restructure: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self._pinned = self.device.type == "cuda"
        self._m: dict[str, torch.Tensor | None] = {}
        self._set_mirror(
            dict(keys=keys, vals=vals, node_count=node_count, node_max=node_max,
                 num_nodes=num_nodes, mkba=mkba, exps=exps)
        )
        self.needs_restructure = bool(needs_restructure)
        self.budget_bytes = budget_bytes
        self._step = 0
        self._reset_residency()
        self.promoted_total = 0
        self.demoted_total = 0
        self.reclaimed_total = 0
        self.last_timings: dict = {}

    # ---- constructors ----------------------------------------------------
    @classmethod
    def from_state(cls, state: FliXState, *, budget_bytes: int | None = None):
        """Adopt a single-tier state (one full page-out); the engine runs on
        the state's device."""
        st = state.drop_volatile()
        return cls(
            st.keys,
            st.vals,
            st.node_count,
            st.node_max,
            st.num_nodes,
            st.mkba,
            st.exps,
            budget_bytes=budget_bytes,
            needs_restructure=bool(st.needs_restructure),
            device=st.device,
        )

    @classmethod
    def from_pairs(
        cls,
        keys,
        vals,
        exps=None,
        *,
        node_size: int = 32,
        nodes_per_bucket: int = 16,
        fill: float = 0.5,
        budget_bytes: int | None = None,
        device=None,
    ):
        """Rebuild from sorted live triples on the host, never allocating
        the full index on the device (the recovery path of a tiered index;
        byte-equal to ``state_from_pairs``)."""
        planes = _host_build(
            keys, vals, exps, node_size=node_size, nodes_per_bucket=nodes_per_bucket,
            fill=fill,
        )
        return cls(*planes, budget_bytes=budget_bytes, device=device)

    # ---- the mirror ------------------------------------------------------
    def _host_tensor(self, a) -> torch.Tensor:
        """An owned, writable int32 CPU tensor holding ``a`` (numpy, or a
        tensor on any device), page-locked when the engine's device is the
        card: one copy, whatever the source."""
        if isinstance(a, torch.Tensor):
            src = a
        else:
            src = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
        out = torch.empty(tuple(src.shape), dtype=torch.int32, pin_memory=self._pinned)
        out.copy_(src)
        return out

    def _set_mirror(self, planes: dict) -> None:
        for name, a in planes.items():
            self._m[name] = None if a is None else self._host_tensor(a)

    def _new_exps_plane(self) -> None:
        """The TTL plane appeared on the device (the first batch with
        deadlines): give the mirror one, all ``NO_EXPIRY``."""
        self._m["exps"] = torch.full(
            tuple(self._m["keys"].shape), NO_EXPIRY, dtype=torch.int32,
            pin_memory=self._pinned,
        )

    @property
    def h_keys(self) -> np.ndarray:
        return self._m["keys"].numpy()

    @property
    def h_vals(self) -> np.ndarray:
        return self._m["vals"].numpy()

    @property
    def h_node_count(self) -> np.ndarray:
        return self._m["node_count"].numpy()

    @property
    def h_node_max(self) -> np.ndarray:
        return self._m["node_max"].numpy()

    @property
    def h_num_nodes(self) -> np.ndarray:
        return self._m["num_nodes"].numpy()

    @property
    def h_mkba(self) -> np.ndarray:
        return self._m["mkba"].numpy()

    @property
    def h_exps(self) -> np.ndarray | None:
        return None if self._m["exps"] is None else self._m["exps"].numpy()

    # ---- geometry / accounting -------------------------------------------
    @property
    def num_buckets(self) -> int:
        return self._m["keys"].shape[0]

    @property
    def geometry(self) -> tuple[int, int, int]:
        return tuple(self._m["keys"].shape)

    @property
    def nodes_per_bucket(self) -> int:
        return self._m["keys"].shape[1]

    @property
    def node_size(self) -> int:
        return self._m["keys"].shape[2]

    @property
    def bucket_bytes(self) -> int:
        return bucket_device_bytes(
            self.nodes_per_bucket, self.node_size, self._m["exps"] is not None
        )

    @property
    def budget_buckets(self) -> int:
        """Resident-set cap in buckets (≥ 1: one bucket must always fit)."""
        nb = self.num_buckets
        if self.budget_bytes is None:
            return nb
        return min(nb, max(1, int(self.budget_bytes) // self.bucket_bytes))

    def memory_bytes_resident(self) -> int:
        """Device-tier footprint (the budget-governed quantity of I7)."""
        return len(self.resident_ids) * self.bucket_bytes

    def live_keys(self) -> int:
        return int(self.h_live.sum())

    # ---- metadata --------------------------------------------------------
    def _reset_residency(self) -> None:
        """Nothing resident, every LRU stamp 0 (the step counter runs on),
        metadata recomputed from the mirror (which must be authoritative)."""
        self.resident_ids = np.zeros((0,), np.int32)
        self._packed: FliXState | None = None
        self.last_used = np.zeros((self.num_buckets,), np.int64)
        view = self._host_state()
        self.h_live = view.node_count.sum(dim=1, dtype=torch.int32).numpy()
        self.h_min_exp = bucket_min_exp(view).numpy()

    def _refresh_meta(self, ids: np.ndarray) -> None:
        """Refresh the metadata of the packed working set from the device."""
        if self._packed is None or len(ids) == 0:
            return
        meta = _bucket_meta(self._packed).cpu().numpy()
        self.h_live[ids] = meta[0]
        self.h_min_exp[ids] = meta[1]

    # ---- residency plumbing ----------------------------------------------
    def _page_out(self, st: FliXState, pos: torch.Tensor | None, ids: np.ndarray) -> None:
        """Write rows ``pos`` of the packed state ``st`` (all when None)
        into the mirror at bucket ids ``ids``: a device ``index_select``,
        one copy to the host a plane (queued, then one wait), and an
        ``index_copy_`` into the mirror.  Never the packed mkba."""
        if st.exps is not None and self._m["exps"] is None:
            self._new_exps_plane()
        host = {}
        for name in ROW_PLANES:
            rows = getattr(st, name)
            if rows is None:
                continue
            if pos is not None:
                rows = rows.index_select(0, pos)
            if rows.device.type == "cpu":
                host[name] = rows
            else:
                host[name] = torch.empty(tuple(rows.shape), dtype=torch.int32,
                                         pin_memory=True)
                host[name].copy_(rows, non_blocking=True)
        if self._pinned:
            torch.cuda.current_stream(self.device).synchronize()
        at = torch.from_numpy(np.asarray(ids, np.int64))
        for name, rows in host.items():
            self._m[name].index_copy_(0, at, rows)

    def _upload(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """Mirror rows ``ids`` of one plane on the engine's device: gathered
        into a page-locked buffer and copied without blocking the host (the
        caching host allocator keeps the buffer until the copy is done)."""
        plane = self._m[name]
        if not self._pinned:
            return plane.index_select(0, ids)  # a fresh tensor on the CPU
        stage = torch.empty((len(ids),) + tuple(plane.shape[1:]), dtype=torch.int32,
                            pin_memory=True)
        torch.index_select(plane, 0, ids, out=stage)
        return stage.to(self.device, non_blocking=True)

    def sync(self) -> None:
        """Page the resident buckets' rows back into the mirror (residency
        unchanged).  Afterwards the mirror is authoritative for every
        bucket: the basis of the host view, the invariant check and a
        restructure."""
        if self._packed is None or len(self.resident_ids) == 0:
            return
        self._page_out(self._packed, None, self.resident_ids)

    def _gather(self, ids: np.ndarray) -> FliXState:
        """Mirror rows ``ids`` (sorted) as a packed state on the device."""
        at = torch.from_numpy(np.asarray(ids, np.int64))
        mkba = self._m["mkba"].index_select(0, at)
        mkba[-1] = MAX_VALID
        return FliXState(
            keys=self._upload("keys", at),
            vals=self._upload("vals", at),
            node_count=self._upload("node_count", at),
            node_max=self._upload("node_max", at),
            num_nodes=self._upload("num_nodes", at),
            mkba=mkba.to(self.device),
            needs_restructure=torch.tensor(self.needs_restructure, device=self.device),
            exps=None if self._m["exps"] is None else self._upload("exps", at),
        )

    def _pad_working_set(self, ids: np.ndarray) -> np.ndarray:
        """Pad the working set to min(nb, a power of two) distinct buckets
        with the lowest-id cold ones (the reference bounds its jit shapes
        so)."""
        nb = self.num_buckets
        target = min(nb, _pow2_ceil(max(len(ids), 1)))
        if target <= len(ids):
            return ids
        cold = np.setdiff1d(np.arange(nb, dtype=np.int32), ids, assume_unique=True)
        return np.sort(np.concatenate([ids, cold[: target - len(ids)]]))

    def _evict_to_budget(self) -> int:
        """LRU page-out down to the device budget (I7, after a commit)."""
        r = self.budget_buckets
        ids = self.resident_ids
        if len(ids) <= r or self._packed is None:
            return 0
        # keep the r most recently used (ties: the lower bucket id)
        order = np.lexsort((ids, -self.last_used[ids]))
        kept = np.sort(ids[order[:r]])
        evicted = np.sort(ids[order[r:]])
        st = self._packed
        dev = st.device

        def positions(which):
            return torch.from_numpy(np.searchsorted(ids, which).astype(np.int64)).to(dev)

        self._page_out(st, positions(evicted), evicted)
        self._packed = _take_buckets(st, positions(kept))
        self.resident_ids = kept
        self.demoted_total += len(evicted)
        return len(evicted)

    # ---- the engine ------------------------------------------------------
    def apply(
        self,
        ops: OpBatch,
        *,
        config: ExecConfig | None = None,
        now: int | None = None,
        commit: bool = True,
    ):
        """Prefetch, promote, run the unchanged executors, demote.

        Returns ``(results, stats, restructured)`` and mutates ``self``.
        ``config`` is forwarded to the inner ``apply_ops`` (``impl="auto"``:
        the fused path's kernels on the card for a batch with updates).
        ``commit=False`` runs a read-only batch: promotion and demotion
        still happen, but the post-apply packed bytes are dropped — an
        expiring read must not reclaim rows.  ``stats`` gains the residency
        counters ``promoted``, ``demoted``, ``resident_bytes`` and
        ``reclaimed_bytes`` and ``restructure_retries``.
        """
        cfg = (config if config is not None else ExecConfig()).replace(donate=False)
        on_card = self.device.type == "cuda"
        t0 = time.perf_counter()
        tag, key, val, _ = ops.to_host()
        touched = touched_buckets(
            self.h_mkba, tag, key, val, live=self.h_live, min_exp=self.h_min_exp, now=now
        )
        t_ids = np.nonzero(touched)[0].astype(np.int32)
        self._step += 1
        self.last_used[t_ids] = self._step

        t1 = time.perf_counter()
        promoted = padded = 0
        s_ids = self.resident_ids
        t_sync = t1
        if self._packed is not None and np.isin(t_ids, s_ids, assume_unique=True).all():
            w_ids = s_ids  # every touched bucket is resident: no transfer
            packed = self._packed
        else:
            self.sync()
            t_sync = time.perf_counter()
            w_ids = np.union1d(s_ids, t_ids).astype(np.int32)
            padded = -len(w_ids)
            w_ids = self._pad_working_set(w_ids)
            padded += len(w_ids)
            promoted = int(len(w_ids) - len(s_ids))
            packed = self._gather(w_ids)
        self.promoted_total += promoted

        t2 = time.perf_counter()
        if on_card:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        upd = (tag == OP_INSERT) | (tag == OP_DELETE) | (tag == OP_EXPIRE)
        has_updates = bool(upd.any())
        new_packed, results, stats = apply_ops(
            packed, ops, config=cfg, has_updates=has_updates, now=now
        )
        if on_card:
            events[1].record()
        stats = dict(stats)
        restructured = False
        reclaimed = 0

        t3 = time.perf_counter()
        overflow = bool(new_packed.needs_restructure) and not self.needs_restructure
        if overflow and commit:
            # bucket overflow: the overflowed result is untrustworthy (the
            # apply_ops_safe contract) — regrow the pre-batch state from a
            # full materialization and replay, the one tiered operation
            # that needs the whole index on the device for a while
            self.resident_ids = w_ids
            self._packed = packed
            full = self.materialize()
            before = full.memory_bytes()
            n_ins = int(((tag == OP_INSERT) | (tag == OP_EXPIRE)).sum())
            grown = restructure_grow(full, extra_keys=max(n_ins, 1))
            del full
            new_full, results, stats = apply_ops(
                grown, ops, config=cfg, has_updates=has_updates, now=now
            )
            if bool(new_full.needs_restructure):
                raise RuntimeError("batch overflowed the geometry restructure_grow planned")
            stats = dict(stats)
            self._install_full(new_full)
            reclaimed = max(0, before - new_full.memory_bytes())
            self.reclaimed_total += reclaimed
            restructured = True
        elif commit:
            self._packed = new_packed
            self.resident_ids = w_ids
            self.needs_restructure = bool(new_packed.needs_restructure)
            if self._m["exps"] is None and new_packed.exps is not None:
                self._new_exps_plane()
            self._refresh_meta(w_ids)
        else:
            # read-only: keep the pre-apply packed bytes
            self._packed = packed
            self.resident_ids = w_ids

        t4 = time.perf_counter()
        demoted = self._evict_to_budget()
        t5 = time.perf_counter()
        self.last_timings = {
            "touched_ms": (t1 - t0) * 1e3,
            "sync_ms": (t_sync - t1) * 1e3,
            "gather_ms": (t2 - t_sync) * 1e3,
            "pass_host_ms": (t3 - t2) * 1e3,
            "pass_ms": events[0].elapsed_time(events[1]) if on_card else (t3 - t2) * 1e3,
            "meta_ms": (t4 - t3) * 1e3,
            "page_out_ms": (t5 - t4) * 1e3,
            "touched": len(t_ids),
            "working_set": len(w_ids),
            "padded": padded,
        }
        stats["restructure_retries"] = int(restructured)
        stats["promoted"] = promoted
        stats["demoted"] = demoted
        stats["resident_bytes"] = self.memory_bytes_resident()
        stats["reclaimed_bytes"] = reclaimed
        return results, stats, restructured

    # ---- full-state transitions ------------------------------------------
    def materialize(self) -> FliXState:
        """The whole single-tier state on the device (restructure and tests
        only: the allocation the tiered engine otherwise avoids)."""
        self.sync()
        planes = {
            n: None if t is None else t.to(self.device, copy=True) for n, t in self._m.items()
        }
        return FliXState(
            needs_restructure=torch.tensor(self.needs_restructure, device=self.device),
            **planes,
        )

    def _install_full(self, state: FliXState) -> None:
        """Replace the whole logical state (after a restructure): page
        everything out to a new mirror and reset residency."""
        st = state.drop_volatile()
        self._set_mirror({n: getattr(st, n) for n in ROW_PLANES + ("mkba",)})
        self.needs_restructure = bool(st.needs_restructure)
        self._reset_residency()

    def compact(self, *, fill: float = 0.5) -> int:
        """Shrink to the smallest geometry for the live set and reclaim the
        freed memory.  Returns the reclaimed bytes."""
        full = self.materialize()
        new, reclaimed = restructure_shrink(full, fill=fill)
        self._install_full(new)
        self.reclaimed_total += reclaimed
        return reclaimed

    # ---- durability / inspection hooks -----------------------------------
    def _host_state(self) -> FliXState:
        return FliXState(needs_restructure=torch.tensor(self.needs_restructure), **self._m)

    def host_view(self) -> FliXState:
        """The synced mirror as a ``FliXState`` on the CPU that shares its
        memory (read it, do not write it): ``check_invariants`` and
        ``checkpoint.serialize.bucket_segments`` take it as it is."""
        self.sync()
        return self._host_state()

    def expired_buckets(self, now: int) -> np.ndarray:
        """Bucket ids holding a live row with deadline ≤ ``now``, from the
        metadata alone (no device scan, no transfer)."""
        return np.nonzero(self.h_min_exp <= np.int32(now))[0]
