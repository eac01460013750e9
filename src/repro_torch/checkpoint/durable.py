"""Engine-aware durable persistence for a FliX index (port of
``repro/checkpoint/durable.py``).

Commit protocol, per engine batch (WAL-ahead):

  1. frame + append the sorted ``OpBatch`` (with its ``max_results``) to
     the write-ahead log and fsync — the batch is durable *before* the
     engine runs it;
  2. execute it (``apply_ops`` or ``shard_apply_ops`` behind an engine
     adapter, restructure-and-retry included);
  3. fold the batch's update keys into the dirty-bucket mask (fences are
     fixed between restructures, so host-side ``searchsorted`` routing is
     exact); a restructure bumps the *fence epoch* and dirties everything;
  4. every ``snapshot_every`` batches, write a snapshot — a dirty-bucket
     delta within an epoch, a full canonical payload after an epoch bump
     or every ``full_every``-th snapshot.

Snapshots are atomic (unique tmp sibling dir, fsync, rename, dir fsync)
and *canonical* (``checkpoint.serialize``): the same logical index always
produces the same payload bytes.  Every file this module writes — payloads,
manifests, WAL segments — is byte-identical to the reference's for the
same history, so a directory written by either package opens in the other.

Recovery (resumable, idempotent):

  1. load the newest crc-verified snapshot chain (full + deltas);
  2. truncate the WAL's torn tail (a crash mid-append);
  3. rebuild on the engine's device and replay every logged batch after
     the snapshot through the engine;
  4. reopen the WAL for append — the instance continues exactly where the
     durable history ends.

``crash_hook`` is the fault-injection seam: it is called with the named
events of ``WriteAheadLog.append`` and ``DurableFliX.apply`` / ``snapshot``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import wal as wal_mod
from repro_torch.checkpoint.manager import tmp_sibling
from repro_torch.checkpoint.serialize import (
    bucket_segments,
    pack_delta,
    pairs_to_bytes,
    parse_canonical,
    parse_delta,
    segment_crcs,
    state_from_pairs,
)
from repro_torch.checkpoint.wal import WriteAheadLog, decode_ops, encode_ops
from repro_torch.core.config import ExecConfig
from repro_torch.core.expiry import NO_EXPIRY
from repro_torch.core.ops import OP_DELETE, OP_EXPIRE, OP_INSERT, OpBatch, apply_ops
from repro_torch.core.restructure import restructure_grow
from repro_torch.core.state import EMPTY, resolve_device

SNAP_FORMAT = "flix-durable-v1"
_SNAP_PREFIX = "snap_"


class SnapshotCorruptionError(RuntimeError):
    """A snapshot failed structural or checksum validation at load."""


def _noop_hook(event: str) -> None:
    return None


# ---------------------------------------------------------------------------
# engine adapters: one batch in, (new handle, results, stats, restructured)
# ---------------------------------------------------------------------------


class EngineBase:
    """Shared engine surface the durability layer talks to: besides
    ``rebuild`` / ``flix`` / ``apply``, four read-only views of the handle,
    through ``flix()`` (a full device state).  ``TieredEngine`` overrides
    all four with host-tier versions and ``ShardEngine`` with shard-by-shard
    ones, so that durability never puts the whole index on one device."""

    def mkba_host(self, handle) -> np.ndarray:
        """The fence array as host numpy (dirty-bucket routing)."""
        return self.flix(handle).mkba.cpu().numpy()

    def geometry(self, handle) -> tuple[int, int, int]:
        """(num_buckets, nodes_per_bucket, node_size) of the handle."""
        return self.flix(handle).geometry

    def segments(self, handle, buckets=None):
        """Canonical per-bucket segments (``serialize.bucket_segments``)."""
        return bucket_segments(self.flix(handle), buckets)

    def expired_buckets(self, handle, now) -> np.ndarray | None:
        """Bucket ids holding live rows with deadline ≤ now, or None when
        the state carries no expiry plane (pre-apply dirty marking).  The
        test runs on the state's device; only the hit list comes back."""
        pre = self.flix(handle)
        if now is None or pre.exps is None:
            return None
        hit = torch.any((pre.exps <= int(now)) & (pre.keys != EMPTY), dim=(1, 2))
        return torch.nonzero(hit)[:, 0].cpu().numpy()


class LocalEngine(EngineBase):
    """Single-device executor behind the durability layer.

    ``config`` carries the execution strategy threaded to every inner
    ``apply_ops`` (the port takes ``config=`` only).  The per-batch
    ``max_results`` is NOT part of it — it is logged per WAL record so
    replay re-runs each batch under its own budget.  ``device`` is where
    recovery rebuilds the state: the card unless the caller names another.
    """

    kind = "local"

    def __init__(
        self,
        *,
        config: ExecConfig | None = None,
        node_size: int = 32,
        nodes_per_bucket: int = 16,
        fill: float = 0.5,
        device=None,
    ):
        self.config = config if config is not None else ExecConfig()
        self.node_size = node_size
        self.nodes_per_bucket = nodes_per_bucket
        self.fill = fill
        self.device = resolve_device(device)

    def rebuild(self, keys, vals, exps=None, geometry: dict | None = None):
        g = geometry or {}
        return state_from_pairs(
            keys,
            vals,
            exps,
            node_size=g.get("node_size", self.node_size),
            nodes_per_bucket=g.get("nodes_per_bucket", self.nodes_per_bucket),
            fill=g.get("fill", self.fill),
            device=self.device,
        )

    def flix(self, handle):
        return handle

    def apply(self, handle, ops: OpBatch, *, max_results: int, now=None):
        """``apply_ops`` with the restructure-and-retry loop surfaced: the
        durability layer must KNOW when the fence epoch changed, so it
        drives the retry itself instead of calling ``apply_ops_safe``."""
        cfg = self.config.replace(max_results=max_results, donate=False)
        new, results, stats = apply_ops(handle, ops, config=cfg, now=now)
        restructured = False
        if bool(new.needs_restructure) and not bool(handle.needs_restructure):
            n_ins = int(((ops.tag == OP_INSERT) | (ops.tag == OP_EXPIRE)).sum())
            grown = restructure_grow(handle, extra_keys=max(n_ins, 1))
            new, results, stats = apply_ops(grown, ops, config=cfg, now=now)
            if bool(new.needs_restructure):
                raise RuntimeError("batch overflowed the geometry restructure_grow planned")
            restructured = True
        stats = dict(stats)
        stats["restructure_retries"] = int(restructured)
        return new, results, stats, restructured


class ShardEngine(EngineBase):
    """The sharded executor (``core.distributed``) behind the durability
    layer.

    The handle is a ``ShardedFliX`` over ``mesh``.  Recovery rebuilds
    through ``shard_build`` (fences re-partitioned from the recovered
    contents, the durable analogue of ``shard_restructure``), and ``apply``
    mirrors ``shard_apply_ops_safe``'s bucket-overflow retry while reporting
    the epoch bump.  The four durable hooks work shard by shard, with
    global bucket ids offset by each shard's first bucket, so no durable
    path gathers the whole index onto one device.  ``config`` carries the
    execution strategy, the routing included; ``device`` is the first
    shard's, where replayed batches are placed.
    """

    kind = "sharded"

    def __init__(
        self,
        mesh,
        *,
        config: ExecConfig | None = None,
        node_size: int = 32,
        nodes_per_bucket: int = 16,
        fill: float = 0.5,
    ):
        self.mesh = mesh
        self.config = config if config is not None else ExecConfig()
        self.node_size = node_size
        self.nodes_per_bucket = nodes_per_bucket
        self.fill = fill
        self.devices = tuple(mesh.devices)
        self.device = self.devices[0]

    def rebuild(self, keys, vals, exps=None, geometry: dict | None = None):
        from repro_torch.core.distributed import shard_build

        g = geometry or {}
        if exps is not None:
            exps = np.asarray(exps, np.int32)
            if not (exps != int(NO_EXPIRY)).any():
                exps = None  # an all-sentinel column rebuilds without TTL

        def col(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

        return shard_build(
            col(keys),
            col(vals),
            self.mesh,
            node_size=g.get("node_size", self.node_size),
            nodes_per_bucket=g.get("nodes_per_bucket", self.nodes_per_bucket),
            fill=g.get("fill", self.fill),
            sorted_exps=None if exps is None else col(exps),
        )

    def flix(self, handle):
        # inspection only: the union state on the first shard's device,
        # which the hooks below exist to avoid
        from repro_torch.core.distributed import shard_union

        return shard_union(handle, self.device)

    def apply(self, handle, ops: OpBatch, *, max_results: int, now=None):
        from repro_torch.core.distributed import shard_apply_ops, shard_restructure

        cfg = self.config.replace(max_results=max_results, donate=False)
        new, results, stats = shard_apply_ops(handle, ops, self.mesh, config=cfg, now=now)
        restructured = False
        if bool(new.needs_restructure) and not bool(handle.needs_restructure):
            n_ins = int(((ops.tag == OP_INSERT) | (ops.tag == OP_EXPIRE)).sum())
            grown = shard_restructure(handle, self.mesh, extra_keys=max(n_ins, 1))
            new, results, stats = shard_apply_ops(grown, ops, self.mesh, config=cfg, now=now)
            if bool(new.needs_restructure):
                raise RuntimeError("batch overflowed the geometry shard_restructure planned")
            restructured = True
        stats = dict(stats)
        stats["restructure_retries"] = int(restructured)
        return new, results, stats, restructured

    def mkba_host(self, handle) -> np.ndarray:
        return np.concatenate([st.mkba.cpu().numpy() for st in handle.states])

    def geometry(self, handle) -> tuple[int, int, int]:
        return handle.geometry

    def segments(self, handle, buckets=None):
        nb_s = handle.states[0].num_buckets
        if buckets is not None:
            buckets = np.asarray(buckets, np.int64)
        parts = []
        for s, st in enumerate(handle.states):
            local = None
            if buckets is not None:
                local = buckets[(buckets >= s * nb_s) & (buckets < (s + 1) * nb_s)] - s * nb_s
                if local.size == 0:
                    continue
            parts.append(bucket_segments(st, local))
        if not parts:
            return bucket_segments(handle.states[0], [])
        return tuple(np.concatenate(cols) for cols in zip(*parts))

    def expired_buckets(self, handle, now) -> np.ndarray | None:
        if now is None or not handle.has_ttl:
            return None
        nb_s = handle.states[0].num_buckets
        hits = []
        for s, st in enumerate(handle.states):
            hit = torch.any((st.exps <= int(now)) & (st.keys != EMPTY), dim=(1, 2))
            hits.append(torch.nonzero(hit)[:, 0].cpu().numpy() + s * nb_s)
        return np.concatenate(hits)


class TieredEngine(EngineBase):
    """The budget-bounded tiered executor (``core.residency``) behind the
    durability layer.

    The handle is a ``TieredFliX``, and every hook runs against its host
    tier: recovery builds the mirror with the numpy twin of
    ``state_from_pairs`` (the same layout, no device allocation), snapshots
    canonicalize the synced mirror on the host, and the expired-bucket scan
    before an apply reads the per-bucket deadline metadata.  So a durable
    tiered index never needs the whole structure on the device; the
    restructure inside ``TieredFliX.apply`` is the one exception, for the
    length of a grow and replay.  ``device`` is where the packed working
    set lives: the card unless the caller names another.
    """

    kind = "tiered"

    def __init__(
        self,
        *,
        budget_bytes: int | None = None,
        config: ExecConfig | None = None,
        node_size: int = 32,
        nodes_per_bucket: int = 16,
        fill: float = 0.5,
        device=None,
    ):
        self.budget_bytes = budget_bytes
        self.config = config if config is not None else ExecConfig()
        self.node_size = node_size
        self.nodes_per_bucket = nodes_per_bucket
        self.fill = fill
        self.device = resolve_device(device)

    def rebuild(self, keys, vals, exps=None, geometry: dict | None = None):
        from repro_torch.core.residency import TieredFliX

        g = geometry or {}
        return TieredFliX.from_pairs(
            keys,
            vals,
            exps,
            node_size=g.get("node_size", self.node_size),
            nodes_per_bucket=g.get("nodes_per_bucket", self.nodes_per_bucket),
            fill=g.get("fill", self.fill),
            budget_bytes=self.budget_bytes,
            device=self.device,
        )

    def flix(self, handle):
        # inspection only: this materializes the whole state on the device,
        # which the hooks below exist to avoid
        return handle.materialize()

    def apply(self, handle, ops: OpBatch, *, max_results: int, now=None):
        """``TieredFliX.apply``, which grows and replays on overflow itself."""
        results, stats, restructured = handle.apply(
            ops, config=self.config.replace(max_results=max_results), now=now
        )
        return handle, results, stats, restructured

    def mkba_host(self, handle) -> np.ndarray:
        return handle.h_mkba

    def geometry(self, handle) -> tuple[int, int, int]:
        return handle.geometry

    def segments(self, handle, buckets=None):
        return bucket_segments(handle.host_view(), buckets)

    def expired_buckets(self, handle, now) -> np.ndarray | None:
        if now is None or handle.h_exps is None:
            return None
        return handle.expired_buckets(now)


# ---------------------------------------------------------------------------
# snapshot store helpers
# ---------------------------------------------------------------------------


def _snap_name(seq: int) -> str:
    return f"{_SNAP_PREFIX}{seq:012d}"


def _snapshot_dirs(directory: Path) -> list[tuple[int, Path]]:
    """(seq, path) for committed snapshots, ascending; scratch dirs with
    ``.tmp`` in the name are crash leftovers and never listed."""
    out = []
    for p in Path(directory).glob(f"{_SNAP_PREFIX}*"):
        if not p.is_dir() or ".tmp" in p.name:
            continue
        try:
            seq = int(p.name[len(_SNAP_PREFIX) :])
        except ValueError:
            continue
        out.append((seq, p))
    return sorted(out)


def _read_manifest(path: Path) -> dict:
    try:
        with open(path / "manifest.json") as f:
            m = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SnapshotCorruptionError(f"{path.name}: unreadable manifest: {e}") from e
    if m.get("format") != SNAP_FORMAT:
        raise SnapshotCorruptionError(
            f"{path.name}: format {m.get('format')!r} != {SNAP_FORMAT!r}"
        )
    return m


def _read_payload(path: Path, manifest: dict) -> bytes:
    try:
        data = (path / "payload.bin").read_bytes()
    except OSError as e:
        raise SnapshotCorruptionError(f"{path.name}: unreadable payload: {e}") from e
    if zlib.crc32(data) != manifest["payload_crc"]:
        raise SnapshotCorruptionError(f"{path.name}: payload checksum mismatch")
    return data


def _splice(cols, lens, bi, ln, delta_cols):
    """Replace the segments of buckets ``bi`` (lengths ``ln``, concatenated
    in ``delta_cols``) in the flat columns ``cols`` split by ``lens``; a
    bucket listed twice takes its last segment, as assignment in order
    would.  One gather over ``cols ++ delta_cols``: no per-bucket arrays."""
    n_old = cols[0].size
    first_rev = np.unique(bi[::-1], return_index=True)[1]
    last = bi.size - 1 - first_rev  # each listed bucket's last entry
    d_off = np.cumsum(ln) - ln
    new_lens = lens.copy()
    new_lens[bi[last]] = ln[last]
    src = np.cumsum(lens) - lens
    src[bi[last]] = n_old + d_off[last]
    out_off = np.cumsum(new_lens) - new_lens
    idx = np.repeat(src - out_off, new_lens) + np.arange(int(new_lens.sum()))
    return [np.concatenate([c, dc])[idx] for c, dc in zip(cols, delta_cols)], new_lens


def load_snapshot_chain(directory: Path, seq: int):
    """Reconstruct the canonical triples at snapshot ``seq``: follow the
    delta chain back to its base full snapshot, then apply the diffs
    forward, verifying every checksum on the way.  Returns
    ``(keys, vals, exps, manifest)`` for the requested snapshot."""
    directory = Path(directory)
    chain: list[tuple[Path, dict]] = []
    name = _snap_name(seq)
    while True:
        path = directory / name
        m = _read_manifest(path)
        chain.append((path, m))
        if m["kind"] == "full":
            break
        if m["kind"] != "delta" or not m.get("base"):
            raise SnapshotCorruptionError(f"{path.name}: malformed chain entry")
        name = m["base"]
        if len(chain) > 10_000:
            raise SnapshotCorruptionError("delta chain does not terminate")
    chain.reverse()  # base full first

    base_path, base_m = chain[0]
    epoch = base_m["epoch"]
    cols = list(parse_canonical(_read_payload(base_path, base_m)))
    lens = np.asarray(base_m["seg_lens"], np.int64)
    if int(lens.sum()) != cols[0].size:
        raise SnapshotCorruptionError(f"{base_path.name}: seg_lens/payload mismatch")

    for path, m in chain[1:]:
        if m["epoch"] != epoch:
            raise SnapshotCorruptionError(
                f"{path.name}: epoch {m['epoch']} != chain epoch {epoch}"
            )
        bi, ln, ks, vs, es = parse_delta(_read_payload(path, m))
        bi, ln = bi.astype(np.int64), ln.astype(np.int64)
        bad = (bi < 0) | (bi >= lens.size)
        if bad.any():
            raise SnapshotCorruptionError(f"{path.name}: bucket {bi[bad][0]} out of range")
        if (ln < 0).any():
            raise SnapshotCorruptionError(f"{path.name}: negative segment length")
        cols, lens = _splice(cols, lens, bi, ln, (ks, vs, es))

    final_m = chain[-1][1]
    want_lens = np.asarray(final_m["seg_lens"], np.int64)
    if len(want_lens) != len(lens) or (want_lens != lens).any():
        raise SnapshotCorruptionError(f"{_snap_name(seq)}: reconstructed lens differ")
    keys, vals, exps = (c.astype(np.int32) for c in cols)
    if segment_crcs(lens, keys, vals, exps) != list(final_m["bucket_crcs"]):
        raise SnapshotCorruptionError(f"{_snap_name(seq)}: bucket checksum mismatch")
    return keys, vals, exps, final_m


# ---------------------------------------------------------------------------
# the durable index
# ---------------------------------------------------------------------------


class DurableFliX:
    """WAL-ahead durable wrapper around a FliX engine.

    Use :meth:`create` for a fresh directory and :meth:`open` to recover;
    ``apply`` is the only mutation path.  ``seq`` counts applied batches
    (0 = the initial snapshot), and every batch whose ``apply`` returned
    is durable: it was fsynced into the WAL before execution.
    """

    def __init__(
        self,
        directory,
        engine,
        handle,
        *,
        seq: int,
        epoch: int,
        snapshot_every: int = 64,
        full_every: int = 8,
        keep_full: int = 2,
        fsync: bool = True,
        crash_hook=None,
        meta_window: int = 256,
    ):
        self.dir = Path(directory)
        self.engine = engine
        self.handle = handle
        self.snapshot_every = snapshot_every
        self.full_every = max(1, full_every)
        self.keep_full = max(1, keep_full)
        self.meta_window = max(0, meta_window)
        self._seq = seq
        self._epoch = epoch
        self._hook = crash_hook or _noop_hook
        self._wal = WriteAheadLog(self.dir, fsync=fsync, crash_hook=self._hook)
        self._all_dirty = True
        self._mkba_host = np.asarray(self.engine.mkba_host(self.handle))
        # one flag per bucket: the batches' update keys land in up to every
        # bucket, which a host-side set would take one at a time
        self._dirty = np.zeros(self._mkba_host.size, bool)
        self._bucket_lens: np.ndarray | None = None
        self._bucket_crcs: np.ndarray | None = None
        self._snaps_since_full = 0
        self._poisoned: str | None = None
        self._closed = False
        # bounded (seq, meta) trail of recent commits: logged in each WAL
        # record, carried across snapshots via the manifest, rebuilt on
        # open() — the gateway's durable dedup window
        self._meta: list[tuple[int, object]] = []

    # -- constructors -----------------------------------------------------
    @staticmethod
    def exists(directory) -> bool:
        d = Path(directory)
        return d.is_dir() and (
            bool(_snapshot_dirs(d)) or bool(wal_mod.segment_files(d))
        )

    @classmethod
    def create(
        cls,
        directory,
        handle,
        *,
        engine=None,
        snapshot_every: int = 64,
        full_every: int = 8,
        keep_full: int = 2,
        fsync: bool = True,
        crash_hook=None,
        meta_window: int = 256,
    ) -> "DurableFliX":
        """Start a durable history at ``seq=0`` from an existing state:
        writes the initial full snapshot and opens the first WAL segment.
        The default engine runs where ``handle`` lives."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        if cls.exists(directory):
            raise FileExistsError(
                f"{directory} already holds a durable index — use open()"
            )
        self = cls(
            directory,
            engine or LocalEngine(device=handle.device),
            handle,
            seq=0,
            epoch=0,
            snapshot_every=snapshot_every,
            full_every=full_every,
            keep_full=keep_full,
            fsync=fsync,
            crash_hook=crash_hook,
            meta_window=meta_window,
        )
        self.snapshot(full=True)  # also opens WAL segment seq+1
        return self

    @classmethod
    def open(
        cls,
        directory,
        *,
        engine=None,
        snapshot_every: int = 64,
        full_every: int = 8,
        keep_full: int = 2,
        fsync: bool = True,
        crash_hook=None,
        truncate_torn: bool = True,
        meta_window: int = 256,
    ) -> "DurableFliX":
        """Crash recovery: newest valid snapshot chain + WAL replay.

        Every batch whose append was acknowledged is recovered; a torn
        tail (crash mid-append) is truncated — or, with
        ``truncate_torn=False``, surfaces as ``WALCorruptionError``.
        Rebuilding from canonical triples is an epoch bump (fresh fences),
        so the first snapshot afterwards is full.  ``timings`` holds the
        seconds of the chain load, the rebuild and the replay.
        """
        directory = Path(directory)
        engine = engine or LocalEngine()
        snaps = _snapshot_dirs(directory)
        if not snaps:
            raise FileNotFoundError(f"no snapshots under {directory}")
        t0 = time.perf_counter()
        keys = vals = exps = manifest = None
        errors = []
        for seq, _path in reversed(snaps):
            try:
                keys, vals, exps, manifest = load_snapshot_chain(directory, seq)
                break
            except SnapshotCorruptionError as e:  # fall back to an older one
                errors.append(str(e))
        if manifest is None:
            raise SnapshotCorruptionError(
                f"no loadable snapshot under {directory}: {errors}"
            )
        t1 = time.perf_counter()
        handle = engine.rebuild(keys, vals, exps, manifest.get("geometry"))
        _sync(engine)
        t2 = time.perf_counter()
        self = cls(
            directory,
            engine,
            handle,
            seq=manifest["seq"],
            epoch=manifest["epoch"] + 1,  # rebuilt fences = new epoch
            snapshot_every=snapshot_every,
            full_every=full_every,
            keep_full=keep_full,
            fsync=fsync,
            crash_hook=crash_hook,
            meta_window=meta_window,
        )
        # the dedup/meta trail up to the snapshot rides in its manifest;
        # the replayed tail below extends it exactly as live applies did
        for mseq, mobj in manifest.get("meta_window") or []:
            self._record_meta(int(mseq), mobj)
        records = wal_mod.replay(
            directory, after_seq=manifest["seq"], truncate_torn=truncate_torn
        )
        for seq, payload in records:
            tag, key, val, max_results, meta_bytes, exp, wnow = decode_ops(payload)
            ops = OpBatch.from_host(tag, key, val, exp, device=engine.device)
            # replay at the LOGGED virtual clock: the recovered expiry state
            # is what the live engine computed, whenever recovery runs
            new, _results, _stats, restructured = engine.apply(
                self.handle, ops, max_results=max_results, now=wnow
            )
            self.handle = new
            if restructured:
                # a replayed restructure moves the fences, and apply()'s
                # dirty-bucket routing reads the refreshed _mkba_host
                self._bump_epoch()
            self._seq = seq
            if meta_bytes:
                self._record_meta(seq, json.loads(meta_bytes.decode()))
        self.replayed = len(records)
        _sync(engine)
        self.timings = {
            "chain_load_s": t1 - t0,
            "rebuild_s": t2 - t1,
            "replay_s": time.perf_counter() - t2,
        }

        # resume appending where the durable history ends: the newest
        # segment (tail-truncated above) stays the active one
        segs = wal_mod.segment_files(directory)
        if segs:
            self._wal.open_segment(segs[-1][0], path=segs[-1][1])
        else:
            self._wal.open_segment(self._seq + 1)
        if self.snapshot_every and self.replayed >= self.snapshot_every:
            self.snapshot()  # bound the next recovery's replay cost
        return self

    # -- accessors --------------------------------------------------------
    @property
    def seq(self) -> int:
        return self._seq

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def state(self):
        """The engine's current FliXState view (for a tiered engine, the
        whole state materialized on the device: no durable path reads it)."""
        return self.engine.flix(self.handle)

    @property
    def healthy(self) -> bool:
        """False once live and durable state have diverged (failed WAL
        rollback) — ``apply``/``snapshot`` are refused; reads of the live
        handle remain valid, and reopening from disk resynchronizes."""
        return self._poisoned is None and not self._closed

    @property
    def poisoned_reason(self) -> str | None:
        return self._poisoned

    def meta_trail(self) -> list[tuple[int, object]]:
        """The bounded ``(seq, meta)`` trail of recent durable commits,
        ascending — everything the last ``meta_window`` metadata-carrying
        batches logged, surviving snapshots and crash recovery."""
        return list(self._meta)

    def _record_meta(self, seq: int, meta: object) -> None:
        if meta is None or self.meta_window == 0:
            return
        self._meta.append((seq, meta))
        if len(self._meta) > self.meta_window:
            del self._meta[: len(self._meta) - self.meta_window]

    # -- the commit path --------------------------------------------------
    def apply(
        self,
        ops: OpBatch,
        *,
        config: ExecConfig | None = None,
        meta=None,
        now: int | None = None,
    ):
        """Durably execute one sorted batch; returns ``(results, stats)``.

        Only ``config.max_results`` is durable — it is logged per WAL
        record so replay re-runs each batch under its own budget; the rest
        of the strategy belongs to the engine.  ``now`` (the batch's
        virtual clock) is logged with any per-op expiry column, so replay
        recovers the identical expiry state.  ``meta`` (any JSON-
        serializable object) is logged inside the batch's record and kept
        in the bounded :meth:`meta_trail`.

        The WAL append (fsynced) precedes execution, so a crash at ANY
        later point replays this batch to the identical logical state;
        ``last_append`` holds its framed bytes and its seconds.  If
        the ENGINE fails, the just-appended record is rolled back before
        re-raising; should that rollback fail too, the instance is
        poisoned (further apply / snapshot refused) because live and
        durable state have diverged.
        """
        mr = (config if config is not None else ExecConfig()).max_results
        self._check_poisoned()
        tag, key, val, exp = ops.to_host()
        if exp is None and now is not None:
            # the record form needs an expiry column to carry the clock;
            # an all-sentinel one is logically "no per-op deadlines"
            exp = np.full(tag.shape, int(NO_EXPIRY), np.int32)
        seq = self._seq + 1
        meta_bytes = b"" if meta is None else json.dumps(meta).encode()
        wal_pos = self._wal.tell()
        payload = encode_ops(tag, key, val, mr, meta_bytes, exp=exp, now=now)
        t0 = time.perf_counter()
        self._wal.append(seq, payload)
        self.last_append = {
            "bytes": wal_mod.REC_HEADER_SIZE + len(payload),
            "append_fsync_s": time.perf_counter() - t0,
        }
        self._seq = seq

        # buckets holding rows the expire pass is about to reclaim change
        # WITHOUT appearing among the batch's update keys — mark them dirty
        # from the pre-apply state so delta snapshots cover the reclamation
        expired_buckets = self.engine.expired_buckets(self.handle, now)

        try:
            new, results, stats, restructured = self.engine.apply(
                self.handle, ops, max_results=mr, now=now
            )
        except BaseException:
            self._seq = seq - 1
            try:
                self._wal.truncate_to(wal_pos)
            except BaseException:
                self._poisoned = (
                    f"batch seq={seq} was logged but neither executed nor "
                    "rolled back; reopen from disk to resynchronize"
                )
            raise
        self.handle = new
        if restructured:
            self._bump_epoch()
        else:
            upd = (tag == OP_INSERT) | (tag == OP_DELETE) | (tag == OP_EXPIRE)
            if upd.any():
                self._dirty[np.searchsorted(self._mkba_host, key[upd], side="left")] = True
            if expired_buckets is not None:
                self._dirty[expired_buckets] = True
        self._record_meta(seq, meta)
        self._hook("apply.done")

        if self.snapshot_every and seq % self.snapshot_every == 0:
            self.snapshot()
        return results, stats

    def _bump_epoch(self) -> None:
        self._epoch += 1
        self._all_dirty = True
        self._mkba_host = np.asarray(self.engine.mkba_host(self.handle))
        self._dirty = np.zeros(self._mkba_host.size, bool)

    def _check_poisoned(self) -> None:
        if self._poisoned:
            raise RuntimeError(
                f"durable history diverged from live state: {self._poisoned}"
            )
        if self._closed:
            raise RuntimeError("durable index is closed")

    # -- snapshots --------------------------------------------------------
    def snapshot(self, *, full: bool | None = None) -> Path:
        """Write one snapshot at the current seq (atomic commit).

        ``full=None`` picks automatically: full on the first snapshot,
        after an epoch bump (fences moved — the delta partition is void),
        and every ``full_every``-th snapshot; otherwise a dirty-bucket
        delta whose write cost is proportional to churn.  ``last_timings``
        holds the seconds of the canonicalization (on the device, the copy
        of the live triples to the host included), of the framing with the
        crcs and the manifest, and of the writes with their fsyncs, and
        the bytes written.
        """
        self._check_poisoned()
        name = _snap_name(self._seq)
        if (self.dir / name).is_dir():
            # a snapshot at this seq is already committed, and seq determines
            # the logical content — forcing another is an idempotent no-op.
            # But only after it validates: open() may have fallen back PAST a
            # corrupt snapshot at exactly this seq.
            try:
                load_snapshot_chain(self.dir, self._seq)
                return self.dir / name
            except SnapshotCorruptionError:
                shutil.rmtree(self.dir / name, ignore_errors=True)
        if full is None:
            full = (
                self._all_dirty
                or self._bucket_lens is None
                or self._snaps_since_full >= self.full_every - 1
            )
        prev_full_name = None
        if not full:
            prev_full_name = self._latest_snap_name()

        t0 = time.perf_counter()
        if full:
            lens, seg_k, seg_v, seg_e = self.engine.segments(self.handle)
            t1 = time.perf_counter()
            payload = pairs_to_bytes(seg_k, seg_v, seg_e)
            all_lens = np.asarray(lens, np.int64)
            all_crcs = np.asarray(segment_crcs(lens, seg_k, seg_v, seg_e), np.int64)
            kind = "full"
        else:
            dirty = np.nonzero(self._dirty)[0]  # ascending bucket ids
            lens, seg_k, seg_v, seg_e = self.engine.segments(self.handle, dirty)
            t1 = time.perf_counter()
            payload = pack_delta(dirty, lens, seg_k, seg_v, seg_e)
            all_lens = self._bucket_lens.copy()
            all_crcs = self._bucket_crcs.copy()
            all_lens[dirty] = lens
            all_crcs[dirty] = segment_crcs(lens, seg_k, seg_v, seg_e)
            kind = "delta"

        nb, npb, ns = self.engine.geometry(self.handle)
        manifest = {
            "format": SNAP_FORMAT,
            "kind": kind,
            "seq": self._seq,
            "epoch": self._epoch,
            "base": prev_full_name,
            "engine": self.engine.kind,
            "geometry": {
                "num_buckets": int(nb),
                "nodes_per_bucket": int(npb),
                "node_size": int(ns),
                "fill": getattr(self.engine, "fill", 0.5),
            },
            "n_live": int(all_lens.sum()),
            "seg_lens": all_lens.tolist(),
            "bucket_crcs": all_crcs.tolist(),
            "payload_crc": zlib.crc32(payload),
            # carry the dedup/meta trail across the WAL segments this
            # snapshot retires — open() reseeds from here
            "meta_window": [[s, m] for s, m in self._meta],
        }
        manifest_bytes = json.dumps(manifest, sort_keys=True).encode()
        t2 = time.perf_counter()

        tmp = tmp_sibling(self.dir / name)
        tmp.mkdir(parents=True)
        try:
            self._write_file(tmp / "payload.bin", payload, split=True)
            self._hook("snap.payload.written")
            self._write_file(tmp / "manifest.json", manifest_bytes)
            self._hook("snap.manifest.written")
            self._hook("snap.before_rename")
            os.rename(tmp, self.dir / name)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._fsync_dir()
        self._hook("snap.committed")
        self.last_timings = {
            "kind": kind,
            "canonicalize_s": t1 - t0,
            "crc_s": t2 - t1,
            "write_fsync_s": time.perf_counter() - t2,
            "payload_bytes": len(payload),
            "manifest_bytes": len(manifest_bytes),
        }

        self._bucket_lens = all_lens
        self._bucket_crcs = all_crcs
        self._dirty[:] = False
        self._all_dirty = False
        self._snaps_since_full = 0 if full else self._snaps_since_full + 1
        self._wal.rotate(self._seq + 1)
        self._gc()
        self._hook("snap.gc")
        return self.dir / name

    def _latest_snap_name(self) -> str:
        snaps = _snapshot_dirs(self.dir)
        if not snaps:
            raise RuntimeError("delta snapshot requires an existing base")
        return snaps[-1][1].name

    def _write_file(self, path: Path, data: bytes, *, split: bool = False) -> None:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
        try:
            if split and len(data) > 1:
                # two writes so the crash hook can land mid-payload
                wal_mod.write_all(fd, data[: len(data) // 2])
                self._hook("snap.payload.partial")
                wal_mod.write_all(fd, data[len(data) // 2 :])
            else:
                wal_mod.write_all(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)

    def _fsync_dir(self) -> None:
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _gc(self) -> None:
        """Retention: keep the ``keep_full`` newest full snapshots, every
        delta above the oldest kept full, and the WAL segments needed to
        replay past the oldest kept snapshot."""
        snaps = [
            (seq, p, _read_manifest(p)["kind"]) for seq, p in _snapshot_dirs(self.dir)
        ]
        fulls = [seq for seq, _p, kind in snaps if kind == "full"]
        if len(fulls) <= self.keep_full:
            return
        cutoff = sorted(fulls)[-self.keep_full]
        for seq, p, _kind in snaps:
            if seq < cutoff:
                shutil.rmtree(p, ignore_errors=True)
        segs = wal_mod.segment_files(self.dir)
        for (start, path), nxt in zip(segs, segs[1:]):
            # a segment holds records [start, next_start); all ≤ cutoff are
            # covered by the oldest kept snapshot
            if nxt[0] <= cutoff + 1:
                path.unlink(missing_ok=True)

    def close(self) -> None:
        """Flush and close the WAL.  Idempotent, and safe on a poisoned
        instance: teardown of a diverged index must not raise on top of
        the failure that poisoned it."""
        if self._closed:
            return
        self._closed = True
        try:
            self._wal.close()
        except OSError:
            if self._poisoned is None:
                raise


def _sync(engine) -> None:
    """Wait for the engine's devices, so that host clocks cover their work."""
    for dev in getattr(engine, "devices", (getattr(engine, "device", None),)):
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
