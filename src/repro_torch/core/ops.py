"""Mixed-operation batch engine (port of ``repro/core/ops.py``; paper §4.1).

The execution unit is one key-sorted batch per step: ``make_ops`` does the
one global sort, and ``apply_ops`` routes the whole mixed batch once with
``bucket_slices``.  Per-type views are derived from that routing with no
second sort: order-preserving prefix-count scatters compact the insert and
delete keys, and their per-bucket slice boundaries are prefix counts of
the single routing.

Within a batch the semantics are update-then-read:

  1. INSERT ops merge in first (upsert — incoming value wins),
  2. DELETE ops remove physically (present-key hits only),
  3. POINT, SUCCESSOR, and RANGE ops observe the post-update state.

RANGE reuses the key column for ``lo`` and the val column for ``hi`` and
answers the half-open ``[lo, hi)``; each batch carries one static
``max_results`` output budget.

TTL (``core/expiry.py``): when the state or the batch carries an expiry
column, ``apply_ops(..., now=)`` first reclaims every row with
``exp <= now``, lowers ``OP_EXPIRE`` (get-or-set with a deadline) to
``OP_INSERT``, and runs the executor twice, on the value plane and on the
expiry plane (``_apply_ops_ttl``).

Two executors sit behind one contract (``ExecConfig.impl``): the plain
torch *reference* engine, which shares ``insert_with_slices``, ``delete``
and the ``core.query`` reads, and the *fused* path of
``kernels/flix_apply``, a thread block or a warp per bucket.  On the card
``"auto"`` takes the fused path for a batch with updates and, for one
without, its read-only pass (``flix_apply_read``): one kernel, a thread an
op, that writes nothing, and no routing.  Precondition: at
most one update op (INSERT, DELETE or EXPIRE) per key per batch.  ``OP_NOP`` slots
(key ``EMPTY``) pad a batch to a fixed size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.batch import bucket_slices
from repro_torch.core.config import DEFAULT_MAX_RESULTS, ExecConfig
from repro_torch.core.delete import delete
from repro_torch.core.insert import insert_with_slices
from repro_torch.core.invariants import check_invariants, check_range_results
from repro_torch.core.query import dense_range_scan, point_query, successor_query
from repro_torch.core.restructure import restructure_grow
from repro_torch.core.state import (
    EMPTY,
    KEY_DTYPE,
    NOT_FOUND,
    VAL_DTYPE,
    FliXState,
    resolve_device,
)

OP_INSERT = 0
OP_DELETE = 1
OP_POINT = 2
OP_SUCCESSOR = 3
OP_NOP = 4  # padding slot; key must be EMPTY so it routes past every bucket
OP_RANGE = 5  # key column = lo, val column = hi; answers [lo, hi)
OP_EXPIRE = 6  # get-or-set with a deadline (exp column); see _apply_ops_ttl

OP_DTYPE = torch.int32


@dataclasses.dataclass(frozen=True)
class OpBatch:
    """A key-sorted batch of tagged operations."""

    tag: torch.Tensor  # [N] int32
    key: torch.Tensor  # [N] int32, ascending (EMPTY = NOP padding, at end)
    val: torch.Tensor  # [N] int32 (INSERT: value; RANGE: exclusive hi)
    exp: torch.Tensor | None = None  # [N] int32 deadlines, or None (no TTL)

    @property
    def size(self) -> int:
        return self.key.shape[0]

    def to_host(self):
        """The batch as host int32 numpy arrays ``(tag, key, val, exp)`` —
        the form the write-ahead log frames and the dirty-bucket tracker
        reads — by one device-to-host copy.  ``exp`` is None for TTL-free
        batches."""
        cols = [self.tag, self.key, self.val]
        if self.exp is not None:
            cols.append(self.exp)
        host = torch.stack([c.to(torch.int32) for c in cols]).cpu().numpy()
        return host[0], host[1], host[2], host[3] if self.exp is not None else None

    @classmethod
    def from_host(cls, tag, key, val, exp=None, *, device=None) -> "OpBatch":
        """A batch from host arrays *without re-sorting* (WAL records hold
        sorted batches, and replay must apply exactly the logged bytes), on
        ``device``: the card unless the caller names another."""
        dev = resolve_device(device)

        def col(a):
            return torch.as_tensor(np.asarray(a, np.int32)).to(dev)

        return cls(
            tag=col(tag), key=col(key), val=col(val), exp=None if exp is None else col(exp)
        )


def make_ops(
    tags, keys, vals=None, *, exps=None, pad_to: int | None = None, device=None
):
    """Sort a raw operation list by key into an :class:`OpBatch`.

    This is the engine's one global sort.  Returns ``(ops, perm)`` where
    ``perm[j]`` is the sorted position input op ``j`` landed at, so
    :func:`unsort` maps per-op results back to submission order.  The batch
    lives on ``device``: the card unless the caller names another.
    ``exps`` attaches a per-op deadline column (sorted with the keys, padded
    with ``NO_EXPIRY``); batches with ``OP_EXPIRE`` or TTL'd inserts need it.
    ``pad_to`` appends ``OP_NOP`` slots up to a fixed size.
    """
    from repro_torch.core.expiry import NO_EXPIRY

    dev = resolve_device(device)
    with trace.span("make_ops"):
        tags = torch.as_tensor(tags).to(device=dev, dtype=OP_DTYPE)
        keys = torch.as_tensor(keys).to(device=dev, dtype=KEY_DTYPE)
        if vals is None:
            vals = torch.zeros(keys.shape, dtype=VAL_DTYPE, device=dev)
        vals = torch.as_tensor(vals).to(device=dev, dtype=VAL_DTYPE)
        if exps is not None:
            exps = torch.as_tensor(exps).to(device=dev, dtype=KEY_DTYPE)
        if pad_to is not None and pad_to > keys.shape[0]:
            extra = pad_to - keys.shape[0]
            tags = torch.cat([tags, tags.new_full((extra,), OP_NOP)])
            keys = torch.cat([keys, keys.new_full((extra,), EMPTY)])
            vals = torch.cat([vals, vals.new_zeros((extra,))])
            if exps is not None:
                exps = torch.cat([exps, exps.new_full((extra,), NO_EXPIRY)])
        order = torch.argsort(keys, stable=True)
        # inverse permutation (input position -> sorted position) by O(N) scatter
        perm = torch.empty_like(order)
        perm[order] = torch.arange(order.shape[0], device=dev)
        exp = None if exps is None else exps[order]
        return OpBatch(tag=tags[order], key=keys[order], val=vals[order], exp=exp), perm


def unsort(sorted_result: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Map a sorted-order result array back to submission order."""
    with trace.span("unsort"):
        return sorted_result[perm]


def touched_buckets(mkba_host, tag, key, val, *, live=None, min_exp=None, now=None):
    """Host prefetch pre-pass: which buckets a sorted batch can touch.

    The tiered engine (``core.residency``) promotes exactly the buckets
    whose bytes the executors may consult, so that running the unchanged
    executors on the packed resident subset is bucket for bucket what they
    do on the full state.  The routing is the engine's own:
    ``min(searchsorted(mkba, q), nb - 1)``.

    Per op type:
      * INSERT / DELETE / POINT / EXPIRE — the op's bucket.
      * RANGE — every bucket from ``b(lo)`` through ``b(hi)`` inclusive: the
        rank arithmetic consults every bucket inside the interval.
      * SUCCESSOR — ``b(q)`` plus the forward walk up to and including the
        first bucket *guaranteed* non-empty after the batch's own updates
        and expiry pass (an insert routed to it, or pre-batch rows that
        survive), so that the packed fence rows' suffix scan agrees with
        the full one.
      * when ``now`` is given — every bucket whose minimum live deadline is
        ≤ ``now``: the expiry pre-pass reclaims rows there.

    ``live`` / ``min_exp`` are per-bucket host metadata ([nb]: live row
    count; minimum live deadline, ``NO_EXPIRY`` without TTLs), both
    optional and degrading conservatively: without ``live`` only inserts
    guarantee non-emptiness; with ``now`` but no ``min_exp`` no pre-batch
    row is safe.  All inputs are host numpy arrays; returns an [nb] bool
    mask.
    """
    mkba = np.asarray(mkba_host)
    nb = mkba.shape[0]
    tag = np.asarray(tag)
    key = np.asarray(key)
    val = np.asarray(val)
    touched = np.zeros(nb, dtype=bool)

    def b_of(q):
        return np.minimum(np.searchsorted(mkba, q, side="left"), nb - 1)

    def cover(lo_b, hi_b):
        """Mark every bucket of the inclusive intervals ``[lo_b, hi_b]``."""
        d = np.zeros(nb + 1, np.int64)
        np.add.at(d, lo_b, 1)
        np.add.at(d, hi_b + 1, -1)
        return np.cumsum(d[:nb]) > 0

    simple = (
        (tag == OP_INSERT) | (tag == OP_DELETE) | (tag == OP_POINT) | (tag == OP_EXPIRE)
    )
    if simple.any():
        touched[b_of(key[simple])] = True

    is_range = tag == OP_RANGE
    if is_range.any():
        lo_b = b_of(key[is_range])
        hi_b = b_of(val[is_range])
        touched[lo_b] = True
        touched[hi_b] = True
        ok = lo_b <= hi_b
        if ok.any():
            touched |= cover(lo_b[ok], hi_b[ok])

    is_succ = tag == OP_SUCCESSOR
    if is_succ.any():
        n_ins = np.zeros(nb, np.int64)
        upd_ins = ((tag == OP_INSERT) | (tag == OP_EXPIRE)) & (key != EMPTY)
        if upd_ins.any():
            np.add.at(n_ins, b_of(key[upd_ins]), 1)
        guaranteed = n_ins > 0
        if live is not None:
            n_del = np.zeros(nb, np.int64)
            upd_del = (tag == OP_DELETE) & (key != EMPTY)
            if upd_del.any():
                np.add.at(n_del, b_of(key[upd_del]), 1)
            survives = np.asarray(live).astype(np.int64) - n_del > 0
            if now is not None:
                if min_exp is None:
                    survives &= False  # no deadline metadata: nothing is safe
                else:
                    survives &= np.asarray(min_exp).astype(np.int64) > int(now)
            guaranteed |= survives
        b = b_of(key[is_succ])
        touched[b] = True
        # next_g[j] = first guaranteed bucket ≥ j (nb if none)
        gidx = np.where(guaranteed, np.arange(nb, dtype=np.int64), nb)
        next_g = np.append(np.minimum.accumulate(gidx[::-1])[::-1], nb)
        starts = b + 1
        inb = starts < nb
        if inb.any():
            s = starts[inb]
            t = next_g[s]
            touched |= cover(s, np.where(t < nb, t, nb - 1))  # to the end if none

    if now is not None and min_exp is not None:
        touched |= np.asarray(min_exp).astype(np.int64) <= int(now)
    return touched


def _compact_by_mask(
    keys: torch.Tensor, mask: torch.Tensor, vals: torch.Tensor | None = None
):
    """Front-pack ``keys[mask]`` preserving order; EMPTY tail.  No sort:
    destinations are a prefix count, so ascending order is preserved."""
    n = keys.shape[0]
    dest = torch.where(mask, torch.cumsum(mask, 0) - 1, n)  # n = discard slot
    out_k = keys.new_full((n + 1,), EMPTY).scatter_(0, dest, keys)[:n]
    if vals is None:
        return out_k
    out_v = vals.new_zeros((n + 1,)).scatter_(0, dest, vals)[:n]
    return out_k, out_v


@dataclasses.dataclass(frozen=True)
class Routing:
    """The single routing of a mixed batch and the per-type views derived
    from it: op slices ``[starts[b], ends[b])`` of the sorted batch, the
    compacted insert and delete keys, and their per-bucket slices."""

    starts: torch.Tensor
    ends: torch.Tensor
    is_ins: torch.Tensor
    is_del: torch.Tensor
    ins_keys: torch.Tensor
    ins_vals: torch.Tensor
    del_keys: torch.Tensor
    ins_starts: torch.Tensor
    ins_ends: torch.Tensor
    del_starts: torch.Tensor
    del_ends: torch.Tensor


def _prefix_counts(mask: torch.Tensor) -> torch.Tensor:
    counts = torch.cumsum(mask, 0, dtype=torch.int32)
    return torch.cat([counts.new_zeros((1,)), counts])


def route(state: FliXState, tag: torch.Tensor, key: torch.Tensor, val: torch.Tensor):
    """One ``bucket_slices`` routing of the whole batch, plus the insert and
    delete views mapped onto it by prefix counts (no second sort, no second
    fence routing).  Shared by both executors."""
    with trace.span("route"):
        starts, ends = bucket_slices(state, key)
        is_ins = tag == OP_INSERT
        is_del = tag == OP_DELETE
        ins_keys, ins_vals = _compact_by_mask(key, is_ins, val)
        del_keys = _compact_by_mask(key, is_del)
        c_ins = _prefix_counts(is_ins)
        c_del = _prefix_counts(is_del)
        return Routing(
            starts=starts,
            ends=ends,
            is_ins=is_ins,
            is_del=is_del,
            ins_keys=ins_keys,
            ins_vals=ins_vals,
            del_keys=del_keys,
            ins_starts=c_ins[starts],
            ins_ends=c_ins[ends],
            del_starts=c_del[starts],
            del_ends=c_del[ends],
        )


def derive_type_views(
    state: FliXState, tag: torch.Tensor, key: torch.Tensor, val: torch.Tensor
):
    """The reference's view tuple ``(is_ins, is_del, ins_keys, ins_vals,
    del_keys, ins_starts, ins_ends)`` of :func:`route`."""
    r = route(state, tag, key, val)
    return (
        r.is_ins,
        r.is_del,
        r.ins_keys,
        r.ins_vals,
        r.del_keys,
        r.ins_starts,
        r.ins_ends,
    )


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _apply_ops_reference(
    state: FliXState,
    ops: OpBatch,
    *,
    max_results: int = DEFAULT_MAX_RESULTS,
    has_ranges: bool | None = None,
):
    """Reference engine: five plain-torch phases (the fused path's oracle).

    An absent op class skips its phase (the reference's ``lax.cond``
    becomes a host-side ``if`` on ``bool(mask.any())``; ``has_ranges``
    answers the RANGE one without it).
    """
    # the update phases construct cache-free states; a batch without updates
    # returns its input, so drop the cache here as the reference does
    state = state.drop_volatile()
    dev = state.device
    tag, key, val = ops.tag, ops.key, ops.val
    n = key.shape[0]
    is_ins, is_del, ins_keys, ins_vals, del_keys, ins_starts, ins_ends = (
        derive_type_views(state, tag, key, val)
    )

    # --- update phase: merge inserts, then physical deletes ---------------
    if trace.host_bool(is_ins.any(), "reference.has_insert"):
        with trace.span("reference.insert"):
            s1, ins_stats = insert_with_slices(
                state, ins_keys, ins_vals, ins_starts, ins_ends
            )
    else:
        s1 = state
        ins_stats = {"inserted": _zero(dev), "overflowed_buckets": _zero(dev)}
    if trace.host_bool(is_del.any(), "reference.has_delete"):
        with trace.span("reference.delete"):
            s2, del_stats = delete(s1, del_keys)
    else:
        s2, del_stats = s1, {"deleted": _zero(dev)}

    # --- read phase: flipped compare-count against the updated state ------
    is_point = tag == OP_POINT
    is_succ = tag == OP_SUCCESSOR
    miss = torch.full((n,), NOT_FOUND, dtype=VAL_DTYPE, device=dev)
    if trace.host_bool(is_point.any(), "reference.has_point"):
        with trace.span("reference.point"):
            pv = point_query(s2, key)
    else:
        pv = miss
    if trace.host_bool(is_succ.any(), "reference.has_successor"):
        with trace.span("reference.successor"):
            sk, sv = successor_query(s2, key)
    else:
        sk, sv = torch.full((n,), EMPTY, dtype=KEY_DTYPE, device=dev), miss

    # --- range phase: dense [lo, hi) scans against the updated state ------
    is_range = tag == OP_RANGE
    if has_ranges is None:
        has_ranges = trace.host_bool(is_range.any(), "reference.has_range")
    if has_ranges:
        with trace.span("reference.range"):
            rk, rv, rstart, rcnt, rtrunc = dense_range_scan(
                s2, is_range, key, val, max_results=max_results
            )
    else:
        rk = torch.full((max_results,), EMPTY, dtype=KEY_DTYPE, device=dev)
        rv = torch.full((max_results,), NOT_FOUND, dtype=VAL_DTYPE, device=dev)
        rstart = torch.zeros((n,), dtype=torch.int32, device=dev)
        rcnt, rtrunc = torch.zeros_like(rstart), _zero(dev)

    results = {
        "value": torch.where(is_point, pv, torch.where(is_succ, sv, NOT_FOUND)),
        "succ_key": torch.where(is_succ, sk, EMPTY),
        "range_key": rk,
        "range_val": rv,
        "range_start": rstart,
        "range_count": rcnt,
    }
    stats = {
        "inserted": ins_stats["inserted"],
        "deleted": del_stats["deleted"],
        "overflowed_buckets": ins_stats["overflowed_buckets"],
        "range_truncated": rtrunc,
    }
    return s2, results, stats


def _apply_ops_plain(
    state: FliXState,
    ops: OpBatch,
    *,
    impl: str,
    cfg: ExecConfig,
    has_ranges=None,
    donate: bool = False,
):
    """Dispatch one TTL-free batch to the chosen executor (impl resolved:
    ``"read"`` is ``"auto"``'s choice for a batch without updates on the
    card).  ``donate`` (resolved by :func:`_apply`: only the fused path's
    staged kernel donates) runs the staged kernel's donated pass."""
    if impl == "reference":
        return _apply_ops_reference(
            state, ops, max_results=cfg.max_results, has_ranges=has_ranges
        )
    if impl == "read":
        from repro_torch.kernels.flix_apply import flix_apply_read

        return flix_apply_read(state, ops.tag, ops.key, ops.val, max_results=cfg.max_results)
    if impl != "fused":
        raise ValueError(f"unknown apply_ops impl: {impl!r}")
    from repro_torch.kernels.flix_apply import flix_apply

    nb, npb, ns = state.geometry
    _, block_b = cfg.resolve_blocks(nb * npb * ns, ops.size)
    staged = cfg.resolve_pipeline(state.device)
    return flix_apply(
        state,
        ops.tag,
        ops.key,
        ops.val,
        max_results=cfg.max_results,
        staged=staged,
        block_b=block_b or 0,
        has_ranges=has_ranges,
        donate=donate,
    )


def _apply_ops_ttl(
    state: FliXState, ops: OpBatch, *, impl: str, cfg: ExecConfig, now=None, has_ranges=None
):
    """TTL-aware batch execution over either executor (the reference's
    ``_apply_ops_ttl``).  Three steps the executors never see:

      1. *Expire pass*: ``expire_state(state, now)`` reclaims every row with
         ``exp <= now`` (skipped when ``now`` is None).
      2. *EXPIRE lowering*: OP_EXPIRE ops probe the post-expire pre-update
         state with one ``successor_query`` (present iff the successor key is
         the op key, which unlike POINT tells a stored NOT_FOUND value from
         a miss) and become OP_INSERT: a hit re-puts the *stored* value
         while the expiry plane takes the op's new deadline, a miss inserts
         the op's (val, exp).  Sound because update ops are unique per key
         within a batch.
      3. *Two-plane execution*: the executor runs on a state whose ``vals``
         hold the deadlines, then on the value plane.  Every layout decision
         is a function of keys and tags only, so both land the same key
         layout and the first run's ``vals`` are the new expiry plane.
    """
    from repro_torch.core.expiry import NO_EXPIRY, attach_expiry, expire_state

    state = attach_expiry(state.drop_volatile())
    tag, key, val = ops.tag, ops.key, ops.val
    exp = ops.exp if ops.exp is not None else torch.full_like(key, NO_EXPIRY)
    if now is not None:
        with trace.span("ttl.expire"):
            state, n_expired = expire_state(state, now)
    else:
        n_expired = _zero(state.device)

    is_exp = tag == OP_EXPIRE
    value_state = dataclasses.replace(state, exps=None)
    exp_state = dataclasses.replace(state, vals=state.exps, exps=None)
    if trace.host_bool(is_exp.any(), "ttl.has_expire"):
        with trace.span("ttl.probe"):
            sk, stored = successor_query(value_state, key)
            present = is_exp & (sk == key)
    else:
        present = torch.zeros_like(is_exp)
        stored = torch.full_like(key, NOT_FOUND)

    tag2 = torch.where(is_exp, OP_INSERT, tag)
    val2 = torch.where(present, stored, val)
    val_e = torch.where(tag2 == OP_INSERT, exp, val)  # RANGE hi rides val in both
    s2e, _, _ = _apply_ops_plain(
        exp_state, OpBatch(tag=tag2, key=key, val=val_e), impl=impl, cfg=cfg,
        has_ranges=has_ranges,
    )
    s2v, results, stats = _apply_ops_plain(
        value_state, OpBatch(tag=tag2, key=key, val=val2), impl=impl, cfg=cfg,
        has_ranges=has_ranges,
    )
    new_exps = torch.where(s2v.keys == EMPTY, NO_EXPIRY, s2e.vals)
    del s2e
    new_state = dataclasses.replace(s2v, exps=new_exps)

    results = dict(results)
    results["value"] = torch.where(
        is_exp, torch.where(present, stored, NOT_FOUND), results["value"]
    )
    stats = dict(stats)
    stats["expired"] = n_expired
    return new_state, results, stats


def apply_ops(
    state: FliXState,
    ops: OpBatch,
    *,
    config: ExecConfig | None = None,
    has_updates: bool | None = None,
    has_ranges: bool | None = None,
    now=None,
):
    """Execute one mixed sorted batch on the state's device.  Returns
    ``(state', results, stats)``.

    ``results`` is aligned with the sorted batch:
      * ``value``    — POINT: stored value or NOT_FOUND; SUCCESSOR: successor
                       value or NOT_FOUND; other tags: NOT_FOUND.
      * ``succ_key`` — SUCCESSOR: smallest stored key ≥ op key (post-update)
                       or EMPTY; other tags: EMPTY.
      * ``range_key`` / ``range_val`` — the dense ``[max_results]`` RANGE
        output, EMPTY / NOT_FOUND beyond the emitted total.
      * ``range_start`` / ``range_count`` — per-op offset and length of its
        segment (0 / 0 for non-RANGE ops); truncation is flagged in
        ``stats["range_truncated"]``.

    ``config.impl`` selects the executor: ``"reference"`` (plain torch),
    ``"fused"`` (``kernels.flix_apply``: the CUDA kernel on the card, its
    plain version on the CPU), or ``"auto"`` — on CUDA the fused path for
    batches that contain updates and, for batches without, the read-only
    pass (``kernels.flix_apply.flix_apply_read``, which returns ``state``
    itself), except under TTL (an expiry column), where those take the
    reference; on the CPU the reference.
    ``has_updates`` answers that check without a device sync when the
    caller already knows, and ``has_ranges`` whether the batch holds RANGE
    ops.
    ``config.pipeline`` picks the fused path's stripe kernel
    (:meth:`ExecConfig.resolve_pipeline`).

    ``now`` is the engine's only notion of time: when the state or the
    batch carries an expiry column, rows with ``exp <= now`` are reclaimed
    before the update phase and OP_EXPIRE ops run get-or-set against the
    expired state; ``stats["expired"]`` counts the reclaimed rows.
    ``now=None`` skips the expire pass (expiry columns are still kept).

    ``config.donate`` True lets the fused path's staged kernel write the
    result into the input state's planes (``kernels.flix_apply``'s donated
    pass): the result then holds the input's ``keys``, ``vals``,
    ``node_count`` and ``node_max`` tensors, and the caller must not read
    the input afterwards.  A donated call whose batch overflows a bucket,
    or whose input already needs restructuring, writes nothing and returns
    the input's planes flagged ``needs_restructure``, its reads unanswered.
    False and None (the default here) write a new state; the reference
    engine, the single-buffer kernel and the TTL path always do.  The
    read-only pass writes none, whatever ``donate`` says.

    On bucket overflow the returned state carries ``needs_restructure`` and
    the overflowing buckets are untrustworthy; hosts use
    :func:`apply_ops_safe`.
    """
    cfg = config if config is not None else ExecConfig()
    out, _ = _apply(state, ops, cfg, has_updates=has_updates, has_ranges=has_ranges, now=now)
    return out


def _apply(state: FliXState, ops: OpBatch, cfg: ExecConfig, *, has_updates, has_ranges, now):
    """:func:`apply_ops`'s body: ``((state', results, stats), donated)``,
    where ``donated`` says whether the call ran the donated pass, which
    only the fused path's staged kernel runs, on a state without expiry."""
    impl = cfg.impl
    if impl == "auto":
        if state.device.type not in _KERNEL_DEVICES:
            impl = "reference"
        else:
            if has_updates is None:
                has_updates = trace.host_bool(_update_mask(ops.tag).any(), "has_updates")
            impl = "fused" if has_updates else "read"
    # TTL is structural: an expiry column on the state or on the batch
    if state.exps is not None or ops.exp is not None:
        impl = "reference" if impl == "read" else impl
        out = _apply_ops_ttl(state, ops, impl=impl, cfg=cfg, now=now, has_ranges=has_ranges)
        return out, False
    donate = bool(cfg.donate) and impl == "fused" and cfg.resolve_pipeline(state.device)
    out = _apply_ops_plain(state, ops, impl=impl, cfg=cfg, has_ranges=has_ranges, donate=donate)
    return out, donate


# the device types on which impl="auto" runs the kernels; elsewhere it runs
# the reference engine (the kernels' plain versions run on any device)
_KERNEL_DEVICES = ("cuda",)


def _update_mask(tag: torch.Tensor) -> torch.Tensor:
    return (tag == OP_INSERT) | (tag == OP_DELETE) | (tag == OP_EXPIRE)


def apply_ops_safe(
    state: FliXState,
    ops: OpBatch,
    *,
    config: ExecConfig | None = None,
    has_updates: bool | None = None,
    now=None,
):
    """Host-level loop: apply, restructure-and-retry on overflow.

    This driver replaces its caller's state, so it donates the input to
    ``apply_ops`` unless ``config.donate`` is False: the result may hold
    the input's planes, written in place, and the caller must not read the
    input afterwards.  A donated call writes nothing when the batch
    overflows a bucket or the input already needs restructuring, so the
    input is whole wherever the result needs restructuring.  The retry
    replays the whole batch, without donating, on the regrown pre-batch
    state; where the donated pass met an input that already needed
    restructuring, the batch is run again without donating and that result
    returned, as without donation.
    OP_EXPIRE counts as an insert when the new geometry is sized.
    ``config.validate_ranges`` runs ``check_range_results`` on the results
    and ``config.validate`` runs ``check_invariants`` on the result state,
    I6 at ``now`` included — except after a batch that wrote rows already
    past their deadline, which stay live until the next batch's expire pass.
    The returned ``stats`` gains ``restructure_retries`` (host int).
    """
    with trace.span("apply_ops_safe"):
        cfg = config if config is not None else ExecConfig()
        run_cfg = cfg.replace(donate=False, validate=False, validate_ranges=False)
        restructure_retries = 0
        (new_state, results, stats), donated = _apply(
            state, ops, run_cfg.replace(donate=cfg.donate is not False),
            has_updates=has_updates, has_ranges=None, now=now,
        )
        needs = trace.host_bool(new_state.needs_restructure, "needs_restructure")
        if needs and trace.host_bool(
            state.needs_restructure, "input_needs_restructure"
        ):
            if donated:  # the donated pass wrote nothing: the batch again, not donated
                new_state, results, stats = apply_ops(
                    state, ops, config=run_cfg, has_updates=has_updates, now=now
                )
        elif needs:
            with trace.span("restructure"):
                n_ins = trace.host_int(
                    ((ops.tag == OP_INSERT) | (ops.tag == OP_EXPIRE)).sum(), "restructure.inserts"
                )
                grown = restructure_grow(state, extra_keys=max(n_ins, 1))
                new_state, results, stats = apply_ops(
                    grown, ops, config=run_cfg, has_updates=has_updates, now=now
                )
                if trace.host_bool(new_state.needs_restructure, "restructure.retry_overflowed"):
                    raise RuntimeError("batch overflowed the geometry restructure_grow planned")
            restructure_retries = 1
        stats = dict(stats)
        stats["restructure_retries"] = restructure_retries
        if cfg.validate_ranges or cfg.validate:
            with trace.span("validate"):
                if cfg.validate_ranges:
                    check_range_results(ops, results, max_results=cfg.max_results)
                if cfg.validate:
                    check_now = now
                    if now is not None and ops.exp is not None:
                        wrote = (ops.tag == OP_INSERT) | (ops.tag == OP_EXPIRE)
                        wrote_expired = (wrote & (ops.exp <= int(now))).any()
                        if trace.host_bool(wrote_expired, "validate.wrote_expired"):
                            check_now = None
                    check_invariants(new_state, now=check_now)
        return new_state, results, stats
