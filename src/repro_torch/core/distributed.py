"""Bucket-sharded FliX over a list of devices (port of
``repro/core/distributed.py``; DESIGN.md §11, §16).

Buckets are *range-partitioned* across shards (contiguous MKBA ranges per
shard), so the flipped mapping lifts one level up: a shard is a
super-bucket, and a sorted operation batch is routed to shards by the same
fence ``searchsorted`` that routes it to buckets.  One mixed ``OpBatch``
runs per :func:`shard_apply_ops` call, with each shard's work done by the
single-device ``core.ops.apply_ops`` unchanged — on the card its fused path
and stripe kernel — so the hierarchy composes: bucket ⊂ shard ⊂ index.

The reference is single-controller: one ``jit(shard_map)`` over a mesh of
devices.  So is the port.  A :class:`ShardMesh` holds an explicit tuple of
torch devices, one per shard (repeats allowed: four shards on one card, or
on the CPU in the tests), and the executors run the reference's shard body
phase by phase in a loop over shards.  Each ``jax.lax`` collective becomes
a plain function over the list of per-shard tensors (:func:`all_gather`,
:func:`all_to_all`, :func:`psum`, :func:`pmin`) that moves them with
``.to(device, non_blocking=True)``: peer copies between cards, nothing at
all between shards of one card.  Values the reference replicates over the
mesh (the recombined results and stats) are computed once, on the device
of the caller's batch.

Two routings (``ExecConfig.routing``):

* ``"replicated"`` — the sorted batch goes to every shard; each shard masks
  the *update* ops to its fence range (reads run everywhere: a successor or
  range answer may live past the op key's owner shard) and the shards'
  answers are recombined by one ``pmin`` and one fused ``psum``.
* ``"a2a"`` — the batch is position-sharded into equal chunks, one a shard;
  each chunk's rows travel to their owner shard through one partition-fence
  ``searchsorted`` driving a padded ``all_to_all`` of fixed per-pair
  ``capacity``, and the answers come back over the inverse ``all_to_all``.
  Rows past the capacity are dropped and counted in
  ``stats["a2a_overflow"]``; :func:`shard_apply_ops` never writes its input,
  so the caller replays the batch with a larger capacity
  (:func:`shard_apply_ops_safe` does).

RANGE results are recombined into the dense exclusive-scan contract of
DESIGN.md §10 with *global* offsets: the per-op local in-range counts are
gathered, an exclusive scan over shards gives each shard its slot window
inside every op's segment, and one global ``max_results`` budget
truncates — byte-identical to single-device ``apply_ops`` on the union
state.  When the batch has RANGE ops and no expiry clock, the counts are
taken from the *predicted* post-update layout before each shard's apply,
as the reference does to overlap its collective with the update; with a
clock they are taken from the updated state.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.batch import bucket_slices, gather_sublists
from repro_torch.core.build import build_from_sorted
from repro_torch.core.config import ExecConfig
from repro_torch.core.expiry import NO_EXPIRY, attach_expiry
from repro_torch.core.ops import (
    OP_DELETE,
    OP_EXPIRE,
    OP_INSERT,
    OP_NOP,
    OP_RANGE,
    OP_SUCCESSOR,
    OP_POINT,
    OpBatch,
    _compact_by_mask,
    _update_mask,
    apply_ops,
)
from repro_torch.core.query import (
    _suffix_min_with_index,
    flat_rank,
    gather_ranks,
    live_prefix,
    node_rank,
    range_offsets,
)
from repro_torch.core.state import (
    EMPTY,
    KEY_DTYPE,
    MIN_KEY,
    NOT_FOUND,
    VAL_DTYPE,
    FliXState,
)

# max_results handed to the *inner* apply_ops: the cross-shard RANGE phase
# answers the batch's RANGE ops, so the inner dense arrays are never read
_INNER_MR = 8

# the state planes laid out per bucket, which a shard holds a slice of
_BUCKET_FIELDS = ("keys", "vals", "node_count", "node_max", "num_nodes", "mkba", "exps")

class ShardMesh:
    """An explicit tuple of torch devices, one per shard, along one named
    axis.  ``shape[axis]`` is the shard count, as the reference reads a
    ``jax.sharding.Mesh``.  Devices may repeat."""

    def __init__(self, devices, axis: str = "shards"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    def __repr__(self) -> str:
        return f"ShardMesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def make_shard_mesh(n_shards: int, devices=None, *, axis: str = "shards") -> ShardMesh:
    """A mesh of ``n_shards`` shards.  Without ``devices``, one CUDA card a
    shard, the first ``n_shards`` of them; raises when there are fewer,
    rather than doubling shards up on a card or putting them on the host.
    ``devices`` places the shards explicitly, repeats allowed (``["cpu"] *
    n`` in the tests, ``["cuda:0"] * n`` on a one-card machine)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_shards:
            raise ValueError(
                f"need {n_shards} CUDA devices for {n_shards} shards, have {have} "
                "(pass devices=[...] to place the shards explicitly)"
            )
        devices = [torch.device("cuda", i) for i in range(n_shards)]
    devices = list(devices)
    if len(devices) != n_shards:
        raise ValueError(f"{n_shards} shards need {n_shards} devices, got {len(devices)}")
    return ShardMesh(devices, axis)


# ---------------------------------------------------------------------------
# the collectives: plain functions over per-shard lists
# ---------------------------------------------------------------------------


def _on(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device, non_blocking=True)


def all_gather(xs, mesh: ShardMesh) -> list[torch.Tensor]:
    """``jax.lax.all_gather``: every shard receives the shards' ``xs``
    stacked along a new leading axis ([S, ...]).  Shards on one device
    share one stack."""
    memo: dict = {}
    out = []
    for d in mesh.devices:
        if d not in memo:
            memo[d] = torch.stack([_on(x, d) for x in xs])
        out.append(memo[d])
    return out


def all_to_all(xs, mesh: ShardMesh) -> list[torch.Tensor]:
    """``jax.lax.all_to_all`` over the leading axis: ``xs[s]`` is shard
    ``s``'s send buffer [S, ...] whose row ``d`` is for shard ``d``; shard
    ``d`` receives [S, ...] whose row ``s`` came from shard ``s``."""
    return [
        torch.stack([_on(x[d], dev) for x in xs]) for d, dev in enumerate(mesh.devices)
    ]


def psum(xs, device) -> torch.Tensor:
    """``jax.lax.psum``: the shards' ``xs`` summed on ``device``, in int32
    (a torch sum of int32 would widen to int64)."""
    return torch.stack([_on(x, device) for x in xs]).sum(0, dtype=torch.int32)


def pmin(xs, device) -> torch.Tensor:
    """``jax.lax.pmin``: the shards' elementwise minimum on ``device``."""
    return torch.stack([_on(x, device) for x in xs]).amin(0)


# ---------------------------------------------------------------------------
# the sharded index
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedFliX:
    """A range-partitioned index: shard ``s`` is the ``FliXState`` of
    buckets ``[s * nb_s, (s + 1) * nb_s)`` of the union state, on the mesh's
    ``s``-th device, with every shard's ``needs_restructure`` the OR over
    shards (the reference replicates it).  ``lower_fence[s]`` is the fence
    below shard ``s``'s range and ``part_fences[s]`` its upper fence, both
    [S] on the first shard's device."""

    states: tuple
    lower_fence: torch.Tensor
    part_fences: torch.Tensor
    axis: str = "shards"

    @property
    def n_shards(self) -> int:
        return len(self.states)

    @property
    def needs_restructure(self) -> torch.Tensor:
        return self.states[0].needs_restructure

    @property
    def geometry(self) -> tuple[int, int, int]:
        """The union state's (num_buckets, nodes_per_bucket, node_size)."""
        nb, npb, ns = self.states[0].geometry
        return nb * self.n_shards, npb, ns

    @property
    def has_ttl(self) -> bool:
        return self.states[0].exps is not None

    def live_keys(self) -> torch.Tensor:
        dev = self.states[0].device
        return torch.stack([_on(st.live_keys(), dev) for st in self.states]).sum()

    def memory_bytes(self) -> int:
        return sum(st.memory_bytes() for st in self.states)


def plan_shard_budget(total_budget: int | None, n_shards: int) -> int | None:
    """Split a global device-memory budget across shards (DESIGN.md §15):
    buckets are range-partitioned evenly, so each shard's bound is an even
    split.  ``None`` = unbounded."""
    if total_budget is None:
        return None
    return max(1, int(total_budget) // max(1, n_shards))


def shard_memory_bytes(idx: ShardedFliX) -> int:
    """Allocated footprint of a sharded index over the mesh: the shards'
    ``memory_bytes`` summed, plus the two fence vectors."""
    return idx.memory_bytes() + idx.lower_fence.numel() * 4 + idx.part_fences.numel() * 4


def _split_state(state: FliXState, mesh: ShardMesh) -> tuple:
    """Shard ``s`` of ``state``: the rows of its bucket range, copied to its
    device as tensors of their own."""
    nb_s = state.num_buckets // mesh.size
    out = []
    for s, d in enumerate(mesh.devices):
        part = {}
        for f in _BUCKET_FIELDS:
            a = getattr(state, f)
            if a is not None:
                part[f] = a[s * nb_s : (s + 1) * nb_s].to(d, copy=True)
        part["needs_restructure"] = state.needs_restructure.to(d, copy=True)
        out.append(FliXState(**part))
    return tuple(out)


def shard_build(
    sorted_keys: torch.Tensor,
    sorted_vals: torch.Tensor,
    mesh: ShardMesh,
    *,
    node_size: int = 32,
    nodes_per_bucket: int = 16,
    fill: float = 0.5,
    extra_keys: int = 0,
    sorted_exps: torch.Tensor | None = None,
) -> ShardedFliX:
    """Build the union state then range-partition it over ``mesh``.

    The bucket count is ``ceil(ceil(n / p) / S) · S``, so every shard owns
    the same number of buckets; ``extra_keys`` over-provisions it (the
    distributed analogue of ``restructure_grow``'s headroom).  The union is
    built on the keys' device and its slices copied to the shards' devices.
    ``sorted_exps`` (aligned with the keys) carries the expiry plane.
    """
    n_shards = mesh.size
    p = max(1, int(node_size * fill))
    n = int((sorted_keys != EMPTY).sum()) + extra_keys
    nb = max(1, math.ceil(math.ceil(n / p) / n_shards)) * n_shards
    geometry = dict(
        num_buckets=nb, nodes_per_bucket=nodes_per_bucket, node_size=node_size, fill=fill
    )
    state = build_from_sorted(sorted_keys, sorted_vals, **geometry)
    if sorted_exps is not None:
        # the expiry plane of the same build: identical layout, exps in vals
        built_e = build_from_sorted(
            sorted_keys, _on(sorted_exps, sorted_keys.device).to(KEY_DTYPE), **geometry
        )
        state = attach_expiry(state, torch.where(state.keys == EMPTY, NO_EXPIRY, built_e.vals))
        del built_e
    part_fences = state.mkba.reshape(n_shards, -1)[:, -1].clone()
    lower_fence = torch.cat([part_fences.new_full((1,), MIN_KEY), part_fences[:-1]])
    dev0 = mesh.devices[0]
    return ShardedFliX(
        states=_split_state(state, mesh),
        lower_fence=_on(lower_fence, dev0),
        part_fences=_on(part_fences, dev0),
        axis=mesh.axis,
    )


def shard_union(idx: ShardedFliX, device) -> FliXState:
    """The union ``FliXState`` of a sharded index on ``device``: for tests
    and checks only.  No serving or durable path calls it."""
    dev = torch.device(device)
    fields = {}
    for f in _BUCKET_FIELDS:
        if getattr(idx.states[0], f) is not None:
            fields[f] = torch.cat([_on(getattr(st, f), dev) for st in idx.states])
    fields["needs_restructure"] = _on(idx.needs_restructure, dev).clone()
    return FliXState(**fields)


def shard_restructure(
    idx: ShardedFliX, mesh: ShardMesh, *, extra_keys: int = 0, fill: float = 0.5
) -> ShardedFliX:
    """Rebalance the partition fences from the live-key distribution.

    The cluster analogue of the paper's §3.5 relaunch: the host pulls the
    live contents, re-plans a uniform geometry for ``live + extra_keys``
    keys and re-partitions it, so every shard owns an equal bucket count of
    an evenly filled structure.  When one bucket must absorb more than its
    chain holds (``p + extra_keys > cap``), the chain is widened, as
    ``restructure_grow`` does.  Host-driven, like single-device
    ``restructure``; the input index is untouched.
    """
    st0 = idx.states[0]
    flat_k = np.concatenate([st.keys.cpu().numpy().reshape(-1) for st in idx.states])
    flat_v = np.concatenate([st.vals.cpu().numpy().reshape(-1) for st in idx.states])
    order = np.argsort(flat_k, kind="stable")  # EMPTY sentinels sort last
    sorted_e = None
    if st0.exps is not None:
        flat_e = np.concatenate([st.exps.cpu().numpy().reshape(-1) for st in idx.states])
        sorted_e = torch.from_numpy(flat_e[order])
    p = max(1, int(st0.node_size * fill))
    cap = st0.bucket_capacity
    if p + extra_keys > cap:
        npb = math.ceil((p + extra_keys) / st0.node_size)
    else:
        npb = st0.nodes_per_bucket
    dev0 = mesh.devices[0]
    return shard_build(
        torch.from_numpy(flat_k[order]).to(dev0),
        torch.from_numpy(flat_v[order]).to(dev0),
        mesh,
        node_size=st0.node_size,
        nodes_per_bucket=npb,
        fill=fill,
        extra_keys=extra_keys,
        sorted_exps=None if sorted_e is None else sorted_e.to(dev0),
    )


def shard_live_counts(idx: ShardedFliX, mesh: ShardMesh) -> torch.Tensor:
    """Per-shard live-key counts [S] int32 on the first shard's device
    (balance diagnostics)."""
    counts = [st.node_count.sum(dtype=torch.int32).reshape(1) for st in idx.states]
    return all_gather(counts, mesh)[0].reshape(-1)


def replicate_batch(ops: OpBatch, mesh: ShardMesh) -> list[OpBatch]:
    """The whole batch on every shard's device (replicated routing's
    placement; shards on one device share one copy)."""
    memo: dict = {}
    for d in mesh.devices:
        if d not in memo:
            memo[d] = _batch_on(ops.tag, ops.key, ops.val, ops.exp, d)
    return [memo[d] for d in mesh.devices]


def shard_batch(ops: OpBatch, mesh: ShardMesh) -> list[OpBatch]:
    """Position-shard a batch: equal contiguous chunks, chunk ``s`` on shard
    ``s``'s device (a2a routing's placement).  Each chunk must be key-sorted
    (a globally sorted batch split into chunks qualifies); chunks need no
    mutual order."""
    n = ops.size // mesh.size
    out = []
    for s, d in enumerate(mesh.devices):
        rows = slice(s * n, (s + 1) * n)
        exp = None if ops.exp is None else ops.exp[rows]
        out.append(_batch_on(ops.tag[rows], ops.key[rows], ops.val[rows], exp, d))
    return out


def _batch_on(tag, key, val, exp, device) -> OpBatch:
    return OpBatch(
        tag=_on(tag, device),
        key=_on(key, device),
        val=_on(val, device),
        exp=None if exp is None else _on(exp, device),
    )


# ---------------------------------------------------------------------------
# the shard body's pieces
# ---------------------------------------------------------------------------


def _inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype, device=order.device)
    return inv


def _post_update_shard_min(state: FliXState):
    """Smallest present key in this shard (EMPTY if none) and its value."""
    bucket_min = torch.where(state.num_nodes > 0, state.keys[:, 0, 0], EMPTY)
    b = torch.argmin(bucket_min)  # the first minimum, as jnp.argmin
    m = bucket_min[b]
    v = torch.where(m != EMPTY, state.vals[b, 0, 0], NOT_FOUND)
    return m, v


def _predict_post_keys(state: FliXState, ins_keys: torch.Tensor, del_keys: torch.Tensor):
    """Post-update per-bucket key rows and rank fences, *before* the apply.

    A shard's post-update bucket multiset is (surviving stripe keys minus
    upsert duplicates) ∪ (its masked insert keys, at most ``cap`` a
    bucket) — exact because one batch never inserts and deletes one key,
    and EXPIRE keys count as inserts (get-or-set leaves the key present).
    Not valid under an expiry pass at ``now``: the caller falls back to the
    updated state then.

    ``ins_keys`` / ``del_keys`` are the shard's masked update keys, sorted,
    EMPTY-padded.  Returns ``(post_rows [nb, S+cap], pref [nb+1])``.  The
    reference sorts each row; :func:`flat_rank`, their one reader, counts
    the keys below a bound, so the port leaves the rows unsorted.
    """
    nb = state.num_buckets
    cap = state.bucket_capacity
    flat_k = state.keys.reshape(nb, cap)
    mflat = flat_k.reshape(-1)
    nk = max(del_keys.shape[0] - 1, 0)
    dpos = torch.clamp(torch.searchsorted(del_keys, mflat, out_int32=True), max=nk)
    dhit = (del_keys[dpos] == mflat) & (mflat != EMPTY)
    masked = torch.where(dhit, EMPTY, mflat)
    del dpos, dhit

    ni = max(ins_keys.shape[0] - 1, 0)
    ipos = torch.clamp(torch.searchsorted(ins_keys, masked, out_int32=True), max=ni)
    upserted = (ins_keys[ipos] == masked) & (masked != EMPTY)
    del ipos
    istarts, iends = bucket_slices(state, ins_keys)
    ik, _, _ = gather_sublists(ins_keys, istarts, iends, cap)
    post_rows = torch.cat([torch.where(upserted, EMPTY, masked).reshape(nb, cap), ik], dim=1)
    del masked, upserted, ik
    live = (post_rows != EMPTY).sum(dim=1, dtype=torch.int32)
    pref = torch.cat([live.new_zeros((1,)), torch.cumsum(live, 0, dtype=torch.int32)])
    return post_rows, pref


def _local_counts(state: FliXState, ins_keys, del_keys, is_range, lo, hi, predicted: bool):
    """This shard's half of the RANGE counts phase: the rank of each op's
    ``lo`` among the shard's post-update keys, and its in-range count (0
    for non-RANGE ops).  ``predicted`` takes them from
    :func:`_predict_post_keys` of the pre-update ``state`` (whose
    transients are freed here), else from the updated ``state`` itself
    (I1–I4 hold there, so ``node_rank`` needs no per-bucket sort)."""
    if predicted:
        post_rows, pref = _predict_post_keys(state, ins_keys, del_keys)
        rank_lo = flat_rank(post_rows, pref, state.mkba, lo)
        rank_hi = flat_rank(post_rows, pref, state.mkba, hi)
        del post_rows
    else:
        pref = live_prefix(state.node_count)
        meta = (state.keys, state.node_count, state.node_max, state.mkba, pref)
        rank_lo = node_rank(*meta, lo)
        rank_hi = node_rank(*meta, hi)
    full = torch.where(is_range, torch.clamp(rank_hi - rank_lo, min=0), 0).to(torch.int32)
    return rank_lo, full


def _range_windows(counts_all: torch.Tensor, is_range: torch.Tensor, max_results: int):
    """The replicated half of the counts phase, from the gathered local
    counts [S, N]: the global budget split over the ops (``range_offsets``
    on the summed counts), each output slot's owning op and in-op offset,
    and every shard's exclusive prefix inside each op's segment."""
    n = counts_all.shape[1]
    global_full = counts_all.sum(0, dtype=torch.int32)
    prefix_lt = (torch.cumsum(counts_all, 0, dtype=torch.int32) - counts_all).to(torch.int32)
    start, emit, total_emit, truncated = range_offsets(global_full, is_range, max_results)
    p = torch.arange(max_results, dtype=torch.int32, device=counts_all.device)
    owner = torch.clamp(torch.searchsorted(start, p, right=True, out_int32=True) - 1, 0, n - 1)
    j = p - start[owner]
    valid = p < total_emit
    return dict(
        prefix_lt=prefix_lt, start=start, emit=emit, truncated=truncated,
        owner=owner, j=j, valid=valid,
    )


def _range_contrib(new_state: FliXState, win: dict, me: int, rank_lo, full):
    """Shard ``me``'s additive share of the dense RANGE arrays: slot ``p``
    is this shard's when its in-op offset falls inside the shard's window
    ``[prefix_lt, prefix_lt + full)`` of its op; it then holds the key of
    local rank ``rank_lo + (offset - prefix_lt)`` in the updated state.
    Exactly one shard owns each emitted slot, so a sum recombines."""
    owner = win["owner"]
    pre = win["prefix_lt"][me][owner]
    j = win["j"]
    mine = win["valid"] & (j >= pre) & (j < pre + full[owner])
    g = torch.where(mine, rank_lo[owner] + (j - pre), -1)
    pref = live_prefix(new_state.node_count)
    rk, rv = gather_ranks(g, pref, new_state.node_count, new_state.keys, new_state.vals)
    return torch.where(mine, rk, 0), torch.where(mine, rv, 0)


def _empty_range_outputs(n: int, max_results: int, device):
    return (
        torch.full((max_results,), EMPTY, dtype=KEY_DTYPE, device=device),
        torch.full((max_results,), NOT_FOUND, dtype=VAL_DTYPE, device=device),
        torch.zeros((n,), dtype=torch.int32, device=device),
        torch.zeros((n,), dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def _set_restructure(states, flag: torch.Tensor) -> tuple:
    """Every shard's ``needs_restructure`` set to the global OR."""
    return tuple(
        dataclasses.replace(st, needs_restructure=_on(flag, st.device)) for st in states
    )


def _apply_shard(state, tag, key, val, exp, inner_cfg, now):
    return apply_ops(
        state,
        OpBatch(tag=tag, key=key, val=val, exp=exp),
        config=inner_cfg,
        has_ranges=False,  # the cross-shard phase answers RANGE
        now=now,
    )


def _replicated(idx, mesh, ops, exp, now, inner_cfg, max_results, has_ranges, has_ttl):
    """The replicated-routing shard body, phase by phase over the shards."""
    out = ops.key.device
    tag, key, val = ops.tag, ops.key, ops.val
    n = key.shape[0]
    predicted = has_ranges and now is None
    with trace.span("shard.route"):
        placed = replicate_batch(OpBatch(tag, key, val, exp), mesh)

    new_states, cands, values, locals_, contrib = [], [], [], [], []
    for s, (state, b) in enumerate(zip(idx.states, placed)):
        d = state.device
        with trace.span("shard.route"):
            lf = _on(idx.lower_fence, d)[s]
            is_upd = _update_mask(b.tag)
            is_rng = b.tag == OP_RANGE
            # updates run on their owner shard only; POINT and SUCCESSOR run
            # everywhere; RANGE is lifted out for the cross-shard phase
            keep = (~is_upd | ((b.key > lf) & (b.key <= state.mkba[-1]))) & ~is_rng
            mtag = torch.where(keep, b.tag, OP_NOP)
            mkey = torch.where(keep, b.key, EMPTY)
            mval = torch.where(keep, b.val, 0)
            order = torch.argsort(mkey, stable=True)
            inv = _inverse_permutation(order)
            stag, skey = mtag[order], mkey[order]
            sexp = None if b.exp is None else torch.where(keep, b.exp, NO_EXPIRY)[order]
        if predicted:
            with trace.span("shard.range"):
                ins_keys = _compact_by_mask(skey, (stag == OP_INSERT) | (stag == OP_EXPIRE))
                del_keys = _compact_by_mask(skey, stag == OP_DELETE)
                locals_.append(
                    _local_counts(state, ins_keys, del_keys, is_rng, b.key, b.val, True)
                )
                del ins_keys, del_keys
        with trace.span("shard.apply"):
            new, res, st = _apply_shard(state, stag, skey, mval[order], sexp, inner_cfg, now)
        if has_ranges and not predicted:
            with trace.span("shard.range"):
                locals_.append(_local_counts(new, None, None, is_rng, b.key, b.val, False))
        with trace.span("shard.combine"):
            value, succ = res["value"][inv], res["succ_key"][inv]
            cands.append(torch.where(b.tag == OP_SUCCESSOR, succ, EMPTY))
            values.append(value)
            new_states.append(new)
            c = {
                "inserted": st["inserted"],
                "deleted": st["deleted"],
                "overflowed_buckets": st["overflowed_buckets"],
                "restructure": new.needs_restructure.to(torch.int32),
            }
            if has_ttl:
                c["expired"] = st["expired"]
            contrib.append(c)

    # SUCCESSOR: shard-local candidates, global minimum; shard key ranges
    # are disjoint, so exactly one shard attains it
    with trace.span("shard.combine"):
        kmin = pmin(cands, out)
        is_point = (tag == OP_POINT) | (tag == OP_EXPIRE)
        is_succ = tag == OP_SUCCESSOR
        for s, (c, value, cand) in enumerate(zip(contrib, values, cands)):
            d = value.device
            hit = _on(is_point, d) & (value != NOT_FOUND)
            winner = (cand == _on(kmin, d)) & (cand != EMPTY)
            c["pv"] = torch.where(hit, value, 0)
            c["n_hit"] = hit.to(torch.int32)
            c["sv"] = torch.where(winner, value, 0)

    if has_ranges:
        with trace.span("shard.range"):
            is_rng = tag == OP_RANGE
            counts_all = all_gather([f for _, f in locals_], mesh)
            win = _range_windows(_on(counts_all[0], out), is_rng, max_results)
            for s, (new, (rank_lo, full)) in enumerate(zip(new_states, locals_)):
                d = new.device
                wd = {k: _on(v, d) for k, v in win.items()}
                c = contrib[s]
                c["rk"], c["rv"] = _range_contrib(new, wd, s, rank_lo, full)
            del locals_

    with trace.span("shard.combine"):
        summed = {k: psum([c[k] for c in contrib], out) for k in contrib[0]}
        point_val = torch.where(summed["n_hit"] > 0, summed["pv"], NOT_FOUND)
        succ_val = torch.where(kmin != EMPTY, summed["sv"], NOT_FOUND)
        if has_ranges:
            rk = torch.where(win["valid"], summed["rk"], EMPTY)
            rv = torch.where(win["valid"], summed["rv"], NOT_FOUND)
            rstart = torch.where(is_rng, win["start"], 0)
            rcnt = torch.where(is_rng, win["emit"], 0)
            rtrunc = win["truncated"]
        else:
            rk, rv, rstart, rcnt, rtrunc = _empty_range_outputs(n, max_results, out)
        results = {
            "value": torch.where(is_point, point_val, torch.where(is_succ, succ_val, NOT_FOUND)),
            "succ_key": torch.where(is_succ, kmin, EMPTY),
            "range_key": rk,
            "range_val": rv,
            "range_start": rstart,
            "range_count": rcnt,
        }
        stats = {
            "inserted": summed["inserted"],
            "deleted": summed["deleted"],
            "overflowed_buckets": summed["overflowed_buckets"],
            "range_truncated": rtrunc,
            "a2a_overflow": torch.zeros((), dtype=torch.int32, device=out),
        }
        if has_ttl:
            stats["expired"] = summed["expired"]
        states = _set_restructure(new_states, summed["restructure"] > 0)
        return states, results, stats


def _a2a(idx, mesh, ops, exp, now, inner_cfg, max_results, has_ranges, has_ttl, capacity):
    """The a2a-routing shard body, phase by phase over the shards."""
    S = mesh.size
    out = ops.key.device
    n_local = ops.size // S
    predicted = has_ranges and now is None
    with trace.span("shard.route"):
        chunks = shard_batch(OpBatch(ops.tag, ops.key, ops.val, exp), mesh)

        if has_ranges:
            # every shard's RANGE rows, gathered up front (the global batch),
            # sorted by lo: the cross-shard phase answers them
            g_tag = ops.tag
            g_isr = g_tag == OP_RANGE
            gorder = torch.argsort(torch.where(g_isr, ops.key, EMPTY), stable=True)
            isr_s, q_lo, q_hi = g_isr[gorder], ops.key[gorder], ops.val[gorder]

        # routing: one partition-fence searchsorted per source shard, padded
        # send buffers of ``capacity`` rows per destination, overflow counted
        routes, sends, overflows = [], [], []
        lane = None
        for s, b in enumerate(chunks):
            d = b.key.device
            # RANGE rows never ride the a2a; masking them to the EMPTY tail
            # keeps the local sort a valid routing order
            rkey = torch.where(b.tag == OP_RANGE, EMPTY, b.key)
            order = torch.argsort(rkey, stable=True)
            inv = _inverse_permutation(order)
            s_tag, s_key, s_val = b.tag[order], rkey[order], b.val[order]
            pf = _on(idx.part_fences, d)
            ends = torch.searchsorted(s_key, pf, right=True, out_int32=True)
            starts = torch.cat([ends.new_zeros((1,)), ends[:-1]])
            overflows.append(torch.clamp(ends - starts - capacity, min=0).sum(dtype=torch.int32))
            if lane is None or lane.device != d:
                lane = torch.arange(capacity, dtype=torch.int32, device=d)
            idx_ = starts[:, None] + lane[None, :]
            valid = idx_ < ends[:, None]
            idx_c = torch.clamp(idx_, max=n_local - 1)
            send = [
                torch.where(valid, s_tag[idx_c], OP_NOP),
                torch.where(valid, s_key[idx_c], EMPTY),
                torch.where(valid, s_val[idx_c], 0),
            ]
            if b.exp is not None:
                # the deadline rides as a fourth lane; EXPIRE rows route to
                # their owner by key like every other update
                send.append(torch.where(valid, b.exp[order][idx_c], NO_EXPIRY))
            sends.append(send)
            routes.append((inv, torch.where(valid, idx_c, n_local).reshape(-1)))
            del s_tag, s_key, s_val, idx_, idx_c, valid, order
        lanes = [all_to_all([snd[k] for snd in sends], mesh) for k in range(len(sends[0]))]
        del sends

    new_states, shard_out, locals_, contrib, mins, mvals = [], [], [], [], [], []
    for dst, state in enumerate(idx.states):
        with trace.span("shard.route"):
            recv = [lane_[dst].reshape(-1) for lane_ in lanes]
            recv_t, recv_k, recv_v = recv[:3]
            recv_e = recv[3] if len(recv) > 3 else None
            rord = torch.argsort(recv_k, stable=True)
            rinv = _inverse_permutation(rord)
            r_tag, r_key = recv_t[rord], recv_k[rord]
            if has_ranges:
                d = state.device
                rng = (_on(isr_s, d), _on(q_lo, d), _on(q_hi, d))
        if predicted:
            with trace.span("shard.range"):
                # the received rows ARE this shard's update batch, so the
                # prediction sees exactly what the apply will do
                ins_keys = _compact_by_mask(r_key, (r_tag == OP_INSERT) | (r_tag == OP_EXPIRE))
                del_keys = _compact_by_mask(r_key, r_tag == OP_DELETE)
                locals_.append(_local_counts(state, ins_keys, del_keys, *rng, True))
                del ins_keys, del_keys
        with trace.span("shard.apply"):
            new, res, st = _apply_shard(
                state, r_tag, r_key, recv_v[rord], None if recv_e is None else recv_e[rord],
                inner_cfg, now,
            )
        if has_ranges and not predicted:
            with trace.span("shard.range"):
                locals_.append(_local_counts(new, None, None, *rng, False))
        with trace.span("shard.combine"):
            m, mv = _post_update_shard_min(new)
            mins.append(m.reshape(1))
            mvals.append(mv.reshape(1))
            shard_out.append((recv_t, res["value"][rinv], res["succ_key"][rinv]))
            new_states.append(new)
            c = {
                "inserted": st["inserted"],
                "deleted": st["deleted"],
                "overflowed_buckets": st["overflowed_buckets"],
                "a2a_overflow": overflows[dst],
                "restructure": new.needs_restructure.to(torch.int32),
            }
            if has_ttl:
                c["expired"] = st["expired"]
            contrib.append(c)
        del recv, rord, rinv, r_tag, r_key
    del lanes

    with trace.span("shard.combine"):
        # SUCCESSOR fallback across shards: an owner whose updated state holds
        # no key ≥ q answers with the first non-empty *later* shard's minimum —
        # the fence-row trick one level up
        all_mins = all_gather(mins, mesh)
        all_mvals = all_gather(mvals, mesh)
        backs_v, backs_k = [], []
        for me, (recv_t, value_r, skey_r) in enumerate(shard_out):
            sufk, sufi = _suffix_min_with_index(all_mins[me].reshape(-1))
            fb_key = sufk[me + 1] if me + 1 < S else torch.full_like(sufk[0], EMPTY)
            fb_idx = sufi[me + 1] if me + 1 < S else torch.zeros_like(sufi[0])
            fb_val = torch.where(fb_key != EMPTY, all_mvals[me].reshape(-1)[fb_idx], NOT_FOUND)
            needs_fb = (recv_t == OP_SUCCESSOR) & (skey_r == EMPTY)
            backs_k.append(torch.where(needs_fb, fb_key, skey_r).reshape(S, capacity))
            backs_v.append(torch.where(needs_fb, fb_val, value_r).reshape(S, capacity))
        del shard_out

        # the inverse a2a: owner d's row s carries the answers for the rows
        # source s sent to d, in their original slots; every unused row lands
        # on the dump slot n_local, the one index that repeats, cut off
        back_v = all_to_all(backs_v, mesh)
        back_k = all_to_all(backs_k, mesh)
        out_v, out_k = [], []
        for s, (inv, dest) in enumerate(routes):
            d = inv.device
            v = torch.full((n_local + 1,), NOT_FOUND, dtype=VAL_DTYPE, device=d)
            k = torch.full((n_local + 1,), EMPTY, dtype=KEY_DTYPE, device=d)
            v.scatter_(0, dest.long(), back_v[s].reshape(-1))
            k.scatter_(0, dest.long(), back_k[s].reshape(-1))
            out_v.append(_on(v[:n_local][inv], out))
            out_k.append(_on(k[:n_local][inv], out))

    if has_ranges:
        with trace.span("shard.range"):
            counts_all = all_gather([f for _, f in locals_], mesh)
            win = _range_windows(_on(counts_all[0], out), isr_s, max_results)
            for me, (new, (rank_lo, full)) in enumerate(zip(new_states, locals_)):
                d = new.device
                wd = {k: _on(v, d) for k, v in win.items()}
                contrib[me]["rk"], contrib[me]["rv"] = _range_contrib(new, wd, me, rank_lo, full)
            del locals_

    with trace.span("shard.combine"):
        summed = {k: psum([c[k] for c in contrib], out) for k in contrib[0]}
        n = ops.size
        if has_ranges:
            rk = torch.where(win["valid"], summed["rk"], EMPTY)
            rv = torch.where(win["valid"], summed["rv"], NOT_FOUND)
            # the per-op offsets back to their input rows (sorted-by-lo order
            # → batch order); non-RANGE rows go to the dump slot n
            back = torch.where(isr_s, gorder, n)
            zeros = torch.zeros((n + 1,), dtype=torch.int32, device=out)
            rstart = zeros.clone().scatter_(0, back, torch.where(isr_s, win["start"], 0))[:n]
            rcnt = zeros.scatter_(0, back, torch.where(isr_s, win["emit"], 0))[:n]
            rtrunc = win["truncated"]
        else:
            rk, rv, rstart, rcnt, rtrunc = _empty_range_outputs(n, max_results, out)
        results = {
            "value": torch.cat(out_v),
            "succ_key": torch.cat(out_k),
            "range_key": rk,
            "range_val": rv,
            "range_start": rstart,
            "range_count": rcnt,
        }
        stats = {
            "inserted": summed["inserted"],
            "deleted": summed["deleted"],
            "overflowed_buckets": summed["overflowed_buckets"],
            "range_truncated": rtrunc,
            "a2a_overflow": summed["a2a_overflow"],
        }
        if has_ttl:
            stats["expired"] = summed["expired"]
        states = _set_restructure(new_states, summed["restructure"] > 0)
        return states, results, stats


# a2a capacity headroom over the uniform per-destination share: uniform
# random batches land within ~1.5x of the even share, so 2x absorbs the
# skew while sending ~2/S of the never-overflowing chunk capacity (the
# doubling retry of shard_apply_ops_safe absorbs the pathological remainder)
A2A_CAPACITY_HEADROOM = 2.0


def default_a2a_capacity(
    chunk: int, n_shards: int, *, headroom: float = A2A_CAPACITY_HEADROOM
) -> int:
    """Per-(source, destination) a2a capacity for a per-shard chunk of
    ``chunk`` rows: the uniform share ``ceil(chunk / n_shards)`` times the
    headroom, clamped to ``chunk`` (which can never overflow)."""
    chunk = max(1, int(chunk))
    if n_shards <= 1:
        return chunk
    share = math.ceil(chunk / n_shards)
    return max(1, min(chunk, math.ceil(share * headroom)))


def _inner_config(cfg: ExecConfig, impl: str) -> ExecConfig:
    """The ExecConfig of each shard's inner ``apply_ops``: the resolved
    impl, the kernel knobs threaded through, and the tiny ``_INNER_MR``
    range budget (the inner dense arrays are never read)."""
    return ExecConfig(
        impl=impl,
        pipeline=cfg.pipeline,
        block_q=cfg.block_q,
        block_b=cfg.block_b,
        tile_table=cfg.tile_table,
        max_results=_INNER_MR,
    )


def shard_apply_ops(
    idx: ShardedFliX,
    ops: OpBatch,
    mesh: ShardMesh,
    *,
    config: ExecConfig | None = None,
    has_updates: bool | None = None,
    has_ranges: bool | None = None,
    now=None,
):
    """Execute one mixed sorted batch across the mesh.  Returns ``(idx',
    results, stats)`` with the single-device ``apply_ops`` contract
    (DESIGN.md §11): results, stats and the dense RANGE arrays equal to
    ``apply_ops`` on the union state, with global offsets and the one
    global ``config.max_results``.

    ``ops`` is one global sorted batch, on any device; results come back
    on its device.  Under ``config.routing="a2a"`` it is position-sharded
    into equal chunks (its size must be a multiple of the shard count), and
    ``value`` / ``succ_key`` / ``range_start`` / ``range_count`` are each
    chunk's answers in its rows: with a globally sorted batch, the batch
    order.  ``config.capacity`` bounds the rows a (source, destination)
    pair carries (default, and at most: the chunk size, which never
    overflows); rows past it are dropped and counted in
    ``stats["a2a_overflow"]``.

    ``config.impl="auto"`` resolves once per batch, as ``apply_ops`` does:
    fused on CUDA when the batch has updates, reference otherwise.
    ``has_updates`` / ``has_ranges`` answer those checks without a sync.
    An expiry column on the index or the batch promotes every shard to TTL.
    On bucket overflow the returned index carries ``needs_restructure``:
    hosts use :func:`shard_apply_ops_safe`.  The input index is never
    written, so a batch can be replayed on it.
    """
    cfg = config if config is not None else ExecConfig()
    impl = cfg.impl
    if impl == "auto":
        if idx.states[0].device.type != "cuda":
            impl = "reference"
        else:
            if has_updates is None:
                has_updates = bool(_update_mask(ops.tag).any())
            impl = "fused" if has_updates else "reference"
    if has_ranges is None:
        has_ranges = bool((ops.tag == OP_RANGE).any())
    inner_cfg = _inner_config(cfg, impl)

    # TTL is structural, as in single-device apply_ops: a batch-side
    # expiry column promotes every shard (an all-NO_EXPIRY plane)
    has_ttl = idx.has_ttl or ops.exp is not None
    if has_ttl and not idx.has_ttl:
        idx = dataclasses.replace(idx, states=tuple(attach_expiry(st) for st in idx.states))
    exp = None
    if has_ttl:
        exp = ops.exp if ops.exp is not None else torch.full_like(ops.key, NO_EXPIRY)
    now = None if not has_ttl or now is None else int(now)

    if cfg.routing == "replicated":
        states, results, stats = _replicated(
            idx, mesh, ops, exp, now, inner_cfg, cfg.max_results, has_ranges, has_ttl
        )
    else:
        if ops.size % mesh.size:
            raise ValueError(
                f"a2a batch size {ops.size} not divisible by {mesh.size} shards"
            )
        chunk = ops.size // mesh.size
        # a pair never carries more than a chunk: a larger capacity is the
        # chunk, which cannot overflow
        capacity = chunk if cfg.capacity is None else min(int(cfg.capacity), chunk)
        states, results, stats = _a2a(
            idx, mesh, ops, exp, now, inner_cfg, cfg.max_results, has_ranges, has_ttl,
            max(1, capacity),
        )
    return dataclasses.replace(idx, states=states), results, stats


def shard_apply_ops_safe(
    idx: ShardedFliX,
    ops: OpBatch,
    mesh: ShardMesh,
    *,
    config: ExecConfig | None = None,
    has_updates: bool | None = None,
    has_ranges: bool | None = None,
    now=None,
):
    """Host-level loop: apply, restructure-and-retry on bucket overflow.

    ``apply_ops_safe`` one level up: the retry replays the whole batch on a
    ``shard_restructure``-grown pre-batch index.  Under ``"a2a"``, per-pair
    overflow is retried too, doubling the capacity each round up to the
    chunk size (which never overflows); an unset capacity starts at
    :func:`default_a2a_capacity`.  Both replays are safe because
    :func:`shard_apply_ops` never writes its input.

    The returned ``stats`` adds host ints: ``restructure_retries`` (bucket
    overflow replays), ``a2a_retries`` (capacity replays) and
    ``a2a_overflow_dropped`` (rows the retried attempts dropped; the final
    attempt's own ``a2a_overflow`` is 0 on success).
    """
    cfg = config if config is not None else ExecConfig()
    n_shards = mesh.size
    chunk = ops.size // n_shards
    cap = cfg.capacity
    if cfg.routing == "a2a" and cap is None:
        cap = default_a2a_capacity(chunk, n_shards)
    run_cfg = cfg.replace(donate=False, capacity=cap)
    a2a_retries = 0
    a2a_dropped = 0
    while True:
        new_idx, results, stats = shard_apply_ops(
            idx, ops, mesh, config=run_cfg, has_updates=has_updates,
            has_ranges=has_ranges, now=now,
        )
        if cfg.routing != "a2a":
            break
        overflow = int(stats["a2a_overflow"])
        if overflow == 0 or run_cfg.capacity >= chunk:
            break
        a2a_retries += 1
        a2a_dropped += overflow
        run_cfg = run_cfg.replace(capacity=min(chunk, run_cfg.capacity * 2))
    overflowed = bool(new_idx.needs_restructure) and not bool(idx.needs_restructure)
    if overflowed:
        n_ins = int(((ops.tag == OP_INSERT) | (ops.tag == OP_EXPIRE)).sum())
        grown = shard_restructure(idx, mesh, extra_keys=max(n_ins, 1))
        new_idx, results, stats = shard_apply_ops(
            grown, ops, mesh, config=run_cfg, has_updates=has_updates,
            has_ranges=has_ranges, now=now,
        )
        if bool(new_idx.needs_restructure):
            raise RuntimeError("batch overflowed the geometry shard_restructure planned")
    stats = dict(stats)
    stats["restructure_retries"] = int(overflowed)
    stats["a2a_retries"] = a2a_retries
    stats["a2a_overflow_dropped"] = a2a_dropped
    return new_idx, results, stats
