"""Fused compute-to-bucket apply (port of ``repro/kernels/flix_apply.py``).

One worker does all of a bucket's work in one visit (the paper's flipped
indexing, §4.1): it pulls its slices of the sorted batch,
upsert-merges the inserts with original-node-region re-chunking, deletes
with in-node and chain compaction, writes the new stripe and its metadata,
and answers the bucket's POINT ops and in-bucket SUCCESSOR candidates
against the post-update stripe in shared memory.  Two stripe kernels
compute that one function, by independent designs, so that each is the
other's witness on the card:

  * ``csrc/flix_apply.cu`` (``pipeline="off"``): a thread block per bucket
    at a time, running the block phases of ``csrc/flix_phases.cuh``.  Its
    persistent blocks walk many buckets; a producer warp per block counts a
    bucket's active rows from ``node_max`` and has the bulk-copy engine copy
    just those rows, and the bucket's short slices, into a ring of stages;
  * ``csrc/flix_apply_staged.cu`` (``pipeline="on"``, the counterpart of
    the TPU's double-buffered ``_apply_kernel_pipelined``): one warp per
    bucket, the paper's mapping.  Each warp of persistent blocks walks many
    buckets, and while one bucket is merged, ``cp.async`` copies the warp's
    next bucket's rows that hold keys (``num_nodes`` of them) into the other
    slot of its ring; a bucket with no insert and no delete writes its rows
    straight back.

Both write a new state.  The staged kernel's donated pass
(:func:`flix_apply_inplace_pass`, ``ExecConfig.donate``) writes the result
into the input's planes instead, and only where the batch updates: a plan
kernel lists the buckets with inserts or deletes and finds any overflow,
and where there is none the staged walk over that list writes them back (an
upsert of a held key only its value), then a thread an op answers the reads
from the result; an overflow, or a state already flagged for restructuring,
leaves the input whole.

A batch without updates takes none of that on the card
(:func:`flix_apply_read`): the read-only pass (:func:`flix_apply_read_pass`)
answers every op, a thread an op, from the input state, which nothing
writes; only a batch with SUCCESSOR or RANGE ops runs the O(nb) fence rows
or the RANGE plumbing below.

Two more launches serve the RANGE ops: the count kernel of
``csrc/flix_range.cu`` ranks them under the batch's RANGE mask
(``flix_apply_rank``), and its gather fills the dense RANGE output, a thread
per slot (``flix_apply_range``; both shared with ``kernels/flix_range``).

Host side (:func:`flix_apply`, the port of ``_fused_apply``): the single
routing (``core.ops.route``), then the stripe pass, then two small steps
that the TPU wrapper predicted *before* its one launch and that run here
*between* the two launches, from the exact post-update state:

  * the successor fence rows of the new state (O(nb): the fence-row
    kernel of ``csrc/flix_fence_rows.cu``, ``flix_successor.fence_rows``)
    resolve SUCCESSOR ops past their bucket's largest key;
  * the RANGE rank plumbing (:func:`range_slots`: the post-update
    live-count prefix ``pref``, and each RANGE op's ``[lo, hi)`` rank and
    count by the count kernel under the RANGE mask, where the reference
    ranks in jnp beside its kernel) feeds the shared
    ``range_offsets``/``range_slot_ranks`` formulas.

That replaces the reference's O(state) delete-membership pass and its
per-bucket sort of (survivors ∪ insert slice), and needs no [nb, cap]
insert or delete tiles: a block reads its slices straight from the
compacted batch, so no present-key filter is needed to bound them either.

Every launch wrapper checks its tensors, runs the kernel's plain torch
version when they lie on the CPU (that is how the CPU tests run), launches
the kernel on the current stream when they lie on the card, checks the
launch's error code, and counts the launch in :data:`LAUNCHES`
(``kernels/_launch.py``).  The plain stripe pass is built from the phases of
``kernels/_phases.py``, which ``flix_insert`` and ``flix_delete`` share.
"""

from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.core.batch import gather_kv_sublists
from repro_torch.core.config import DEFAULT_MAX_RESULTS
from repro_torch.core.ops import OP_POINT, OP_RANGE, OP_SUCCESSOR, route
from repro_torch.core.query import (
    _bucket_index,
    live_prefix,
    range_offsets,
    range_slot_ranks,
)
from repro_torch.core.state import EMPTY, NOT_FOUND, FliXState, bucket_chunks
from repro_torch.kernels._build import load_library
from repro_torch.kernels._launch import _require_cuda, check, check_smem, launch
from repro_torch.kernels._phases import compact_chunk, merge_chunk, slice_hits
from repro_torch.kernels.flix_query import query_chunks
from repro_torch.kernels.flix_range import flix_range_count, range_gather
from repro_torch.kernels.flix_successor import fence_rows

# the most warps a block of the staged kernel may be given (csrc/flix_warp.cuh's
# kMaxWalkWarps, the kernel's launch bounds)
STAGED_MAX_WARPS = 8

# the stripe pass's inputs, in the order of the C entry point
_PASS_INPUTS = (
    "keys",
    "vals",
    "node_max",
    "ins_keys",
    "ins_vals",
    "ins_starts",
    "ins_ends",
    "del_keys",
    "del_starts",
    "del_ends",
    "tag",
    "key",
    "op_starts",
    "op_ends",
)


# ---------------------------------------------------------------------------
# launch 1: the stripe pass
# ---------------------------------------------------------------------------


def stripe_inputs(state: FliXState, tag, key, val):
    """Route a sorted batch and return ``(args, routing)``: the inputs of
    :func:`flix_apply_pass` in order, and the routing they came from."""
    r = route(state, tag, key, val)
    args = (
        state.keys,
        state.vals,
        state.node_max,
        r.ins_keys,
        r.ins_vals,
        r.ins_starts,
        r.ins_ends,
        r.del_keys,
        r.del_starts,
        r.del_ends,
        tag,
        key,
        r.starts,
        r.ends,
    )
    return args, r


def flix_apply_pass(
    keys,
    vals,
    node_max,
    ins_keys,
    ins_vals,
    ins_starts,
    ins_ends,
    del_keys,
    del_starts,
    del_ends,
    tag,
    key,
    op_starts,
    op_ends,
):
    """Merge + delete + reads for every bucket; the CUDA kernel on the card,
    :func:`flix_apply_reference` on the CPU.

    ``keys``/``vals`` [nb, npb, ns] and ``node_max`` [nb, npb] are the
    pre-batch state; ``ins_*``/``del_*`` the compacted sorted insert and
    delete keys with their per-bucket ``[start, end)`` slices; ``tag``/
    ``key`` the sorted batch with the per-bucket op slices.  Returns
    ``(keys, vals, node_count, node_max, num_nodes, overflow, deleted,
    value, succ_key)``; SUCCESSOR ops with no in-bucket successor come back
    as (NOT_FOUND, EMPTY).
    """
    args = (
        keys,
        vals,
        node_max,
        ins_keys,
        ins_vals,
        ins_starts,
        ins_ends,
        del_keys,
        del_starts,
        del_ends,
        tag,
        key,
        op_starts,
        op_ends,
    )
    return _stripe_pass(args)


def flix_apply_grid(npb: int, ns: int, device) -> int:
    """The blocks the single-buffer kernel's persistent grid holds at once
    for a ``(npb, ns)`` geometry on ``device`` (a CUDA card); a launch over
    fewer buckets takes a block per bucket."""
    _require_cuda("flix_apply", torch.device(device))
    with torch.cuda.device(device):
        blocks = load_library().flix_apply_grid(npb, ns)
    if blocks < 0:
        raise RuntimeError(f"flix_apply_grid failed with CUDA error {-blocks}")
    return blocks


def staged_blocks_per_sm(npb: int, ns: int, block_b: int, device) -> int:
    """The staged kernel's blocks of ``block_b`` warps (0: its default count)
    that one SM of ``device`` (a CUDA card) holds at once for a ``(npb, ns)``
    geometry, as the occupancy API answers for its launch."""
    _require_cuda("flix_apply_staged", torch.device(device))
    with torch.cuda.device(device):
        blocks = load_library().flix_apply_staged_blocks_per_sm(npb, ns, block_b)
    if blocks < 0:
        raise RuntimeError(f"flix_apply_staged_blocks_per_sm failed with CUDA error {-blocks}")
    return blocks


def flix_apply_staged_pass(num_nodes, *args, block_b: int = 0):
    """The stripe pass by the staged kernel (``csrc/flix_apply_staged.cu``):
    the same function as :func:`flix_apply_pass` on the same ``args``, with
    the state's ``num_nodes`` [nb] telling it which rows hold keys (I3/I4
    pack the active nodes first), so that only those rows are read.  Its
    plain version is :func:`flix_apply_reference`, which runs on the CPU.

    ``block_b`` is the warps of one block of the launch, 1 to
    :data:`STAGED_MAX_WARPS` (0: the kernel's own count, as many as 4 that
    fit): the TPU kernel's bucket stripes a grid step.  A count whose block
    does not fit the card's shared memory raises ``ValueError``.  The plain
    version does not read it."""
    nb = args[0].shape[0]
    check(args[0].device, ("num_nodes",), (num_nodes,))
    if num_nodes.shape != (nb,):
        raise ValueError(f"num_nodes must have shape ({nb},)")
    if not 0 <= block_b <= STAGED_MAX_WARPS:
        raise ValueError(
            f"flix_apply_staged: block_b={block_b} warps a block; the kernel takes "
            f"0 (its own count) to {STAGED_MAX_WARPS}"
        )
    return _stripe_pass(args, num_nodes=num_nodes, block_b=block_b)


def flix_apply_inplace_pass(
    num_nodes, node_count, needs_restructure, val, bucket, *args, block_b: int = 0
):
    """The donated stripe pass (``csrc/flix_apply_staged.cu``'s
    ``flix_apply_inplace_launch``): the function of
    :func:`flix_apply_staged_pass` on the same ``args``, its result written
    into the input's ``keys``, ``vals`` (``args[:2]``), ``node_count`` and
    ``node_max`` (``args[2]``), which the caller must not read as the old
    state afterwards.  Only what the batch changes is written: an upsert of
    a key the bucket holds, its value; a bucket with deletes or an insert of
    a key it does not hold, its rows that held or now hold keys and its
    metadata.  ``val`` [ops] is the sorted batch's value column, ``bucket``
    [ops] each op's bucket, clamped into range (``core.query._bucket_index``):
    upserts and reads go a thread an op.

    Writes nothing when any bucket would overflow or ``needs_restructure``
    (the state's one-element bool flag) is set; the stats still count.
    Returns ``(num_nodes, value, succ_key, counts)``: the result's new [nb]
    ``num_nodes`` (the input's copied where no bucket was written), the
    reads as :func:`flix_apply_pass` answers them (unanswered where nothing
    was written), and [5] int32 counts: the inserts (each bucket's slice cut
    at its capacity), the keys deleted, the buckets that overflow, the
    buckets merged (with deletes, or an insert of a key they do not hold;
    where nothing is written, those with deletes), and the buckets with
    inserts whose overflow took the merge's plan to decide
    (``nn + m > npb``).  Its plain version is
    :func:`flix_apply_inplace_reference`, which runs on the CPU."""
    keys, vals, node_max = args[:3]
    nb, npb, ns = keys.shape
    n = args[11].shape[0]
    dev = keys.device
    check(dev, ("num_nodes", "node_count", "val", "bucket"),
          (num_nodes, node_count, val, bucket))
    if num_nodes.shape != (nb,) or node_count.shape != (nb, npb):
        raise ValueError("num_nodes and node_count disagree with the planes' geometry")
    if val.shape != (n,) or bucket.shape != (n,):
        raise ValueError(f"val and bucket must have shape ({n},), an entry an op")
    nr = needs_restructure
    if nr.dtype != torch.bool or nr.numel() != 1 or nr.device != dev:
        raise ValueError(
            f"needs_restructure must be a one-element bool tensor on {dev}"
        )
    if not 0 <= block_b <= STAGED_MAX_WARPS:
        raise ValueError(
            f"flix_apply_staged_inplace: block_b={block_b} warps a block; the "
            f"kernel takes 0 (its own count) to {STAGED_MAX_WARPS}"
        )
    _check_pass(args)
    if dev.type == "cpu":
        return flix_apply_inplace_reference(
            num_nodes, node_count, needs_restructure, val, bucket, *args
        )
    check_smem("flix_apply_staged", "flix_apply_staged_smem_bytes", npb, ns, dev,
               warps=block_b)
    work_cap = min(nb, n)
    outs = tuple(torch.empty((k,), dtype=torch.int32, device=dev) for k in (nb, n, n))
    lists = torch.empty((2, max(work_cap, 1)), dtype=torch.int32, device=dev)
    fresh = torch.empty(((nb + 31) // 32,), dtype=torch.int32, device=dev)
    counts = torch.empty((5,), dtype=torch.int32, device=dev)
    launch("flix_apply_staged_inplace", "flix_apply_inplace_launch", dev, *args,
           num_nodes, node_count, nr, val, bucket, *outs, lists[0], lists[1], fresh,
           counts, nb, npb, ns, n, work_cap, block_b)
    return (*outs, counts)


def flix_apply_inplace_reference(
    num_nodes, node_count, needs_restructure, val, bucket, *args
):
    """Plain torch version of :func:`flix_apply_inplace_pass`, from the
    functional pass's plain version: where no bucket overflows and the state
    needs no restructuring, each bucket whose inserts all upsert held keys,
    with no delete, gets its live values from it, and each other bucket with
    inserts or deletes its rows that held or now hold keys, node counts,
    node max and ``num_nodes``, in place.  ``val`` and ``bucket`` are not
    read: the insert slices carry the values, the op slices the buckets."""
    keys, vals, node_max = args[:3]
    ins_starts, ins_ends, del_starts, del_ends = args[5], args[6], args[8], args[9]
    nb, npb, ns = keys.shape
    S = npb * ns
    n = args[11].shape[0]
    out = flix_apply_reference(*args)
    okeys, ovals, ocnt, omax, onn, oflow, odel, value, succ_key = out
    m = ins_ends - ins_starts
    dn = del_ends - del_starts
    nn = torch.clamp(num_nodes, 0, npb)
    overflowed = ((oflow > 0) | (m > S)).sum(dtype=torch.int32)
    upd = (m > 0) | (dn > 0)
    # no delete, and as many keys after as before: every insert upserted a held key
    live = keys != EMPTY
    held = (dn == 0) & (m > 0) & ((okeys != EMPTY).sum((1, 2)) == live.sum((1, 2)))
    merged = upd & ~held
    counts = torch.stack([
        torch.clamp(m, max=S).sum(dtype=torch.int32),
        odel.sum(dtype=torch.int32),
        overflowed,
        merged.sum(dtype=torch.int32),
        ((m > 0) & (m <= S) & (nn + m > npb)).sum(dtype=torch.int32),
    ])
    new_nn = num_nodes.clone()
    if bool(needs_restructure) or int(overflowed) > 0:
        counts[1] = 0
        # the plan lists the buckets with deletes before the overflow is known
        counts[3] = (dn > 0).sum(dtype=torch.int32)
        miss = torch.full((n,), NOT_FOUND, dtype=torch.int32, device=keys.device)
        return new_nn, miss, torch.full_like(miss, EMPTY), counts
    vals[held] = torch.where(live[held], ovals[held], vals[held])
    reach = torch.maximum(nn, onn)
    rows = merged[:, None] & (torch.arange(npb, device=keys.device) < reach[:, None])
    keys[rows] = okeys[rows]
    vals[rows] = ovals[rows]
    node_count[merged] = ocnt[merged]
    node_max[merged] = omax[merged]
    new_nn[merged] = onn[merged]
    return new_nn, value, succ_key, counts


def _check_pass(args):
    """The stripe pass's inputs: int32, contiguous, on one device, in
    agreeing shapes."""
    keys, vals, node_max, ins_keys, ins_vals = args[:5]
    tag, key = args[10:12]
    nb, npb, _ = keys.shape
    check(keys.device, _PASS_INPUTS, args)
    if vals.shape != keys.shape or node_max.shape != (nb, npb):
        raise ValueError("keys, vals and node_max disagree in geometry")
    bounds = (args[5], args[6], args[8], args[9], args[12], args[13])
    if any(t.shape != (nb,) for t in bounds):
        raise ValueError(f"per-bucket slice bounds must have shape ({nb},)")
    if ins_vals.shape != ins_keys.shape or tag.shape != key.shape:
        raise ValueError("batch columns disagree in length")


def _stripe_pass(args, *, num_nodes=None, block_b: int = 0):
    """Check the stripe pass's inputs, then run the plain version (CPU), the
    single-buffer kernel, or (given ``num_nodes``) the staged kernel in
    blocks of ``block_b`` warps."""
    keys, vals, node_max = args[:3]
    nb, npb, ns = keys.shape
    n = args[11].shape[0]
    dev = keys.device
    _check_pass(args)
    if dev.type == "cpu":
        return flix_apply_reference(*args)

    staged = num_nodes is not None
    kernel = "flix_apply_staged" if staged else "flix_apply"
    check_smem(kernel, f"{kernel}_smem_bytes", npb, ns, dev,
               warps=block_b if staged else None)
    outs = (
        torch.empty_like(keys),
        torch.empty_like(vals),
        torch.empty_like(node_max),
        torch.empty_like(node_max),
        torch.empty((nb,), dtype=torch.int32, device=dev),
        torch.empty((nb,), dtype=torch.int32, device=dev),
        torch.empty((nb,), dtype=torch.int32, device=dev),
        torch.full((n,), NOT_FOUND, dtype=torch.int32, device=dev),
        torch.full((n,), EMPTY, dtype=torch.int32, device=dev),
    )
    extra, warps = ((num_nodes,), (block_b,)) if staged else ((), ())
    launch(kernel, f"{kernel}_launch", dev, *args, *extra, *outs, nb, npb, ns, *warps)
    return outs


def _stripe_chunk(A, Av, nmax, B, Bv, del_keys, ds, de, npb, ns):
    """The plain stripe pass of one chunk of buckets (``flix_apply_kernel``'s
    phases, batched over the leading bucket dimension)."""
    M, Mv, pieces = merge_chunk(A, Av, nmax, B, Bv, npb, ns)
    hit = slice_hits(del_keys, M, ds, de)
    F, Fv, ocnt, omax, onn = compact_chunk(M, Mv, hit, npb, ns)
    overflow = (pieces > npb).to(torch.int32)
    return F, Fv, ocnt, omax, onn, overflow, hit.sum(1, dtype=torch.int32)


def flix_apply_reference(
    keys,
    vals,
    node_max,
    ins_keys,
    ins_vals,
    ins_starts,
    ins_ends,
    del_keys,
    del_starts,
    del_ends,
    tag,
    key,
    op_starts,
    op_ends,
):
    """Plain torch version of the stripe pass: same inputs and outputs as
    :func:`flix_apply_pass`, written from the kernel's formulas and run in
    bucket chunks.  The CPU path of the wrapper and the card's yardstick
    for the kernel's results."""
    nb, npb, ns = keys.shape
    S = npb * ns
    n = key.shape[0]
    dev = keys.device
    per_bucket = (
        torch.empty_like(keys),  # keys
        torch.empty_like(vals),  # vals
        torch.empty_like(node_max),  # node_count
        torch.empty_like(node_max),  # node_max
        torch.empty((nb,), dtype=torch.int32, device=dev),  # num_nodes
        torch.empty((nb,), dtype=torch.int32, device=dev),  # overflow
        torch.empty((nb,), dtype=torch.int32, device=dev),  # deleted
    )
    for c0, c1 in bucket_chunks(nb, 4 * S):
        B, Bv, _, _ = gather_kv_sublists(
            ins_keys, ins_vals, ins_starts[c0:c1], ins_ends[c0:c1], S
        )
        chunk = _stripe_chunk(
            keys[c0:c1].reshape(c1 - c0, S),
            vals[c0:c1].reshape(c1 - c0, S),
            node_max[c0:c1],
            B,
            Bv,
            del_keys,
            del_starts[c0:c1],
            del_ends[c0:c1],
            npb,
            ns,
        )
        for out, part in zip(per_bucket, chunk):
            out[c0:c1] = part
    out_k, out_v, _, omax, onn, _, _ = per_bucket

    # reads: op i belongs to the bucket whose slice [op_starts, op_ends)
    # holds it, and reads that bucket's post-update stripe
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    b = torch.searchsorted(op_ends, idx, right=True, out_int32=True)
    bc = torch.clamp(b, max=nb - 1)
    owned = (b < nb) & (idx >= op_starts[bc])
    is_point = owned & (tag == OP_POINT)
    is_succ = owned & (tag == OP_SUCCESSOR)
    nidx = (omax[bc] < key[:, None]).sum(1, dtype=torch.int32)
    node = torch.clamp(nidx, max=npb - 1)
    row = out_k[bc, node]
    raw_pos = (row < key[:, None]).sum(1, dtype=torch.int32)
    pos = torch.clamp(raw_pos, max=ns - 1)
    key_at = out_k[bc, node, pos]
    val_at = out_v[bc, node, pos]
    use_in = (nidx < onn[bc]) & (raw_pos < ns)
    value = torch.where(is_point & use_in & (key_at == key), val_at, NOT_FOUND)
    value = torch.where(is_succ & use_in, val_at, value)
    succ_key = torch.where(is_succ & use_in, key_at, EMPTY)
    return (*per_bucket, value, succ_key)


# ---------------------------------------------------------------------------
# the read-only pass
# ---------------------------------------------------------------------------

# the bits of the read pass's class word (csrc/flix_apply_staged.cu's
# kHasSuccessor, kHasRange)
HAS_SUCCESSOR = 1
HAS_RANGE = 2

_READ_INPUTS = ("keys", "vals", "node_max", "num_nodes", "mkba", "tag", "key")


def flix_apply_read_pass(keys, vals, node_max, num_nodes, mkba, tag, key):
    """The read-only pass (``csrc/flix_apply_staged.cu``'s
    ``flix_apply_read_launch``), a thread an op, on a state that it does not
    write: each op's bucket by a binary search of the fences ``mkba``,
    clamped to the last bucket as the engine routes; a POINT op's value or
    NOT_FOUND, a SUCCESSOR op's in-bucket candidate or (NOT_FOUND, EMPTY),
    (NOT_FOUND, EMPTY) for every other op.  ``keys``/``vals`` [nb, npb, ns],
    ``node_max`` [nb, npb], ``num_nodes`` and ``mkba`` [nb] are the state's;
    ``tag``/``key`` the sorted batch.  Returns ``(value, succ_key, bucket,
    classes)``: ``bucket`` each op's, and ``classes`` [1] the OR of
    :data:`HAS_SUCCESSOR` and :data:`HAS_RANGE` over the batch's ops.  Its
    plain version is :func:`flix_apply_read_reference`, which runs on the
    CPU."""
    nb, npb, ns = keys.shape
    n = key.shape[0]
    dev = keys.device
    check(dev, _READ_INPUTS, (keys, vals, node_max, num_nodes, mkba, tag, key))
    if vals.shape != keys.shape or node_max.shape != (nb, npb):
        raise ValueError("keys, vals and node_max disagree in geometry")
    if num_nodes.shape != (nb,) or mkba.shape != (nb,) or nb < 1:
        raise ValueError(f"num_nodes and mkba must have shape ({nb},), nb >= 1")
    if tag.shape != (n,):
        raise ValueError("batch columns disagree in length")
    if dev.type == "cpu":
        return flix_apply_read_reference(keys, vals, node_max, num_nodes, mkba, tag, key)
    outs = tuple(torch.empty((n,), dtype=torch.int32, device=dev) for _ in range(3))
    classes = torch.empty((1,), dtype=torch.int32, device=dev)
    launch("flix_apply_read", "flix_apply_read_launch", dev, keys, vals, node_max,
           num_nodes, mkba, tag, key, *outs, classes, nb, npb, ns, n)
    return (*outs, classes)


def flix_apply_read_reference(keys, vals, node_max, num_nodes, mkba, tag, key):
    """Plain torch version of :func:`flix_apply_read_pass`: the kernel's
    formulas as compare-counts over the gathered rows, in op chunks."""
    nb, npb, ns = keys.shape
    n = key.shape[0]
    value, succ_key, bucket = (torch.empty_like(key) for _ in range(3))
    for c0, c1 in query_chunks(n, npb + ns):
        q, tg = key[c0:c1], tag[c0:c1]
        b = torch.clamp(torch.searchsorted(mkba, q, out_int32=True), max=nb - 1)
        nidx = (node_max[b] < q[:, None]).sum(1, dtype=torch.int32)
        node = torch.clamp(nidx, max=npb - 1)
        raw_pos = (keys[b, node] < q[:, None]).sum(1, dtype=torch.int32)
        pos = torch.clamp(raw_pos, max=ns - 1)
        key_at = keys[b, node, pos]
        val_at = vals[b, node, pos]
        use_in = (nidx < torch.clamp(num_nodes[b], 0, npb)) & (raw_pos < ns)
        is_succ = (tg == OP_SUCCESSOR) & use_in
        hit = (tg == OP_POINT) & use_in & (key_at == q)
        value[c0:c1] = torch.where(hit | is_succ, val_at, NOT_FOUND)
        succ_key[c0:c1] = torch.where(is_succ, key_at, EMPTY)
        bucket[c0:c1] = b
    classes = (tag == OP_SUCCESSOR).any() * HAS_SUCCESSOR | (tag == OP_RANGE).any() * HAS_RANGE
    return value, succ_key, bucket, classes.to(torch.int32).reshape(1)


def flix_apply_read(
    state: FliXState,
    tag: torch.Tensor,
    key: torch.Tensor,
    val: torch.Tensor,
    *,
    max_results: int = DEFAULT_MAX_RESULTS,
):
    """A batch without updates (no INSERT, DELETE or EXPIRE op): the
    results and stats of :func:`flix_apply` on it, from the read-only pass,
    and ``state`` itself, which nothing writes.  One device-to-host read,
    of the batch's op classes; SUCCESSOR ops past their bucket's largest key
    take the fence rows (the state's successor cache where it carries one),
    RANGE ops the count kernel and the gather, as in :func:`flix_apply`; a
    batch of neither runs no O(nb) pass.  No restructure flag gates it: a
    flagged state answers as the reference engine answers from it."""
    with trace.span("read"):
        value, succ_key, b, classes = flix_apply_read_pass(
            state.keys, state.vals, state.node_max, state.num_nodes, state.mkba, tag, key
        )
        classes = trace.host_int(classes, "read.classes")
        zero = torch.zeros((), dtype=torch.int32, device=state.device)
        results, stats = answers(state, b, tag, key, val, value, succ_key, (zero,) * 3,
                                 max_results=max_results, site="read",
                                 has_successor=bool(classes & HAS_SUCCESSOR),
                                 has_ranges=bool(classes & HAS_RANGE))
    return state, results, stats


# ---------------------------------------------------------------------------
# launch 2: the dense RANGE gather
# ---------------------------------------------------------------------------


def flix_apply_range_pass(g, pref, node_count, keys, vals):
    """Dense RANGE output of the fused path: slot p holds the key of global
    post-update rank ``g[p]`` (EMPTY / NOT_FOUND where ``g[p] < 0``).  The
    gather kernel of ``csrc/flix_range.cu`` on the card, counted as
    ``flix_apply_range``; ``flix_range.flix_range_gather_reference`` on the
    CPU."""
    return range_gather(g, pref, node_count, keys, vals, kernel="flix_apply_range")


# ---------------------------------------------------------------------------
# the host side
# ---------------------------------------------------------------------------


def range_slots(
    state: FliXState,
    is_range: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    max_results: int,
):
    """The RANGE plumbing against a post-update state: its live-count
    prefix ``pref`` [nb+1], each RANGE op's ``[lo, hi)`` rank and count (the
    count kernel of ``csrc/flix_range.cu`` on the card, counted as
    ``flix_apply_rank``, the other ops masked out), the shared budget split,
    and the global rank of every output slot.  Returns ``(g, pref, start,
    emit, truncated)`` — the range gather's inputs and the per-op
    segments."""
    pref = live_prefix(state.node_count)
    meta = (state.keys, state.node_count, state.node_max, state.mkba, pref)
    rank_lo, full = flix_range_count(*meta, lo, hi, is_range=is_range,
                                     kernel="flix_apply_rank")
    start, emit, total_emit, truncated = range_offsets(full, is_range, max_results)
    g = range_slot_ranks(rank_lo, start, total_emit, max_results)
    return g, pref, start, emit, truncated


def flix_apply(
    state: FliXState,
    tag: torch.Tensor,
    key: torch.Tensor,
    val: torch.Tensor,
    *,
    max_results: int = DEFAULT_MAX_RESULTS,
    staged: bool = False,
    block_b: int = 0,
    has_ranges: bool | None = None,
    donate: bool = False,
):
    """Fused mixed-batch apply.  Same contract as ``core.ops.apply_ops``.

    ``staged`` runs the stripe pass on the staged kernel
    (``ExecConfig(pipeline="on")``), else on the single-buffer one; on the
    CPU both are the one plain version.  ``block_b`` is the staged kernel's
    warps a block (``ExecConfig.block_b`` or the tile table's pick; 0 its
    own count); the single-buffer kernel, a block per bucket, and the plain
    version do not read it.  The TPU kernel's ``block_q`` (ops a window) has
    no counterpart: a warp finds its op slice from the batch's per-bucket
    bounds.  ``has_ranges`` says whether the batch holds RANGE ops, which
    spares the host a sync.

    ``donate`` (with ``staged``) runs the donated pass
    (:func:`flix_apply_inplace_pass`): the result takes the input's
    ``keys``, ``vals``, ``node_count`` and ``node_max`` planes, written in
    place, and a new ``num_nodes``; the caller must not read the input
    state's planes afterwards.  Where a bucket overflows, or the input
    already needs restructuring, nothing is written: the result is the
    input's planes, flagged ``needs_restructure``, with its reads
    unanswered (``apply_ops_safe`` then reruns the batch without donating).
    """
    if donate and not staged:
        raise ValueError(
            "donate runs the staged kernel's in-place pass: pass staged=True"
        )
    cap = state.bucket_capacity
    n = key.shape[0]
    dev = state.device

    args, r = stripe_inputs(state, tag, key, val)
    b = _bucket_index(state, key)
    if donate:
        onn, value, succ_key, counts = flix_apply_inplace_pass(
            state.num_nodes, state.node_count, state.needs_restructure, val, b, *args,
            block_b=block_b,
        )
        okeys, ovals = state.keys, state.vals
        ocnt, omax = state.node_count, state.node_max
        inserted, deleted, overflowed = counts[0], counts[1], counts[2]
        any_overflow = overflowed > 0
    else:
        if staged:
            outs = flix_apply_staged_pass(state.num_nodes, *args, block_b=block_b)
        else:
            outs = flix_apply_pass(*args)
        okeys, ovals, ocnt, omax, onn, oflow, odel, value, succ_key = outs
        true_counts = r.ins_ends - r.ins_starts
        slice_overflow = true_counts > cap
        any_overflow = (oflow > 0).any() | slice_overflow.any()
        inserted = torch.clamp(true_counts, max=cap).sum(dtype=torch.int32)
        deleted = odel.sum(dtype=torch.int32)
        overflowed = ((oflow > 0) | slice_overflow).sum(dtype=torch.int32)
    new_state = FliXState(
        keys=okeys,
        vals=ovals,
        node_count=ocnt,
        node_max=omax,
        num_nodes=onn,
        mkba=state.mkba,
        needs_restructure=state.needs_restructure | any_overflow,
    )

    results, stats = answers(new_state, b, tag, key, val, value, succ_key,
                             (inserted, deleted, overflowed), max_results=max_results,
                             site="fused", has_ranges=has_ranges)
    return new_state, results, stats


def answers(
    state: FliXState,
    b: torch.Tensor,
    tag: torch.Tensor,
    key: torch.Tensor,
    val: torch.Tensor,
    value: torch.Tensor,
    succ_key: torch.Tensor,
    counts,
    *,
    max_results: int,
    site: str,
    has_successor: bool = True,
    has_ranges: bool | None = None,
):
    """The results and stats of a batch whose POINT and SUCCESSOR ops a
    kernel answered in their buckets ``b`` (``value``, ``succ_key``), on
    ``state`` as the batch leaves it: a SUCCESSOR op past its bucket's
    largest key takes the first key of the next non-empty bucket (from the
    state's successor cache where it carries one, else its fence rows), and
    RANGE ops the count kernel and the range gather.  ``has_successor``
    False skips the fallback; ``has_ranges`` None reads whether the batch
    holds RANGE ops (one sync).  ``counts`` are the (inserted, deleted,
    overflowed) stats; spans ``<site>.successor`` and ``<site>.range``."""
    n = key.shape[0]
    dev = state.device
    if has_successor:
        with trace.span(f"{site}.successor"):
            if state.succ_smin is not None:
                out_key = state.succ_smin[b + 1]
                out_val = state.vals[state.succ_sidx[b + 1], 0, 0]
            else:
                next_key, next_val = fence_rows(state.keys, state.vals,
                                                num_nodes=state.num_nodes)
                out_key, out_val = next_key[b], next_val[b]
            fallback = (tag == OP_SUCCESSOR) & (succ_key == EMPTY)
            succ_key = torch.where(fallback, out_key, succ_key)
            value = torch.where(fallback & (out_key != EMPTY), out_val, value)

    # RANGE: rank fences and per-slot ranks, then the gather
    is_range = tag == OP_RANGE
    if has_ranges is None:
        has_ranges = trace.host_bool(is_range.any(), "has_ranges")
    if has_ranges:
        with trace.span(f"{site}.range"):
            g, pref, rstart, remit, rtrunc = range_slots(state, is_range, key, val, max_results)
            rk, rv = flix_apply_range_pass(g, pref, state.node_count, state.keys, state.vals)
            range_start = torch.where(is_range, rstart, 0)
            range_count = torch.where(is_range, remit, 0)
    else:
        rk = torch.full((max_results,), EMPTY, dtype=torch.int32, device=dev)
        rv = torch.full((max_results,), NOT_FOUND, dtype=torch.int32, device=dev)
        range_start = torch.zeros((n,), dtype=torch.int32, device=dev)
        range_count = torch.zeros_like(range_start)
        rtrunc = torch.zeros((), dtype=torch.int32, device=dev)

    results = {
        "value": value,
        "succ_key": succ_key,
        "range_key": rk,
        "range_val": rv,
        "range_start": range_start,
        "range_count": range_count,
    }
    inserted, deleted, overflowed = counts
    stats = {
        "inserted": inserted,
        "deleted": deleted,
        "overflowed_buckets": overflowed,
        "range_truncated": rtrunc,
    }
    return results, stats
