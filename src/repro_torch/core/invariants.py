"""Structural invariant checker for FliXState (port of
``repro/core/invariants.py``, I1–I5 — see ``core/state.py`` — I6, the
expiry liveness of ``core/expiry.py``, and I7, the tiered residency of
``core/residency.py``).

Host-side numpy.  The reference loops over buckets in Python; this form is
vectorised over the whole state, so it checks a 2^20-bucket state in
seconds.  ``check_invariants`` raises ``AssertionError`` naming the first
violated invariant and a (bucket, node) where it fails.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.state import EMPTY, MAX_VALID, MIN_KEY, NOT_FOUND, FliXState


def _require(ok: np.ndarray, what: str) -> None:
    """Raise naming ``what`` at the first index where ``ok`` is False."""
    if not ok.all():
        where = tuple(int(i) for i in np.argwhere(~ok)[0])
        raise AssertionError(f"{what} at {where}")


def check_invariants(st: FliXState, now: int | None = None) -> None:
    """Assert I1–I6 hold for ``st``.

    I6 applies to a state with an expiry plane: empty slots hold
    ``NO_EXPIRY``, and — when the caller gives the ``now`` the engine last
    ran at — no live row holds ``exp <= now``.
    """
    keys = st.keys.cpu().numpy()
    counts = st.node_count.cpu().numpy()
    nmax = st.node_max.cpu().numpy()
    nn = st.num_nodes.cpu().numpy()
    mkba = st.mkba.cpu().numpy()
    _, npb, ns = keys.shape

    active = np.arange(npb)[None, :] < nn[:, None]  # [nb, npb]
    filled = np.arange(ns)[None, None, :] < counts[:, :, None]  # [nb, npb, ns]
    _require(~active | (counts > 0), "active empty node")
    _require(active | (counts == 0), "inactive slot dirty (count)")
    # I1: the row's tail past its count is EMPTY (this also covers inactive
    # slots, whose count is 0), and the filled prefix is strictly ascending
    _require(filled | (keys == EMPTY), "I1 padding violated (or inactive slot dirty)")
    both = filled[..., 1:]  # a pair (i, i+1) lies in the prefix iff i+1 does
    _require(~both | (keys[..., 1:] > keys[..., :-1]), "I1 violated")
    # I4 on active nodes (I1 puts the max at position count-1)
    last_pos = np.maximum(counts - 1, 0)[..., None]
    last = np.take_along_axis(keys, last_pos, axis=2)[..., 0]
    _require(~active | (nmax == last), "I4 violated")
    # I2: node j's smallest key above node j-1's largest
    _require(~active[:, 1:] | (keys[:, 1:, 0] > nmax[:, :-1]), "I2 violated")
    # I3: with I1+I2 the bucket's keys span [keys[b,0,0], nmax[b, nn-1]]
    lf = np.concatenate([[MIN_KEY], mkba[:-1]])
    _require(~active | (keys[:, :, 0] > lf[:, None]), "I3 violated (lower fence)")
    _require(~active | (nmax <= mkba[:, None]), "I3 violated (upper fence)")
    assert (np.diff(mkba.astype(np.int64)) >= 0).all(), "I5 violated"
    assert mkba[-1] == MAX_VALID, "I5 violated: mkba[-1] != MAX_VALID"
    if st.exps is not None:
        _check_expiry(keys, st.exps.cpu().numpy(), now)


def _check_expiry(keys: np.ndarray, exps: np.ndarray, now: int | None) -> None:
    """I6 on host arrays of the key and expiry planes."""
    assert exps.shape == keys.shape, "I6 violated: expiry plane shape"
    empty = keys == EMPTY
    _require(~empty | (exps == EMPTY), "I6 violated: an empty slot carries a deadline")
    if now is not None:
        leaked = ~empty & (exps <= int(now))
        if leaked.any():
            raise AssertionError(
                "I6 violated: live row(s) past their expiry deadline (keys "
                f"{keys[leaked][:8].tolist()} expired at {exps[leaked][:8].tolist()} "
                f"<= now={int(now)})"
            )


def check_tiered_invariants(tiered, now: int | None = None) -> None:
    """Assert I7 for a ``core.residency.TieredFliX``.

    I7: every live row is reachable in exactly one tier — resident buckets
    are authoritative on the device, all others in the host mirror — and
    the synced host view satisfies I1–I6; the device tier holds at most
    ``max(budget, one bucket)`` bytes.  Also pins the bookkeeping the
    engine's correctness rests on: sorted, unique, in-range resident ids,
    packed fences equal to the full ones (the last forced to
    ``MAX_VALID``), and fresh per-bucket metadata.
    """
    from repro_torch.core.expiry import bucket_min_exp

    nb = tiered.num_buckets
    ids = np.asarray(tiered.resident_ids)
    assert len(ids) < 2 or (np.diff(ids) > 0).all(), "I7: resident_ids not sorted/unique"
    if len(ids):
        assert ids[0] >= 0 and ids[-1] < nb, "I7: resident id out of range"
    packed = tiered._packed
    if packed is None:
        assert len(ids) == 0, "I7: resident ids without a packed state"
    else:
        assert packed.num_buckets == len(ids), "I7: packed bucket count != resident id count"
        pm = packed.mkba.cpu().numpy()
        assert (pm[:-1] == np.asarray(tiered.h_mkba)[ids[:-1]]).all(), (
            "I7: packed fences diverge from the full fence array"
        )
        assert pm[-1] == MAX_VALID, "I7: packed mkba not MAX_VALID-terminated"
    if tiered.budget_bytes is not None:
        cap = max(int(tiered.budget_bytes), tiered.bucket_bytes)
        assert tiered.memory_bytes_resident() <= cap, (
            f"I7: resident bytes {tiered.memory_bytes_resident()} > budget {cap}"
        )
    view = tiered.host_view()  # sync() makes the mirror authoritative
    check_invariants(view, now=now)
    live = view.node_count.sum(dim=1).numpy()
    assert (live == np.asarray(tiered.h_live)).all(), "I7: stale live metadata"
    min_exp = bucket_min_exp(view).numpy()
    assert (min_exp == np.asarray(tiered.h_min_exp)).all(), "I7: stale min-expiry metadata"


def check_range_results(ops, results, *, max_results: int) -> None:
    """Structural checks on a batch's dense RANGE output.

    For every RANGE op in the sorted batch: its segment is strictly
    ascending, every key lies inside the op's ``[lo, hi)``, segments are
    packed consecutively from offset 0 in batch order, and slots beyond the
    emitted total hold EMPTY / NOT_FOUND.
    """
    from repro_torch.core.ops import OP_RANGE

    tag = ops.tag.cpu().numpy()
    lo = ops.key.cpu().numpy()
    hi = ops.val.cpu().numpy()
    keys = results["range_key"].cpu().numpy()
    vals = results["range_val"].cpu().numpy()
    start = results["range_start"].cpu().numpy()
    count = results["range_count"].cpu().numpy()
    assert keys.shape == (max_results,) and vals.shape == (max_results,)

    is_range = tag == OP_RANGE
    assert (start[~is_range] == 0).all(), "non-RANGE op with a range offset"
    assert (count[~is_range] == 0).all(), "non-RANGE op with range results"

    cursor = 0
    for i in np.nonzero(is_range)[0]:
        c = int(count[i])
        assert 0 <= c <= max_results, f"op {i}: count {c} out of budget"
        assert start[i] == cursor, (
            f"op {i}: segment start {start[i]} != packed cursor {cursor}"
        )
        seg = keys[cursor : cursor + c].astype(np.int64)
        assert (np.diff(seg) > 0).all(), f"op {i}: segment not strictly ascending"
        assert ((seg >= int(lo[i])) & (seg < int(hi[i]))).all(), (
            f"op {i}: key outside [{lo[i]}, {hi[i]})"
        )
        cursor += c
    assert (keys[cursor:] == EMPTY).all(), "dirty keys beyond emitted total"
    assert (vals[cursor:] == NOT_FOUND).all(), "dirty vals beyond emitted total"
