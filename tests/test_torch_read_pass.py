"""The read-only pass (``kernels.flix_apply.flix_apply_read``) on the CPU,
where it runs its plain version (``flix_apply_read_reference``): results
and stats equal to the reference engine's (``core.ops._apply_ops_reference``)
on read-only batches, the input state returned as it is, no byte of it
written; and ``impl="auto"``'s choice of executor.  The CUDA kernel
against this plain version: ``tests/test_torch_kernels_cuda.py -k read``.
The file imports no JAX, so the card's tests can take its cases."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import ops as tops_mod  # noqa: E402
from repro_torch.kernels import flix_apply as fa  # noqa: E402

torch.set_num_threads(1)

EMPTY = tcore.EMPTY
RESULT_KEYS = ("value", "succ_key", "range_key", "range_val", "range_start", "range_count")
PLANES = ("keys", "vals", "node_count", "node_max", "num_nodes", "mkba", "needs_restructure")
MAX_RESULTS = 64
SPACE = 20000


def read_state(device="cpu", ns=8, npb=4, seed=3):
    """A state with holes: built from 600 keys, then every key of four runs
    of buckets deleted (and of the last bucket), so that successors fall
    back across empty buckets and past the last one.  Returns it and its
    live keys."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(SPACE, 600, replace=False)).astype(np.int32)
    st = tcore.build(keys, keys * 3, node_size=ns, nodes_per_bucket=npb, device="cpu")
    nb = st.num_buckets
    gone = np.concatenate([np.arange(3, 6), np.arange(nb // 2, nb // 2 + 2), [nb - 1]])
    dels = st.keys[torch.as_tensor(gone)].flatten()
    dels = dels[dels != EMPTY].numpy().astype(np.int32)
    ops, _ = tcore.make_ops(np.full(dels.size, tcore.OP_DELETE, np.int32), dels,
                            device="cpu")
    st = tcore.apply_ops(st, ops, config=tcore.ExecConfig(impl="reference"))[0]
    live = np.setdiff1d(keys, dels)
    assert int((st.num_nodes == 0).sum()) >= len(gone)
    return to(st, device), live


def to(st, device):
    fields = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
    return tcore.FliXState(**{k: None if v is None else v.to(device) for k, v in fields.items()})


def _tops(st):
    """Each non-empty bucket's largest key."""
    nn = st.num_nodes.cpu()
    mx = st.node_max.cpu()
    return np.array([int(mx[b, nn[b] - 1]) for b in range(len(nn)) if nn[b] > 0], np.int32)


def points(rng, st, live):
    return [(tcore.OP_POINT, rng.choice(live, 40)), (tcore.OP_POINT, rng.integers(0, SPACE, 40))]


def successors_in_bucket(rng, st, live):
    return [(tcore.OP_SUCCESSOR, rng.choice(live, 30)),
            (tcore.OP_SUCCESSOR, rng.choice(live, 30) - 1)]


def successors_past(rng, st, live):
    """Successors just past each bucket's largest key: the next bucket's
    first key, across empty buckets, and none past the last live key."""
    tops = _tops(st)
    return [(tcore.OP_SUCCESSOR, tops + 1), (tcore.OP_SUCCESSOR, [int(live.max()) + 1, SPACE])]


def ranges(rng, st, live, width=200):
    lo = rng.integers(0, SPACE, 6)
    return [(tcore.OP_RANGE, lo, lo + rng.integers(1, width, 6))]


def mixed(rng, st, live):
    return points(rng, st, live) + successors_past(rng, st, live)[:1] + ranges(rng, st, live)


CASES = {
    "point_hits_and_misses": (points, {}),
    "successor_in_bucket": (successors_in_bucket, {}),
    "successor_fallback": (successors_past, {}),
    "range": (ranges, {}),
    "range_truncated": (lambda rng, st, live: ranges(rng, st, live, width=6000), {}),
    "mixed": (mixed, {}),
    "mixed_padded": (mixed, {"pad_to": 512}),
    "above_last_fence": (mixed, {"low_fence": True}),
    "flagged_state": (mixed, {"flagged": True}),
    "successor_cache": (mixed, {"cache": True}),
}


def read_case(case, device="cpu"):
    """A state and a read-only sorted batch of one case of :data:`CASES`."""
    make, kw = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    st, live = read_state()
    groups = make(rng, st, live)
    if kw.get("low_fence"):
        # the last fence at the last bucket's largest key, as a packed subset
        # of buckets has it: keys above it lie past every bucket
        top = int(_tops(st)[-1])
        mkba = st.mkba.clone()
        mkba[-1] = max(top, int(mkba[-2]) + 1)
        st = dataclasses.replace(st, mkba=mkba)
        groups += [(tcore.OP_POINT, [int(mkba[-1]) + 5, EMPTY - 1]),
                   (tcore.OP_SUCCESSOR, [int(mkba[-1]) + 7, EMPTY - 1])]
    if kw.get("flagged"):
        st = dataclasses.replace(st, needs_restructure=torch.ones((), dtype=torch.bool))
    if kw.get("cache"):
        st = tcore.with_successor_cache(st)
    tags = np.concatenate([np.full(len(g[1]), g[0]) for g in groups]).astype(np.int32)
    keys = np.concatenate([np.asarray(g[1]) for g in groups]).astype(np.int32)
    vals = np.concatenate([np.asarray(g[2]) if len(g) > 2 else np.zeros(len(g[1]))
                           for g in groups]).astype(np.int32)
    ops, _ = tcore.make_ops(tags, keys, vals, pad_to=kw.get("pad_to"), device="cpu")
    ops = tcore.OpBatch(tag=ops.tag.to(device), key=ops.key.to(device), val=ops.val.to(device))
    return to(st, device), ops


def planes(st):
    return {f: getattr(st, f).clone() for f in PLANES}


def assert_same_result(want, got, msg=""):
    for k in RESULT_KEYS:
        assert torch.equal(want[1][k], got[1][k]), f"{msg}{k}"
    assert set(want[2]) <= set(got[2])
    for k in want[2]:
        assert int(want[2][k]) == int(got[2][k]), f"{msg}{k}"


@pytest.mark.parametrize("case", list(CASES))
def test_read_pass_matches_the_reference_engine(case):
    """Every result and stat of the reference engine, the input state
    returned itself, and none of its planes written."""
    st, ops = read_case(case)
    before = planes(st)
    want = tops_mod._apply_ops_reference(st, ops, max_results=MAX_RESULTS)
    got = fa.flix_apply_read(st, ops.tag, ops.key, ops.val, max_results=MAX_RESULTS)
    assert got[0] is st
    assert_same_result(want, got)
    for f in PLANES:
        assert torch.equal(before[f], getattr(st, f)), f
    if case.startswith("range"):
        assert (int(got[2]["range_truncated"]) > 0) == (case == "range_truncated")
        assert int(got[1]["range_count"].sum()) > 0
    if case == "successor_fallback":
        tops = torch.as_tensor(_tops(st))
        fell = (ops.tag == tcore.OP_SUCCESSOR) & torch.isin(ops.key - 1, tops)
        assert bool((got[1]["succ_key"][fell] != EMPTY).any())
        assert bool((got[1]["succ_key"][fell] == EMPTY).any())  # past the last key


def test_read_pass_plain_version_answers_and_classes():
    """The plain version alone: (NOT_FOUND, EMPTY) for every op but POINT
    and SUCCESSOR, each op's routed bucket, and the class bits of the
    batch's SUCCESSOR and RANGE ops."""
    st, ops = read_case("mixed_padded")
    args = (st.keys, st.vals, st.node_max, st.num_nodes, st.mkba)
    value, succ, bucket, classes = fa.flix_apply_read_pass(*args, ops.tag, ops.key)
    assert int(classes) == fa.HAS_SUCCESSOR | fa.HAS_RANGE
    want_b = torch.clamp(torch.searchsorted(st.mkba, ops.key), max=st.num_buckets - 1)
    assert torch.equal(bucket, want_b.to(torch.int32))
    other = (ops.tag != tcore.OP_POINT) & (ops.tag != tcore.OP_SUCCESSOR)
    assert bool((value[other] == tcore.NOT_FOUND).all() & (succ[other] == EMPTY).all())
    for cls, tags in ((0, [tcore.OP_POINT]), (fa.HAS_SUCCESSOR, [tcore.OP_SUCCESSOR]),
                      (fa.HAS_RANGE, [tcore.OP_RANGE, tcore.OP_NOP])):
        tag = torch.tensor(tags, dtype=torch.int32)
        key = torch.tensor([5, EMPTY][: len(tags)], dtype=torch.int32)
        assert int(fa.flix_apply_read_pass(*args, tag, key)[3]) == cls
    with pytest.raises(ValueError):
        fa.flix_apply_read_pass(*args, ops.tag[:-1], ops.key)


def on_card_dispatch(monkeypatch):
    """Let ``impl="auto"`` choose as on the card, with the kernels' plain
    versions, and count the reference engine's runs."""
    monkeypatch.setattr(tops_mod, "_KERNEL_DEVICES", ("cuda", "cpu"))
    calls = []
    ref = tops_mod._apply_ops_reference

    def counted(*a, **kw):
        calls.append(1)
        return ref(*a, **kw)

    monkeypatch.setattr(tops_mod, "_apply_ops_reference", counted)
    return calls


@pytest.mark.parametrize("case", ["mixed", "flagged_state", "successor_cache"])
def test_auto_runs_the_read_pass_for_a_batch_without_updates(case, monkeypatch):
    """``apply_ops_safe`` with ``impl="auto"`` as on the card: a read-only
    batch takes the read pass, whatever ``donate`` says, and returns the
    input state itself with the reference engine's answers."""
    st, ops = read_case(case)
    want = tops_mod._apply_ops_reference(st, ops, max_results=MAX_RESULTS)
    calls = on_card_dispatch(monkeypatch)
    for donate in (None, False, True):
        cfg = tcore.ExecConfig(max_results=MAX_RESULTS, donate=donate)
        got = tcore.apply_ops_safe(st, ops, config=cfg)
        assert got[0] is st and not calls
        assert_same_result(want, got)
        assert got[2]["restructure_retries"] == 0


def test_auto_with_updates_still_donates_and_the_cpu_runs_the_reference(monkeypatch):
    """A batch with updates: the donated pass as on the card (the result
    holds the input's planes); on the CPU, the reference engine, for a
    read-only batch too.  A read-only batch under TTL keeps the reference."""
    st, ops = read_case("mixed")
    live = st.keys[st.keys != EMPTY][:5]
    upd = tcore.make_ops(torch.full((5,), tcore.OP_INSERT, dtype=torch.int32), live,
                         live + 1, device="cpu")[0]
    cfg = tcore.ExecConfig(max_results=MAX_RESULTS, pipeline="on")  # the card's default
    calls = on_card_dispatch(monkeypatch)
    copy = to(st, "cpu")
    got = tcore.apply_ops_safe(copy, upd, config=cfg)
    assert got[0].keys is copy.keys and not calls
    ttl = tcore.attach_expiry(st)
    tcore.apply_ops_safe(ttl, ops, config=cfg, now=1)
    assert len(calls) == 2  # the expiry plane, then the value plane
    monkeypatch.setattr(tops_mod, "_KERNEL_DEVICES", ("cuda",))
    calls.clear()
    got = tcore.apply_ops_safe(st, ops, config=cfg)
    assert len(calls) == 1
    got = tcore.apply_ops_safe(to(st, "cpu"), upd, config=cfg)
    assert len(calls) == 2
