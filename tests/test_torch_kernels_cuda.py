"""The port's CUDA kernels against their plain torch versions, exact (the
grouped GEMM within the float32 tolerance stated below), on a CUDA card only (the kernels have no CPU mode; these tests skip without a
card).  The file imports no JAX, so it also runs where only torch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import core as tcore  # noqa: E402
from repro_torch.kernels import GMM_VARIANTS, LAUNCHES, ops  # noqa: E402
from repro_torch.kernels import flix_apply as fa  # noqa: E402
from repro_torch.kernels import flix_delete as fd  # noqa: E402
from repro_torch.kernels import flix_insert as fi  # noqa: E402
from repro_torch.kernels import flix_query as fq  # noqa: E402
from repro_torch.kernels import flix_range as fr  # noqa: E402
from repro_torch.kernels import flix_successor as fs  # noqa: E402
from repro_torch.kernels import grouped_matmul as tg  # noqa: E402
from repro_torch.kernels import moe_dispatch as tmd  # noqa: E402
from test_torch_read_pass import CASES as READ_CASES  # noqa: E402
from test_torch_read_pass import read_case  # noqa: E402

EMPTY = tcore.EMPTY
GEOMETRIES = [(32, 16), (8, 8), (32, 64), (64, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _equal(want, got, what):
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.shape == g.shape and torch.equal(w, g), f"{what}: output {i}"


def _random_case(rng, n_keys, ns, npb, device, n_ops=4096):
    keys = rng.choice(1 << 24, n_keys, replace=False).astype(np.int32)
    st = tcore.build(keys, keys ^ 0x5A5A, node_size=ns, nodes_per_bucket=npb, device=device)
    absent = rng.integers(0, 1 << 24, n_ops).astype(np.int32)
    tags = rng.choice(
        [tcore.OP_INSERT, tcore.OP_DELETE, tcore.OP_POINT, tcore.OP_SUCCESSOR,
         tcore.OP_RANGE], n_ops, p=[0.2, 0.2, 0.4, 0.15, 0.05],
    ).astype(np.int32)
    k = np.where(tags == tcore.OP_DELETE, rng.choice(keys, n_ops), absent)
    k, first = np.unique(k, return_index=True)  # one update per key
    tags = tags[first]
    v = np.where(tags == tcore.OP_RANGE, np.minimum(k + 5000, EMPTY - 1), k + 1)
    ops_, _ = tcore.make_ops(tags, k, v.astype(np.int32), device=device)
    return st, ops_


@pytest.mark.cuda
@pytest.mark.parametrize("ns,npb", [(32, 16), (8, 8), (32, 64)])
def test_kernels_match_plain_versions_on_card(cuda, ns, npb):
    rng = np.random.default_rng(ns * npb)
    st, ops_ = _random_case(rng, 1 << 16, ns, npb, cuda)
    args = list(fa.stripe_inputs(st, ops_.tag, ops_.key, ops_.val)[0])
    before = dict(LAUNCHES)
    got = fa.flix_apply_pass(*args)
    want = fa.flix_apply_reference(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["flix_apply"] == before["flix_apply"] + 1
    _equal(want, got, "flix_apply")
    new = tcore.FliXState(got[0], got[1], got[2], got[3], got[4], st.mkba, st.needs_restructure)
    live = got[2].sum(1, dtype=torch.int32)
    pref = torch.cat([live.new_zeros(1), torch.cumsum(live, 0, dtype=torch.int32)])
    g = torch.randint(-1, int(pref[-1]), (8192,), device=cuda, dtype=torch.int32)
    g = torch.sort(g).values
    w = fr.flix_range_gather_reference(g, pref, new.node_count, new.keys, new.vals)
    k = fa.flix_apply_range_pass(g, pref, new.node_count, new.keys, new.vals)
    assert torch.equal(w[0], k[0]) and torch.equal(w[1], k[1])


@pytest.mark.cuda
def test_engine_fused_matches_reference_on_card(cuda):
    st, ops_ = _random_case(np.random.default_rng(5), 1 << 15, 32, 16, cuda)
    cfg = tcore.ExecConfig(max_results=4096)
    a = tcore.apply_ops_safe(st, ops_, config=cfg.replace(impl="fused", donate=False))
    b = tcore.apply_ops_safe(st, ops_, config=cfg.replace(impl="reference"))
    for f in ("keys", "node_count", "node_max", "num_nodes"):
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
    live = a[0].keys != EMPTY
    assert torch.equal(a[0].vals[live], b[0].vals[live])
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


@pytest.mark.cuda
def test_oversized_geometry_is_refused(cuda):
    st = tcore.empty_state(2, 2048, 32, device=cuda)
    ops_, _ = tcore.make_ops(np.array([tcore.OP_POINT], np.int32), np.array([5], np.int32))
    with pytest.raises(ValueError, match="shared memory"):
        tcore.apply_ops(st, ops_, config=tcore.ExecConfig(impl="fused"))
    q = torch.tensor([5], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="npb=2048"):
        ops.flix_insert(st, q, q)
    with pytest.raises(ValueError, match="npb=2048"):
        fd.flix_delete_pass(st.num_nodes, st.keys, st.vals, st.mkba, q)


def _state_with_holes(rng, ns, npb, device):
    """Keys from a sparse space (so one bucket's range can take a flood),
    with a run of deleted keys that empties whole buckets."""
    keys = np.sort(rng.choice(1 << 26, 1 << 15, replace=False)).astype(np.int32)
    st = tcore.build(keys, keys ^ 0x33, node_size=ns, nodes_per_bucket=npb, device=device)
    st = tcore.delete(st, torch.as_tensor(keys[1000:1400], device=device))[0]
    return st, np.concatenate([keys[:1000], keys[1400:]])


@pytest.mark.cuda
@pytest.mark.parametrize("ns,npb", GEOMETRIES)
def test_query_kernels_match_plain_on_card(cuda, ns, npb):
    rng = np.random.default_rng(ns + npb)
    st, live = _state_with_holes(rng, ns, npb, cuda)
    q = np.concatenate([
        rng.choice(live, 5000), rng.integers(0, 1 << 26, 5000),
        np.repeat(live[990:1010], 3), [0, 1, tcore.MAX_VALID - 1, tcore.MAX_VALID, EMPTY],
    ])
    q = torch.as_tensor(np.sort(q).astype(np.int32), device=cuda)
    planes = (st.keys, st.vals, st.node_max, st.mkba, q)
    before = dict(LAUNCHES)
    got = fq.flix_point_query(*planes)
    gk, gv = fs.flix_successor(*planes)
    torch.cuda.synchronize()
    assert LAUNCHES["flix_point_query"] == before["flix_point_query"] + 1
    assert LAUNCHES["flix_successor"] == before["flix_successor"] + 1
    assert torch.equal(got, fq.flix_point_query_reference(*planes))
    _equal(fs.flix_successor_reference(*planes), (gk, gv), "flix_successor")
    assert torch.equal(got, tcore.point_query(st, q))
    _equal(tcore.successor_query(st, q), (gk, gv), "successor vs core")


@pytest.mark.cuda
@pytest.mark.parametrize("ns,npb", GEOMETRIES)
def test_update_kernels_match_plain_on_card(cuda, ns, npb):
    rng = np.random.default_rng(7 * ns + npb)
    st, live = _state_with_holes(rng, ns, npb, cuda)
    cap = ns * npb
    b = int(np.searchsorted(st.mkba.cpu().numpy(), live[3000]))
    lo, hi = int(st.mkba[b - 1]) + 1, int(st.mkba[b])  # bucket b's key range
    flood = rng.choice(np.arange(lo, hi + 1), cap + 40, replace=False)
    fresh = rng.integers(0, 1 << 26, 3000)
    ins = np.unique(np.concatenate([flood, fresh, [0, tcore.MAX_VALID]])).astype(np.int32)
    ik = torch.as_tensor(ins, device=cuda)
    iv = ik * 7 + 1
    args = (st.num_nodes, st.keys, st.vals, st.node_max, st.mkba, ik, iv)
    got = fi.flix_insert_pass(*args)
    _equal(fi.flix_insert_reference(*args), got, "flix_insert")
    assert int(got[5].max()) == 2  # the flooded bucket overflows both ways

    dels = np.concatenate([
        live[::5], np.repeat(live[2000:2100], 3), rng.integers(0, 1 << 26, 2000), [0],
    ])
    dk = torch.as_tensor(np.sort(dels).astype(np.int32), device=cuda)
    got = fd.flix_delete_pass(st.num_nodes, st.keys, st.vals, st.mkba, dk)
    _equal(fd.flix_delete_reference(st.num_nodes, st.keys, st.vals, st.mkba, dk), got,
           "flix_delete")
    new = ops.flix_delete(st, dk)
    want = tcore.delete(st, dk)[0]
    for f in ("keys", "node_count", "node_max", "num_nodes"):
        assert torch.equal(getattr(new, f), getattr(want, f)), f


# the edge cases' geometries (the staged stripe kernel's and the point-query
# kernel's): GEOMETRIES and S = 8 (4-key nodes, 2 a bucket), where most
# lanes of a bucket's warp idle; S = 2048 is (32, 64)
EDGE_GEOMETRIES = GEOMETRIES + [(4, 2)]
STAGED_CASES = ("mixed", "flood", "long_slices", "emptied_bucket", "delete_all",
                "full_bucket", "above_max", "edge_keys")


def _bucket_range(st, b):
    """The keys bucket b holds: (mkba[b-1], mkba[b]]."""
    mk = st.mkba.cpu().numpy()
    return (int(mk[b - 1]) + 1 if b > 0 else 0), int(mk[b])


def _sorted_ops(groups, device):
    """A batch of one op per key from (tag, keys, vals or None) groups; vals
    default to key + 1."""
    t = np.concatenate([np.full(len(k), tag, np.int32) for tag, k, _ in groups])
    k = np.concatenate([np.asarray(k, np.int64) for _, k, _ in groups])
    v = np.concatenate([np.asarray(k, np.int64) + 1 if v is None else np.asarray(v, np.int64)
                        for _, k, v in groups])
    k, first = np.unique(k, return_index=True)
    return tcore.make_ops(t[first], k.astype(np.int32), v[first].astype(np.int32),
                          device=device)[0]


def _full_bucket(rng, ns, npb, device):
    """A state whose middle bucket has every row active and full (one row
    at fill 1, then (npb - 1) * ns fresh keys through the reference engine),
    and one fresh insert into it, which overflows."""
    keys = np.sort(rng.choice(1 << 26, 1 << 15, replace=False)).astype(np.int32)
    st = tcore.build(keys, keys ^ 0x33, node_size=ns, nodes_per_bucket=npb, fill=1.0,
                     device=device)
    b = st.num_buckets // 2
    lo, hi = _bucket_range(st, b)
    fresh = rng.choice(np.setdiff1d(np.arange(lo, hi + 1), keys), (npb - 1) * ns + 1,
                       replace=False)
    fill = _sorted_ops([(tcore.OP_INSERT, fresh[1:], None)], device)
    st = tcore.apply_ops(st, fill, config=tcore.ExecConfig(impl="reference"))[0]
    assert int(st.num_nodes[b]) == npb and int(st.node_count[b].sum()) == npb * ns
    groups = [(tcore.OP_INSERT, fresh[:1], None), (tcore.OP_POINT, fresh[1:40], None),
              (tcore.OP_SUCCESSOR, rng.integers(lo, hi + 1, 20), None)]

    def premise(got, r):
        assert int(got[5][b]) == 1 and int(got[5].sum()) == 1  # only b overflows

    return st, groups, premise


def stripe_case(ns, npb, case, device):
    """A state, a sorted batch and a check of the case's premise (called
    with the stripe pass's outputs and the routing), for one edge of the
    stripe kernels; the same inputs on every device."""
    return _staged_case(np.random.default_rng(3 * ns + npb), ns, npb, case, device)


def _staged_case(rng, ns, npb, case, device):
    """A state, a sorted batch and a check of the case's premise, for one
    edge of the warp-per-bucket staged kernel."""
    ins, dele, pt, succ = tcore.OP_INSERT, tcore.OP_DELETE, tcore.OP_POINT, tcore.OP_SUCCESSOR
    st, live = _state_with_holes(rng, ns, npb, device)
    S, nb = ns * npb, st.num_buckets
    nn = st.num_nodes.cpu().numpy()
    b = int(np.searchsorted(st.mkba.cpu().numpy(), live[3000]))
    lo, hi = _bucket_range(st, b)
    premise = lambda got, r: None  # noqa: E731
    if case == "mixed":
        return st, _random_case(rng, 1 << 15, ns, npb, device)[1], premise
    if case == "full_bucket":
        st, groups, premise = _full_bucket(rng, ns, npb, device)
    elif case == "flood":  # more inserts than the bucket has slots: the slice is cut at S
        groups = [(ins, rng.choice(np.arange(lo, hi + 1), S + 40, replace=False), None),
                  (ins, rng.integers(0, 1 << 26, 2000), None)]

        def premise(got, r):
            assert int(got[5].max()) == 1

    elif case == "long_slices":  # op slices of more than 64 and more than 32 ops
        near = rng.choice(np.arange(lo, hi + 1), 103, replace=False)
        lo2, hi2 = _bucket_range(st, b + 7)
        row2 = st.keys[b + 7].cpu().numpy().reshape(-1)
        groups = [(pt, near[:70], None), (succ, near[70:100], None), (ins, near[100:], None),
                  (pt, rng.choice(np.arange(lo2, hi2 + 1), 40, replace=False), None),
                  (dele, row2[row2 != EMPTY][:2], None)]

        def premise(got, r):
            n_ops = (r.ends - r.starts).cpu().numpy()
            assert n_ops[b] > 64 and 32 < n_ops[b + 7] <= 64

    elif case == "emptied_bucket":  # num_nodes = 0, then inserts
        gone = np.nonzero(nn == 0)[0]
        gone = [int(g) for g in gone[(gone > 0) & (gone < nb - 1)][:3]]
        assert len(gone) == 3
        groups = []
        for g in gone:
            l2, h2 = _bucket_range(st, g)
            groups += [(ins, rng.choice(np.arange(l2, h2 + 1), ns + 3, replace=False), None),
                       (pt, rng.integers(l2, h2 + 1, 5), None),
                       (succ, rng.integers(l2, h2 + 1, 5), None)]

        def premise(got, r):
            assert all(int(got[4][g]) > 0 for g in gone)

    elif case == "delete_all":  # every key of two buckets
        groups = []
        for bb in (b, b + 3):
            row = st.keys[bb].cpu().numpy().reshape(-1)
            l2, h2 = _bucket_range(st, bb)
            groups += [(dele, row[row != EMPTY], None), (pt, rng.integers(l2, h2 + 1, 5), None),
                       (succ, rng.integers(l2, h2 + 1, 5), None)]

        def premise(got, r):
            assert int(got[4][b]) == 0 and int(got[4][b + 3]) == 0

    elif case == "above_max":  # inserts above the last node's max (the onn_c clamp)
        mk = st.mkba.cpu().numpy()
        picks = [bb for bb in range(1, nb - 1, max(1, nb // 40)) if nn[bb] > 0]
        tops = np.array([int(st.node_max[bb, nn[bb] - 1]) for bb in picks], np.int32)
        st = tcore.delete(st, torch.as_tensor(np.sort(tops), device=device))[0]
        nn = st.num_nodes.cpu().numpy()
        groups = [(ins, [tcore.MAX_VALID - 3], None)]
        for bb, old in zip(picks, tops):
            top = int(st.node_max[bb, nn[bb] - 1]) if nn[bb] else int(mk[bb - 1])
            groups += [(ins, rng.choice(np.arange(top + 1, int(old) + 1), min(3, int(old) - top),
                                        replace=False), None),
                       (pt, [int(old)], None), (succ, [top + 1], None)]

        def premise(got, r):
            assert len(picks) >= 20

    else:  # "edge_keys": keys 0 and MAX_VALID, values NOT_FOUND
        miss = tcore.NOT_FOUND
        groups = [(ins, [0, tcore.MAX_VALID], [miss, miss]),
                  (ins, rng.integers(0, 1 << 26, 100), np.full(100, miss)),
                  (pt, [1, tcore.MAX_VALID - 1, EMPTY], None),
                  (succ, [2, tcore.MAX_VALID - 2], None), (pt, rng.choice(live, 50), None)]

        def premise(got, r):
            assert int(got[7].eq(miss).sum()) > 0

    return st, _sorted_ops(groups, device), premise


@pytest.mark.cuda
@pytest.mark.parametrize("case", STAGED_CASES)
@pytest.mark.parametrize("ns,npb", EDGE_GEOMETRIES)
def test_staged_kernel_matches_single_buffer_and_plain_on_card(cuda, ns, npb, case):
    """The warp-per-bucket staged kernel computes the single-buffer kernel's
    function: a mixed batch on a state with emptied buckets, an insert flood
    that overflows a bucket (the pre-retry outputs equal too), op slices
    longer than a warp, inserts into emptied buckets and above the last
    node's max, buckets emptied by deletes, a full bucket that one insert
    overflows, the boundary keys and NOT_FOUND as a value."""
    st, ops_, premise = stripe_case(ns, npb, case, cuda)
    args, r = fa.stripe_inputs(st, ops_.tag, ops_.key, ops_.val)
    args = list(args)
    before = dict(LAUNCHES)
    got = fa.flix_apply_staged_pass(st.num_nodes, *args)
    torch.cuda.synchronize()
    assert LAUNCHES["flix_apply_staged"] == before["flix_apply_staged"] + 1
    _equal(fa.flix_apply_pass(*args), got, f"staged vs single ({case})")
    _equal(fa.flix_apply_reference(*args), got, f"staged vs plain ({case})")
    premise(got, r)


def _planes(st):
    """Copies of the four planes a donated pass writes."""
    return [st.keys.clone(), st.vals.clone(), st.node_count.clone(), st.node_max.clone()]


def _donated(st, args, val, planes, flag=None, block_b=0):
    """The donated pass (kernel on the card, plain version on the CPU) on
    ``planes`` (keys, vals, node_count, node_max), written in place."""
    from repro_torch.core.query import _bucket_index

    k, v, cnt, mx = planes
    dev = k.device
    nr = (st.needs_restructure if flag is None else flag).to(dev)
    b = _bucket_index(st, args[11].to(st.device)).to(dev)
    rest = [a.to(dev) for a in args[3:]]
    return fa.flix_apply_inplace_pass(st.num_nodes.to(dev), cnt, nr, val.to(dev), b, k, v, mx,
                                      *rest, block_b=block_b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", STAGED_CASES)
@pytest.mark.parametrize("ns,npb", EDGE_GEOMETRIES)
def test_donated_pass_matches_staged_and_plain_on_card(cuda, ns, npb, case):
    """The donated pass (plan and in-place write) on the staged kernel's
    edge cases: byte for byte its plain version, outputs and the planes it
    writes; where no bucket overflows, the functional staged pass's keys,
    counts, node max, num_nodes, reads and live values, with the inserts
    and deletes its stats count; where one does (flood, full bucket), the
    planes untouched and the overflow counted."""
    st, ops_, _ = stripe_case(ns, npb, case, cuda)
    args, r = fa.stripe_inputs(st, ops_.tag, ops_.key, ops_.val)
    args = list(args)
    want = fa.flix_apply_staged_pass(st.num_nodes, *args)
    _equal(fa.flix_apply_pass(*args), want, f"staged vs single ({case})")
    before = dict(LAUNCHES)
    planes = _planes(st)
    got = _donated(st, args, ops_.val, planes)
    torch.cuda.synchronize()
    assert LAUNCHES["flix_apply_staged_inplace"] == before["flix_apply_staged_inplace"] + 1
    assert LAUNCHES["flix_apply_staged"] == before["flix_apply_staged"]
    cpu = [t.cpu() for t in _planes(st)]
    plain = _donated(st, [a.cpu() for a in args], ops_.val, cpu)
    _equal(plain, [t.cpu() for t in got], f"donated vs plain ({case})")
    _equal(cpu, [t.cpu() for t in planes], f"donated planes vs plain ({case})")
    true_counts = r.ins_ends - r.ins_starts
    overflowed = int(((want[5] > 0) | (true_counts > ns * npb)).sum())
    counts = got[3].tolist()
    assert counts[0] == int(torch.clamp(true_counts, max=ns * npb).sum())
    assert counts[2] == overflowed
    if overflowed:
        _equal(_planes(st), planes, f"overflow leaves the planes ({case})")
        assert counts[1] == 0 and torch.equal(got[0], st.num_nodes)
        return
    live = want[0] != EMPTY
    assert counts[1] == int(want[6].sum())
    for i, j in ((0, 0), (2, 2), (3, 3)):
        assert torch.equal(planes[i], want[j]), (case, i)
    assert torch.equal(planes[1][live], want[1][live])
    _equal(want[4:5] + want[7:9], got[:3], f"donated counts and reads ({case})")


@pytest.mark.cuda
@pytest.mark.parametrize("ns,npb", [(32, 16), (4, 2)])
def test_donated_pass_writes_nothing_on_a_flagged_state_on_card(cuda, ns, npb):
    """A state already flagged ``needs_restructure``: the donated pass
    writes no byte of its planes, at any warps a block, and still counts."""
    st, ops_, _ = stripe_case(ns, npb, "mixed", cuda)
    args = list(fa.stripe_inputs(st, ops_.tag, ops_.key, ops_.val)[0])
    flag = torch.ones((), dtype=torch.bool, device=cuda)
    for w in (0, 1, 8):
        planes = _planes(st)
        got = _donated(st, args, ops_.val, planes, flag=flag, block_b=w)
        torch.cuda.synchronize()
        _equal(_planes(st), planes, f"flagged state, {w} warps")
        assert int(got[3][1]) == 0 and int(got[3][0]) > 0
        assert bool((got[1] == tcore.NOT_FOUND).all()) and torch.equal(got[0], st.num_nodes)


@pytest.mark.cuda
def test_engine_donates_and_matches_functional_on_card(cuda):
    """``apply_ops_safe`` donates by default on the card: three mixed
    batches in a row, each on the state the last one wrote in place, equal
    plane for plane and result for result to the functional path on its own
    copy, the donated kernel launched instead of the functional one."""
    rng = np.random.default_rng(21)
    st, _ = _random_case(rng, 1 << 16, 32, 16, cuda)
    copy = tcore.FliXState(*_planes(st), st.num_nodes.clone(), st.mkba, st.needs_restructure)
    cfg = tcore.ExecConfig(max_results=4096)
    for i in range(3):
        ops_ = _random_case(rng, 1 << 16, 32, 16, cuda)[1]
        before = dict(LAUNCHES)
        got = tcore.apply_ops_safe(st, ops_, config=cfg)
        assert LAUNCHES["flix_apply_staged_inplace"] == before["flix_apply_staged_inplace"] + 1
        assert LAUNCHES["flix_apply_staged"] == before["flix_apply_staged"]
        assert got[0].keys is st.keys
        want = tcore.apply_ops_safe(copy, ops_, config=cfg.replace(donate=False))
        assert LAUNCHES["flix_apply_staged"] == before["flix_apply_staged"] + 1
        for f in ("keys", "vals", "node_count", "node_max", "num_nodes", "needs_restructure"):
            assert torch.equal(getattr(got[0], f), getattr(want[0], f)), (i, f)
        for k in want[1]:
            assert torch.equal(got[1][k], want[1][k]), (i, k)
        for k in want[2]:
            assert int(got[2][k]) == int(want[2][k]), (i, k)
        st, copy = got[0], want[0]


@pytest.mark.cuda
@pytest.mark.parametrize("ns,npb", [(32, 16), (16, 8), (32, 64), (64, 64)])
def test_staged_kernel_warps_a_block_on_card(cuda, ns, npb):
    """``block_b``, the staged kernel's warps a block: every count of the
    autotuner's candidates whose block fits gives the default launch's
    outputs byte for byte, holds the model's resident warps an SM, and is
    what ``apply_ops`` hands the launch; one that does not fit raises."""
    from repro_torch.kernels import autotune as at

    geo = dict(node_size=ns, nodes_per_bucket=npb)
    st, ops_ = _random_case(np.random.default_rng(ns + npb), 1 << 15, ns, npb, cuda)
    args = list(fa.stripe_inputs(st, ops_.tag, ops_.key, ops_.val)[0])
    want = fa.flix_apply_staged_pass(st.num_nodes, *args)
    _equal(fa.flix_apply_reference(*args), want, "W = 0 vs plain")
    cfg = tcore.ExecConfig(impl="fused", pipeline="on", max_results=4096)
    base = tcore.apply_ops(st, ops_, config=cfg)
    for w in at.CANDIDATE_BLOCK_B:
        if at.smem_bytes(128, w, **geo) > at.SMEM_BUDGET_BYTES:
            with pytest.raises(ValueError, match=rf"npb={npb}, ns={ns}\) with {w} warps"):
                fa.flix_apply_staged_pass(st.num_nodes, *args, block_b=w)
            continue
        before = LAUNCHES["flix_apply_staged"]
        _equal(want, fa.flix_apply_staged_pass(st.num_nodes, *args, block_b=w), f"W={w}")
        assert LAUNCHES["flix_apply_staged"] == before + 1
        assert fa.staged_blocks_per_sm(npb, ns, w, cuda) == at.blocks_per_sm(w, **geo)
        got = tcore.apply_ops(st, ops_, config=cfg.replace(block_b=w))
        for f in ("keys", "vals", "node_count", "node_max", "num_nodes"):
            assert torch.equal(getattr(got[0], f), getattr(base[0], f)), (w, f)
        for k in base[1]:
            assert torch.equal(got[1][k], base[1][k]), (w, k)
    with pytest.raises(ValueError, match="block_b=9"):
        fa.flix_apply_staged_pass(st.num_nodes, *args, block_b=9)


# ---------------------------------------------------------------------------
# the single-buffer stripe kernel's walk (csrc/flix_apply.cu: persistent
# blocks, each taking the buckets b, b + grid, ... through a ring of stages;
# tests/test_torch_stripe_cases.py holds the same cases' plain version
# against the JAX package on the CPU)
# ---------------------------------------------------------------------------

WALK_CASES = ("nb_1", "under_grid", "over_grid", "full_then_emptied", "empty_slot_vals",
              "unaligned_planes")
# EDGE_GEOMETRIES, then ns = 6 (rows in by cp.async: a bulk copy needs a
# multiple of 16 bytes) and ns = npb = 3 (S = 9: stripes out by the threads'
# stores too)
WALK_GEOMETRIES = EDGE_GEOMETRIES + [(6, 4), (3, 3)]
WALK_WIDTH = 4  # a bucket's key range, in stripes


def _unaligned(t):
    """A copy of int32 tensor ``t`` laid 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def walk_state(rng, rows, ns, npb, device, junk_vals=False, unaligned=False):
    """A state whose bucket b holds ``len(rows[b])`` active nodes of
    ``rows[b][j]`` keys each, drawn from its range [b·W, (b+1)·W) (W =
    WALK_WIDTH·S).  ``junk_vals`` puts non-zero vals at every EMPTY slot
    (vals there are unspecified); ``unaligned`` lays the key and val planes
    4 bytes past a 16-byte boundary."""
    nb, S = len(rows), ns * npb
    W = WALK_WIDTH * S
    keys = np.full((nb, npb, ns), EMPTY, np.int32)
    vals = (rng.integers(1, 1 << 30, (nb, npb, ns)) if junk_vals
            else np.zeros((nb, npb, ns))).astype(np.int32)
    count = np.zeros((nb, npb), np.int32)
    for b, counts in enumerate(rows):
        k = np.sort(rng.choice(np.arange(b * W + 1, (b + 1) * W), sum(counts), replace=False))
        at = 0
        for j, c in enumerate(counts):
            keys[b, j, :c] = k[at:at + c]
            vals[b, j, :c] = k[at:at + c] ^ 0x2B
            count[b, j] = c
            at += c
    nmax = np.where(count > 0, np.take_along_axis(keys, np.maximum(count - 1, 0)[..., None],
                                                  2)[..., 0], EMPTY).astype(np.int32)
    mkba = (np.arange(1, nb + 1) * W - 1).astype(np.int32)
    mkba[-1] = tcore.MAX_VALID
    arrays = dict(keys=keys, vals=vals, node_count=count, node_max=nmax,
                  num_nodes=np.array([len(c) for c in rows], np.int32), mkba=mkba,
                  needs_restructure=np.zeros((), bool))
    st = tcore.state_from_numpy(arrays, device)
    if unaligned:
        planes = [_unaligned(t) for t in (st.keys, st.vals)]
        st = tcore.FliXState(*planes, *(getattr(st, f) for f in
                                        ("node_count", "node_max", "num_nodes", "mkba",
                                         "needs_restructure")))
    tcore.check_invariants(st)
    return st


def walk_case(ns, npb, case, grid, device):
    """A state, a sorted batch and a check of the case's premise (called with
    the stripe pass's outputs and the routing), for one edge of the
    single-buffer kernel's walk.  ``grid`` is the kernel's persistent grid
    on the card (``fa.flix_apply_grid``), any positive number elsewhere; the
    inputs depend on nothing else."""
    rng = np.random.default_rng(1000 * WALK_CASES.index(case) + 10 * ns + npb)
    S, W = ns * npb, WALK_WIDTH * ns * npb
    nb = {"nb_1": 1, "under_grid": max(grid - 1, 1), "over_grid": grid + 1,
          "full_then_emptied": 8 * grid + 3, "empty_slot_vals": 2 * grid + 1,
          "unaligned_planes": grid + 1}[case]
    if case == "full_then_emptied":  # a block's walk alternates full and emptied buckets
        rows = [[ns] * npb if (b // grid) % 2 == 0 else [] for b in range(nb)]
    elif case == "empty_slot_vals":  # active rows with EMPTY slots
        rows = [[int(c) for c in rng.integers(1, max(ns, 2), rng.integers(1, npb + 1))]
                for _ in range(nb)]
    else:
        rows = [[int(c) for c in rng.integers(1, ns + 1, n)]
                for n in rng.integers(0, npb + 1, nb)]
    st = walk_state(rng, rows, ns, npb, device, junk_vals=case == "empty_slot_vals",
                    unaligned=case == "unaligned_planes")
    live = _stored(st)[0]
    nn = np.array([len(c) for c in rows])
    ins, dele, pt, succ = tcore.OP_INSERT, tcore.OP_DELETE, tcore.OP_POINT, tcore.OP_SUCCESSOR

    def fresh(buckets, n):  # n keys of each bucket's range, not stored
        k = (np.repeat(buckets, n) * W + rng.integers(1, W, len(buckets) * n)).astype(np.int64)
        return np.setdiff1d(k, live)

    every = np.arange(nb)
    groups = [(ins, fresh(rng.choice(every, max(nb // 3, 1)), 2), None),
              (dele, rng.choice(live, min(len(live), nb // 4 + 1), replace=False), None),
              (pt, rng.choice(live, min(len(live), nb // 2 + 1), replace=False), None),
              (pt, fresh(every, 1)[: nb // 3 + 1], None),
              (succ, rng.integers(0, nb * W, nb // 3 + 2), None)]
    if case == "full_then_emptied":
        gone, full = every[nn == 0], every[nn == npb]
        groups = [(ins, fresh(gone[::3], ns + 2), None),  # the update path on nn = 0
                  (ins, fresh(full[1::5], 1), None),  # a full bucket overflows
                  (pt, fresh(gone[1::3], 2), None), (succ, fresh(gone[2::3], 2), None),
                  (dele, _stored(st)[0][(live // W) % 7 == 0], None)] + groups[2:]

    def premise(got, r):
        upd = ((r.ins_ends - r.ins_starts) > 0) | ((r.del_ends - r.del_starts) > 0)
        assert int(got[4].shape[0]) == nb
        if nb > 1:
            assert bool(upd.any()) and not bool(upd.all())  # both paths run
        if case == "full_then_emptied":
            assert int(st.num_nodes[0]) == npb and int(st.num_nodes[grid]) == 0
            assert bool(upd[gone].any()) and not bool(upd[gone].all())
            assert int(got[5].sum()) > 0  # the full buckets that take an insert overflow
        if case == "empty_slot_vals":
            keep = ~upd.cpu().numpy()
            k, v = st.keys.cpu().numpy()[keep], st.vals.cpu().numpy()[keep]
            active = np.arange(npb)[None, :, None] < nn[keep][:, None, None]
            assert ((k == EMPTY) & active & (v != 0)).any()
        if case == "unaligned_planes":
            assert st.keys.data_ptr() % 16 and st.vals.data_ptr() % 16

    return st, _sorted_ops(groups, device), premise


@pytest.mark.cuda
@pytest.mark.parametrize("case", WALK_CASES)
@pytest.mark.parametrize("ns,npb", WALK_GEOMETRIES)
def test_apply_kernel_walk_edges_on_card(cuda, ns, npb, case):
    """The single-buffer kernel on the edges of its persistent walk: one
    bucket; one bucket fewer and one more than the grid holds, so that the
    walk wraps part way; a block's walk alternating full and emptied buckets
    (stale rows in a reused stage); keep-path buckets whose active rows hold
    EMPTY slots with non-zero vals; planes and slice columns off 16-byte
    alignment, and geometries whose rows or stripes no bulk copy may move,
    where the kernel copies by cp.async and its threads' stores and reads
    the slices in place.  Each equals the plain version and the staged
    kernel, byte for byte."""
    st, ops_, premise = walk_case(ns, npb, case, fa.flix_apply_grid(npb, ns, cuda), cuda)
    args, r = fa.stripe_inputs(st, ops_.tag, ops_.key, ops_.val)
    if case == "unaligned_planes":  # the insert keys and op keys too
        args = tuple(_unaligned(t) if i in (3, 11) else t for i, t in enumerate(args))
    want = fa.flix_apply_reference(*args)
    _equal(want, fa.flix_apply_staged_pass(st.num_nodes, *args), f"staged ({case})")
    before = LAUNCHES["flix_apply"]
    got = fa.flix_apply_pass(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["flix_apply"] == before + 1
    _equal(want, got, f"flix_apply ({case})")
    premise(want, r)


# ---------------------------------------------------------------------------
# the point-query kernel's edge cases (tests/test_torch_query_cases.py holds
# the same cases' plain version against the JAX reference on the CPU)
# ---------------------------------------------------------------------------

QUERY_CASES = ("long_slices", "one_bucket", "emptied_buckets", "fences", "edge_keys",
               "not_found_value", "nq_1", "nq_ragged", "nq_below_warps", "every_bucket")
QUERY_BUCKETS = 320  # buckets of every case's state, whatever the geometry
# the fewest buckets a warp of csrc/flix_query.cu owns (kRunMin): at
# QUERY_BUCKETS the kernel runs 5 warps of two fence groups each
RUN_MIN = 64


def _query_state(rng, ns, npb, device, edge_keys=False, miss_vals=False,
                 buckets=QUERY_BUCKETS):
    """``buckets`` buckets built at fill 0.5, then fresh keys inserted so
    that bucket b holds (0, p/2, p+1, 2 ns)[b % 4] more than its p: chains
    of one to several nodes.  Values are key ^ 0x33 (fresh: key ^ 0x55);
    ``edge_keys`` stores keys 0 and MAX_VALID, ``miss_vals`` gives every
    third fresh key the value NOT_FOUND."""
    p = max(1, ns // 2)
    keys = np.sort(rng.choice(1 << 26, buckets * p, replace=False)).astype(np.int64)
    if edge_keys:
        keys[0], keys[-1] = 0, tcore.MAX_VALID
    st = tcore.build(keys, keys ^ 0x33, node_size=ns, nodes_per_bucket=npb, device=device)
    assert st.num_buckets == buckets
    mk = st.mkba.cpu().numpy().astype(np.int64)
    lows = np.concatenate([[0], mk[:-1] + 1])
    fresh = []
    for b in range(buckets):
        m = min((0, p // 2, p + 1, 2 * ns)[b % 4], ns * npb - p)
        cand = np.unique(rng.integers(lows[b], mk[b] + 1, 4 * m + 8))
        fresh.append(np.setdiff1d(cand, keys)[:m])
    fresh = np.concatenate(fresh)
    fv = fresh ^ 0x55
    if miss_vals:
        fv[::3] = tcore.NOT_FOUND
    st, stats = tcore.insert(st, torch.as_tensor(fresh.astype(np.int32), device=device),
                             torch.as_tensor(fv.astype(np.int32), device=device))
    assert int(stats["overflowed_buckets"]) == 0 and not bool(st.needs_restructure)
    return st


def _stored(st):
    """The state's live keys, ascending, and their values."""
    k, v = st.keys.cpu().numpy().reshape(-1), st.vals.cpu().numpy().reshape(-1)
    live = k != EMPTY
    order = np.argsort(k[live], kind="stable")
    return k[live][order], v[live][order]


def _slices(st, q):
    """Queries per bucket (searchsorted left on the fences); the last entry
    counts the queries above the last fence."""
    b = np.searchsorted(st.mkba.cpu().numpy(), q, side="left")
    return np.bincount(b, minlength=st.num_buckets + 1)


def query_case(ns, npb, case, device):
    """A state, a sorted int32 query batch and a check of the case's premise
    (called with the state and the batch), for one edge of the point-query
    kernel; the same inputs on every device."""
    rng = np.random.default_rng(1000 * QUERY_CASES.index(case) + 10 * ns + npb)
    st = _query_state(rng, ns, npb, device, edge_keys=case == "edge_keys",
                      miss_vals=case == "not_found_value")
    nb = st.num_buckets
    live, lv = _stored(st)

    def around(bs, n):  # n random keys in each bucket of bs, hits and misses
        out = []
        for b in bs:
            lo, hi = _bucket_range(st, b)
            mine = live[(live >= lo) & (live <= hi)]
            out += [rng.integers(lo, hi + 1, n)] + ([rng.choice(mine, n)] if len(mine) else [])
        return np.concatenate(out)

    if case == "long_slices":  # one slice over 64 (one key repeated), one over 32
        lo, hi = _bucket_range(st, 37)
        k37 = live[(live >= lo) & (live <= hi)]
        q = np.concatenate([np.repeat(k37[:1], 70), around([101], 20), around(range(0, 300, 9), 2)])

        def premise(st, q):
            c = _slices(st, q)
            assert c[37] > 64 and 32 < c[101] <= 64

    elif case == "one_bucket":  # every query in bucket 150: each key three times, misses
        lo, hi = _bucket_range(st, 150)
        q = np.concatenate([np.repeat(live[(live >= lo) & (live <= hi)], 3),
                            rng.integers(lo, hi + 1, 60)])

        def premise(st, q):
            assert np.count_nonzero(_slices(st, q)) == 1 and len(q) > 64

    elif case == "emptied_buckets":  # every key of buckets 10-13 and 200 deleted
        gone = [10, 11, 12, 13, 200]
        dead = np.concatenate([live[(live >= _bucket_range(st, b)[0])
                                    & (live <= _bucket_range(st, b)[1])] for b in gone])
        st = tcore.delete(st, torch.as_tensor(np.sort(dead).astype(np.int32), device=device))[0]
        q = np.concatenate([dead, around(gone + [9, 14, 199, 201], 6)])

        def premise(st, q):
            nn = st.num_nodes.cpu().numpy()
            assert all(nn[b] == 0 for b in gone) and all(_slices(st, q)[b] > 0 for b in gone)

    elif case == "fences":  # mkba[b] and mkba[b] + 1 (EMPTY after the last fence)
        mk = st.mkba.cpu().numpy().astype(np.int64)
        q = np.concatenate([mk, mk + 1])

        def premise(st, q):
            assert np.isin(st.mkba.cpu().numpy(), q).all() and int(q.max()) == EMPTY

    elif case == "edge_keys":  # keys 0 and MAX_VALID stored; EMPTY - 1 is MAX_VALID
        q = np.concatenate([[0, 0, 1, tcore.MAX_VALID - 1, tcore.MAX_VALID, EMPTY - 1, EMPTY],
                            around([0, nb - 1, 160], 5)])

        def premise(st, q):
            assert {0, tcore.MAX_VALID} <= set(_stored(st)[0][[0, -1]].tolist())

    elif case == "not_found_value":  # stored values equal to NOT_FOUND
        q = np.concatenate([live[lv == tcore.NOT_FOUND][::8], around(range(0, nb, 7), 3)])

        def premise(st, q):
            k, v = _stored(st)
            assert np.isin(k[v == tcore.NOT_FOUND], q).sum() > 10

    elif case == "nq_1":
        q = live[len(live) // 2 : len(live) // 2 + 1]

        def premise(st, q):
            assert len(q) == 1

    elif case == "nq_ragged":  # 77 queries: two windows and a part
        q = np.concatenate([rng.choice(live, 40), rng.integers(0, 1 << 26, 37)])

        def premise(st, q):
            assert len(q) % 32 and len(q) > 64

    elif case == "nq_below_warps":  # 3 queries, in the runs of three of the five warps
        q = np.concatenate([around([b], 1)[:1] for b in (10, 150, 300)])

        def premise(st, q):
            runs = np.searchsorted(st.mkba.cpu().numpy(), q, side="left") // RUN_MIN
            assert len(q) < st.num_buckets // RUN_MIN and len(set(runs.tolist())) == len(q)

    else:  # "every_bucket": each slice non-empty, so windows straddle every run and group
        mk = st.mkba.cpu().numpy().astype(np.int64)
        q = np.concatenate([mk, around(range(nb), 1)])

        def premise(st, q):
            assert _slices(st, q)[:nb].min() > 0

    return st, np.sort(np.asarray(q, np.int64)).astype(np.int32), premise


@pytest.mark.cuda
@pytest.mark.parametrize("case", QUERY_CASES)
@pytest.mark.parametrize("ns,npb", EDGE_GEOMETRIES)
def test_query_kernel_edge_cases_on_card(cuda, ns, npb, case):
    """The run-per-warp point-query kernel equals its plain version and
    core.point_query byte for byte: slices over 32 and 64 queries, every
    query in one bucket, buckets emptied by deletes, queries at and just
    above the fences, keys 0 / MAX_VALID / EMPTY, NOT_FOUND as a stored
    value, one query, a ragged batch, fewer queries than warps, and a
    query in every bucket."""
    st, q, premise = query_case(ns, npb, case, cuda)
    premise(st, q)
    planes = (st.keys, st.vals, st.node_max, st.mkba, torch.as_tensor(q, device=cuda))
    before = LAUNCHES["flix_point_query"]
    got = fq.flix_point_query(*planes)
    torch.cuda.synchronize()
    assert LAUNCHES["flix_point_query"] == before + 1
    assert torch.equal(got, fq.flix_point_query_reference(*planes)), case
    assert torch.equal(got, tcore.point_query(st, planes[-1])), case


# ---------------------------------------------------------------------------
# the successor kernel's edge cases (tests/test_torch_successor_cases.py
# holds the same cases' plain version against the JAX reference on the CPU)
# ---------------------------------------------------------------------------

SUCCESSOR_CASES = QUERY_CASES + ("past_last_key", "empty_run_across_runs", "empty_tail",
                                 "next_head_not_found")


def _tops(st):
    """Each non-empty bucket's largest key (EMPTY for an empty bucket)."""
    nn = st.num_nodes.cpu().numpy().astype(np.int64)
    nm = st.node_max.cpu().numpy()
    top = nm[np.arange(st.num_buckets), np.maximum(nn - 1, 0)].astype(np.int64)
    return np.where(nn > 0, top, EMPTY)


def _fallbacks(st, q):
    """Whether each query lies past its bucket's largest key (so that its
    answer is the bucket's fence row), by the reference's formula."""
    b = np.minimum(np.searchsorted(st.mkba.cpu().numpy(), q, side="left"), st.num_buckets - 1)
    nidx = (st.node_max.cpu().numpy()[b] < np.asarray(q)[:, None]).sum(1)
    return nidx >= st.num_nodes.cpu().numpy()[b]


def _empty_buckets(st, bs, device):
    """``st`` with every key of the buckets ``bs`` deleted, and those keys."""
    live, _ = _stored(st)
    dead = np.concatenate([live[(live >= _bucket_range(st, b)[0])
                                & (live <= _bucket_range(st, b)[1])] for b in bs])
    dead = np.sort(dead).astype(np.int32)
    return tcore.delete(st, torch.as_tensor(dead, device=device))[0], dead


def _drop_tops(st, bs, device):
    """``st`` with the largest key of each bucket of ``bs`` that holds two or
    more deleted, so that those buckets' fences lie above their keys."""
    nc = st.node_count.cpu().numpy().sum(1)
    bs = np.asarray(bs)[nc[bs] > 1]
    top = np.sort(_tops(st)[bs]).astype(np.int32)
    return tcore.delete(st, torch.as_tensor(top, device=device))[0]


def _past_tops(st, bs):
    """For each bucket of ``bs`` whose largest key lies below its fence, the
    key one above it and the fence itself: queries past the bucket's keys."""
    top, mk = _tops(st)[bs], st.mkba.cpu().numpy()[bs].astype(np.int64)
    below = top < mk
    return np.concatenate([top[below] + 1, mk[below]])


def successor_case(ns, npb, case, device):
    """A state, a sorted int32 query batch and a check of the case's premise
    (called with the state and the batch), for one edge of the successor
    kernel: the point-query kernel's ten cases, then queries that all fall
    to the fence rows, a run of emptied buckets longer than two warps' runs,
    an emptied tail, and fence rows whose key is stored with the value
    NOT_FOUND.  The same inputs on every device."""
    if case in QUERY_CASES:
        return query_case(ns, npb, case, device)
    rng = np.random.default_rng(2000 * SUCCESSOR_CASES.index(case) + 10 * ns + npb)
    st = _query_state(rng, ns, npb, device)
    nb = st.num_buckets

    def inside(bs, n):  # n random keys of each bucket's range
        return np.concatenate([rng.integers(*_bucket_range(st, b), n, endpoint=True)
                               for b in bs])

    if case == "past_last_key":  # one above each bucket's largest key, and the fence
        st = _drop_tops(st, np.arange(nb), device)
        q = _past_tops(st, np.arange(nb))

        def premise(st, q):
            assert len(q) > nb and _fallbacks(st, q).all()

    elif case == "empty_run_across_runs":  # buckets 100-239 emptied: three runs
        gone = list(range(100, 100 + 2 * RUN_MIN + 12))
        st, dead = _empty_buckets(st, gone, device)
        top = int(_tops(st)[99])
        some = dead[:: max(1, len(dead) // 200)]
        q = np.concatenate([some, inside(gone[::5], 2), inside([99], 20),
                            [top, top + 1, _bucket_range(st, 99)[1]]])

        def premise(st, q):
            nn = st.num_nodes.cpu().numpy()
            c = _slices(st, q)
            assert (nn[gone] == 0).all() and nn[99] > 0 and nn[gone[-1] + 1] > 0
            assert (c[gone[::5]] > 0).all() and c[99] > 0
            assert len(gone) > 2 * RUN_MIN

    elif case == "empty_tail":  # every bucket from nb - 40 on emptied
        gone = list(range(nb - 40, nb))
        st, dead = _empty_buckets(st, gone, device)
        top = int(_tops(st)[nb - 41])
        some = dead[:: max(1, len(dead) // 200)]
        q = np.concatenate([some, inside(gone, 2), inside([nb - 41], 20),
                            [top, top + 1, tcore.MAX_VALID, EMPTY]])

        def premise(st, q):
            nn = st.num_nodes.cpu().numpy()
            assert (nn[gone] == 0).all() and nn[nb - 41] > 0
            assert (_slices(st, q)[gone] > 0).all()
            assert _fallbacks(st, q)[q > top].all()

    else:  # "next_head_not_found": every third bucket's head stored with NOT_FOUND
        heads = st.keys[2::3, 0, 0].cpu().numpy()
        heads = np.sort(heads[heads != EMPTY])
        st = tcore.insert(st, torch.as_tensor(heads, device=device),
                          torch.full((len(heads),), tcore.NOT_FOUND, dtype=torch.int32,
                                     device=device))[0]
        prev = np.arange(1, nb - 1, 3)  # the buckets before them
        st = _drop_tops(st, prev, device)
        q = _past_tops(st, prev)

        def premise(st, q):
            k, v = _stored(st)
            nxt = k[np.searchsorted(k, q)]  # each query's successor
            assert _fallbacks(st, q).all() and len(q) > nb // 6
            assert (v[np.searchsorted(k, nxt)] == tcore.NOT_FOUND).all()

    return st, np.sort(np.asarray(q, np.int64)).astype(np.int32), premise


@pytest.mark.cuda
@pytest.mark.parametrize("case", SUCCESSOR_CASES)
@pytest.mark.parametrize("ns,npb", EDGE_GEOMETRIES)
def test_successor_kernel_edge_cases_on_card(cuda, ns, npb, case):
    """The run-per-warp successor kernel, after the fence-row kernel, equals
    its plain version and core.successor_query byte for byte: the
    point-query kernel's edges, queries past every bucket's largest key,
    140 emptied buckets in a row, an emptied tail and fence rows whose
    value is NOT_FOUND."""
    st, q, premise = successor_case(ns, npb, case, cuda)
    premise(st, q)
    planes = (st.keys, st.vals, st.node_max, st.mkba, torch.as_tensor(q, device=cuda))
    before = dict(LAUNCHES)
    got = fs.flix_successor(*planes)
    torch.cuda.synchronize()
    assert LAUNCHES["flix_successor"] == before["flix_successor"] + 1
    assert LAUNCHES["flix_fence_rows"] == before["flix_fence_rows"] + 1
    _equal(fs.flix_successor_reference(*planes), got, f"flix_successor ({case})")
    _equal(tcore.successor_query(st, planes[-1]), got, f"successor vs core ({case})")


# ---------------------------------------------------------------------------
# the fence-row kernel (tests/test_torch_successor_cases.py holds next_rows
# against the Pallas wrapper's rows on the CPU)
# ---------------------------------------------------------------------------

FENCE_CASES = ("random", "equal_heads", "empty_buckets", "all_empty", "empty_tail", "nb_1")


def fence_case(case, ns, npb, device, nb=300):
    """Planes as a state holds them, a bucket's active node_max entries
    first, with random non-monotone heads: ``(keys3d, vals3d, node_max,
    num_nodes)``.  Empty buckets keep junk keys, which the rows must
    ignore."""
    rng = np.random.default_rng(100 * FENCE_CASES.index(case) + 10 * ns + npb + nb)
    nb = 1 if case == "nb_1" else nb
    keys = rng.integers(0, tcore.MAX_VALID, (nb, npb, ns), endpoint=True).astype(np.int32)
    vals = rng.integers(-(1 << 31), 1 << 31, (nb, npb, ns)).astype(np.int32)
    active = rng.integers(1, npb + 1, nb)
    if case == "equal_heads":  # few distinct heads, 0 and MAX_VALID among them
        keys[:, 0, 0] = rng.choice([0, 7, 1000, tcore.MAX_VALID], nb)
        active[rng.random(nb) < 0.2] = 0
    elif case == "empty_buckets":  # scattered, and runs longer than a tile
        active[rng.random(nb) < 0.4] = 0
        for a in rng.integers(0, nb, 4):
            active[a : a + min(nb // 8, 3000)] = 0
    elif case == "all_empty":
        active[:] = 0
    elif case == "empty_tail":
        active[-min(40, nb - 1):] = 0
    nm = rng.integers(0, tcore.MAX_VALID, (nb, npb), endpoint=True).astype(np.int32)
    nm = np.where(np.arange(npb) < active[:, None], nm, EMPTY).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (keys, vals, nm, active.astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", FENCE_CASES)
@pytest.mark.parametrize("nb", [300, (1 << 20) + 3])  # the second: no multiple of a tile
def test_fence_rows_kernel_on_card(cuda, case, nb):
    """The fence-row kernel equals next_rows byte for byte, from node_max
    (flix_successor) and from num_nodes (the fused apply), one launch each."""
    keys, vals, nm, nn = fence_case(case, 4, 2, cuda, nb)
    for kw in (dict(node_max=nm), dict(num_nodes=nn)):
        before = LAUNCHES["flix_fence_rows"]
        got = fs.fence_rows(keys, vals, **kw)
        torch.cuda.synchronize()
        assert LAUNCHES["flix_fence_rows"] == before + 1
        _equal(fs.next_rows(keys, vals, **kw), got, f"fence rows ({case}, {list(kw)})")


# ---------------------------------------------------------------------------
# the insert and delete kernels' edge cases (tests/test_torch_update_cases.py
# holds the same cases' plain versions against the JAX package on the CPU)
# ---------------------------------------------------------------------------

UPDATE_CASES = ("flood", "long_slices", "emptied_bucket", "delete_all", "full_bucket",
                "above_max", "edge_keys", "delete_repeats", "not_found_value", "n_0", "n_1")
UPDATE_BUCKETS = 32  # buckets of every case's state, whatever the geometry
# the most insert or delete entries csrc/flix_insert.cu and flix_delete.cu
# stage with a bucket; longer slices are read in place
RING_CAP = 32


def _fresh(rng, st, b, n):
    """n distinct keys of bucket b's range that the state does not hold."""
    lo, hi = _bucket_range(st, b)
    live = _stored(st)[0]
    cand = np.setdiff1d(np.unique(rng.integers(lo, hi + 1, 4 * n + 64)), live)
    assert len(cand) >= n
    return rng.choice(cand, n, replace=False)


def _per_bucket(st, keys):
    """Entries of the sorted keys in each bucket's slice."""
    return np.bincount(np.searchsorted(st.mkba.cpu().numpy(), keys, side="left"),
                       minlength=st.num_buckets + 1)[: st.num_buckets]


def prefilter(st, dk):
    """flix_delete's cut of a sorted delete batch to the keys a point query
    finds, re-sorted with EMPTY in place of the rest (the plain version)."""
    planes = (st.keys, st.vals, st.node_max, st.mkba)
    present = fq.flix_point_query_reference(*planes, dk) != tcore.NOT_FOUND
    return torch.sort(torch.where(present, dk, EMPTY), stable=True).values


def update_case(ns, npb, case, device):
    """A state, a sorted insert batch ``(keys, vals)``, a sorted delete
    batch and a check of the case's premise (called with the state, the
    insert keys, the pre-filtered delete batch and the insert and delete
    passes' outputs), for one edge of the insert and delete kernels; the
    same inputs on every device.  The state holds I1-I5 (checked here), as
    every state the entry points receive does."""
    rng = np.random.default_rng(2000 * UPDATE_CASES.index(case) + 10 * ns + npb)
    st = _query_state(rng, ns, npb, device, edge_keys=case == "edge_keys",
                      miss_vals=case == "not_found_value", buckets=UPDATE_BUCKETS)
    S, nb, ins_grp, del_grp = ns * npb, st.num_buckets, [], []

    def mine(b):
        lo, hi = _bucket_range(st, b)
        live = _stored(st)[0]
        return live[(live >= lo) & (live <= hi)]

    def premise(st, ik, dkf, ins, dele):
        pass

    if case == "flood":  # cap + 40 keys into bucket 5: pieces past npb and the cut at cap
        ins_grp.append((_fresh(rng, st, 5, S + 40), None))

        def premise(st, ik, dkf, ins, dele):
            assert int(ins[5][5]) == 2

    elif case == "long_slices":  # both slices longer than the ring stages
        ins_grp.append((_fresh(rng, st, 1, RING_CAP + 8), None))
        full = mine(7)  # 7 % 4 == 3: the bucket with the most keys
        del_grp.append(np.repeat(full, -(-(RING_CAP + 1) // len(full))))

        def premise(st, ik, dkf, ins, dele):
            assert _per_bucket(st, ik)[1] > RING_CAP
            assert _per_bucket(st, dkf.cpu().numpy())[7] > RING_CAP

    elif case == "emptied_bucket":  # buckets 3 and 4 emptied by deletes, then inserts
        dead = np.concatenate([mine(3), mine(4)]).astype(np.int32)
        st = tcore.delete(st, torch.as_tensor(np.sort(dead), device=device))[0]
        ins_grp += [(_fresh(rng, st, 3, ns + 3), None), (_fresh(rng, st, 4, 1), None)]
        del_grp.append(dead[:5])  # absent now

        def premise(st, ik, dkf, ins, dele):
            nn = st.num_nodes.cpu().numpy()
            assert nn[3] == 0 and nn[4] == 0
            assert int(ins[4][3]) > 0 and int(ins[4][4]) == 1 and int(dele[4][3]) == 0

    elif case == "delete_all":  # every key of buckets 6 and 7
        del_grp += [mine(6), mine(7)]

        def premise(st, ik, dkf, ins, dele):
            assert int(st.num_nodes[7]) > 1 and int(dele[4][6]) == 0 and int(dele[4][7]) == 0

    elif case == "full_bucket":  # bucket 8 (one node) filled to every slot, then one more key
        add = _fresh(rng, st, 8, S - len(mine(8)) + 1)
        st = tcore.insert(st, torch.as_tensor(np.sort(add[1:]).astype(np.int32), device=device),
                          torch.as_tensor(np.sort(add[1:]).astype(np.int32), device=device))[0]
        ins_grp.append((add[:1], None))

        def premise(st, ik, dkf, ins, dele):
            assert int(st.num_nodes[8]) == npb and int(st.node_count[8].sum()) == S
            assert int(ins[5][8]) == 1

    elif case == "above_max":  # keys above each bucket's last node max (the onn_c clamp)
        nn = st.num_nodes.cpu().numpy()
        olds = [int(st.node_max[b, nn[b] - 1]) for b in range(1, 13)]  # the fences, at build
        st = tcore.delete(st, torch.as_tensor(np.array(olds, np.int32), device=device))[0]
        nn = st.num_nodes.cpu().numpy()
        tops = []
        for b, old in zip(range(1, 13), olds):
            top = int(st.node_max[b, nn[b] - 1]) if nn[b] else int(st.mkba[b - 1])
            above = np.unique(rng.integers(top + 1, old + 1, 8))[:2]
            assert len(above) == 2
            ins_grp.append((above, None))
            tops.append(top)

        def premise(st, ik, dkf, ins, dele):
            b = np.searchsorted(st.mkba.cpu().numpy(), ik, side="left")
            sel = (b >= 1) & (b < 13)
            assert sel.sum() == 24 and (ik[sel] > np.repeat(tops, 2)).all()

    elif case == "edge_keys":  # keys 0 and MAX_VALID stored, upserted and deleted
        ins_grp += [([0, tcore.MAX_VALID], [11, 12]), (_fresh(rng, st, nb // 2, 3), None)]
        del_grp.append([0, tcore.MAX_VALID])

        def premise(st, ik, dkf, ins, dele):
            assert {0, tcore.MAX_VALID} <= set(_stored(st)[0][[0, -1]].tolist())
            assert {0, tcore.MAX_VALID} <= set(dkf.cpu().numpy().tolist())

    elif case == "delete_repeats":  # a slice of present keys past cap: only its first cap count
        full = mine(11)
        del_grp.append(np.repeat(full, S // len(full) + 2))

        def premise(st, ik, dkf, ins, dele):
            assert _per_bucket(st, dkf.cpu().numpy())[11] > S
            assert 0 < int(dele[2][11].sum()) < int(st.node_count[11].sum())

    elif case == "not_found_value":  # stored NOT_FOUND values: never deleted; upserts to it
        k, v = _stored(st)
        miss = k[v == tcore.NOT_FOUND]
        del_grp.append(miss)
        ins_grp.append((k[v != tcore.NOT_FOUND][::7], np.full(len(k[v != tcore.NOT_FOUND][::7]),
                                                              tcore.NOT_FOUND)))

        def premise(st, ik, dkf, ins, dele):
            assert len(miss) > 5 and not np.isin(miss, dkf.cpu().numpy()).any()
            assert np.isin(miss, _stored(tcore.FliXState(*dele, st.mkba,
                                                         st.needs_restructure))[0]).all()

    elif case == "n_1":  # one insert, one delete
        ins_grp.append((_fresh(rng, st, 9, 1), None))
        del_grp.append(mine(10)[:1])

        def premise(st, ik, dkf, ins, dele):
            assert len(ik) == 1 and len(dkf) == 1 and int(dele[2][10].sum()) == int(
                st.node_count[10].sum()) - 1

    else:  # "n_0": an empty batch of each kind

        def premise(st, ik, dkf, ins, dele):
            assert len(ik) == 0 and len(dkf) == 0

    if case not in ("n_0", "n_1"):  # other buckets take a few updates too
        ins_grp += [(_fresh(rng, st, b, 1), None) for b in range(16, nb, 3)]
        del_grp += [mine(b)[:1] for b in range(17, nb, 5)] + [rng.integers(0, 1 << 26, 5)]
    k = np.concatenate([np.asarray(k, np.int64) for k, _ in ins_grp] + [np.zeros(0, np.int64)])
    v = np.concatenate([np.asarray(k, np.int64) * 3 + 1 if v is None else np.asarray(v, np.int64)
                        for k, v in ins_grp] + [np.zeros(0, np.int64)])
    k, first = np.unique(k, return_index=True)
    dk = np.sort(np.concatenate([np.asarray(d, np.int64) for d in del_grp]
                                + [np.zeros(0, np.int64)]))
    tcore.check_invariants(st)
    return st, (k.astype(np.int32), v[first].astype(np.int32)), dk.astype(np.int32), premise


@pytest.mark.cuda
@pytest.mark.parametrize("case", UPDATE_CASES)
@pytest.mark.parametrize("ns,npb", EDGE_GEOMETRIES)
def test_update_kernel_edge_cases_on_card(cuda, ns, npb, case):
    """The warp-per-bucket insert and delete kernels equal their plain
    versions byte for byte: a flood past cap, slices longer than the ring
    stages, buckets emptied by deletes, deleting every key of a bucket, a
    full bucket that one insert overflows, inserts above the last node max,
    keys 0 and MAX_VALID, delete keys repeated past cap, stored NOT_FOUND
    values, and batches of 0 and 1."""
    st, (ik, iv), dk, premise = update_case(ns, npb, case, cuda)
    ik, iv = torch.as_tensor(ik, device=cuda), torch.as_tensor(iv, device=cuda)
    dkf = prefilter(st, torch.as_tensor(dk, device=cuda))
    ins_args = (st.num_nodes, st.keys, st.vals, st.node_max, st.mkba, ik, iv)
    del_args = (st.num_nodes, st.keys, st.vals, st.mkba, dkf)
    before = dict(LAUNCHES)
    ins = fi.flix_insert_pass(*ins_args)
    dele = fd.flix_delete_pass(*del_args)
    torch.cuda.synchronize()
    assert LAUNCHES["flix_insert"] == before["flix_insert"] + 1
    assert LAUNCHES["flix_delete"] == before["flix_delete"] + 1
    _equal(fi.flix_insert_reference(*ins_args), ins, f"flix_insert ({case})")
    _equal(fd.flix_delete_reference(*del_args), dele, f"flix_delete ({case})")
    premise(st, ik.cpu().numpy(), dkf, ins, dele)


@pytest.mark.cuda
def test_pipeline_on_launches_the_staged_kernel(cuda):
    st, ops_ = _random_case(np.random.default_rng(15), 1 << 15, 32, 16, cuda)
    cfg = tcore.ExecConfig(impl="fused", max_results=4096)
    before = dict(LAUNCHES)
    on = tcore.apply_ops_safe(st, ops_, config=cfg.replace(pipeline="on", donate=False))
    assert LAUNCHES["flix_apply_staged"] == before["flix_apply_staged"] + 1
    assert LAUNCHES["flix_apply"] == before["flix_apply"]
    off = tcore.apply_ops_safe(st, ops_, config=cfg.replace(pipeline="off"))
    assert LAUNCHES["flix_apply"] == before["flix_apply"] + 1
    for f in ("keys", "vals", "node_count", "node_max", "num_nodes"):
        assert torch.equal(getattr(on[0], f), getattr(off[0], f)), f
    for k in on[1]:
        assert torch.equal(on[1][k], off[1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("ns,npb", GEOMETRIES)
def test_range_kernels_match_plain_on_card(cuda, ns, npb):
    """Both passes of flix_range against their plain versions, and the scan
    against dense_range_scan: fences, inverted ranges, emptied buckets,
    truncation."""
    from repro_torch.core.query import live_prefix

    rng = np.random.default_rng(11 * ns + npb)
    st, live = _state_with_holes(rng, ns, npb, cuda)
    mk = st.mkba[:-1].cpu().numpy().astype(np.int64)
    lo = np.concatenate([mk[::97], mk[::97] + 1, live[990:1010], rng.integers(0, 1 << 26, 3000)])
    hi = np.concatenate([mk[::97] + 1, mk[::97] - 3, live[990:1010] + 50000,
                         lo[-3000:] + rng.integers(-1000, 1 << 16, 3000)])
    order = np.argsort(lo, kind="stable")
    lo_t = torch.as_tensor(lo[order].astype(np.int32), device=cuda)
    hi_t = torch.as_tensor(np.clip(hi[order], 0, EMPTY).astype(np.int32), device=cuda)
    pref = live_prefix(st.node_count)
    meta = (st.keys, st.node_count, st.node_max, st.mkba, pref, lo_t, hi_t)
    _equal(fr.flix_range_count_reference(*meta), fr.flix_range_count(*meta), "range count")
    many_lo = torch.randint(0, 1 << 26, (RANGE_K2_SIZE,), device=cuda, dtype=torch.int32)
    many = (*meta[:5], many_lo, many_lo + torch.randint_like(many_lo, -100, 1 << 14))
    _equal(fr.flix_range_count_reference(*many), fr.flix_range_count(*many),
           f"range count of {RANGE_K2_SIZE} ops")
    for n in (1 << 14, RANGE_K2_SIZE):
        g = torch.sort(torch.randint(-1, int(pref[-1]), (n,), device=cuda,
                                     dtype=torch.int32)).values
        gargs = (g, pref, st.node_count, st.keys, st.vals)
        _equal(fr.flix_range_gather_reference(*gargs), fr.flix_range_scatter(*gargs),
               f"scatter of {n} slots")
    is_range = torch.ones(lo_t.shape, dtype=torch.bool, device=cuda)
    for budget in (1024, 1 << 22):
        before = dict(LAUNCHES)
        got = fr.flix_range(st.keys, st.vals, st.mkba, lo_t, hi_t, max_results=budget)
        assert LAUNCHES["flix_range_count"] == before["flix_range_count"] + 1
        assert LAUNCHES["flix_range_scatter"] == before["flix_range_scatter"] + 1
        want = tcore.dense_range_scan(st, is_range, lo_t, hi_t, max_results=budget)
        _equal(want, got, f"flix_range @ {budget}")
        assert (int(got[4]) > 0) == (budget == 1024)


# ---------------------------------------------------------------------------
# the range kernels' edge cases (tests/test_torch_range_cases.py holds the
# same cases' plain versions against the JAX package on the CPU)
# ---------------------------------------------------------------------------

RANGE_CASES = ("bucket_fences", "emptied_run", "lo_ge_hi", "edge_keys", "all_overlap",
               "odd_budget", "empty_state", "nb_1", "nb_1023", "nb_1025", "masked")
RANGE_BUDGET = 1 << 16  # holds every case's results but odd_budget's
ODD_BUDGET = 517  # no multiple of 32, below odd_budget's results
# csrc/flix_range.cu's kernels take 1, 2 or 4 ops or slots a thread, the
# fewest that fit the card's resident threads in one wave: on an H100 (132
# SMs of 2048 threads) this many ops or slots take 2, where the cases' own
# take 1 and flix_range's 2^22 takes 4; odd, so a thread's last slot is alone
RANGE_K2_SIZE = (1 << 19) - 3


def in_range(st, lo, hi):
    """Stored keys in each ``[lo, hi)``, from the state's sorted keys."""
    k, _ = _stored(st)
    return np.maximum(np.searchsorted(k, hi) - np.searchsorted(k, lo), 0)


def range_case(ns, npb, case, device):
    """A state, a sorted int32 ``lo`` column, an aligned ``hi``, a budget,
    an ``is_range`` mask (None: every op a RANGE op) and a check of the
    case's premise (called with those five), for one edge of the range
    kernels; the same inputs on every device."""
    rng = np.random.default_rng(3000 * RANGE_CASES.index(case) + 10 * ns + npb)
    buckets = {"nb_1": 1, "nb_1023": 1023, "nb_1025": 1025}.get(case, QUERY_BUCKETS)
    st = _query_state(rng, ns, npb, device, edge_keys=case == "edge_keys", buckets=buckets)
    nb = st.num_buckets
    mk = st.mkba.cpu().numpy().astype(np.int64)
    budget, mask = RANGE_BUDGET, None

    def inside(bs, n):  # n random keys of each bucket's range
        return np.concatenate([rng.integers(*_bucket_range(st, b), n, endpoint=True)
                               for b in bs])

    def fits(st, lo, hi, budget, mask):
        return in_range(st, lo, hi)[mask if mask is not None else slice(None)].sum() <= budget

    if case == "bucket_fences":  # bounds on, below and above the fences
        b = np.arange(0, nb - 2, 2)
        lo = np.concatenate([mk[b], mk[b] + 1, mk[b] - 1, mk[b], mk[b] + 1])
        hi = np.concatenate([mk[b] + 1, mk[b + 1], mk[b] + 1, mk[b + 1] + 1, mk[b + 2]])

        def premise(st, lo, hi, budget, mask):
            assert np.isin(mk[:-2:2], lo).all() and np.isin(mk[1:-1:2], hi).all()
            assert fits(st, lo, hi, budget, mask)

    elif case == "emptied_run":  # buckets 100-239 emptied: 140 equal pref entries in a row
        gone = list(range(100, 240))
        st, _ = _empty_buckets(st, gone, device)
        inner = inside(gone[::7], 2)
        across = inside([95, 97, 99], 3)
        lo = np.concatenate([inner, inner, across, inside(gone[::20], 1)])
        hi = np.concatenate([inner + 5000, np.full(len(inner), mk[gone[-1]] + 1),
                             inside([241, 260, 300], 3), inside([245], len(gone[::20]))])

        def premise(st, lo, hi, budget, mask):
            nn = st.num_nodes.cpu().numpy()
            c = in_range(st, lo, hi)
            assert (nn[gone] == 0).all() and len(gone) > 4 * 32  # over four fence groups
            over = (lo <= mk[gone[0] - 1]) & (hi > mk[gone[-1] + 1])  # across the run
            assert over.sum() >= 9 and (c[over] > 0).all() and (c == 0).sum() > 10
            assert fits(st, lo, hi, budget, mask)

    elif case == "lo_ge_hi":  # hi <= lo, among a few true ranges
        lo = np.sort(rng.integers(0, 1 << 26, 600))
        hi = lo - rng.integers(0, 3000, 600)
        hi[::4] = lo[::4]
        hi[::25] = lo[::25] + rng.integers(1, 1 << 16, len(lo[::25]))

        def premise(st, lo, hi, budget, mask):
            assert (hi <= lo).sum() > 500 and (hi == lo).sum() > 100
            assert (in_range(st, lo, hi)[hi > lo] > 0).any()

    elif case == "edge_keys":  # bounds at 0, EMPTY - 1 (MAX_VALID) and EMPTY
        first = inside([0], 10)
        lo = np.concatenate([[0, 0, 0, 1, EMPTY - 1, EMPTY - 1, EMPTY, EMPTY],
                             mk[-3:], inside([nb - 1], 20), first])
        hi = np.concatenate([[0, 1, EMPTY, EMPTY, EMPTY - 1, EMPTY, EMPTY, 0],
                             np.full(23, EMPTY), first + 3000])

        def premise(st, lo, hi, budget, mask):
            assert {0, tcore.MAX_VALID} <= set(_stored(st)[0][[0, -1]].tolist())
            assert {0, EMPTY - 1, EMPTY} <= set(lo.tolist()) & set(hi.tolist())
            assert fits(st, lo, hi, budget, mask)

    elif case == "all_overlap":  # one wide range, then narrow ranges inside it
        a, z = _bucket_range(st, 20)[0], mk[300]
        narrow = np.sort(rng.integers(a, z, 600))
        width = (z - a) // 280 // 2  # about half a bucket's key range
        lo = np.concatenate([[a], narrow])
        hi = np.concatenate([[z], np.minimum(narrow + rng.integers(1, width, 600), z)])

        def premise(st, lo, hi, budget, mask):
            assert (lo[1:] >= lo[0]).all() and (hi[1:] <= hi[0]).all()
            c = in_range(st, lo, hi)
            assert c[0] > 256 and (c[1:] > 0).sum() > 200 and fits(st, lo, hi, budget, mask)

    elif case == "odd_budget":  # a budget that is no multiple of 32, and truncates
        lo = np.sort(rng.integers(0, 1 << 26, 300))
        hi = lo + rng.integers(1, 1 << 20, 300)
        budget = ODD_BUDGET

        def premise(st, lo, hi, budget, mask):
            assert budget % 32 and in_range(st, lo, hi).sum() > budget

    elif case == "empty_state":  # every key deleted
        st, _ = _empty_buckets(st, range(nb), device)
        lo = np.sort(np.concatenate([rng.integers(0, 1 << 26, 200), mk[::5], [0]]))
        hi = lo + rng.integers(-10, 1 << 20, len(lo))

        def premise(st, lo, hi, budget, mask):
            assert int(st.num_nodes.sum()) == 0 and not in_range(st, lo, hi).any()

    elif case in ("nb_1", "nb_1023", "nb_1025"):
        # the searches' fixed step counts: nb fences for the count kernel
        # (1, 2^10 - 1, 2^10 + 1) and nb + 1 pref entries for the gather
        # (2, 2^10, 2^10 + 2); bounds on, below and above every fence
        b = np.unique(np.concatenate([[0, 1, 2, nb - 3, nb - 2, nb - 1], np.arange(0, nb, 7)]))
        b = b[(b >= 0) & (b < nb)]
        nxt = mk[np.minimum(b + 1, nb - 1)]
        live = _stored(st)[0].astype(np.int64)
        one = live[:: max(1, len(live) // 200)]  # ranges of one stored key each
        lo = np.concatenate([mk[b], mk[b] - 1, mk[b] + 1, inside(b[::3], 1), one, [0, EMPTY - 1]])
        hi = np.concatenate([nxt + 1, mk[b] + 1, nxt, inside(b[::3], 1) + 2000, one + 1,
                             [mk[min(3, nb - 1)], EMPTY]])

        def premise(st, lo, hi, budget, mask):
            assert nb == {"nb_1": 1, "nb_1023": 1023, "nb_1025": 1025}[case]
            assert np.isin(mk[[0, nb - 1]], lo).all() and np.isin(mk[[0, nb - 1]] + 1, hi).all()
            assert (in_range(st, lo, hi) > 0).sum() > len(b) and fits(st, lo, hi, budget, mask)

    else:  # "masked": a mixed batch's sorted keys, 1% of them RANGE ops
        lo = np.sort(rng.choice(1 << 26, 1000, replace=False))
        mask = np.zeros(1000, bool)
        mask[rng.choice(1000, 10, replace=False)] = True
        hi = np.where(mask, lo + rng.integers(1 << 19, 1 << 20, 1000),
                      rng.integers(-(1 << 31), 1 << 31, 1000))

        def premise(st, lo, hi, budget, mask):
            assert mask.sum() == 10 and (in_range(st, lo, hi)[mask] > 0).all()
            assert (hi[~mask] < lo[~mask]).any() and fits(st, lo, hi, budget, mask)

    lo = np.asarray(lo, np.int64)
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], np.asarray(hi, np.int64)[order]
    mask = None if mask is None else mask[order]
    i32 = np.iinfo(np.int32)
    return (st, lo.astype(np.int32), np.clip(hi, i32.min, i32.max).astype(np.int32), budget,
            mask, premise)


@pytest.mark.cuda
@pytest.mark.parametrize("case", RANGE_CASES)
@pytest.mark.parametrize("ns,npb", EDGE_GEOMETRIES)
def test_range_kernel_edge_cases_on_card(cuda, ns, npb, case):
    """The count kernel (with and without the case's mask, and on the ops
    in reverse order: it needs none) and the gather (at the case's budget
    and at RANGE_K2_SIZE) equal their plain versions byte for byte, one
    launch each; without a mask, flix_range equals dense_range_scan."""
    from repro_torch.core.query import live_prefix, range_offsets, range_slot_ranks

    st, lo, hi, budget, mask, premise = range_case(ns, npb, case, cuda)
    premise(st, lo, hi, budget, mask)
    lo_t, hi_t = (torch.as_tensor(a, device=cuda) for a in (lo, hi))
    is_range = torch.as_tensor(np.ones(len(lo), bool) if mask is None else mask, device=cuda)
    pref = live_prefix(st.node_count)
    meta = (st.keys, st.node_count, st.node_max, st.mkba, pref, lo_t, hi_t)
    kw = {} if mask is None else {"is_range": is_range}
    before = dict(LAUNCHES)
    got = fr.flix_range_count(*meta, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flix_range_count"] == before["flix_range_count"] + 1
    want = fr.flix_range_count_reference(*meta, **kw)
    _equal(want, got, f"range count ({case})")
    back = (*meta[:5], lo_t.flip(0).contiguous(), hi_t.flip(0).contiguous())
    _equal([w.flip(0) for w in want], fr.flix_range_count(*back, **{
        k: v.flip(0).contiguous() for k, v in kw.items()}), f"range count, reversed ({case})")
    for mr in (budget, RANGE_K2_SIZE):
        start, _, total, _ = range_offsets(want[1], is_range, mr)
        gargs = (range_slot_ranks(want[0], start, total, mr), pref, st.node_count, st.keys,
                 st.vals)
        before = dict(LAUNCHES)
        got = fr.flix_range_scatter(*gargs)
        torch.cuda.synchronize()
        assert LAUNCHES["flix_range_scatter"] == before["flix_range_scatter"] + 1
        _equal(fr.flix_range_gather_reference(*gargs), got, f"range gather ({case} @ {mr})")
    if mask is None:
        got = fr.flix_range(st.keys, st.vals, st.mkba, lo_t, hi_t, max_results=budget)
        want = tcore.dense_range_scan(st, is_range, lo_t, hi_t, max_results=budget)
        _equal(want, got, f"flix_range ({case})")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2])
def test_tiered_packed_fused_pass_on_card(cuda, width):
    """A tiered index under a one-bucket budget runs the fused path's
    kernels on a packed working set of ``width`` buckets (a SUCCESSOR's walk
    adds the next bucket) and equals the same index on the CPU: results,
    stats, residency and the synced mirror."""
    from repro_torch.core.residency import TieredFliX

    keys = np.arange(0, 1 << 14, 2, dtype=np.int32)  # 512 buckets of 16 keys
    sides = {
        dev: TieredFliX.from_state(
            tcore.build(keys, keys // 2, node_size=32, nodes_per_bucket=16, device=dev),
            budget_bytes=1,
        )
        for dev in (cuda, torch.device("cpu"))
    }
    # all in bucket 5 (keys 160..190): inserts, deletes, reads, a range
    tags = [tcore.OP_INSERT] * 4 + [tcore.OP_DELETE] * 2 + [tcore.OP_POINT] * 4
    k = [161, 163, 165, 167, 170, 172, 160, 161, 174, 189]
    tags.append(tcore.OP_RANGE)
    k.append(162)
    if width == 2:
        tags.append(tcore.OP_SUCCESSOR)  # past bucket 5's largest key
        k.append(189)
    v = [x * 3 for x in k]
    v[10] = 186  # the range's hi
    out = {}
    for dev, tiered in sides.items():
        ops_, _ = tcore.make_ops(np.array(tags, np.int32), np.array(k, np.int32),
                                 np.array(v, np.int32), device=dev)
        before = dict(LAUNCHES)
        out[dev.type] = tiered.apply(ops_)
        torch.cuda.synchronize()
        ran = {n: LAUNCHES[n] - before[n] for n in LAUNCHES}
        assert tiered.last_timings["working_set"] == width
        assert tiered.resident_ids.tolist() == [5]
        if dev.type == "cuda":
            for n in ("flix_apply_staged", "flix_fence_rows", "flix_apply_rank",
                      "flix_apply_range"):
                assert ran[n] >= 1, (n, ran)
        tcore.check_tiered_invariants(tiered)
    (gr, gs, _), (wr, ws, _) = out["cuda"], out["cpu"]
    for key in wr:
        assert torch.equal(gr[key].cpu(), wr[key]), key
    for key in ws:
        assert int(gs[key]) == int(ws[key]), key
    got, want = sides[cuda].host_view(), sides[torch.device("cpu")].host_view()
    for f in ("keys", "node_count", "node_max", "num_nodes", "mkba"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    live = want.keys != EMPTY
    assert torch.equal(got.vals[live], want.vals[live])


@pytest.mark.cuda
@pytest.mark.parametrize("routing", ["replicated", "a2a"])
def test_sharded_fused_pass_on_card(cuda, routing):
    """Four shards on the one card run the fused path's stripe kernel and
    fence rows once a shard for a mixed batch (RANGE ops included, answered
    across shards in torch) and equal the same index on the CPU: results,
    stats and every shard's state."""
    from repro_torch.core import distributed as dist

    keys = np.arange(0, 1 << 14, 2, dtype=np.int32)
    k = np.concatenate([keys[::7] + 1, keys[3::11], keys[::5], keys[1::9] + 1,
                        keys[::400]]).astype(np.int32)
    tags = np.concatenate([np.full(len(keys[::7]), tcore.OP_INSERT),
                           np.full(len(keys[3::11]), tcore.OP_DELETE),
                           np.full(len(keys[::5]), tcore.OP_POINT),
                           np.full(len(keys[1::9]), tcore.OP_SUCCESSOR),
                           np.full(len(keys[::400]), tcore.OP_RANGE)]).astype(np.int32)
    v = np.where(tags == tcore.OP_RANGE, k + 700, k * 3).astype(np.int32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = dist.make_shard_mesh(4, [dev] * 4)
        idx = dist.shard_build(torch.as_tensor(keys).to(dev), torch.as_tensor(keys // 2).to(dev),
                               mesh)
        ops_, _ = tcore.make_ops(tags, k, v, pad_to=4608, device=dev)
        cfg = tcore.ExecConfig(routing=routing, impl="fused", max_results=512)
        before = dict(LAUNCHES)
        out[dev.type] = dist.shard_apply_ops(idx, ops_, mesh, config=cfg)
        torch.cuda.synchronize()
        ran = {n: LAUNCHES[n] - before[n] for n in LAUNCHES}
        if dev.type == "cuda":
            assert {n: c for n, c in ran.items() if c} == {
                "flix_apply_staged": 4, "flix_fence_rows": 4}, ran
    (gi, gr, gs), (wi, wr, ws) = out["cuda"], out["cpu"]
    for key in wr:
        assert torch.equal(gr[key].cpu(), wr[key]), key
    for key in ws:
        assert int(gs[key]) == int(ws[key]), key
    for got, want in zip(gi.states, wi.states):
        for f in ("keys", "node_count", "node_max", "num_nodes", "mkba"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.cuda
def test_kv_index_on_card_equals_cpu(cuda):
    """A few serving steps (TTL, get-or-set, frees, ranges, a pinned read)
    on the card and on the CPU give the same results and state."""
    from repro_torch.serve import PAGE_BITS, KVPageIndex

    cards = KVPageIndex(node_size=32, nodes_per_bucket=16, snapshot_window=2, device=cuda)
    host = KVPageIndex(node_size=32, nodes_per_bucket=16, snapshot_window=2, device="cpu")
    seqs = np.arange(64)
    steps = [
        dict(allocs=(np.repeat(seqs, 4), np.tile(np.arange(4), 64), np.arange(256),
                     np.full(256, 30)), now=0),
        dict(getsets=(seqs[:8], np.zeros(8, int), seqs[:8], np.full(8, 90)),
             lookups=(seqs, np.ones(64, int)), now=10),
        dict(free_seqs=seqs[40:48], ranges=(seqs[:4] << PAGE_BITS, (seqs[:4] + 1) << PAGE_BITS),
             now=20, max_pages=4),
        dict(lookups=(seqs, np.zeros(64, int)), now=40),
        dict(lookups=(seqs, np.zeros(64, int)), as_of=2),
    ]
    for kw in steps:
        a, b = cards.step(**kw), host.step(**kw)
        assert torch.equal(a.slots.cpu(), b.slots)
        for k in (a.range_out or {}):
            assert torch.equal(a.range_out[k].cpu(), b.range_out[k])
    for f in ("keys", "node_count", "node_max", "num_nodes", "exps"):
        assert torch.equal(getattr(cards.state, f).cpu(), getattr(host.state, f)), f


@pytest.mark.cuda
def test_gateway_durable_soak_on_card_equals_cpu(cuda, tmp_path):
    """The hostile-traffic soak of ``torch_traffic_replay.py`` through two
    durable gateways in lockstep, one over an index on the card (the fused
    path) and one on the CPU: every ticket, pump report, metric and
    canonical state equal after every pump, both directories byte-identical
    at the end."""
    import torch_traffic_replay as tr
    from repro_torch.checkpoint.serialize import canonical_state_bytes

    host = tr.make_gateway(tr.make_index(durability_dir=tmp_path / "cpu"))
    card = tr.make_gateway(tr.make_index(durability_dir=tmp_path / "card", device=cuda))
    twin = tr.Lockstep(host, card, bytes_a=canonical_state_bytes,
                       bytes_b=canonical_state_bytes)
    twin.register_tenant("tenant-hot", rate=24, burst=48, weight=3.0)
    twin.register_tenant("tenant-mid", rate=16, burst=32)
    before = LAUNCHES["flix_apply_staged"]
    res = tr.run_traffic(twin, tr.default_population(0), ticks=20, seed=0)
    assert LAUNCHES["flix_apply_staged"] > before
    assert host.metrics["restructure_retries"] >= 1
    host.close(now=float(res.end_tick))
    card.close(now=float(res.end_tick))
    got, want = tr.dir_bytes(tmp_path / "card"), tr.dir_bytes(tmp_path / "cpu")
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name


# The grouped GEMM and its plain version both sum float32 products in float32,
# in different orders (the kernel with FMA), so they agree to a relative 1e-4
# of the output's largest magnitude; rows outside every group are exactly 0.
def _assert_gemm_close(got, want):
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


def _gemm_inputs(rng, T, D, F, offs, dx, dw, device):
    E = len(offs) - 1
    x = torch.as_tensor(rng.normal(size=(T, D)).astype(np.float32), device=device).to(dx)
    w = torch.as_tensor((rng.normal(size=(E, D, F)) * 0.1).astype(np.float32), device=device)
    return x, w.to(dw), torch.as_tensor(np.asarray(offs, np.int32), device=device)


def _uniform_offs(rng, T, E):
    return np.concatenate([[0], np.cumsum(rng.multinomial(T, np.ones(E) / E))])


GEMM_CASES = {
    "sweep_256": (256, 128, 256, lambda r: _uniform_offs(r, 256, 4)),
    "sweep_512": (512, 64, 128, lambda r: _uniform_offs(r, 512, 8)),
    "empty_groups": (256, 64, 128, lambda r: [0, 0, 128, 128, 128, 256, 256, 256, 256]),
    "one_group": (300, 64, 72, lambda r: [0, 0, 300, 300]),
    "ragged": (1000, 96, 200, lambda r: _uniform_offs(r, 1000, 5)),
    "outside_rows": (1000, 96, 200, lambda r: [37, 200, 200, 650, 900]),
    "odd_widths": (777, 99, 201, lambda r: _uniform_offs(r, 777, 6)),
    "odd_widths_small_tiles": (200, 130, 75, lambda r: _uniform_offs(r, 200, 16)),
    # half the rows in one group, 8 groups empty
    "skewed": (768, 256, 176, lambda r: [0] * 9 + [384, 440, 500, 560, 610, 650, 720, 768]),
    # TMA-eligible widths (wgmma for bf16 weights): a K tail (D % 64 != 0),
    # groups that straddle 64- and 128-row tiles, a decode-sized split
    "k_tail": (300, 200, 136, lambda r: _uniform_offs(r, 300, 5)),
    "straddle": (512, 128, 264, lambda r: [0, 70, 190, 333, 512]),
    "decode_like": (96, 256, 384, lambda r: _uniform_offs(r, 96, 8)),
}
FLOATS = [torch.float32, torch.bfloat16]


def _expected_variant(D, F, dx, dw, aligned=True):
    """grouped_matmul's variant: wgmma for bf16 weights where TMA can
    address both tensors, mma for other bf16 x bf16, fma for the rest."""
    if dw == torch.bfloat16 and aligned and F % 8 == 0 and D % (8 if dx == torch.bfloat16
                                                                else 4) == 0:
        return "wgmma"
    return "mma" if dx == dw == torch.bfloat16 else "fma"


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GEMM_CASES))
@pytest.mark.parametrize("dx", FLOATS)
@pytest.mark.parametrize("dw", FLOATS)
def test_grouped_matmul_matches_plain_on_card(cuda, case, dx, dw):
    T, D, F, make = GEMM_CASES[case]
    rng = np.random.default_rng(T + D + F)
    offs = make(rng)
    x, w, o = _gemm_inputs(rng, T, D, F, offs, dx, dw, cuda)
    # leave NaN in the memory the output will reuse: rows outside every group
    # must come out zero from the kernel, not from a fresh allocation
    torch.full((T * F,), float("nan"), device=cuda)
    before, variants = LAUNCHES["grouped_matmul"], dict(GMM_VARIANTS)
    got = tg.grouped_matmul(x, w, o)
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_matmul"] == before + 1
    variant = _expected_variant(D, F, dx, dw)
    assert tg.kernel_variant(x, w) == variant
    assert GMM_VARIANTS == {**variants, variant: variants[variant] + 1}
    want = tg.grouped_matmul_reference(x, w, o)
    _assert_gemm_close(got, want)
    outside = torch.cat([got[: offs[0]], got[offs[-1]:]])
    assert torch.equal(outside, torch.zeros_like(outside))


@pytest.mark.cuda
def test_grouped_matmul_refuses_other_dtypes_on_card(cuda):
    x = torch.zeros(16, 8, device=cuda)
    w = torch.zeros(2, 8, 4, device=cuda)
    o = torch.tensor([0, 8, 16], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tg.grouped_matmul(x.half(), w, o)
    with pytest.raises(TypeError):
        tg.grouped_matmul(x, w.half(), o)


@pytest.mark.cuda
def test_flipped_moe_ffn_on_card_matches_dense_oracle(cuda):
    """The walk of ``examples/moe_routing.py`` through ``ops.grouped_matmul``
    on the card, with bf16 weights: two launches, equal to the oracle."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(9)
    T, D, F, E, K = 256, 128, 96, 8, 2
    x = torch.as_tensor(rng.normal(size=(T, D)).astype(np.float32), device=cuda)
    logits = torch.as_tensor(rng.normal(size=(T, E)).astype(np.float32), device=cuda)
    w_up = torch.as_tensor(rng.normal(size=(E, D, F)) * 0.05, device=cuda).bfloat16()
    w_down = torch.as_tensor(rng.normal(size=(E, F, D)) * 0.05, device=cuda).bfloat16()
    before = LAUNCHES["grouped_matmul"]
    plan = tmd.make_plan(logits, K, E)
    xs = tmd.dispatch(x.bfloat16(), plan, K)
    h = torch.nn.functional.silu(ops.grouped_matmul(xs, w_up, plan.group_offsets))
    out = tmd.combine(ops.grouped_matmul(h, w_down, plan.group_offsets), plan, K)
    torch.cuda.synchronize()
    assert LAUNCHES["grouped_matmul"] == before + 2
    _assert_gemm_close(out, tmd.moe_ffn_reference(x.bfloat16(), logits, w_up, w_down, K))


@pytest.mark.cuda
@pytest.mark.parametrize("dx", FLOATS)
@pytest.mark.parametrize("shift", [1, 3, 8])
def test_grouped_matmul_on_unaligned_views_on_card(cuda, shift, dx):
    """x and w as contiguous views whose data do not start on 16 bytes
    (shift 8 bf16 elements is 16 bytes: aligned again).  An unaligned view
    keeps PR 14's variants: mma for bf16 x bf16, fma for f32 x bf16."""
    rng = np.random.default_rng(shift)
    T, D, F, E = 160, 64, 136, 4
    offs = _uniform_offs(rng, T, E)
    x0, w0, o = _gemm_inputs(rng, T, D, F, offs, dx, torch.bfloat16, cuda)
    xb = torch.empty(T * D + shift, dtype=dx, device=cuda)
    wb = torch.empty(E * D * F + shift, dtype=torch.bfloat16, device=cuda)
    x = xb[shift:].view(T, D).copy_(x0)
    w = wb[shift:].view(E, D, F).copy_(w0)
    variants = dict(GMM_VARIANTS)
    got = tg.grouped_matmul(x, w, o)
    variant = _expected_variant(D, F, dx, torch.bfloat16, aligned=shift == 8)
    assert GMM_VARIANTS == {**variants, variant: variants[variant] + 1}
    _assert_gemm_close(got, tg.grouped_matmul_reference(x0, w0, o))


def _assert_same_non_finite_and_close_by_row(got, want):
    """Where ``want`` is inf or NaN, ``got`` is the same; elsewhere within
    ``rtol=1e-4`` and ``1e-4`` times the row's largest finite ``|want|``."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    row_scale = torch.where(fin, want.abs(), torch.zeros_like(want)).amax(1, keepdim=True)
    err = (got - want).abs()
    ok = ~fin | (err <= 1e-4 * want.abs() + 1e-4 * row_scale)
    assert bool(ok.all()), float(torch.where(fin, err, torch.zeros_like(err)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("T,E", [(96, 8), (512, 4)])  # 64- and 128-row tiles
def test_grouped_matmul_split_edge_values_on_card(cuda, T, E):
    """f32 x bf16 on wgmma through the three-piece split: huge, tiny,
    subnormal, infinite and NaN entries of x, one a row, each row's
    output finite or not exactly as the reference's."""
    rng = np.random.default_rng(T)
    D, F = 128, 192
    offs = _uniform_offs(rng, T, E)
    x, w, o = _gemm_inputs(rng, T, D, F, offs, torch.float32, torch.bfloat16, cuda)
    specials = [1e30, 3.3e38, -3.3e38, 1e-30, 1e-40, -1e-42, float("inf"), -float("inf"),
                float("nan")]
    for i, v in enumerate(specials):
        x[7 * i + 3, (5 * i) % D] = v
    variants = dict(GMM_VARIANTS)
    got = tg.grouped_matmul(x, w, o)
    assert GMM_VARIANTS == {**variants, "wgmma": variants["wgmma"] + 1}
    want = tg.grouped_matmul_reference(x, w, o)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(want[7 * 6 + 3]).any())  # the inf rows are not finite
    assert bool(torch.isfinite(want[7 * 1 + 3]).all())  # 3.3e38 * w stays finite
    _assert_same_non_finite_and_close_by_row(got, want)


# ---------------------------------------------------------------------------
# the read-only pass (tests/test_torch_read_pass.py holds its cases' plain
# version against the reference engine on the CPU)
# ---------------------------------------------------------------------------


def _read_args(st):
    return (st.keys, st.vals, st.node_max, st.num_nodes, st.mkba)


def _all_planes(st):
    return _planes(st) + [st.num_nodes.clone(), st.mkba.clone(), st.needs_restructure.clone()]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(READ_CASES))
def test_read_pass_matches_plain_and_reference_on_card(cuda, case):
    """The read kernel byte for byte its plain version, one launch; the
    read-only pass the reference engine's results and stats, on the input
    state itself, whose planes it leaves as they were."""
    st, ops_ = read_case(case, cuda)
    before = _all_planes(st)
    n0 = LAUNCHES["flix_apply_read"]
    got = fa.flix_apply_read_pass(*_read_args(st), ops_.tag, ops_.key)
    torch.cuda.synchronize()
    assert LAUNCHES["flix_apply_read"] == n0 + 1
    _equal(fa.flix_apply_read_reference(*_read_args(st), ops_.tag, ops_.key), got,
           f"read kernel vs plain ({case})")
    want = tcore.ops._apply_ops_reference(st, ops_, max_results=64)
    res = fa.flix_apply_read(st, ops_.tag, ops_.key, ops_.val, max_results=64)
    assert res[0] is st
    for k in want[1]:
        assert torch.equal(want[1][k], res[1][k]), (case, k)
    for k in want[2]:
        assert int(want[2][k]) == int(res[2][k]), (case, k)
    _equal(before, _all_planes(st), f"planes after the read pass ({case})")


@pytest.mark.cuda
def test_read_pass_on_a_skewed_batch_on_card(cuda):
    """2^20 POINT reads of which one key takes 40,000 (the head of a
    Zipfian batch), half the rest hits, half uniform: the kernel byte for
    byte its plain version; ``apply_ops_safe`` launches it once and nothing
    else, returns the input state, and writes no byte of its planes."""
    rng = np.random.default_rng(38)
    n = 1 << 20
    keys = rng.choice(1 << 26, n, replace=False).astype(np.int32)
    st = tcore.build(keys, keys ^ 0x5A5A, node_size=32, nodes_per_bucket=16, device=cuda)
    q = np.concatenate([np.full(40000, keys[7]), rng.choice(keys, n // 2 - 40000),
                        rng.integers(0, 1 << 26, n - n // 2)]).astype(np.int32)
    rng.shuffle(q)
    ops_, perm = tcore.make_ops(np.full(n, tcore.OP_POINT, np.int32), q, device=cuda)
    got = fa.flix_apply_read_pass(*_read_args(st), ops_.tag, ops_.key)
    _equal(fa.flix_apply_read_reference(*_read_args(st), ops_.tag, ops_.key), got,
           "read kernel vs plain, skewed")
    value = tcore.unsort(got[0], perm).cpu().numpy()
    assert (value[q == keys[7]] == keys[7] ^ 0x5A5A).all()
    assert int((got[0] != tcore.NOT_FOUND).sum()) >= n // 2
    assert int(got[3]) == 0
    planes = _all_planes(st)
    before = dict(LAUNCHES)
    res = tcore.apply_ops_safe(st, ops_, config=tcore.ExecConfig())
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]} == {
        "flix_apply_read": 1}
    assert res[0] is st and torch.equal(res[1]["value"], got[0])
    assert res[2]["restructure_retries"] == 0
    _equal(planes, _all_planes(st), "planes after a read-only batch")
