"""The sharded engine (``repro_torch.core.distributed``) against the JAX
reference on the CPU, shards on ``["cpu"] * S``.

``shard_apply_ops`` / ``shard_apply_ops_safe`` are held against the
reference's single-device ``apply_ops`` on ``build_from_sorted`` at the
union geometry (DESIGN.md §11's contract): results, stats and the gathered
post-state, for S ∈ {2, 4, 8} under both routings.  The cases mirror
``tests/test_shard_engine.py``: the mixed batch, global truncation,
read-only and NOP batches, skew, ``shard_restructure`` and TTL with and
without ``now``.  The a2a-only fields (overflow, ``shard_apply_ops_safe``'s retry
counters, the regrown fences) are held against the reference's own
``shard_apply_ops_safe``, run once in a subprocess with 2 and 4 fake host
devices.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_with_devices  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.checkpoint.serialize import canonical_state_bytes as j_canonical  # noqa: E402
from repro.checkpoint.serialize import state_from_pairs as j_state_from_pairs  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core.config import ExecConfig as JConfig  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.checkpoint.serialize import canonical_state_bytes as canonical  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from test_shard_engine import (  # noqa: E402
    KEY_SPACE,
    RESULT_KEYS,
    STAT_KEYS,
    _mixed_batch,
)
from test_torch_common import assert_same, assert_same_state, t32  # noqa: E402

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
A2A_FIELDS = ("a2a_overflow", "a2a_retries", "a2a_overflow_dropped", "restructure_retries")


def cpu_mesh(n_shards):
    return dist.make_shard_mesh(n_shards, ["cpu"] * n_shards)


def port_ops(jops):
    """A JAX OpBatch as the port's, on the CPU."""
    exp = None if jops.exp is None else np.array(jops.exp)
    return tcore.OpBatch.from_host(
        np.array(jops.tag), np.array(jops.key), np.array(jops.val), exp, device="cpu"
    )


def build_pair(rng, n_shards, n=2048, exps=None):
    """The reference's single-device state and the port's sharded index over
    the same contents (``test_shard_engine._build_pair``'s geometry)."""
    keys = np.sort(rng.permutation(KEY_SPACE)[:n]).astype(np.int32)
    vals = np.arange(n, dtype=np.int32)
    if exps is None:
        st = jcore.build_from_sorted(
            jnp.asarray(keys), jnp.asarray(vals), num_buckets=max(1, n // 8),
            nodes_per_bucket=8, node_size=16,
        )
    else:
        st = j_state_from_pairs(keys, vals, exps, node_size=16, nodes_per_bucket=8)
    idx = dist.shard_build(
        t32(keys), t32(vals), cpu_mesh(n_shards), node_size=16, nodes_per_bucket=8,
        sorted_exps=None if exps is None else t32(exps),
    )
    return keys, st, idx


def assert_same_apply(want, got, label=""):
    """Results, stats and the gathered post-state equal to the reference's
    single-device ``apply_ops``."""
    ws, wr, wst = want
    gi, gr, gst = got
    for k in RESULT_KEYS:
        assert_same(wr[k], gr[k], f"{label} {k}")
    for k in STAT_KEYS + (("expired",) if "expired" in wst else ()):
        assert int(wst[k]) == int(gst[k]), (label, k)
    u = dist.shard_union(gi, "cpu")
    assert_same_state(ws, u)
    if ws.exps is not None:
        live = np.asarray(ws.keys) != tcore.EMPTY
        assert_same(np.asarray(ws.exps)[live], u.exps[torch.as_tensor(live)], "exps")


def j_apply(st, jops, mr, **kw):
    return jcore.apply_ops(st, jops, config=JConfig(impl="reference", max_results=mr), **kw)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("routing", ["replicated", "a2a"])
def test_matches_single_device(n_shards, routing):
    rng = np.random.default_rng(1234)
    keys, st, idx = build_pair(rng, n_shards)
    assert idx.geometry == st.geometry and idx.n_shards == n_shards
    jops = _mixed_batch(rng, keys)
    got = dist.shard_apply_ops(
        idx, port_ops(jops), cpu_mesh(n_shards),
        config=tcore.ExecConfig(routing=routing, max_results=512),
    )
    assert_same_apply(j_apply(st, jops, 512), got, f"{routing}/s{n_shards}")
    assert int(got[2]["a2a_overflow"]) == 0
    # the input index was not written: a replay gives the same answers
    again = dist.shard_apply_ops(
        idx, port_ops(jops), cpu_mesh(n_shards),
        config=tcore.ExecConfig(routing=routing, max_results=512),
    )
    for k in RESULT_KEYS:
        assert torch.equal(got[1][k], again[1][k]), k


@pytest.mark.parametrize("routing", ["replicated", "a2a"])
def test_truncation_under_global_budget(routing):
    rng = np.random.default_rng(1234)
    keys, st, idx = build_pair(rng, 4)
    jops = _mixed_batch(rng, keys, n_rg=96, span=8_000)
    want = j_apply(st, jops, 64)
    assert int(want[2]["range_truncated"]) > 0  # the case is exercised
    got = dist.shard_apply_ops(
        idx, port_ops(jops), cpu_mesh(4), config=tcore.ExecConfig(routing=routing, max_results=64)
    )
    assert_same_apply(want, got, routing)


def test_read_only_and_nop_batches():
    rng = np.random.default_rng(1234)
    keys, st, idx = build_pair(rng, 4)
    mesh = cpu_mesh(4)
    jops = _mixed_batch(rng, keys, n_ins=0, n_del=0, n_pt=512, n_sc=512, n_rg=32)
    want = j_apply(st, jops, 256)
    for routing in ("replicated", "a2a"):
        for impl in ("reference", "fused"):
            cfg = tcore.ExecConfig(routing=routing, max_results=256, impl=impl)
            got = dist.shard_apply_ops(idx, port_ops(jops), mesh, config=cfg)
            assert_same_apply(want, got, f"{routing}/{impl}")
    nops = tcore.make_ops(np.zeros(0, np.int32), np.zeros(0, np.int32), pad_to=64,
                          device="cpu")[0]
    jn = jcore.make_ops(np.zeros(0, np.int32), np.zeros(0, np.int32), pad_to=64)[0]
    for routing in ("replicated", "a2a"):
        got = dist.shard_apply_ops(idx, nops, mesh, config=tcore.ExecConfig(routing=routing))
        assert_same_apply(j_apply(st, jn, 128), got, f"nop/{routing}")
        assert (got[1]["value"] == tcore.NOT_FOUND).all()


def skew_batch(rng, keys, hi, n=256):
    """Every op inside shard 0's fence range (``test_a2a_matches_replicated_on_skew``)."""
    absent = np.setdiff1d(rng.integers(0, hi, 4096).astype(np.int32), keys)
    in_shard0 = keys[keys < hi]
    tags = np.concatenate([np.full(n, jcore.OP_INSERT), np.full(n, jcore.OP_DELETE),
                           np.full(n, jcore.OP_POINT), np.full(n, jcore.OP_SUCCESSOR),
                           np.full(32, jcore.OP_RANGE)]).astype(np.int32)
    bk = np.concatenate([absent[:n], rng.choice(in_shard0, n, replace=False),
                         rng.integers(0, hi, n), rng.integers(0, hi, n),
                         rng.integers(0, hi, 32)]).astype(np.int32)
    bv = np.zeros(bk.shape, np.int32)
    bv[:n] = np.arange(n) + 5_000_000
    bv[-32:] = bk[-32:] + 500
    return jcore.make_ops(tags, bk, bv, pad_to=1280)[0]


@pytest.mark.parametrize("routing", ["replicated", "a2a"])
def test_skew_on_one_shard(routing):
    rng = np.random.default_rng(1234)
    keys, st, idx = build_pair(rng, 4)
    hi = int(idx.part_fences[0])
    jops = skew_batch(rng, keys, hi)
    # the default capacity (the chunk) never overflows, even at full skew
    got = dist.shard_apply_ops(
        idx, port_ops(jops), cpu_mesh(4), config=tcore.ExecConfig(routing=routing,
                                                                  max_results=256)
    )
    assert int(got[2]["a2a_overflow"]) == 0
    assert_same_apply(j_apply(st, jops, 256), got, f"skew/{routing}")


def test_shard_restructure_rebalances_and_preserves_contents():
    rng = np.random.default_rng(1234)
    keys, st, idx = build_pair(rng, 4)
    mesh = cpu_mesh(4)
    hi = int(idx.part_fences[0])
    extra = np.setdiff1d(rng.integers(0, hi, 6000).astype(np.int32), keys)[:1024]
    jops = jcore.make_ops(np.full(extra.shape, jcore.OP_INSERT, np.int32), np.sort(extra),
                          np.arange(extra.shape[0], dtype=np.int32))[0]
    idx2, _, stats = dist.shard_apply_ops_safe(idx, port_ops(jops), mesh)
    want = jcore.apply_ops_safe(st, jops, config=JConfig(impl="reference"))
    # both overflow and regrow: the reference by restructure_grow, the
    # sharded index by shard_restructure, so the contents are compared
    assert stats["restructure_retries"] == 1 == want[2]["restructure_retries"]
    assert canonical(dist.shard_union(idx2, "cpu")) == j_canonical(want[0])
    before = dist.shard_live_counts(idx2, mesh)
    nb_s = idx2.states[0].num_buckets
    per_shard = [int(s.node_count.sum()) for s in idx2.states]
    assert before.tolist() == per_shard and idx2.geometry[0] == 4 * nb_s
    idx3 = dist.shard_restructure(idx2, mesh)
    after = dist.shard_live_counts(idx3, mesh).numpy()
    assert before.sum() == after.sum() == keys.shape[0] + extra.shape[0]
    assert int(before.max()) > 2 * int(before.min())  # the skew was real
    assert after.max() - after.min() <= after.mean() * 0.25 + 16  # rebalanced
    tcore.check_invariants(dist.shard_union(idx3, "cpu"))
    # the rebalanced index is the JAX restructure of the same live pairs
    live_k = np.sort(np.concatenate([keys, extra]))
    probe = tcore.make_ops(np.full(live_k.shape, tcore.OP_POINT, np.int32), live_k,
                           device="cpu")[0]
    _, res, _ = dist.shard_apply_ops(idx3, probe, mesh, config=tcore.ExecConfig(max_results=8))
    assert (res["value"] != tcore.NOT_FOUND).all()
    jwant = j_apply(want[0], jcore.make_ops(np.full(live_k.shape, jcore.OP_POINT, np.int32),
                                            live_k)[0], 8)
    assert_same(jwant[1]["value"], res["value"])


def ttl_case(rng, n=2048, now=1000):
    """``test_shard_engine.test_ttl_matches_single_device``'s contents and batch."""
    keys = np.sort(rng.permutation(KEY_SPACE)[:n]).astype(np.int32)
    exps = np.where(rng.random(n) < 0.25, rng.integers(1, 2 * now, n),
                    jcore.NO_EXPIRY).astype(np.int32)
    absent = np.setdiff1d(rng.integers(0, KEY_SPACE + 20_000, 4096).astype(np.int32), keys)
    ins, gs_miss = absent[:96], absent[96:144]
    gs_hit = rng.choice(keys, 48, replace=False).astype(np.int32)
    dels = rng.choice(np.setdiff1d(keys, gs_hit), 96, replace=False).astype(np.int32)
    pts = rng.integers(0, KEY_SPACE, 256).astype(np.int32)
    scs = rng.integers(0, KEY_SPACE, 128).astype(np.int32)
    los = np.concatenate([rng.integers(0, KEY_SPACE, 15), [0]]).astype(np.int32)
    his = np.concatenate([los[:15] + rng.integers(1, 2_000, 15),
                          [KEY_SPACE + 20_000]]).astype(np.int32)
    tags = np.concatenate([np.full(96, jcore.OP_INSERT), np.full(96, jcore.OP_EXPIRE),
                           np.full(96, jcore.OP_DELETE), np.full(256, jcore.OP_POINT),
                           np.full(128, jcore.OP_SUCCESSOR),
                           np.full(16, jcore.OP_RANGE)]).astype(np.int32)
    bk = np.concatenate([ins, gs_miss, gs_hit, dels, pts, scs, los]).astype(np.int32)
    bv = np.concatenate([np.arange(96, dtype=np.int32) + 7_000_000,
                         np.arange(96, dtype=np.int32) + 8_000_000,
                         np.zeros(96 + 256 + 128, np.int32), his]).astype(np.int32)
    bexp = np.concatenate([now + rng.integers(-5, 200, 96), now + rng.integers(1, 200, 96),
                           np.full(96 + 256 + 128 + 16, jcore.NO_EXPIRY)]).astype(np.int32)
    jops = jcore.make_ops(tags, bk, bv, exps=jnp.asarray(bexp), pad_to=1024)[0]
    return keys, exps, jops, np.sort(np.concatenate([ins, gs_hit, keys[:256]]))


@pytest.mark.parametrize("routing", ["replicated", "a2a"])
@pytest.mark.parametrize("clock", ["now", "no_now"])
def test_ttl_matches_single_device(routing, clock):
    """The TTL path — the expiry pre-pass at ``now`` (or none), TTL'd inserts
    (some dead on arrival) and EXPIRE get-or-set — equal to the reference's
    single-device engine, ``expired`` included; then a later clock's
    pre-pass reclaims the same rows on both."""
    rng = np.random.default_rng(1234)
    now = 1000 if clock == "now" else None
    keys, exps, jops, probe = ttl_case(rng)
    _, st, idx = build_pair(np.random.default_rng(1234), 4, exps=exps)
    mesh = cpu_mesh(4)
    cfg = tcore.ExecConfig(routing=routing, max_results=512)
    want = j_apply(st, jops, 512, now=now)
    got = dist.shard_apply_ops(idx, port_ops(jops), mesh, config=cfg, now=now)
    assert_same_apply(want, got, f"ttl/{routing}/{clock}")
    if now is not None:
        assert int(got[2]["expired"]) == int(want[2]["expired"]) > 0
    later = 1100
    jq = jcore.make_ops(np.full(probe.shape, jcore.OP_POINT, np.int32), probe, pad_to=1024)[0]
    want2 = j_apply(want[0], jq, 8, now=later)
    got2 = dist.shard_apply_ops(got[0], port_ops(jq), mesh, now=later,
                                config=cfg.replace(max_results=8))
    assert_same(want2[1]["value"], got2[1]["value"])
    assert int(got2[2]["expired"]) == int(want2[2]["expired"]) > 0


def test_ttl_plane_appears_with_the_batch():
    """A TTL-free index promoted by a batch's expiry column, as in
    single-device ``apply_ops``."""
    rng = np.random.default_rng(5)
    keys, st, idx = build_pair(rng, 2)
    assert not idx.has_ttl
    k = np.setdiff1d(np.arange(0, KEY_SPACE, 7, dtype=np.int32), keys)[:64]
    jops = jcore.make_ops(np.full(64, jcore.OP_EXPIRE, np.int32), k, k + 1,
                          exps=jnp.asarray(np.full(64, 50, np.int32)), pad_to=64)[0]
    for routing in ("replicated", "a2a"):
        got = dist.shard_apply_ops(idx, port_ops(jops), cpu_mesh(2), now=10,
                                   config=tcore.ExecConfig(routing=routing))
        assert got[0].has_ttl
        assert_same_apply(j_apply(st, jops, 128, now=10), got, routing)


def test_plan_budget_capacity_and_mesh():
    for total in (None, 0, 1, 1000, 1 << 33):
        for s in (1, 2, 3, 4, 8):
            assert dist.plan_shard_budget(total, s) == jdist.plan_shard_budget(total, s)
    for chunk in (0, 1, 7, 64, 1000, 1 << 18):
        for s in (1, 2, 3, 4, 8):
            for h in (1.0, 2.0, 3.5):
                assert dist.default_a2a_capacity(chunk, s, headroom=h) == (
                    jdist.default_a2a_capacity(chunk, s, headroom=h)
                )
    assert dist.A2A_CAPACITY_HEADROOM == jdist.A2A_CAPACITY_HEADROOM
    mesh = cpu_mesh(3)
    assert mesh.shape == {"shards": 3} and mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="3 shards need 3 devices"):
        dist.make_shard_mesh(3, ["cpu"] * 2)
    rng = np.random.default_rng(2)
    keys, st, idx = build_pair(rng, 4, n=1024)
    # the union's planes, a flag a shard, and the two fence vectors
    assert dist.shard_memory_bytes(idx) == st.memory_bytes() + (4 - 1) + 2 * 4 * 4
    assert int(idx.live_keys()) == 1024
    with pytest.raises(ValueError, match="not divisible"):
        dist.shard_apply_ops(idx, tcore.make_ops([2], [5], device="cpu")[0], cpu_mesh(4),
                             config=tcore.ExecConfig(routing="a2a"))
    # the collectives: a gather, an exchange, an int32 sum and a min
    xs = [torch.tensor([s, 10 + s], dtype=torch.int32) for s in range(3)]
    g = dist.all_gather(xs, mesh)
    assert g[0] is g[2] and g[1].tolist() == [[0, 10], [1, 11], [2, 12]]
    sends = [torch.arange(3 * 2, dtype=torch.int32).reshape(3, 2) + 100 * s for s in range(3)]
    recv = dist.all_to_all(sends, mesh)
    assert recv[1].tolist() == [[2, 3], [102, 103], [202, 203]]
    big = [torch.tensor([2**30], dtype=torch.int32)] * 3
    assert dist.psum(big, "cpu").dtype == torch.int32
    assert dist.pmin(xs, "cpu").tolist() == [0, 10]


# ---------------------------------------------------------------------------
# the a2a-only fields against the reference's own sharded engine
# ---------------------------------------------------------------------------


def a2a_cases(n_shards):
    """Host inputs of the cases whose a2a fields are compared: a skewed
    read batch at capacity 64 (``shard_apply_ops_safe``'s capacity retries), and a
    clustered insert burst that overflows a shard (a regrow), at the
    default capacity."""
    rng = np.random.default_rng(40 + n_shards)
    n = 2048
    keys = np.sort(rng.permutation(KEY_SPACE)[:n]).astype(np.int32)
    vals = np.arange(n, dtype=np.int32)
    hi = int(keys[n // n_shards // 2])  # inside shard 0's range
    sk = rng.integers(0, hi, 1024).astype(np.int32)
    stag = np.full(1024, jcore.OP_POINT, np.int32)
    stag[:256] = jcore.OP_SUCCESSOR
    burst = np.setdiff1d(np.arange(0, hi, dtype=np.int32), keys)[:200]
    btag = np.concatenate([np.full(burst.size, jcore.OP_INSERT), np.full(56, jcore.OP_POINT),
                           np.full(8, jcore.OP_RANGE)]).astype(np.int32)
    bk = np.concatenate([burst, rng.integers(0, KEY_SPACE, 56), rng.integers(0, hi, 8)])
    bv = np.concatenate([burst * 3, np.zeros(56), bk[-8:] + 900]).astype(np.int32)
    return keys, vals, [
        ("skew", stag, sk, np.zeros(1024, np.int32), 64, 1024),
        ("burst", btag, bk.astype(np.int32), bv, None, 256),
    ]


CHILD = """
import json, sys
sys.path.insert(0, {tests!r})
import jax.numpy as jnp, numpy as np
from repro import core
from repro.core import distributed as dist
from repro.core.config import ExecConfig
from test_torch_distributed import a2a_cases

out = {{}}
for s in (2, 4):
    keys, vals, cases = a2a_cases(s)
    mesh = dist.make_shard_mesh(s)
    idx = dist.shard_build(jnp.asarray(keys), jnp.asarray(vals), mesh, node_size=16,
                           nodes_per_bucket=8)
    for name, tag, key, val, cap, pad in cases:
        ops, _ = core.make_ops(tag, key, val, pad_to=pad)
        new, res, st = dist.shard_apply_ops_safe(
            idx, ops, mesh, config=ExecConfig(routing="a2a", capacity=cap, max_results=64))
        out[f"{{name}}/{{s}}"] = dict(
            stats={{k: int(v) for k, v in st.items()}},
            part_fences=np.asarray(new.part_fences).tolist(),
            geometry=list(new.state.geometry),
            value=np.asarray(res["value"]).tolist(),
            succ_key=np.asarray(res["succ_key"]).tolist(),
            range_key=np.asarray(res["range_key"]).tolist(),
            range_count=np.asarray(res["range_count"]).tolist(),
        )
print("A2A " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_a2a():
    out = run_with_devices(CHILD.format(tests=str(TESTS)), n_devices=4)
    line = next(ln for ln in out.splitlines() if ln.startswith("A2A "))
    return json.loads(line[4:])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_a2a_fields_match_the_reference_sharded_engine(reference_a2a, n_shards):
    keys, vals, cases = a2a_cases(n_shards)
    mesh = cpu_mesh(n_shards)
    idx = dist.shard_build(t32(keys), t32(vals), mesh, node_size=16, nodes_per_bucket=8)
    for name, tag, key, val, cap, pad in cases:
        want = reference_a2a[f"{name}/{n_shards}"]
        ops = tcore.make_ops(tag, key, val, pad_to=pad, device="cpu")[0]
        cfg = tcore.ExecConfig(routing="a2a", capacity=cap, max_results=64)
        new, res, st = dist.shard_apply_ops_safe(idx, ops, mesh, config=cfg)
        for k in A2A_FIELDS + STAT_KEYS:
            assert int(st[k]) == want["stats"][k], (name, k)
        assert new.part_fences.tolist() == want["part_fences"], name
        assert list(new.geometry) == want["geometry"], name
        for k in ("value", "succ_key", "range_key", "range_count"):
            assert res[k].tolist() == want[k], (name, k)
    # the cases do what they are for
    skew = reference_a2a[f"skew/{n_shards}"]["stats"]
    assert skew["a2a_retries"] >= 1 and skew["a2a_overflow_dropped"] > 0
    assert reference_a2a[f"burst/{n_shards}"]["stats"]["restructure_retries"] == 1
    # unsafe at capacity 64: the overflow is reported and nothing retried
    ops = tcore.make_ops(cases[0][1], cases[0][2], pad_to=1024, device="cpu")[0]
    _, _, st = dist.shard_apply_ops(idx, ops, mesh,
                                    config=tcore.ExecConfig(routing="a2a", capacity=64))
    assert 0 < int(st["a2a_overflow"]) <= skew["a2a_overflow_dropped"]
