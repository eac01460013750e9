"""Durability parity: ``repro_torch.checkpoint`` against the JAX reference's
``repro.checkpoint`` on the CPU, byte for byte.

Both packages' ``DurableFliX`` run the same batches (the crash harness's
mixed workload, whose clustered inserts force a restructure at 8x4, and
its TTL workload, each ending in a flood of inserts that overflows a
bucket at every geometry) at 8x4 and 32x16, the port on its fused path.
Along the way every canonical payload, digest, bucket segment, segment crc
and delta frame of the two packages' states is equal, and so is every
file of the two durable directories after every commit: payloads,
manifests and WAL segments.  A directory and a WAL written by either
package open in the other to the same bytes.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fault_injection as fi  # noqa: E402
from repro.checkpoint import DurableFliX as JDurable  # noqa: E402
from repro.checkpoint import LocalEngine as JEngine  # noqa: E402
from repro.checkpoint import load_snapshot_chain as jdur_chain  # noqa: E402
from repro.checkpoint import serialize as jser  # noqa: E402
from repro.checkpoint import wal as jwal  # noqa: E402
from repro.core.config import ExecConfig as JConfig  # noqa: E402
from repro.core.ops import OpBatch as JOpBatch  # noqa: E402
from repro_torch.checkpoint import DurableFliX, LocalEngine  # noqa: E402
from repro_torch.checkpoint import load_snapshot_chain as tdur_chain  # noqa: E402
from repro_torch.checkpoint import serialize as tser  # noqa: E402
from repro_torch.checkpoint import wal as twal  # noqa: E402
from repro_torch.core import ExecConfig, OpBatch  # noqa: E402
from repro_torch.core.expiry import NO_EXPIRY  # noqa: E402
from repro_torch.core.ops import OP_INSERT, OP_POINT  # noqa: E402
from test_torch_common import assert_same_state  # noqa: E402

torch.set_num_threads(1)

GEOMETRIES = {"8x4": dict(node_size=8, nodes_per_bucket=4),
              "32x16": dict(node_size=32, nodes_per_bucket=16)}
WORKLOADS = ("mixed", "ttl")
CASES = [(g, w) for g in GEOMETRIES for w in WORKLOADS]
N_MIXED, N_TTL = 10, 8


def flood_batch(t: int):
    """600 fresh inserts above the workloads' key space, with 16 reads:
    they all route to the last bucket and overflow it at every geometry."""
    keys = np.arange(fi.KEY_SPACE + 7, fi.KEY_SPACE + 7 + 616, dtype=np.int32)
    tag = np.where(np.arange(616) < 600, OP_INSERT, OP_POINT).astype(np.int32)
    return tag, keys, keys * 3 + t, 64


def workload(kind: str):
    """``(tag, key, val, exp, now, max_results)`` of every batch, host arrays."""
    if kind == "mixed":
        out = [(*b[:3], None, None, b[3]) for b in map(fi.make_batch_host, range(1, N_MIXED + 1))]
        tag, key, val, mr = flood_batch(N_MIXED + 1)
        return out + [(tag, key, val, None, None, mr)]
    out = [fi.make_batch_host_ttl(t) for t in range(1, N_TTL + 1)]
    tag, key, val, mr = flood_batch(N_TTL + 1)
    exp = np.where(tag == OP_INSERT, (N_TTL + 1) * fi.TTL_TICK + 500, int(NO_EXPIRY))
    return out + [(tag, key, val, exp.astype(np.int32), (N_TTL + 1) * fi.TTL_TICK, mr)]


def initial(kind: str):
    return fi.initial_pairs() if kind == "mixed" else fi.initial_pairs_ttl()


def dir_files(d) -> dict[str, bytes]:
    d = Path(d)
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


_RUNS: dict = {}


def durable_run(geometry: str, kind: str, root: Path):
    """Both packages' ``DurableFliX`` over the workload, from the same
    initial triples: per seq, the two states and the two directories'
    files.  Cached per case for the module."""
    if (geometry, kind) in _RUNS:
        return _RUNS[geometry, kind]
    geo = GEOMETRIES[geometry]
    jdir, tdir = root / f"{geometry}-{kind}-jax", root / f"{geometry}-{kind}-port"
    jeng = JEngine(**geo)
    teng = LocalEngine(**geo, config=ExecConfig(impl="fused"), device="cpu")
    kw = dict(snapshot_every=3, full_every=2)
    jd = JDurable.create(jdir, jeng.rebuild(*initial(kind)), engine=jeng, **kw)
    td = DurableFliX.create(tdir, teng.rebuild(*initial(kind)), engine=teng, **kw)
    seqs = [(jd.state, td.state, dir_files(jdir), dir_files(tdir))]
    for t, (tag, key, val, exp, now, mr) in enumerate(workload(kind), start=1):
        meta = {"batch": t} if t % 2 else None
        jd.apply(JOpBatch.from_host(tag, key, val, exp), config=JConfig(max_results=mr),
                 meta=meta, now=now)
        td.apply(OpBatch.from_host(tag, key, val, exp, device="cpu"),
                 config=ExecConfig(max_results=mr), meta=meta, now=now)
        assert jd.seq == td.seq == t and jd.epoch == td.epoch
        assert jd.meta_trail() == td.meta_trail()
        seqs.append((jd.state, td.state, dir_files(jdir), dir_files(tdir)))
    jd.close()
    td.close()
    _RUNS[geometry, kind] = (seqs, jdir, tdir, jd.epoch)
    return _RUNS[geometry, kind]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    yield tmp_path_factory.mktemp("durable")
    _RUNS.clear()


@pytest.mark.parametrize("geometry,kind", CASES)
def test_canonical_payloads_match(root, geometry, kind):
    """canonical_state_bytes, state_digest and parse_canonical at every seq."""
    seqs, *_ = durable_run(geometry, kind, root)
    for s, (js, ts, _, _) in enumerate(seqs):
        want = jser.canonical_state_bytes(js)
        got = tser.canonical_state_bytes(ts)
        assert got == want, f"seq {s}"
        assert tser.state_digest(ts) == jser.state_digest(js)
        for a, b in zip(jser.parse_canonical(got), tser.parse_canonical(want)):
            np.testing.assert_array_equal(a, b)
    if kind == "ttl":
        assert (tser.parse_canonical(got)[2] != int(NO_EXPIRY)).any()


@pytest.mark.parametrize("geometry,kind", CASES)
def test_bucket_segments_and_crcs_match(root, geometry, kind):
    """bucket_segments over all buckets and over a dirty list (in request
    order, unsorted), and segment_crcs of each, at every seq."""
    seqs, *_ = durable_run(geometry, kind, root)
    rng = np.random.default_rng(5)
    for s, (js, ts, _, _) in enumerate(seqs):
        nb = ts.num_buckets
        dirty = rng.permutation(nb)[: max(1, nb // 3)]
        for buckets in (None, dirty):
            want = jser.bucket_segments(js, buckets)
            got = tser.bucket_segments(ts, buckets)
            for w, g in zip(want, got):
                assert g.dtype == np.int32, g.dtype
                np.testing.assert_array_equal(w, g, err_msg=f"seq {s}")
            assert tser.segment_crcs(*got) == jser.segment_crcs(*want)


@pytest.mark.parametrize("geometry,kind", CASES)
def test_delta_frames_match(root, geometry, kind):
    """pack_delta of a dirty list's segments, and parse_delta both ways."""
    seqs, *_ = durable_run(geometry, kind, root)
    for js, ts, _, _ in seqs[1:]:
        dirty = np.arange(0, ts.num_buckets, 2)
        segs = tser.bucket_segments(ts, dirty)
        got = tser.pack_delta(dirty, *segs)
        assert got == jser.pack_delta(dirty, *jser.bucket_segments(js, dirty))
        for a, b in zip(jser.parse_delta(got), tser.parse_delta(got)):
            np.testing.assert_array_equal(a, b)
    assert tser.pack_delta([], [], [], []) == jser.pack_delta([], [], [], [])


@pytest.mark.parametrize("geometry,kind", CASES)
def test_snapshot_directories_are_byte_identical(root, geometry, kind):
    """Every file of the two durable directories after every commit: full
    and delta payloads, manifests, WAL segments, and what GC removed."""
    seqs, _, _, epoch = durable_run(geometry, kind, root)
    kinds = set()
    for s, (_, _, jf, tf) in enumerate(seqs):
        assert sorted(tf) == sorted(jf), f"seq {s}"
        for name in jf:
            assert tf[name] == jf[name], f"seq {s}: {name}"
            if name.endswith("manifest.json"):
                kinds.add(json.loads(jf[name])["kind"])
    assert kinds == {"full", "delta"} and epoch >= 1  # the flood restructured


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("geometry,kind", CASES)
def test_directory_opens_in_the_other_package(root, tmp_path, geometry, kind, writer):
    """A directory written by either package, opened by the other, lands on
    the writer's final canonical bytes, seq and meta trail."""
    seqs, jdir, tdir, _ = durable_run(geometry, kind, root)
    js, ts, _, _ = seqs[-1]
    src = jdir if writer == "jax" else tdir
    d = tmp_path / "copy"
    shutil.copytree(src, d)
    geo = GEOMETRIES[geometry]
    if writer == "jax":
        dur = DurableFliX.open(d, engine=LocalEngine(**geo, device="cpu"))
        got = tser.canonical_state_bytes(dur.state)
    else:
        dur = JDurable.open(d, engine=JEngine(**geo))
        got = jser.canonical_state_bytes(dur.state)
    try:
        assert dur.seq == len(seqs) - 1
        assert got == jser.canonical_state_bytes(js) == tser.canonical_state_bytes(ts)
        assert [s for s, _ in dur.meta_trail()] == list(range(1, len(seqs), 2))
    finally:
        dur.close()


@pytest.mark.parametrize("geometry,kind", CASES)
def test_state_from_pairs_matches(root, geometry, kind):
    """The rebuild from the final triples: the reference's arrays, geometry
    (bucket count rounded up to a multiple of 8) and expiry plane included."""
    seqs, *_ = durable_run(geometry, kind, root)
    keys, vals, exps = tser.parse_canonical(tser.canonical_state_bytes(seqs[-1][1]))
    geo = GEOMETRIES[geometry]
    want = jser.state_from_pairs(keys, vals, exps, **geo)
    got = tser.state_from_pairs(keys, vals, exps, **geo, device="cpu")
    assert got.geometry == want.geometry and got.num_buckets % 8 == 0
    assert_same_state(want, got, live_vals_only=False)
    assert (got.exps is None) == (want.exps is None) == (kind == "mixed")
    if got.exps is not None:
        np.testing.assert_array_equal(np.asarray(want.exps), got.exps.numpy())


def test_encode_ops_matches():
    """encode_ops in both record forms, with and without meta, and
    decode_ops of each package on the other's bytes."""
    rng = np.random.default_rng(3)
    tag, key, val, mr = fi.make_batch_host(4)
    ttag, tkey, tval, texp, now, tmr = fi.make_batch_host_ttl(5)
    cases = [
        ((tag, key, val, mr), {}),
        ((tag, key, val, mr, b'{"k": [1, 2]}'), {}),
        ((ttag, tkey, tval, tmr), dict(exp=texp, now=now)),
        ((ttag, tkey, tval, tmr, b"m"), dict(exp=texp, now=None)),
        ((rng.integers(0, 7, 0), np.zeros(0), np.zeros(0), 1), dict(exp=np.zeros(0))),
    ]
    for args, kw in cases:
        got = twal.encode_ops(*args, **kw)
        assert got == jwal.encode_ops(*args, **kw)
        for a, b in zip(jwal.decode_ops(got), twal.decode_ops(got)):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def _fill_wal(pkg, d, n=6):
    """A single-segment WAL of ``n`` real batch records; frame end offsets."""
    wal = pkg.WriteAheadLog(d)
    wal.open_segment(1)
    ends, off = [], 0
    for s in range(1, n + 1):
        tag, key, val, mr = fi.make_batch_host(s)
        payload = pkg.encode_ops(tag[: 4 * s], key[: 4 * s], val[: 4 * s], mr)
        wal.append(s, payload)
        off += pkg.REC_HEADER_SIZE + len(payload)
        ends.append(off)
    wal.close()
    return ends


# the torn-tail cut offsets of test_crash_recovery.py
CUTS = [1, 7, 15, 16, 17, 40, 99, 150, -1, -17]


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_replays_in_the_other_package(tmp_path, writer, cut):
    """A WAL written by either package is the other's byte for byte, and
    replays there after a tear at any of the reference's cut offsets."""
    jd, td = tmp_path / "j", tmp_path / "t"
    jd.mkdir(), td.mkdir()
    ends = _fill_wal(jwal, jd)
    assert _fill_wal(twal, td) == ends
    seg = "wal_000000000001.log"
    assert (jd / seg).read_bytes() == (td / seg).read_bytes()
    src, reader = (jd, twal) if writer == "jax" else (td, jwal)
    data = (src / seg).read_bytes()
    c = cut % len(data)
    (src / seg).write_bytes(data[:c])
    want = sum(1 for e in ends if e <= c)
    recs = reader.replay(src)
    assert [s for s, _ in recs] == list(range(1, want + 1))
    other = jwal if reader is twal else twal
    for (s, payload), (s2, p2) in zip(recs, other.replay(src)):
        assert (s, payload) == (s2, p2)
    assert (src / seg).stat().st_size == (ends[want - 1] if want else 0)


def test_empty_dirty_list_differs_from_the_reference(tmp_path):
    """A delta over no dirty bucket: the reference's ``bucket_segments``
    raises (``reshape(0, -1)`` of an empty selection), so its
    ``DurableFliX`` cannot snapshot after a batch with no update op; the
    port writes an empty delta, which both packages load."""
    jst = JEngine(**fi.GEOMETRY).rebuild(*fi.initial_pairs())
    with pytest.raises(ValueError):
        jser.bucket_segments(jst, [])
    eng = LocalEngine(**fi.GEOMETRY, device="cpu")
    lens, k, v, e = tser.bucket_segments(eng.rebuild(*fi.initial_pairs()), [])
    assert lens.size == k.size == v.size == e.size == 0 and k.dtype == np.int32
    dur = DurableFliX.create(tmp_path / "d", eng.rebuild(*fi.initial_pairs()), engine=eng)
    tag = np.full(4, OP_POINT, np.int32)
    dur.apply(OpBatch.from_host(tag, np.arange(4), np.zeros(4), device="cpu"))
    path = dur.snapshot()
    dur.close()
    assert json.loads((path / "manifest.json").read_text())["kind"] == "delta"
    want = jser.canonical_state_bytes(jst)
    for pkg_chain, ser in ((jdur_chain, jser), (tdur_chain, tser)):
        keys, vals, exps, _ = pkg_chain(tmp_path / "d", 1)
        assert ser.pairs_to_bytes(keys, vals, exps) == want
