"""The yardstick's own parts on the CPU: generators, key streams, the
bytes a batch needs, the operation encoding and the import rules."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from flixbench import opcodes
from flixbench.generators.index_ops import IndexOps, counts_of
from flixbench.keys import KeyRing, fnv1a64, scrambled_zipf
from flixbench.roofline import apply_bytes

BENCH = Path(__file__).resolve().parent.parent
INDEX_CONFIG = {"build_keys": 1024, "key_space_bits": 14}
MIXED = {"batch_ops": 512, "range_width": 64, "hit_keys": "uniform",
         "shares": {"insert": 0.2, "delete": 0.2, "point_hit": 0.25, "point_miss": 0.25,
                    "successor": 0.09, "range": 0.01}}
YCSB_A = {"batch_ops": 512, "hit_keys": "scrambled_zipf",
          "shares": {"point_hit": 0.5, "update": 0.5}}


def batches(seed, n, params=MIXED):
    gen = IndexOps(params, INDEX_CONFIG, seed, "cpu")
    return gen, [gen.next() for _ in range(n)]


def test_key_ring_is_a_bijection_and_depends_on_the_seed():
    a = KeyRing(12, 4096, seed=5).key(torch.arange(4096))
    assert torch.unique(a).numel() == 4096 and int(a.min()) >= 0 and int(a.max()) < 4096
    b = KeyRing(12, 4096, seed=6).key(torch.arange(4096))
    assert not torch.equal(a, b)
    ring = KeyRing(29, 1 << 20, seed=3 << 33)  # a seed past 32 bits
    assert torch.unique(ring.key(torch.arange(1 << 20))).numel() == 1 << 20


def test_index_batches_repeat_per_seed_and_keep_their_counts():
    _, one = batches(2**33 + 7, 3)
    _, two = batches(2**33 + 7, 3)
    _, other = batches(11, 3)
    for x, y in zip(one, two):
        assert torch.equal(x.keys, y.keys) and torch.equal(x.tags, y.tags)
        assert torch.equal(x.vals, y.vals) and x.base == y.base
    assert not torch.equal(one[0].keys, other[0].keys)
    want = counts_of(512, MIXED["shares"])
    assert sum(want.values()) == 512
    for b in one + other:
        got = {t: int((b.tags == t).sum()) for t in range(7)}
        assert got[opcodes.INSERT] == want["insert"] and got[opcodes.DELETE] == want["delete"]
        assert got[opcodes.POINT] == want["point_hit"] + want["point_miss"]
        assert got[opcodes.RANGE] == want["range"]


def test_index_batches_keep_the_live_count_steady():
    gen, bs = batches(4, 12)
    live = set(gen.ring.window(0, 1024, "cpu")[0].tolist())
    for b in bs:
        ins = b.keys[b.tags == opcodes.INSERT].tolist()
        dels = b.keys[b.tags == opcodes.DELETE].tolist()
        assert not live & set(ins) and set(dels) <= live
        live = (live - set(dels)) | set(ins)
        assert len(live) == 1024
        assert live == set(gen.ring.window(b.base + len(dels), 1024, "cpu")[0].tolist())
        points = b.keys[b.tags == opcodes.POINT]
        hits = sum(k in live for k in points.tolist())
        assert hits == counts_of(512, MIXED["shares"])["point_hit"]


def test_scrambled_zipf_is_skewed_and_deterministic():
    gen = torch.Generator().manual_seed(3)
    a = scrambled_zipf(1 << 16, 1 << 20, gen)
    gen.manual_seed(3)
    assert torch.equal(a, scrambled_zipf(1 << 16, 1 << 20, gen))
    assert int(a.min()) >= 0 and int(a.max()) < 1 << 20
    counts = torch.bincount(a).sort(descending=True).values
    assert int(counts[0]) / a.numel() > 1 / 26.469 - 0.005  # rank 0: 1/zeta of the draws
    # YCSB's fnvhash64 in exact integers: 8 octets, Java's wrapping longs, Math.abs
    vals = [0, 1, 12345678901, 2**62 + 17]
    want = []
    for v in vals:
        h = 0xCBF29CE484222325
        for _ in range(8):
            h = ((h ^ (v & 0xFF)) * 1099511628211) % (1 << 64)
            v >>= 8
        want.append(abs(h - (1 << 64) if h >= 1 << 63 else h))
    assert fnv1a64(torch.tensor(vals, dtype=torch.int64)).tolist() == want


@pytest.mark.parametrize("seed", [1, 2**40 + 3])
def test_updates_are_coalesced_and_replayed(seed):
    gen, bs = batches(seed, 6, YCSB_A)
    _, again = batches(seed, 6, YCSB_A)
    values = dict(zip(*(t.tolist() for t in gen.initial())))
    walk = gen.replay(len(bs))
    for b, c in zip(bs, again):
        assert torch.equal(b.keys, c.keys) and torch.equal(b.vals, c.vals)
        i, base, table, inserted = next(walk)
        pos = torch.arange(base, base + 1024)
        assert dict(zip(gen.ring.key(pos).tolist(), table[pos].tolist())) == values
        ins = b.tags == opcodes.INSERT
        nop = b.tags == opcodes.NOP
        assert int(ins.sum()) + int(nop.sum()) == 256 and int(ins.sum()) == inserted
        assert int(nop.sum()) > 0  # Zipfian draws repeat keys: duplicates were coalesced
        sent = b.keys[ins].tolist()
        assert len(set(sent)) == len(sent) and set(sent) <= set(values)
        assert (b.keys[nop] == opcodes.EMPTY).all()
        values.update(zip(sent, b.vals[ins].tolist()))
    i, base, table, inserted = next(walk)
    assert i == 6 and inserted is None
    pos = torch.arange(base, base + 1024)
    assert dict(zip(gen.ring.key(pos).tolist(), table[pos].tolist())) == values


def test_the_last_update_drawn_of_a_key_is_sent():
    rows_pos, _, rows_sent = IndexOps(YCSB_A, INDEX_CONFIG, 8, "cpu")._updates(0, 3)
    for pos, sent in zip(rows_pos, rows_sent):
        for p in set(pos.tolist()):
            drawn = torch.nonzero(pos == p)[:, 0]
            assert sent[drawn].tolist() == [False] * (drawn.numel() - 1) + [True]


def test_apply_bytes_counts_a_hand_built_state():
    # 4 buckets (fences 10, 20, 30, MAX), 2 nodes of 4 keys each
    mkba = torch.tensor([10, 20, 30, opcodes.MAX_VALID], dtype=torch.int32)
    before = torch.tensor([1, 2, 1, 0], dtype=torch.int32)
    after = torch.tensor([1, 2, 2, 0], dtype=torch.int32)

    class B:
        tags = torch.tensor([opcodes.POINT, opcodes.INSERT, opcodes.RANGE], dtype=torch.int32)
        keys = torch.tensor([5, 25, 12], dtype=torch.int32)
        vals = torch.tensor([0, 1, 28], dtype=torch.int32)

    got = apply_bytes(B, mkba, before, after, npb=2, ns=4, max_results=8)
    row, meta = 16, 8  # a node row of 4 int32 keys; a row of 2 int32 per bucket
    read = (1 * row + meta) + (2 * row + meta) + (1 * row + meta)  # buckets 0, 1 (range), 2
    read += 1 * row + meta  # bucket 2 updated: its values and node_count
    written = 2 * 2 * row + 2 * meta + 4  # bucket 2's rows as after, both metadata rows
    assert got == read + written + 3 * 12 + 3 * 16 + 8 * 8


def test_opcodes_are_the_programs():
    from repro_torch import core

    for name in ("INSERT", "DELETE", "POINT", "SUCCESSOR", "NOP", "RANGE"):
        assert getattr(opcodes, name) == getattr(core, f"OP_{name}")
    for name in ("EMPTY", "MAX_VALID", "NOT_FOUND"):
        assert getattr(opcodes, name) == getattr(core, name)


def imported(path: Path) -> set[str]:
    """Top-level names of every module the file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imported(f) & {"jax", "jaxlib", "flax", "repro"}, f
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "repro_torch" not in imported(f), f
    # what the reference imports of the benchmark imports nothing of the program
    assert "repro_torch" not in imported(BENCH / "opcodes.py")
