"""Port parity of the reads: point, successor and the dense RANGE machinery
against the JAX reference on the five adversarial query batches
(``tests/test_differential.py:73-87``), exact."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core import query as jquery  # noqa: E402
from repro.core.state import MAX_VALID  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402
from test_torch_common import EMPTY, assert_same, build_adversarial, t32  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def adversarial():
    return build_adversarial(np.random.default_rng(1234))


def _query_batches(rng, live, pad_to=1024):
    """The five batches, each padded with EMPTY to one length so that the
    reference compiles each read once."""
    absent = np.setdiff1d(np.arange(0, 130000, 7, dtype=np.int32), live)
    batches = {
        "duplicates": np.sort(np.repeat(rng.choice(live, 40), 8)).astype(np.int32),
        "all_miss": np.sort(rng.choice(absent, 300)).astype(np.int32),
        "boundary": np.array(
            [0, 0, 1, int(MAX_VALID) - 1, int(MAX_VALID), int(MAX_VALID)], np.int32
        ),
        "empty_buckets": np.arange(29000, 61000, 50, dtype=np.int32),
        "mixed": np.sort(
            np.concatenate([rng.choice(live, 200), rng.choice(absent, 200)])
        ).astype(np.int32),
    }
    return {
        name: np.concatenate([q, np.full(pad_to - len(q), EMPTY, np.int32)])
        for name, q in batches.items()
    }


@pytest.mark.parametrize(
    "batch", ["duplicates", "all_miss", "boundary", "empty_buckets", "mixed"]
)
def test_point_and_successor_match_reference(adversarial, batch):
    js, ts, live = adversarial
    q = _query_batches(np.random.default_rng(5), live)[batch]
    assert_same(jcore.point_query(js, jnp.asarray(q)), tcore.point_query(ts, t32(q)))
    jk, jv = jcore.successor_query(js, jnp.asarray(q))
    tk, tv = tcore.successor_query(ts, t32(q))
    assert_same(jk, tk, "succ_key")
    assert_same(jv, tv, "succ_val")


@pytest.mark.parametrize(
    "batch", ["duplicates", "all_miss", "boundary", "empty_buckets", "mixed"]
)
def test_dense_range_scan_matches_reference(adversarial, batch):
    """Each batch's keys as range lows, with widths from 0 to past the end of
    the key space; budgets that truncate and that fit."""
    js, ts, live = adversarial
    rng = np.random.default_rng(11)
    lo = _query_batches(np.random.default_rng(5), live)[batch]
    width = rng.integers(0, 4000, len(lo))
    hi = np.minimum(lo.astype(np.int64) + width, EMPTY).astype(np.int32)
    hi[::7] = EMPTY
    is_range = rng.random(len(lo)) < 0.7
    for max_results in (64, 4096):
        want = jcore.dense_range_scan(
            js, jnp.asarray(is_range), jnp.asarray(lo), jnp.asarray(hi),
            max_results=max_results,
        )
        got = tcore.dense_range_scan(
            ts, torch.as_tensor(is_range), t32(lo), t32(hi), max_results=max_results
        )
        for w, g, name in zip(want, got, ("keys", "vals", "start", "count", "trunc")):
            assert_same(w, g, f"{name}@{max_results}")


def test_suffix_min_ties_go_to_the_higher_index():
    rng = np.random.default_rng(2)
    for g in (
        np.array([5, EMPTY, EMPTY, 3, EMPTY, EMPTY], np.int32),
        np.full(9, EMPTY, np.int32),
        rng.integers(-4, 4, 200).astype(np.int32),  # many ties, negative keys
    ):
        jv, ji = jquery._suffix_min_with_index(jnp.asarray(g))
        tv, ti = tquery._suffix_min_with_index(t32(g))
        assert_same(jv, tv)
        assert_same(ji, ti)


def test_range_offsets_and_slot_ranks_match_reference():
    rng = np.random.default_rng(4)
    full = rng.integers(0, 300, 500).astype(np.int32)
    full[::13] = 1 << 30  # whole-keyspace floods must not wrap the scan
    is_range = rng.random(500) < 0.5
    rank_lo = rng.integers(0, 1 << 20, 500).astype(np.int32)
    for mr in (1, 128, 100000):
        want = jquery.range_offsets(jnp.asarray(full), jnp.asarray(is_range), mr)
        got = tquery.range_offsets(t32(full), torch.as_tensor(is_range), mr)
        for w, g in zip(want, got):
            assert_same(w, g)
        assert_same(
            jquery.range_slot_ranks(jnp.asarray(rank_lo), want[0], want[2], mr),
            tquery.range_slot_ranks(t32(rank_lo), got[0], got[2], mr),
        )
