"""The benchmark's readers of the program's own spans
(``flixbench/metrics/syncs_per_batch.py``, ``sync_wait_ms.py`` and
``idle_ms.engine.py``, on ``flixbench/program_spans.py``): exact values on
a hand-made trace, None where the trace holds no program span (a program
older than its tracing module) or no card, and the counts a tiny traced
run of each cell reports on the CPU; and ``tools/span_breakdown.py``'s
split of the same trace by span."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from flixbench import devtrace, harness, program_spans  # noqa: E402

READERS = ("syncs_per_batch", "sync_wait_ms", "idle_ms.engine")


def reader(name):
    return harness.load_module(REPO / "flixbench" / "metrics" / f"{name}.py").read


def run_of(trace, traced_steps=2):
    return harness.Run("test card", setup_s=0.0, trace=trace, traced_steps=traced_steps)


# the window [0, 1000) us; the card busy over [100, 350) and [600, 700), so
# idle over [0, 100), [350, 600) and [700, 1000)
DEVICE = [("k1", 100.0, 200.0), ("k2", 250.0, 100.0), ("k3", 600.0, 100.0)]
HOST = [
    ("flixbench.apply", 40.0, 700.0),  # the harness's own span: not the program's
    ("aten::add", 300.0, 500.0),
    ("repro_torch.make_ops", -50.0, 30.0),  # starts before the window: left out
    ("repro_torch.apply_ops_safe", 50.0, 600.0),  # [50, 650)
    ("repro_torch.route", 60.0, 30.0),  # nested
    ("repro_torch.sync.has_updates", 95.0, 10.0),  # nested, a sync mark
    ("repro_torch.sync.needs_restructure", 400.0, 150.0),  # nested, a sync mark
    ("repro_torch.unsort", 800.0, 50.0),  # [800, 850)
    ("repro_torch.sync.late", 1000.0, 5.0),  # starts as the window closes: left out
]


def hand_made(host=HOST, device=DEVICE):
    return devtrace.Trace(list(device), list(host), (0.0, 1000.0))


def test_readers_on_a_hand_made_trace():
    run = run_of(hand_made())
    assert reader("syncs_per_batch")(run) == 1.0  # two marks over two steps
    assert reader("sync_wait_ms")(run) == pytest.approx((10 + 150) * 1e-3 / 2, abs=1e-15)
    # the program covers [50, 650) and [800, 850): 50 + 250 + 50 us of idle card
    assert reader("idle_ms.engine")(run) == pytest.approx(350 * 1e-3 / 2, abs=1e-15)


def test_span_breakdown_splits_the_idle_time_by_span():
    tool = harness.load_module(REPO / "tools" / "span_breakdown.py")
    rows, outside = tool.breakdown(hand_made(), steps=2)
    # apply_ops_safe's own time: [50, 60), [90, 95), [105, 400), [550, 650)
    want = {
        "apply_ops_safe": [0.5, 0.3, 0.205, 0.0575],
        "route": [0.5, 0.015, 0.015, 0.015],
        "sync.has_updates": [0.5, 0.005, 0.005, 0.0025],
        "sync.needs_restructure": [0.5, 0.075, 0.075, 0.075],
        "unsort": [0.5, 0.025, 0.025, 0.025],
    }
    assert set(rows) == set(want)
    for name, row in want.items():
        assert rows[name] == pytest.approx(row, abs=1e-12), name
    # the spans' idle sums to idle_ms.engine's reading; the rest lies outside
    assert sum(r[3] for r in rows.values()) == pytest.approx(
        reader("idle_ms.engine")(run_of(hand_made())), abs=1e-12)
    assert outside == pytest.approx((650 - 350) * 1e-3 / 2, abs=1e-12)


def test_interval_helpers():
    assert program_spans.merged([(5, 7), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 7]]
    assert program_spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert program_spans.overlap([(0, 1)], [(1, 2)]) == 0
    assert program_spans.idle_intervals(hand_made()) == [(0.0, 100.0), (350.0, 600.0),
                                                         (700.0, 1000.0)]
    assert program_spans.idle_intervals(hand_made(device=[])) == [(0.0, 1000.0)]


@pytest.mark.parametrize("name", READERS)
def test_no_program_span_no_reading(name):
    older = [e for e in HOST if not e[0].startswith("repro_torch.")]
    outside = [e for e in HOST if e[0] in ("repro_torch.make_ops", "repro_torch.sync.late")]
    for trace in (hand_made(older), hand_made(older + outside)):
        assert reader(name)(run_of(trace)) is None
    assert reader(name)(run_of(None)) is None
    assert reader(name)(run_of(hand_made(), traced_steps=0)) is None


def test_no_sync_mark_reads_zero():
    no_sync = [e for e in HOST if ".sync." not in e[0]]
    run = run_of(hand_made(no_sync))
    assert reader("syncs_per_batch")(run) == 0.0
    assert reader("sync_wait_ms")(run) == 0.0


def test_no_card_no_wait():
    run = run_of(hand_made(device=[]))
    assert reader("syncs_per_batch")(run) == 1.0  # a count holds without a card
    assert reader("sync_wait_ms")(run) is None
    assert reader("idle_ms.engine")(run) is None


@pytest.mark.parametrize("cell", ["u26-mixed", "u26-ycsbc-zipf", "u26-mixed-small"])
def test_tiny_traced_run_reports_the_sync_marks(cell):
    """On the CPU ``impl="auto"`` runs the reference engine with no
    ``has_updates`` read: five phase checks and ``needs_restructure`` a
    batch; the card's readings are left out."""
    from flixbench.tests.tiny import run_tiny

    line, _ = run_tiny(cell, 2**33 + 5, trace=True)
    assert line["correct"]
    assert line["metrics"]["syncs_per_batch"] == {"value": 6.0, "unit": "syncs"}
    assert "sync_wait_ms" not in line["metrics"]
    assert "idle_ms.engine" not in line["metrics"]
