"""CPU tests of the reduction of the program's spans (``portbench/spans.py``):
each span metric on synthetic records, and idle gaps labelled by program
spans on a synthetic trace."""

from __future__ import annotations

import pytest

from portbench import spans
from portbench.trace import Trace
from repro_torch.core.spans import SpanRecord

T0 = 1_700_000_000_000_000_000  # the profiler's trace_start_ns
MAIN, PRODUCER = 101, 202


def rec(name, a_us, b_us, tid=MAIN, device_s=None):
    return SpanRecord(name, 0, None, tid, T0 + int(a_us * 1e3), T0 + int(b_us * 1e3),
                      device_s=device_s)


RECORDS = [
    rec("trainer.data_wait", 0, 2000),  # host: 2 ms
    rec("loader.draw", 0, 30000, tid=PRODUCER),  # host: 30 ms
    rec("loader.draw", 40000, 50000, tid=PRODUCER),  # host: 10 ms
    rec("engine.recompute", 0, 1, device_s=0.25),
    rec("engine.recompute", 0, 1, device_s=0.15),
    rec("engine.accumulate", 0, 1, device_s=0.01),
    rec("engine.pool_mean", 0, 1, device_s=0.02),
    rec("engine.adamw", 0, 1, device_s=0.08),
    rec("engine.microbatch", 0, 1, device_s=0.9),
]


@pytest.mark.parametrize("name, want", [
    ("loader_wait_pct", 0.1), ("loader_busy_pct", 2.0), ("recompute_pct", 20.0),
    ("accumulate_pct", 0.5), ("update_pct", 5.0),
])
def test_each_share_of_the_window(name, want):
    """Host spans count their host time, device-timed spans their device
    pair's, over the profiled steps' wall (2 s)."""
    assert spans.metrics(RECORDS, [], 2.0)[name] == pytest.approx(want)


def test_first_signature_seconds_over_set_up():
    setup = [rec("engine.first_signature", 0, 9e6, device_s=4.5),
             rec("engine.first_signature", 0, 1, device_s=1.5),
             rec("engine.microbatch", 0, 1, device_s=0.5)]
    got = spans.metrics(RECORDS, setup, 2.0)
    assert got["first_signature_s"] == pytest.approx(6.0)
    assert set(got) == {*spans.SHARES, "first_signature_s"}


def test_a_program_without_spans_reads_nothing():
    assert spans.metrics([], [], 2.0) == {}
    assert spans.share_pct(RECORDS, ("engine.adamw",), 0.0) is None


def test_gaps_take_the_program_span_that_holds_most_of_them():
    """Kernels at 0-10, 20-30, 40-50, 60-70 us: the first gap is held 3 us
    by one span and 7 by another; the second only by spans of the loader's
    producer thread; the third whole by a span and its inner span."""
    tr = Trace([("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 40.0, 50.0), ("k", 60.0, 70.0)],
               [], 100e-6)
    records = [
        rec("a", 8, 13), rec("b", 13, 30),
        rec("loader.draw", 25, 45, tid=PRODUCER), rec("other", 29, 41, tid=PRODUCER),
        rec("trainer.step", 45, 100), rec("engine.adamw", 48, 62),
    ]
    rows = spans.on_trace(records, T0)
    assert ("b", 13.0, 30.0) in rows and not any(r[0] == "other" for r in rows)
    gaps = spans.labelled_gaps(tr, rows)
    assert [name for name, _ in gaps] == ["b", "between spans", "engine.adamw", "edges"]
    assert [s for _, s in gaps] == pytest.approx([10e-6, 10e-6, 10e-6, 30e-6])
    assert [name for name, _ in tr.gaps()] == ["between spans"] * 3 + ["edges"]
    assert spans.idle_by_label(gaps + [("b", 5e-6)]) == pytest.approx(
        {"b": 15e-6, "between spans": 10e-6, "engine.adamw": 10e-6, "edges": 30e-6})


def test_two_spans_that_hold_a_gap_alike_give_it_to_the_shorter():
    assert spans.label([("outer", 0.0, 100.0), ("inner", 5.0, 20.0)], 10.0, 15.0) == "inner"
    assert spans.label([("outer", 0.0, 100.0), ("inner", 5.0, 12.0)], 10.0, 15.0) == "outer"
    assert spans.label([("far", 20.0, 30.0)], 10.0, 15.0) is None
