"""The program's spans as the benchmark would read them: on the device
trace's clock, as labels of its idle gaps, and as the six span metrics.

A span is a record of ``repro_torch.core.spans`` (``name``, ``tid``,
``start_ns`` and ``end_ns`` in ``time.time_ns()``, and ``seconds``: the
device's time where the span has a CUDA-event pair, the host's otherwise);
nothing here imports the program.  The profiler stamps an event at
``prof.profiler.kineto_results.trace_start_ns()`` plus its offset, so a
span lies on the trace's microseconds at ``(start_ns - trace_start_ns) /
1e3``.

``harness.py`` does not record spans yet, so no cell reads these: the edits
that would (in ``harness.py``, ``trace.py`` and ``BENCHMARK.json``) are in
``PERF.md``'s Open questions.
"""

from __future__ import annotations

PRODUCER = "loader.draw"  # the loader's producer thread records only this

#: each share's spans, summed over the profiled steps' wall (``Trace.window_s``)
SHARES = {
    "loader_wait_pct": ("trainer.data_wait",),
    "loader_busy_pct": ("loader.draw",),
    "recompute_pct": ("engine.recompute",),
    "accumulate_pct": ("engine.accumulate",),
    "update_pct": ("engine.pool_mean", "engine.adamw"),
}
FIRST_SIGNATURE = "engine.first_signature"  # summed over set-up: ``first_signature_s``


def on_trace(records, trace_start_ns: int) -> list[tuple[str, float, float]]:
    """``(name, start_us, end_us)`` of every span that can label a gap: all
    but the loader's producer thread's, on the trace's microseconds."""
    producer = {r.tid for r in records if r.name == PRODUCER}
    return [(r.name, (r.start_ns - trace_start_ns) / 1e3, (r.end_ns - trace_start_ns) / 1e3)
            for r in records if r.tid not in producer]


def label(rows, a: float, b: float) -> str | None:
    """The span that holds most of the stretch ``[a, b]`` (us), the shorter
    of two that hold as much (the innermost); None if none overlaps it."""
    best, key = None, None
    for name, s0, s1 in rows:
        overlap = min(b, s1) - max(a, s0)
        if overlap > 0 and (key is None or (overlap, s0 - s1) > key):
            best, key = name, (overlap, s0 - s1)
    return best


def labelled_gaps(trace, rows) -> list[tuple[str, float]]:
    """``trace.gaps()`` with each idle stretch between two kernels labelled
    by the program span that holds most of it; a stretch that no span
    overlaps, and the edges, keep the trace's own label."""
    busy = trace.busy_intervals()
    gaps = trace.gaps()
    inner = [(label(rows, a, b) or name, s)
             for (name, s), ((_, a), (b, _)) in zip(gaps, zip(busy, busy[1:]))]
    return inner + gaps[len(inner):]


def idle_by_label(gaps) -> dict[str, float]:
    """Seconds of idle time by label."""
    out: dict[str, float] = {}
    for name, s in gaps:
        out[name] = out.get(name, 0.0) + s
    return out


def share_pct(records, names, window_s: float) -> float | None:
    """The spans named ``names`` as a share of ``window_s``; None where the
    run recorded no spans at all (a program without them)."""
    if not records or window_s <= 0:
        return None
    return 100.0 * sum(r.seconds for r in records if r.name in names) / window_s


def first_signature_s(setup_records) -> float | None:
    """Seconds of the microbatches that were the first of their batch
    signature, over set-up; None where set-up recorded no spans."""
    if not setup_records:
        return None
    return sum(r.seconds for r in setup_records if r.name == FIRST_SIGNATURE)


def metrics(records, setup_records, window_s: float) -> dict[str, float]:
    """The six span metrics that find something to read."""
    out = {name: share_pct(records, names, window_s) for name, names in SHARES.items()}
    out["first_signature_s"] = first_signature_s(setup_records)
    return {k: v for k, v in out.items() if v is not None}
