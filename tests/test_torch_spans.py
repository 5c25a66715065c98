"""The port's span recorder (``repro_torch.core.spans``) and the spans the
trainer, the engine, the loader and the MMDiT's block recompute record:
the off path, parents and thread ids, collection, the profiler's clock,
the count of each span in steps of k microbatches, and training that is
bitwise the same with tracing on and off.  One test needs the card."""

from __future__ import annotations

import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch.configs import wan2_1_mmdit
from repro_torch.core import spans
from repro_torch.core.bucketing import Bucket, DataShape
from repro_torch.data.pipeline import BucketedLoader
from repro_torch.models.mmdit import MMDiT
from repro_torch.optim.adamw import OptimizerConfig, init_opt_state
from repro_torch.train.engine import EmulatedEngine
from repro_torch.train.loop import Trainer


@pytest.fixture
def tracing():
    """Tracing on for the test, and off with nothing left recorded after."""
    spans.collect()
    spans.enable()
    try:
        yield
    finally:
        spans.disable()
        spans.collect()


def test_off_records_nothing_reads_no_clock_and_allocates_nothing(monkeypatch):
    assert not spans.enabled()
    dev = torch.device("cpu")
    assert spans.span("x") is spans.OFF and spans.span("x", dev) is spans.OFF

    def no_clock(*a):
        raise AssertionError("a clock was read with tracing off")

    monkeypatch.setattr(spans, "clock", no_clock)
    monkeypatch.setattr(spans.time, "time_ns", no_clock)
    with spans.span("x", dev) as s:
        s.pair(0.0, 1.0)
    monkeypatch.undo()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with spans.span("engine.adamw", dev) as s:
                s.pair(0.0, 1.0)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == spans.__file__ and d.size_diff > 0]
    assert not grown, grown
    assert spans.collect() == []


def test_nesting_sets_parents_per_thread_with_native_tids(tracing):
    inner = {}

    def other():
        with spans.span("c"):
            with spans.span("d"):
                inner["tid"] = threading.get_native_id()

    with spans.span("a"):
        with spans.span("b"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    by = {r.name: r for r in spans.collect()}
    main = threading.get_native_id()
    assert by["a"].parent is None and by["b"].parent == by["a"].id
    # the thread opened "c" while "a" and "b" were open on the main thread
    assert by["c"].parent is None and by["d"].parent == by["c"].id
    assert by["a"].tid == by["b"].tid == main
    assert by["c"].tid == by["d"].tid == inner["tid"] != main
    assert by["a"].start_ns <= by["b"].start_ns <= by["b"].end_ns <= by["a"].end_ns


def test_collect_resolves_the_device_pairs_and_clears(tracing):
    dev = torch.device("cpu")
    with spans.span("host"):
        pass
    with spans.span("device", dev):
        time.sleep(0.002)
    with spans.span("paired") as s:
        t = spans.clock(dev)
        s.pair(t, t + 0.5)
    recs = {r.name: r for r in spans.collect()}
    assert recs["host"].device_s is None and recs["host"].seconds == recs["host"].host_s
    assert recs["device"].device_s >= 0.002 and recs["device"].host_s >= 0.002
    assert recs["paired"].device_s == recs["paired"].seconds == 0.5
    assert all(r.marks is None for r in recs.values())
    assert spans.collect() == []


def test_a_span_agrees_with_the_profilers_clock():
    """The span's host times and the profiler's time of a
    ``record_function`` inside it, read as ``trace_start_ns`` plus the
    event's offset, agree within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans.enable()
        try:
            with spans.span("outer"):
                with record_function("inner"):
                    for _ in range(20):
                        x = torch.tanh(x @ x)
        finally:
            spans.disable()
    (rec,) = spans.collect()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    (ev,) = [e for e in prof.events() if e.name == "inner"]
    start, end = t0 + ev.time_range.start * 1e3, t0 + ev.time_range.end * 1e3
    assert abs(start - rec.start_ns) <= 1e6 and abs(rec.end_ns - end) <= 1e6


@pytest.mark.card
def test_a_span_around_a_kernel_holds_its_device_interval_on_the_card():
    """On the profiler's clock, the device interval of a kernel launched
    inside a span that ends after ``torch.cuda.synchronize()`` lies within
    the span's host times, to 50 us."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    (x @ x).sum().item()  # cuBLAS set up outside the profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spans.enable()
        try:
            with spans.span("one.kernel"):
                x @ x
                torch.cuda.synchronize()
        finally:
            spans.disable()
    (rec,) = spans.collect()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ev = max(kernels, key=lambda e: e.time_range.end - e.time_range.start)
    start, end = t0 + ev.time_range.start * 1e3, t0 + ev.time_range.end * 1e3
    print(f"kernel {ev.name[:60]}: {(start - rec.start_ns) / 1e3:.1f} us after the span's "
          f"start, {(rec.end_ns - end) / 1e3:.1f} us before its end "
          f"({(end - start) / 1e3:.1f} us long)")
    assert rec.start_ns - 5e4 <= start and end <= rec.end_ns + 5e4


# -- the program's spans ---------------------------------------------------------------

CFG = wan2_1_mmdit.smoke_config()
OPT = OptimizerConfig(peak_lr=1e-3, schedule="constant", warmup=0, total_steps=10)
# steps of k = 2, 1, 3 microbatches (B, S); (3, 16) is a new signature in step 2
STEPS = [[(2, 32), (1, 48)], [(1, 48)], [(2, 32), (3, 16), (1, 48)]]
FRESH = [[True, True], [False], [False, True, False]]


def _stream():
    rng = np.random.default_rng(0)
    for step in STEPS:
        yield [(Bucket(DataShape(1, 16, 16), b), {
            "latents": torch.from_numpy(rng.standard_normal((b, s, CFG.in_channels * 4))
                                        .astype(np.float32)),
            "text": torch.from_numpy(rng.standard_normal((b, CFG.text_len, 4096))
                                     .astype(np.float32)),
        }) for b, s in step]


def _train():
    """Three steps from the same weights, on one thread (the suite's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = MMDiT(CFG, seed=0, device="cpu")
        state = {"model": model, "opt": init_opt_state(dict(model.named_parameters()), OPT),
                 "step": 0}
        trainer = Trainer(CFG, OPT, engine=EmulatedEngine(CFG, OPT))
        return trainer.run(state, _stream(), len(STEPS), rng=5, log_every=0)
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traced():
    """The three steps with tracing on: ``(state, history, records)``."""
    spans.collect()
    spans.enable()
    try:
        state, hist = _train()
    finally:
        spans.disable()
    return state, hist, spans.collect()


def _inside(recs, outer):
    return [r for r in recs if r is not outer
            and outer.start_ns <= r.start_ns and r.end_ns <= outer.end_ns]


def test_trainer_and_engine_record_each_span_per_microbatch_and_step(traced):
    recs = traced[2]
    steps = [r for r in recs if r.name == "trainer.step"]
    assert len(steps) == len(STEPS)
    # one fetch a step, the first before step 0, the last inside step 1 of 3
    waits = [r for r in recs if r.name == "trainer.data_wait"]
    assert len(waits) == len(STEPS)
    assert waits[0].end_ns <= steps[0].start_ns
    for step, spec, fresh in zip(steps, STEPS, FRESH):
        inside = _inside(recs, step)
        count = {}
        for r in inside:
            count[r.name] = count.get(r.name, 0) + 1
        k = len(spec)
        assert count["engine.forward"] == count["engine.backward"] == k
        assert count["engine.recompute"] == CFG.n_layers * k
        assert count.get("engine.accumulate", 0) == k - 1
        assert count.get("engine.pool_mean", 0) == (1 if k > 1 else 0)
        assert count["engine.adamw"] == count["trainer.sync"] == 1
        micro = sorted((r for r in inside if r.name in ("engine.microbatch",
                                                          "engine.first_signature")),
                       key=lambda r: r.start_ns)
        assert [r.name == "engine.first_signature" for r in micro] == fresh
        for m in micro:
            assert all(r.device_s is not None for r in _inside(recs, m))
            assert {r.name for r in _inside(recs, m)} == {"engine.forward", "engine.backward",
                                                          "engine.recompute"}
            assert m.parent == step.id and m.device_s > 0
    assert sum(len(_inside(recs, s)) for s in steps) + len(steps) + 1 == len(recs)


def test_loader_draws_are_spans_of_its_producer_thread(tracing):
    b = Bucket(DataShape(1, 16, 16), 2)
    loader = BucketedLoader([b], None, lambda rng, bucket: {"x": rng.standard_normal(4)},
                            budget=2.0, budget_of=lambda bucket: 1.0)
    try:
        for _ in range(3):
            next(loader)
    finally:
        loader.close()
    draws = [r for r in spans.collect() if r.name == "loader.draw"]
    assert len(draws) >= 3
    assert {r.tid for r in draws} == {loader._thread.native_id} != {threading.get_native_id()}
    assert all(r.parent is None and r.device_s is None for r in draws)


def test_training_is_bitwise_the_same_with_tracing_on_and_off(traced):
    state_off, hist_off = _train()
    assert spans.collect() == []
    state_on, hist_on, _ = traced
    assert hist_on.losses == hist_off.losses and hist_on.events == hist_off.events
    on, off = dict(state_on["model"].named_parameters()), dict(state_off["model"]
                                                               .named_parameters())
    for name in off:
        assert torch.equal(on[name], off[name]), name
        for m in ("m", "v"):
            assert torch.equal(state_on["opt"][m][name], state_off["opt"][m][name]), name
