"""Training loop of the port: the counterpart of ``repro.train.loop``'s
``Trainer`` and ``TrainHistory`` on one device.

``Trainer.run`` drives ONE :class:`~repro_torch.train.engine.ExecutionEngine`
(``EmulatedEngine`` by default) over a single-rank stream
(``BucketedLoader``: each item is one ``list[(bucket, batch)]``) or a
planner-driven multi-rank stream (``ShardedBucketedLoader``: each item is
per-rank lists from one global dispatch decision).  Each step splits the
trainer's key into the next key and the step key, runs the step, and
records its loss, time, tokens and microbatch telemetry; a step that ran a
batch signature for the first time (kernel builds, library set-up) is
recorded as a ``compile@i`` event and kept out of
``TrainHistory.throughput``.  Step times come from CUDA events on the
card and from the host clock on the CPU.

With ``scheduler=`` attached (``core.scheduler.AdaptiveLoadScheduler``)
every step's records go to ``scheduler.observe``: the closed loop of
telemetry, cost-model refit and replan, which reaches the loader's planner
when the loader was built on ``scheduler.make_planner()``.

Fault tolerance, mesh execution, chaos injection and run-state
checkpoints come with their own slices: this ``Trainer`` takes none of
their arguments (``ft=``, ``mesh=``, ``chaos=``, ``start_step=``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np

from repro_torch.core.scheduler import AdaptiveLoadScheduler
from repro_torch.core.telemetry import WorkerStepRecord
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.engine import EmulatedEngine, ExecutionEngine, clock, seconds


def split_key(key: int) -> tuple[int, int]:
    """(next key, subkey) from an integer key (``jax.random.split``)."""
    a, b = np.random.SeedSequence(key).generate_state(2, np.uint64)
    return int(a), int(b)


@dataclasses.dataclass
class TrainHistory:
    losses: list[float] = dataclasses.field(default_factory=list)
    step_times: list[float] = dataclasses.field(default_factory=list)
    tokens: list[int] = dataclasses.field(default_factory=list)
    events: list[str] = dataclasses.field(default_factory=list)
    # steps that ran a batch signature for the first time: kept in
    # step_times (the record stays complete) but out of throughput
    compile_steps: list[int] = dataclasses.field(default_factory=list)
    #: microbatches per step, and their telemetry (what the scheduler reads)
    microbatches: list[int] = dataclasses.field(default_factory=list)
    records: list[WorkerStepRecord] = dataclasses.field(default_factory=list)
    #: the ``StepPlan`` each step consumed, where the stream is planned (the
    #: launcher fills it from ``ShardedBucketedLoader.plans``)
    plans: list = dataclasses.field(default_factory=list)

    @property
    def throughput(self) -> float:
        skip = set(self.compile_steps)
        if len(skip) >= len(self.step_times):  # nothing but compile steps
            skip = set()
        t = sum(dt for i, dt in enumerate(self.step_times) if i not in skip)
        tok = sum(tk for i, tk in enumerate(self.tokens) if i not in skip)
        return tok / t if t > 0 else 0.0


class Trainer:
    def __init__(self, cfg: ModelConfig, opt: OptimizerConfig, *,
                 scheduler: AdaptiveLoadScheduler | None = None,
                 worker_time_scale: Mapping[int, float] | None = None,
                 engine: ExecutionEngine | None = None):
        self.cfg = cfg
        self.opt = opt
        self.scheduler = scheduler
        if engine is not None:
            if worker_time_scale is not None:
                raise ValueError("pass worker_time_scale to the engine given as engine=")
            self.engine = engine
        else:
            self.engine = EmulatedEngine(cfg, opt, worker_time_scale=worker_time_scale)

    @staticmethod
    def _as_worker_steps(step) -> list[list[tuple[Any, Any]]]:
        """A data item as per-rank microbatch lists: ``BucketedLoader``
        yields ``[(bucket, batch), ...]`` (one rank),
        ``ShardedBucketedLoader`` ``[[(bucket, batch), ...], ...]`` (one
        list a rank)."""
        if step and isinstance(step[0], list):
            return step
        return [step]

    def run(self, state, data_iter, n_steps: int, *, rng: int = 0, log_every: int = 50,
            on_metrics: Callable[[int, dict], None] | None = None):
        """Drive ``n_steps`` optimizer steps from the integer key ``rng``;
        ``on_metrics(step, {"loss", "time", "tokens"})`` is called after
        each."""
        hist = TrainHistory()
        engine = self.engine
        device = state["model"].device
        item = next(data_iter) if n_steps > 0 else None
        for i in range(n_steps):
            worker_steps = self._as_worker_steps(item)
            t0 = clock(device)
            tok = sum(bucket.tokens for ws in worker_steps for bucket, _ in ws)
            n_micro = sum(len(ws) for ws in worker_steps)
            rng, sub = split_key(rng)
            state, out = engine.execute_step(state, worker_steps, step_key=sub, step=i)
            dt = seconds(t0, clock(device))
            recs = engine.timing_records()
            loss = float(out.loss)

            hist.losses.append(loss)
            hist.step_times.append(dt)
            hist.tokens.append(tok)
            hist.microbatches.append(n_micro)
            hist.records.extend(recs)
            if out.compiled:
                hist.compile_steps.append(i)
                hist.events.append(f"compile@{i}")
            if self.scheduler is not None:
                self.scheduler.observe(recs)
            if i + 1 < n_steps:
                item = next(data_iter)
            if on_metrics is not None:
                on_metrics(i, {"loss": loss, "time": dt, "tokens": tok})
            if log_every and i % log_every == 0:
                print(f"step {i:5d}  loss {loss:.4f}  {tok/dt:,.0f} tok/s  "
                      f"({n_micro} microbatches, {len(worker_steps)} ranks)")
        return state, hist
