"""Training loop of the port: the counterpart of ``repro.train.loop``'s
``Trainer`` and ``TrainHistory``.

``Trainer.run`` drives ONE :class:`~repro_torch.train.engine.ExecutionEngine`
(``EmulatedEngine`` by default; ``MeshEngine`` with ``mesh=``, a
``launch.mesh.DataGroup``: one process a rank, each running this loop over
the same plan stream) over a single-rank stream
(``BucketedLoader``: each item is one ``list[(bucket, batch)]``) or a
planner-driven multi-rank stream (``ShardedBucketedLoader``: each item is
per-rank lists from one global dispatch decision).  Each step splits the
trainer's key into the next key and the step key, runs the step, and
records its loss, time, tokens and microbatch telemetry; a step that ran a
batch signature for the first time (kernel builds, library set-up) is
recorded as a ``compile@i`` event and kept out of
``TrainHistory.throughput``.  Step times come from CUDA events on the
card and from the host clock on the CPU.  While tracing is on
(``core.spans``), each step's body is a ``trainer.step`` span, each fetch
from the loader a ``trainer.data_wait``, and the reads that wait on the
device (the timing records, the step time, the loss) a ``trainer.sync``.

With ``scheduler=`` attached (``core.scheduler.AdaptiveLoadScheduler``)
every step's records go to ``scheduler.observe``: the closed loop of
telemetry, cost-model refit and replan, which reaches the loader's planner
when the loader was built on ``scheduler.make_planner()``.  On a mesh of
more than one process the loader draws with no lead (``prefetch=0``), so a
replan lands at the same plan index on every process: after the step it
was observed in with serial dispatch, one step later with async dispatch
(the next step was already fetched).

**Fault tolerance & resume.**  With ``ft=`` attached
(``distributed.fault_tolerance.FaultTolerantRunner``) every step (1)
heartbeats the engine's completed ranks into the monitor, (2) offers the
cadence a checkpoint whose manifest carries a *run-state* blob (the
trainer key and the next step, plus whatever ``run_state_of`` contributes:
the loader's snapshot), (3) on dead ranks runs emergency save ->
``recovery_plan`` -> ``on_resize`` and keeps training on the survivors,
(4) admits queued joins and (5) ends the run on a graceful preemption,
with the handoff checkpoint on disk (``TrainHistory.preempted``).
``chaos=`` (``distributed.chaos.ChaosSchedule``) fires its events at the
plan boundary after each step through the same hooks.  ``run(start_step=,
rng=)`` resumes the step numbering and the key stream exactly, so a
killed-and-resumed run replays byte-identical plan digests and the same
parameters as the uninterrupted run.  The event strings and their order
are the reference's (``repro/train/loop.py``).  An engine with
``async_dispatch`` (``MeshEngine`` unless it measures serially) returns
before the device finishes a step: the next step is fetched and staged
(``engine.prepare``) behind it, and a checkpoint's loader snapshot is
rewound past that held step, as in the reference; the other engines fetch
after the fault-tolerance block, with nothing held.  On a mesh the
cadence reads the slowest process's step time (``engine.agreed_time``), so
every process saves at the same steps.

The run-state blob has the reference's schema, and the trainer key is
stored as two uint32 words (:func:`serialize_rng_key`), so either package
reads the other's blob.  A resume across the two frameworks carries over
the weights, the moments, ``step`` and the loader and planner streams
exactly; the trainer key does not reproduce the other package's noise
draws, which were never the same (``steps.fold_in`` against
``jax.random``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np

from repro_torch.core.dispatch import group_worker_steps
from repro_torch.core.scheduler import AdaptiveLoadScheduler
from repro_torch.core.spans import span
from repro_torch.core.telemetry import WorkerStepRecord
from repro_torch.data.pipeline import ShardedBucketedLoader, SnapshotUnavailable
from repro_torch.distributed.chaos import ChaosContext, ChaosSchedule
from repro_torch.distributed.fault_tolerance import FaultTolerantRunner
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.engine import (
    EmulatedEngine,
    ExecutionEngine,
    MeshEngine,
    clock,
    seconds,
)

RUN_STATE_VERSION = 1


def _fetch(data_iter):
    """The loader's next item, under a ``trainer.data_wait`` span."""
    with span("trainer.data_wait"):
        return next(data_iter)


def split_key(key: int) -> tuple[int, int]:
    """(next key, subkey) from an integer key (``jax.random.split``)."""
    a, b = np.random.SeedSequence(key).generate_state(2, np.uint64)
    return int(a), int(b)


def serialize_rng_key(key: int) -> list[int]:
    """The trainer's 64-bit key as two uint32 words, high word first: the
    form (and JSON schema) of a raw JAX key, whose ``PRNGKey(s)`` is
    ``[0, s]`` for a small seed."""
    key = int(key)
    if not 0 <= key < 2**64:
        raise ValueError(f"trainer key {key} is not a 64-bit unsigned integer")
    return [key >> 32, key & 0xFFFFFFFF]


def deserialize_rng_key(words) -> int:
    """The integer key of :func:`serialize_rng_key`'s two words (a JAX
    package's blob gives its key's words as one integer)."""
    hi, lo = (int(w) for w in words)
    if not (0 <= hi < 2**32 and 0 <= lo < 2**32):
        raise ValueError(f"rng words {list(words)} are not two uint32 values")
    return (hi << 32) | lo


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
    #: True iff the run ended early on a graceful-preemption drain (the
    #: handoff checkpoint is already on disk; relaunch with resume)
    preempted: bool = False

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
                 ft: FaultTolerantRunner | None = None,
                 worker_time_scale: Mapping[int, float] | None = None,
                 engine: ExecutionEngine | None = None,
                 run_state_of: Callable[[int], dict] | None = None,
                 chaos: ChaosSchedule | None = None,
                 mesh=None,
                 measure_ranks: bool | str | None = None):
        self.cfg = cfg
        self.opt = opt
        self.scheduler = scheduler
        self.ft = ft
        # deterministic chaos injection: events fire at the plan boundary
        # after each completed step, through the same monitor/runner/engine
        # hooks a real cluster manager would drive
        self.chaos = chaos
        # elastic "remap" mode (set_physical_ranks): the logical fan-out
        # width stays fixed, churn only regroups logical shares onto the
        # current physical fleet, keeping the plan stream digest-stable
        self._n_physical: int | None = None
        # run_state_of(held) -> dict merged into every checkpoint's
        # run-state blob.  ``held`` is how many data items the trainer has
        # popped but not yet executed (the async engine's double buffer): a
        # loader snapshot rewinds by that many plans
        self.run_state_of = run_state_of
        #: run-state blob as of the END of the last completed ``run``:
        #: what a launcher persists with its final checkpoint
        self.last_run_state: dict | None = None
        if engine is not None:
            if mesh is not None:
                raise ValueError("pass engine= or mesh=, not both")
            if worker_time_scale is not None:
                raise ValueError("pass worker_time_scale to the engine given as engine=")
            self.engine = engine
        elif mesh is not None:
            # measure_ranks: False | "serial" | "async" (True = "async");
            # by default measured only when a scheduler reads the records
            measure = measure_ranks if measure_ranks is not None else scheduler is not None
            self.engine = MeshEngine(mesh.group, cfg, opt, device=mesh.device, measure=measure,
                                     worker_time_scale=worker_time_scale)
        else:
            self.engine = EmulatedEngine(cfg, opt, worker_time_scale=worker_time_scale)

    def set_physical_ranks(self, n: int) -> None:
        """Elastic *remap*: run the fixed-width logical plan stream on ``n``
        physical ranks.

        The loader and planner keep drawing at their original logical
        width, the churn-stable choice: pool sizes, plan digests and
        (because logical shares are merged contiguously, keeping the pool's
        rank-major order) every microbatch's draws stay those of an
        uninterrupted run.  This is the ``on_resize`` target for
        kill-then-rejoin churn; capacity changes that should change the
        plan stream itself use ``loader.resize`` instead.  ``n`` larger than
        a fan-out's logical width is clamped to it."""
        if n < 1:
            raise ValueError("need at least one physical rank")
        self._n_physical = int(n)

    def _to_physical(self, worker_steps):
        """Apply the remap (identity when inactive or already narrower)."""
        n = self._n_physical
        if n is None or n >= len(worker_steps):
            return worker_steps
        return group_worker_steps(worker_steps, n)

    @staticmethod
    def _as_worker_steps(step) -> list[list[tuple[Any, Any]]]:
        """A data item as per-rank microbatch lists: ``BucketedLoader``
        yields ``[(bucket, batch), ...]`` (one rank),
        ``ShardedBucketedLoader`` ``[[(bucket, batch), ...], ...]`` (one
        list a rank)."""
        if step and isinstance(step[0], list):
            return step
        return [step]

    def _run_state(self, next_step: int, rng: int, held: int = 0) -> dict:
        """The resumable run-state blob for a checkpoint taken between step
        ``next_step - 1`` and ``next_step``."""
        rs = {
            "version": RUN_STATE_VERSION,
            "step": int(next_step),
            "trainer": {"rng": serialize_rng_key(rng)},
        }
        if self.run_state_of is not None:
            rs.update(self.run_state_of(held) or {})
        return rs

    def _failure_run_state(self, next_step: int, rng: int, held: int = 0) -> dict:
        """Run state for an EMERGENCY save: if the loader cannot snapshot
        right now (a resize in flight), degrade to weights + trainer key
        rather than lose the save."""
        try:
            return self._run_state(next_step, rng, held)
        except SnapshotUnavailable:
            return {
                "version": RUN_STATE_VERSION,
                "step": int(next_step),
                "trainer": {"rng": serialize_rng_key(rng)},
            }

    def run(self, state, data_iter, n_steps: int, *, rng: int = 0, start_step: int = 0,
            log_every: int = 50, on_metrics: Callable[[int, dict], None] | None = None):
        """Drive ``n_steps`` optimizer steps ``start_step .. start_step +
        n_steps - 1`` from the integer key ``rng``; ``on_metrics(step,
        {"loss", "time", "tokens"})`` is called after each.  A resumed run
        passes the checkpoint's ``step`` as ``start_step`` and its restored
        trainer key as ``rng``: the step numbering, the key stream and (via
        the loader's restored plan stream) the dispatched plans continue
        exactly where the save left off."""
        hist = TrainHistory()
        engine = self.engine
        ft = self.ft
        if (isinstance(engine, MeshEngine) and engine.executor.n_ranks > 1
                and isinstance(data_iter, ShardedBucketedLoader) and data_iter.prefetch > 0):
            # a replan or a resize would land at a plan index set by each
            # process's own producer thread, and the plans would part
            raise ValueError("on a mesh every process draws the plan stream itself: build the "
                             "loader with prefetch=0, so that a replan or a resize lands at "
                             "the same plan on every process")
        if ft is not None and start_step > 0:
            # the restored checkpoint IS start_step's save: count the
            # cadence from there instead of re-saving on the first step
            ft.note_restored(start_step)
        state = engine.place_state(state)
        device = state["model"].device
        item = _fetch(data_iter) if n_steps > 0 else None
        held = 0
        for i in range(n_steps):
            with span("trainer.step"):
                step_no = start_step + i
                worker_steps = self._as_worker_steps(item)
                t0 = clock(device)
                tok = sum(bucket.tokens for ws in worker_steps for bucket, _ in ws)
                n_micro = sum(len(ws) for ws in worker_steps)
                rng, sub = split_key(rng)
                state, out = engine.execute_step(state, self._to_physical(worker_steps),
                                                 step_key=sub, step=step_no)
                t1 = clock(device)
                held = 0
                if engine.async_dispatch and i + 1 < n_steps:
                    # the device still computes step i: fetch step i+1 and stage
                    # its batches behind that compute
                    item = _fetch(data_iter)
                    engine.prepare(self._to_physical(self._as_worker_steps(item)))
                    held = 1
                with span("trainer.sync"):
                    recs = engine.timing_records()
                    dt = seconds(t0, t1)
                    loss = float(out.loss)

                hist.losses.append(loss)
                hist.step_times.append(dt)
                hist.tokens.append(tok)
                hist.microbatches.append(n_micro)
                hist.records.extend(recs)
                if out.compiled:
                    hist.compile_steps.append(i)
                    hist.events.append(f"compile@{step_no}")
                if self.scheduler is not None:
                    self.scheduler.observe(recs)

                if self.chaos is not None:
                    ctx = ChaosContext(monitor=ft.monitor if ft else None, runner=ft,
                                       engine=engine, preemption=ft.preemption if ft else None)
                    for msg in self.chaos.fire(step_no, ctx):
                        hist.events.append(f"{msg}@{step_no}")

                if ft is not None and self._fault_tolerance(state, step_no, rng,
                                                            engine.agreed_time(dt), hist, held):
                    break

                if not engine.async_dispatch and i + 1 < n_steps:
                    # fetched AFTER the fault-tolerance block: a checkpoint then
                    # sits exactly on a plan boundary (nothing popped to rewind)
                    item = _fetch(data_iter)
                if on_metrics is not None:
                    on_metrics(step_no, {"loss": loss, "time": dt, "tokens": tok})
                if log_every and i % log_every == 0:
                    print(f"step {step_no:5d}  loss {loss:.4f}  {tok/dt:,.0f} tok/s  "
                          f"({n_micro} microbatches, {len(worker_steps)} ranks)")
        # degraded variant: an end-of-run loader that cannot snapshot (a
        # resize still draining) must not crash a finished run; the
        # launcher then persists weights + trainer key.  A preempted run
        # counts only its completed steps.
        self.last_run_state = self._failure_run_state(start_step + len(hist.losses), rng,
                                                      held if hist.preempted else 0)
        return state, hist

    def _fault_tolerance(self, state, step_no: int, rng: int, dt: float,
                         hist: TrainHistory, held: int) -> bool:
        """The runner's work at the plan boundary after ``step_no``, in the
        reference's order: heartbeats, cadence, failures, joins, preemption.
        Returns True when a preemption ends the run."""
        ft = self.ft
        # heartbeat BEFORE failure checks: a rank that completed this step
        # is alive, whatever the wall clock says
        for w in self.engine.heartbeat_ranks():
            ft.monitor.heartbeat(w)
        # a thunk: the snapshot work happens only on steps that save.
        # ``step_no + 1`` = steps completed = the step a resume starts from
        next_step = step_no + 1

        def run_state():
            return self._run_state(next_step, rng, held)

        def failure_run_state():
            return self._failure_run_state(next_step, rng, held)

        try:
            if ft.maybe_checkpoint(state, next_step, dt, run_state=run_state):
                hist.events.append(f"ckpt@{step_no}")
        except SnapshotUnavailable:
            # a resize re-emitted the boundary plan: no replayable snapshot
            # THIS step; the cadence check re-fires next step
            hist.events.append(f"ckpt-deferred@{step_no}")
        failure = ft.handle_failures(state, next_step, run_state=failure_run_state)
        if failure is not None:
            hist.events.append(f"failure@{step_no}:{failure['plan']}")
        try:
            join = ft.handle_joins(state, next_step, run_state=run_state)
            if join is not None:
                hist.events.append(f"join@{step_no}:{join['joined']}"
                                   f"->{join['plan'].get('data_parallel')}")
        except SnapshotUnavailable:
            # mid-drain: the join stays queued for the next snapshotable
            # boundary
            hist.events.append(f"join-deferred@{step_no}")
        preempt = ft.handle_preemption(state, next_step, run_state=failure_run_state)
        for ev in ft.drain_events():
            hist.events.append(f"{ev}@{step_no}")
        if preempt is None:
            return False
        # grace drain complete: in-flight microbatches done, full run state
        # on disk: hand off cleanly
        hist.events.append(f"preempt@{step_no}")
        hist.preempted = True
        return True
