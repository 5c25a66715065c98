"""Execution engines of the port: the counterpart of ``repro.train.engine``:
the backend contract, ``EmulatedEngine`` (every rank serially on one
device) and ``MeshEngine`` (one process a rank over ``torch.distributed``,
through ``distributed.plan_exec.PlanExecutor``).

Every engine implements the reference's gradient semantics: each
microbatch of the step's global pool contributes the gradient of its own
loss (draws keyed on ``(step_key, pool_index)``, pool enumerated
rank-major), gradients accumulate in the parameters' dtype, and ONE
optimizer update consumes their mean over the pool, divided in f32
(``engine.py:132-137,223``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.dispatch import SplitShard, merge_split_worker_steps
from repro_torch.core.telemetry import WorkerStepRecord
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig, adamw_update
from repro_torch.train.steps import NoiseHook, decay_rule, make_pool_grad_step

WorkerSteps = Sequence[Sequence[tuple[Any, dict]]]  # [rank][(bucket, batch)]


def clock(device: torch.device):
    """A mark on ``device``'s timeline: a recorded CUDA event on the card,
    the host clock elsewhere (where the work is synchronous)."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def seconds(start, end) -> float:
    """Seconds between two :func:`clock` marks (waits for a CUDA event)."""
    if isinstance(end, torch.cuda.Event):
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return end - start


@dataclasses.dataclass
class StepOutcome:
    """What one executed step reports back to the trainer.  ``compiled`` is
    True iff a microbatch was the first of its batch signature (kernel
    builds, library set-up), which the trainer records as an event and
    keeps out of throughput.  Both may be device scalars, read once the
    next step is staged."""

    loss: Any
    compiled: Any = False


class ExecutionEngine:
    """Backend contract for ``Trainer.run``.  ``async_dispatch`` says that
    ``execute_step`` returns before the device has finished the step: the
    trainer then fetches the next step and hands it to :meth:`prepare`
    while the device still computes."""

    async_dispatch: bool = False

    def place_state(self, state):
        """Put a train state where this engine runs it (identity here)."""
        return state

    def prepare(self, worker_steps: WorkerSteps) -> None:
        """Optional: stage a future step's batches behind the current step."""

    def agreed_time(self, seconds_: float) -> float:
        """A step time every process of the run agrees on (this process's
        own here), for decisions that must not part the ranks."""
        return seconds_

    def execute_step(self, state, worker_steps: WorkerSteps, *, step_key: int,
                     step: int) -> tuple[Any, StepOutcome]:
        raise NotImplementedError

    def timing_records(self) -> list[WorkerStepRecord]:
        """Per-microbatch telemetry of the last executed step."""
        return []

    def heartbeat_ranks(self) -> list[int]:
        """Ranks that completed work in the last executed step (every rank
        of the last fan-out)."""
        return list(getattr(self, "_last_ranks", []))

    def set_time_scale(self, worker: int, scale: float) -> None:
        """Scale rank ``worker``'s *recorded* compute times from now on (a
        degraded device as telemetry shows it).  Engines without per-rank
        telemetry ignore it."""


class EmulatedEngine(ExecutionEngine):
    """Single-device emulation: every DP rank's microbatches run serially
    where the model lives, with the pool-mean gradient and one update per
    step.  Each microbatch is timed between two :func:`clock` marks (CUDA
    events on the card: no synchronisation per microbatch) and gives one
    ``WorkerStepRecord``; the first microbatch of each batch signature is
    kept out of telemetry.  A sequence-parallel split fan-out is merged
    back into whole windows first (``merge_split_worker_steps``: this
    engine has no ring to shard over; the merged entry keeps shard 0's
    pool position).  ``worker_time_scale`` scales rank ``w``'s *recorded*
    times (a degraded device, for the scheduler's straggler path); ``noise``
    injects the draws (tests)."""

    def __init__(self, cfg: ModelConfig, opt: OptimizerConfig, *,
                 noise: NoiseHook | None = None,
                 worker_time_scale: Mapping[int, float] | None = None):
        self.opt = opt
        self._grad_step = make_pool_grad_step(cfg, noise)
        self._decay = decay_rule(cfg)
        self._worker_time_scale = dict(worker_time_scale or {})
        self._seen_signatures: set = set()
        self._pending: list = []
        self._records: list[WorkerStepRecord] = []

    def set_time_scale(self, worker: int, scale: float) -> None:
        if scale <= 0:
            raise ValueError("time scale must be positive")
        self._worker_time_scale[int(worker)] = float(scale)

    @staticmethod
    def _signature(batch) -> tuple:
        return tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in batch.items()))

    def execute_step(self, state, worker_steps, *, step_key, step):
        model = state["model"]
        self._pending, self._records = [], []
        self._last_ranks = list(range(len(worker_steps)))
        had_splits = any(isinstance(b, SplitShard) for share in worker_steps for b, _ in share)
        if had_splits:
            worker_steps = merge_split_worker_steps(worker_steps)
        compiled = False
        acc = None
        loss_sum = None
        pool_index = 0
        for w, share in enumerate(worker_steps):
            if not share:
                if had_splits:
                    # this rank's whole share was sibling shards of split
                    # groups owned by lower ranks: nothing left to run
                    continue
                raise ValueError(f"rank {w} received an empty microbatch list")
            scale = self._worker_time_scale.get(w, 1.0)
            for bucket, batch in share:
                sig = self._signature(batch)
                fresh = sig not in self._seen_signatures
                self._seen_signatures.add(sig)
                compiled = compiled or fresh
                t0 = clock(model.device)
                loss, grads = self._grad_step(model, batch, step_key, pool_index)
                if not fresh:  # first-call set-up would poison telemetry
                    self._pending.append((t0, clock(model.device), w, bucket, scale))
                if acc is None:
                    acc = grads
                else:
                    for name, g in grads.items():
                        acc[name].add_(g)
                loss_sum = loss if loss_sum is None else loss_sum + loss
                pool_index += 1
                del grads
        if acc is None:
            raise ValueError("execute_step received an empty fan-out")
        if pool_index > 1:  # the pool mean, in f32; frees each sum as it goes
            for name in acc:
                acc[name] = acc[name].float() / pool_index
        # one microbatch: its gradients are the mean as they are (AdamW widens
        # each block to f32 itself, and x / 1 is exact), and no f32 copy of
        # the gradients is held (21.8 GB for Llama-4-Scout at 2 layers)
        params = dict(model.named_parameters())
        adamw_update(params, acc, state["opt"], state["step"], self.opt, decay=self._decay)
        state["step"] += 1
        self._step = step
        return state, StepOutcome(loss=loss_sum.float() / pool_index, compiled=compiled)

    def timing_records(self) -> list[WorkerStepRecord]:
        """The last step's records; CUDA events resolve here, and each
        rank's ``worker_time_scale`` applies to its resolved times."""
        if self._pending:
            self._records = [
                WorkerStepRecord(
                    step=self._step, worker=w, batch_size=bucket.batch_size,
                    seq_len=bucket.seq_len, compute_time=seconds(t0, t1) * scale,
                    timing="device" if isinstance(t1, torch.cuda.Event) else "host",
                    ring_ranks=getattr(bucket, "n_ranks", 1),
                )
                for t0, t1, w, bucket, scale in self._pending
            ]
            self._pending = []
        return self._records


class MeshEngine(ExecutionEngine):
    """One process a data-parallel rank: rank ``r``'s microbatches run in
    process ``r`` of ``group`` through
    :class:`~repro_torch.distributed.plan_exec.PlanExecutor`; gradients
    meet in one ``all_reduce``, one update a step on every process.

    ``measure``:

    * ``False``: no telemetry;
    * ``"async"`` (alias ``True``): CUDA event pairs a microbatch, resolved
      and all-gathered in :meth:`timing_records`, so every process holds
      every rank's records;
    * ``"serial"``: a synchronisation after each microbatch.

    ``async_dispatch`` is set exactly when ``measure != "serial"``: the
    step returns before the device has finished it (over NCCL), and the
    trainer stages the next step's batches behind it.  Every step
    all-gathers this process's own ``worker_steps_digest`` (every process
    derives its own plan).  ``worker_time_scale`` scales rank ``w``'s
    recorded times.  The reference's ``donate`` has no counterpart."""

    def __init__(self, group, cfg: ModelConfig, opt: OptimizerConfig, *, device=None,
                 measure: bool | str = False,
                 worker_time_scale: Mapping[int, float] | None = None):
        from repro_torch.distributed.plan_exec import PlanExecutor

        if measure is True:
            measure = "async"
        if measure not in (False, "serial", "async"):
            raise ValueError(f"measure must be False, 'serial', or 'async'; got {measure!r}")
        self.executor = PlanExecutor(group, cfg, opt, device=device)
        self.async_dispatch = measure != "serial"
        self._measure = measure
        self._scale = dict(worker_time_scale or {})
        self._records: list[WorkerStepRecord] = []
        self._timers = None
        self._rank_times: list[float] | None = None

    def set_time_scale(self, worker: int, scale: float) -> None:
        if scale <= 0:
            raise ValueError("time scale must be positive")
        self._scale[int(worker)] = float(scale)

    def place_state(self, state):
        if self.executor.is_placed(state):
            return state
        return self.executor.place_state(state)

    def prepare(self, worker_steps) -> None:
        self.executor.stage(worker_steps)

    def agreed_time(self, seconds_: float) -> float:
        """The slowest process's time (one small ``all_reduce``)."""
        ex = self.executor
        t = torch.tensor([seconds_], dtype=torch.float64, device=ex.comm_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=ex.group)
        return float(t.item())

    def execute_step(self, state, worker_steps, *, step_key, step):
        from repro_torch.distributed.plan_exec import worker_steps_digest

        self._last_ranks = list(range(len(worker_steps)))
        state, out = self.executor.execute(
            state, worker_steps, step_key=step_key, step=step,
            digest=worker_steps_digest(worker_steps),
            measure=self._measure, time_scale=lambda w: self._scale.get(w, 1.0))
        self._records = out.get("records", [])
        self._timers = out.get("timers")
        self._rank_times = out.get("rank_times")
        return state, StepOutcome(loss=out["loss"], compiled=out["compiled"])

    def timing_records(self) -> list[WorkerStepRecord]:
        """Every rank's records of the last step, rank-major (a collective
        in async mode: every process calls it once a step)."""
        if self._timers is not None:
            self._records, self._rank_times = self._timers.join()
            self._timers = None
        return self._records

    @property
    def rank_times(self) -> list[float] | None:
        """Each rank's time in the last measured step."""
        if self._timers is not None:
            self.timing_records()
        return self._rank_times


__all__ = ["EmulatedEngine", "ExecutionEngine", "MeshEngine", "StepOutcome", "WorkerSteps",
           "clock", "seconds"]
