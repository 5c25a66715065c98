"""Execution engines of the port: the counterpart of ``repro.train.engine``
(the backend contract and ``EmulatedEngine``; the mesh engine, one rank a
GPU, comes with the multi-GPU slice).

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
    """What one executed step reports back to the trainer.  ``loss`` may be
    a device scalar; ``compiled`` is True iff a microbatch was the first of
    its batch signature (kernel builds, library set-up), which the trainer
    records as an event and keeps out of throughput."""

    loss: Any
    compiled: bool = False


class ExecutionEngine:
    """Backend contract for ``Trainer.run``."""

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
        for name in acc:  # the pool mean, in f32; frees each sum as it goes
            acc[name] = acc[name].float() / pool_index
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


__all__ = ["EmulatedEngine", "ExecutionEngine", "StepOutcome", "WorkerSteps", "clock", "seconds"]
