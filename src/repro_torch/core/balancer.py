"""Per-step worker assignment + load-dispersion metrics (paper §4.3): the
port's copy of ``repro.core.balancer`` (framework-free numpy).

Metrics follow the paper:

* ``CV_step`` ("Load Balancing Efficiency", Fig. 6) — relative spread of
  per-worker step latencies, ``(len_max - len_min) / len_max``.
* ``Compute CV`` (Fig. 7) — coefficient of variation (std/mean) of the
  physical load pressure ``O = B * S^p`` across workers.

Assignment strategies:

* ``assign_random`` — the baseline: each DP worker independently draws the
  next bucket from the stream (what a sharded dataset iterator does).
* ``assign_lpt`` — greedy Longest-Processing-Time bin packing of the step's
  microbatches to workers ("intra-step re-alignment of sequences", §4.5);
  used when a step carries several microbatches per worker.

These are the packing *primitives*; the cluster-level engine that draws a
global per-step pool and applies them (plus a knapsack-style swap
refinement) lives in ``repro_torch.core.dispatch``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class StepMetrics:
    step_time: float  # max over workers (AllReduce barrier, Eq. 1)
    cv_step: float  # (max - min)/max of worker latencies
    compute_cv: float  # std/mean of worker loads O = B*S^p
    tokens: int  # total tokens processed this step
    worker_times: tuple[float, ...]
    wait_sync: tuple[float, ...]  # per-worker idle time at the barrier


def step_metrics(
    worker_times: Sequence[float],
    worker_loads: Sequence[float],
    tokens: int,
) -> StepMetrics:
    t = np.asarray(worker_times, dtype=np.float64)
    o = np.asarray(worker_loads, dtype=np.float64)
    t_sync = float(t.max())
    cv_step = float((t.max() - t.min()) / t.max()) if t.max() > 0 else 0.0
    compute_cv = float(o.std() / o.mean()) if o.mean() > 0 else 0.0
    return StepMetrics(
        step_time=t_sync,
        cv_step=cv_step,
        compute_cv=compute_cv,
        tokens=tokens,
        worker_times=tuple(float(x) for x in t),
        wait_sync=tuple(float(t_sync - x) for x in t),
    )


def assign_random(
    n_items: int, n_workers: int, rng: np.random.Generator
) -> list[list[int]]:
    """Baseline: shuffle items, deal them round-robin to workers."""
    perm = rng.permutation(n_items)
    out: list[list[int]] = [[] for _ in range(n_workers)]
    for i, item in enumerate(perm):
        out[i % n_workers].append(int(item))
    return out


def assign_lpt(
    loads: Sequence[float],
    n_workers: int,
    capacities: Sequence[float] | None = None,
) -> list[list[int]]:
    """Greedy LPT: heaviest item first onto the worker that would finish
    it earliest.

    Classic 4/3-approximation of makespan scheduling; this is the
    "intra-step re-alignment" lever on top of the dual-constraint batch
    sizes.  With ``capacities`` (per-worker relative speeds; 1.0 = nominal)
    the greedy criterion becomes *finish time* ``(total + load) / capacity``
    instead of raw total, so fast ranks absorb proportionally more packed
    load on a heterogeneous fleet.  ``capacities=None`` is exactly the
    uniform classic.
    """
    if capacities is not None:
        caps = _validated_capacities(capacities, n_workers)
    else:
        caps = [1.0] * n_workers
    order = sorted(range(len(loads)), key=lambda i: -loads[i])
    totals = [0.0] * n_workers
    out: list[list[int]] = [[] for _ in range(n_workers)]
    for i in order:
        w = min(
            range(n_workers),
            key=lambda r: (totals[r] + loads[i]) / caps[r],
        )
        out[w].append(i)
        totals[w] += loads[i]
    return out


def _validated_capacities(
    capacities: Sequence[float], n_workers: int
) -> list[float]:
    caps = [float(c) for c in capacities]
    if len(caps) != n_workers:
        raise ValueError(
            f"{len(caps)} capacities for {n_workers} workers"
        )
    if any(c <= 0 for c in caps):
        raise ValueError("worker capacities must be positive")
    return caps


def makespan(
    loads: Sequence[float],
    assignment: Sequence[Sequence[int]],
    capacities: Sequence[float] | None = None,
) -> float:
    """Max per-worker *time*: group load divided by the worker's capacity
    (uniform capacities reduce to the classic max group-sum)."""
    if capacities is None:
        return max(sum(loads[i] for i in group) for group in assignment)
    caps = _validated_capacities(capacities, len(assignment))
    return max(
        sum(loads[i] for i in group) / caps[w]
        for w, group in enumerate(assignment)
    )


@dataclasses.dataclass
class RunningStats:
    """Streaming mean/percentile tracker for step metrics."""

    values: list[float] = dataclasses.field(default_factory=list)

    def add(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def mean(self) -> float:
        return float(np.mean(self.values)) if self.values else 0.0

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.values, q)) if self.values else 0.0

    def tail_ratio(self) -> float:
        """p99/p50 — the long-tail severity indicator."""
        p50 = self.percentile(50)
        return self.percentile(99) / p50 if p50 > 0 else 0.0
