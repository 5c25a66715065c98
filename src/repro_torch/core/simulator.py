"""N-worker cluster simulator: T_sync = max_i T_i (paper Eq. 1, Figs. 5-7),
the port's copy of ``repro.core.simulator`` (framework-free numpy).

Each data-parallel worker draws the next bucket from a shared stream and
executes one microbatch per step; the global step latches on the slowest
worker (AllReduce barrier).  Step times come from a cost function — either
the fitted ``CostModel`` or the ``AnalyticDeviceModel`` — plus lognormal
hardware jitter.

The simulator is policy-agnostic: feed it buckets built with
``mode='equal_token'`` for the baseline and ``mode='adaptive'`` for
AdaptiveLoad, and compare the emitted ``StepMetrics`` streams.

Three dispatch regimes are modeled:

* ``simulate``         — one microbatch per worker per step, independent draws.
* ``simulate_packed``  — gradient accumulation, each worker draws to its own
  budget independently (the sharded-iterator status quo).
* ``simulate_planned`` — the §4.5 global regime: a ``StepPlanner`` draws one
  cluster-wide pool and packs it across ranks (random/LPT/knapsack).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from .balancer import StepMetrics, step_metrics
from .bucketing import Bucket
from .dispatch import StepPlanner


@dataclasses.dataclass
class CorpusSampler:
    """Weighted sampler over buckets — the mixed image/video data stream."""

    buckets: Sequence[Bucket]
    weights: Sequence[float] | None = None

    def __post_init__(self) -> None:
        if self.weights is None:
            self.weights = [1.0] * len(self.buckets)
        w = np.asarray(self.weights, dtype=np.float64)
        self._probs = w / w.sum()

    def draw(self, rng: np.random.Generator, n: int) -> list[Bucket]:
        idx = rng.choice(len(self.buckets), size=n, p=self._probs)
        return [self.buckets[i] for i in idx]


@dataclasses.dataclass
class SimulationResult:
    metrics: list[StepMetrics]

    @property
    def mean_throughput(self) -> float:
        """tokens/sec averaged over steps (paper Fig. 5 headline metric)."""
        tok = sum(m.tokens for m in self.metrics)
        t = sum(m.step_time for m in self.metrics)
        return tok / t if t > 0 else 0.0

    @property
    def throughput_series(self) -> list[float]:
        return [m.tokens / m.step_time for m in self.metrics]

    @property
    def mean_cv_step(self) -> float:
        return float(np.mean([m.cv_step for m in self.metrics]))

    @property
    def mean_compute_cv(self) -> float:
        return float(np.mean([m.compute_cv for m in self.metrics]))

    @property
    def mean_wait_sync(self) -> float:
        return float(np.mean([np.mean(m.wait_sync) for m in self.metrics]))

    def summary(self) -> dict[str, float]:
        return {
            "mean_throughput": self.mean_throughput,
            "mean_cv_step": self.mean_cv_step,
            "mean_compute_cv": self.mean_compute_cv,
            "mean_wait_sync": self.mean_wait_sync,
            "p99_step_time": float(
                np.percentile([m.step_time for m in self.metrics], 99)
            ),
            "mean_step_time": float(np.mean([m.step_time for m in self.metrics])),
        }


def simulate_packed(
    sampler: CorpusSampler,
    n_workers: int,
    n_steps: int,
    cost_fn: Callable[[int, int], float],
    *,
    budget: float,
    budget_of: Callable[[Bucket], float],
    p: float = 2.0,
    jitter: float = 0.03,
    seed: int = 0,
    straggler_worker: int | None = None,
    straggler_slowdown: float = 1.0,
) -> SimulationResult:
    """Gradient-accumulation regime: each worker keeps drawing microbatches
    until its accumulated ``budget_of`` reaches ``budget`` (>= 1 microbatch).

    * equal-token baseline: ``budget_of = tokens``, budget = token target —
      every rank processes the same token count per optimizer step, but the
      *quadratic* load of its composition varies (the paper's core failure
      mode).
    * AdaptiveLoad: ``budget_of = load(p̂)``, budget = accumulation x M_comp —
      ranks equalize fitted compute, not tokens.
    """
    rng = np.random.default_rng(seed)
    out: list[StepMetrics] = []
    for _ in range(n_steps):
        times, loads = [], []
        tokens = 0
        for w in range(n_workers):
            acc_budget = 0.0
            t_w, o_w = 0.0, 0.0
            while True:
                b = sampler.draw(rng, 1)[0]
                t = cost_fn(b.batch_size, b.seq_len)
                if jitter > 0:
                    t *= float(rng.lognormal(0.0, jitter))
                t_w += t
                o_w += b.load(p)
                tokens += b.tokens
                acc_budget += budget_of(b)
                if acc_budget >= budget:
                    break
            if straggler_worker is not None and w == straggler_worker:
                t_w *= straggler_slowdown
            times.append(t_w)
            loads.append(o_w)
        out.append(step_metrics(times, loads, tokens))
    return SimulationResult(out)


def simulate_planned(
    sampler: CorpusSampler,
    n_workers: int,
    n_steps: int,
    cost_fn: Callable[[int, int], float],
    *,
    budget: float,
    budget_of: Callable[[Bucket], float],
    strategy: str = "lpt",
    load_of: Callable[[Bucket], float] | None = None,
    p: float = 2.0,
    jitter: float = 0.03,
    seed: int = 0,
    straggler_worker: int | None = None,
    straggler_slowdown: float = 1.0,
) -> SimulationResult:
    """Planner-driven regime (§4.5): ONE global pool per optimizer step,
    drawn to the cluster budget ``n_workers * budget`` and packed across
    ranks by ``load_of`` (default: quadratic load ``B*S^p``).

    The apples-to-apples counterpart of :func:`simulate_packed` — same
    corpus, same cost function, same per-rank budget — isolating the value
    of global dispatch vs independent per-worker draws.  ``strategy`` is
    any of ``repro_torch.core.dispatch.DISPATCH_STRATEGIES``; ``random`` deals
    the same pool round-robin and serves as the sanity baseline.
    """
    planner = StepPlanner(
        sampler.buckets,
        sampler.weights,
        n_workers=n_workers,
        budget=budget,
        budget_of=budget_of,
        load_of=load_of if load_of is not None else (lambda b: b.load(p)),
        strategy=strategy,
        seed=seed,
    )
    rng = np.random.default_rng(seed + 1)  # jitter stream, decoupled from draws
    out: list[StepMetrics] = []
    for _ in range(n_steps):
        plan = planner.plan()
        times, loads = [], []
        for w in range(n_workers):
            t_w, o_w = 0.0, 0.0
            for b in plan.worker_microbatches(w):
                t = cost_fn(b.batch_size, b.seq_len)
                if jitter > 0:
                    t *= float(rng.lognormal(0.0, jitter))
                t_w += t
                o_w += b.load(p)
            if straggler_worker is not None and w == straggler_worker:
                t_w *= straggler_slowdown
            times.append(t_w)
            loads.append(o_w)
        out.append(step_metrics(times, loads, plan.tokens))
    return SimulationResult(out)


def simulate(
    sampler: CorpusSampler,
    n_workers: int,
    n_steps: int,
    cost_fn: Callable[[int, int], float],
    *,
    p: float = 2.0,
    jitter: float = 0.03,
    seed: int = 0,
    straggler_worker: int | None = None,
    straggler_slowdown: float = 1.0,
) -> SimulationResult:
    """Run ``n_steps`` of DP training.

    ``cost_fn(batch_size, seq_len) -> seconds`` models one worker's step.
    ``straggler_worker``/``straggler_slowdown`` optionally inject a
    persistently slow worker (hardware degradation) to exercise the
    closed-loop detector.
    """
    rng = np.random.default_rng(seed)
    out: list[StepMetrics] = []
    for _ in range(n_steps):
        draws = sampler.draw(rng, n_workers)
        times, loads = [], []
        tokens = 0
        for w, b in enumerate(draws):
            t = cost_fn(b.batch_size, b.seq_len)
            if jitter > 0:
                t *= float(rng.lognormal(0.0, jitter))
            if straggler_worker is not None and w == straggler_worker:
                t *= straggler_slowdown
            times.append(t)
            loads.append(b.load(p))
            tokens += b.tokens
        out.append(step_metrics(times, loads, tokens))
    return SimulationResult(out)
