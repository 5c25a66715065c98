"""AdaptiveLoad closed-loop scheduler (paper §3.1-§3.2, Fig. 2): the port's
copy of ``repro.core.scheduler`` (framework-free numpy).

Ties the pieces together into the feedback loop the paper describes:

    telemetry -> cost-model refit -> M_comp recalibration -> new buckets

plus the operational concerns a real cluster adds:

* **elastic scaling** — on a worker-count change the scheduler re-plans
  (bucket batch sizes are per-device, so the plan survives resizes; the
  global batch is re-derived),
* **straggler mitigation** — persistent stragglers detected from telemetry
  trigger either an alert or an automatic compute-budget derate so the
  barrier stops latching on the sick worker,
* **recalibration hysteresis** — the model is only swapped when the refit
  improves R² or shifts p materially, avoiding plan thrash,
* **global dispatch** — an attached ``StepPlanner`` (``make_planner()``)
  receives every replan, so cluster-level microbatch dispatch (§4.5) tracks
  refits, derates, and elastic resizes without draining the pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .bucketing import Bucket, BucketingPolicy, DataShape
from .cost_model import (
    CostModel,
    fit_cost_model,
    fit_cost_model_per_class,
    split_load,
)
from .dispatch import DISPATCH_STRATEGIES, StepPlanner
from .telemetry import TelemetryBuffer, WorkerStepRecord

#: Static relative-throughput table for known accelerator classes — the
#: capacity seed a heterogeneous fleet starts from BEFORE telemetry warms
#: up (the capacity_planning loop then refines it from measured speeds).
#: These are the reference's TPU class ratios, copied verbatim so capacity
#: vectors and scheduler state stay interchangeable with ``repro``: unitless
#: dense-transformer step-throughput ratios, not a measurement of any GPU
#: (no GPU class has a measured ratio, so none is listed).  Only ratios
#: matter (capacity vectors are normalized to mean 1).
DEVICE_CLASSES: dict[str, float] = {
    "v4": 0.55,
    "v5e": 0.45,
    "v5p": 1.0,
    "v6e": 1.35,
}


def capacities_from_classes(classes: Sequence[str]) -> list[float]:
    """Per-rank capacity vector from device-class names, normalized to
    mean 1.0 (the same convention telemetry-estimated capacities use, so
    the budget scale is unchanged)."""
    try:
        caps = [float(DEVICE_CLASSES[c]) for c in classes]
    except KeyError as e:
        raise ValueError(
            f"unknown device class {e.args[0]!r}; known: "
            f"{sorted(DEVICE_CLASSES)}"
        ) from None
    mean = sum(caps) / len(caps)
    return [c / mean for c in caps]


@dataclasses.dataclass
class SchedulerConfig:
    target_sync: float  # desired step latency ceiling (s)
    m_mem: float  # memory-bound token budget (tokens/device)
    refit_interval: int = 100  # steps between cost-model refits
    min_samples: int = 32
    p_shift_tol: float = 0.05  # hysteresis on exponent changes
    r2_floor: float = 0.80  # refuse models that explain the data poorly
    straggler_threshold: float = 1.25
    straggler_derate: float = 0.9  # M_comp multiplier while a straggler persists
    dispatch: str = "lpt"  # step-level microbatch dispatch strategy (§4.5)
    # knapsack-swap refinement off the critical path: planners built by
    # make_planner() return the LPT seed immediately and adopt the
    # background-refined assignment at the next step boundary (only
    # meaningful with dispatch="knapsack"; see core.dispatch.PlanRefiner)
    overlap_refine: bool = False
    # deterministic fixed-round refinement: exactly refine_rounds
    # digest-seeded exchange rounds, adoption blocking on the result — the
    # adopted plan is a pure function of the seed plan, so every host (and
    # every killed-and-resumed run) dispatches identically
    deterministic_refine: bool = False
    refine_rounds: int = 16
    # heterogeneous-rank capacity planning: estimate per-rank relative
    # speeds from the same shape-normalized telemetry the straggler
    # detector uses and feed the vector into the attached StepPlanner, so
    # lpt/knapsack pack against weighted finish times (fast ranks get the
    # heavy packed windows) instead of assuming identical devices.
    # Off by default: uniform fleets keep byte-identical plan streams.
    capacity_planning: bool = False
    capacity_floor: float = 0.25  # clip speeds to [floor, 1/floor]
    capacity_tol: float = 0.10  # hysteresis: replan only on a bigger shift
    # heterogeneous fleet composition declared up front: one DEVICE_CLASSES
    # name per rank, seeding the planner's capacity vector from the static
    # class table so the very first plans pack against known speed ratios
    # instead of waiting a telemetry warm-up (capacity_planning refines the
    # seed from measured speeds once it has data)
    device_classes: tuple[str, ...] | None = None
    # sequence parallelism: let the attached StepPlanner split one long
    # packed window across up to this many contiguous ranks (ring
    # attention); 1 = never split.  The split cost is priced by the fitted
    # model's split_load (compute/k + comm_scale ring traffic).
    sp_max_ranks: int = 1

    def __post_init__(self) -> None:
        if self.device_classes is not None:
            unknown = [c for c in self.device_classes if c not in DEVICE_CLASSES]
            if unknown:
                raise ValueError(
                    f"unknown device classes {unknown}; known: "
                    f"{sorted(DEVICE_CLASSES)}"
                )
        if self.sp_max_ranks < 1:
            raise ValueError("sp_max_ranks must be >= 1")
        if not 0.0 < self.capacity_floor <= 1.0:
            raise ValueError("capacity_floor must be in (0, 1]")
        if self.capacity_tol < 0:
            raise ValueError("capacity_tol must be >= 0")
        if self.dispatch not in DISPATCH_STRATEGIES:
            raise ValueError(
                f"unknown dispatch strategy {self.dispatch!r}; expected one "
                f"of {DISPATCH_STRATEGIES}"
            )
        if self.overlap_refine and self.dispatch != "knapsack":
            raise ValueError(
                "overlap_refine only applies to dispatch='knapsack' (other "
                "strategies have no refinement to overlap)"
            )
        if self.deterministic_refine and not self.overlap_refine:
            raise ValueError(
                "deterministic_refine configures the overlapped refiner; "
                "the synchronous knapsack pass is already deterministic — "
                "set overlap_refine=True or drop deterministic_refine"
            )
        if self.refine_rounds < 1:
            raise ValueError("refine_rounds must be >= 1")


@dataclasses.dataclass
class PlanUpdate:
    step: int
    reason: str
    model: CostModel
    m_comp: float
    buckets: list[Bucket]
    dispatch: str = "lpt"
    n_workers: int = 0


class AdaptiveLoadScheduler:
    """Closed-loop bucket planner."""

    def __init__(
        self,
        config: SchedulerConfig,
        shapes: Sequence[DataShape],
        *,
        initial_model: CostModel,
        n_workers: int,
    ):
        self.config = config
        self.shapes = list(shapes)
        self.telemetry = TelemetryBuffer()
        self.n_workers = n_workers
        self.model = initial_model
        self._derate = 1.0
        #: per-device-class fits (shared p, per-class a/b) — populated by
        #: refits when ``config.device_classes`` names the fleet; their
        #: slope ratios derate the capacity vector with measured speeds
        self.class_models: dict[str, CostModel] | None = None
        self._capacities: list[float] | None = None
        if config.device_classes is not None:
            if len(config.device_classes) != n_workers:
                raise ValueError(
                    f"device_classes names {len(config.device_classes)} "
                    f"ranks but the scheduler drives {n_workers}"
                )
            # static seed; telemetry capacity planning may later override
            self._capacities = capacities_from_classes(config.device_classes)
        self.updates: list[PlanUpdate] = []
        self._steps_seen = 0
        self.planner: StepPlanner | None = None
        self._planner_accumulation = 1.0
        self.policy = self._policy_from_model(initial_model)
        self.buckets = self.policy.make_buckets(self.shapes)

    # -- planning -----------------------------------------------------------

    def _policy_from_model(self, model: CostModel) -> BucketingPolicy:
        m_comp = model.m_comp_for_target(self.config.target_sync) * self._derate
        return BucketingPolicy(
            m_mem=self.config.m_mem, m_comp=m_comp, p=model.p, mode="adaptive"
        )

    def _replan(self, step: int, model: CostModel, reason: str) -> None:
        self.model = model
        self.policy = self._policy_from_model(model)
        self.buckets = self.policy.make_buckets(self.shapes)
        self.updates.append(
            PlanUpdate(
                step, reason, model, self.policy.m_comp, list(self.buckets),
                dispatch=self.config.dispatch, n_workers=self.n_workers,
            )
        )
        if self.planner is not None:
            p = model.p
            self.planner.update(
                buckets=self.buckets,
                budget=self.policy.m_comp * self._planner_accumulation,
                budget_of=lambda b: b.load(p),
                n_workers=self.n_workers,
                capacities=self._capacities_for(self.n_workers),
                split_load_of=self._split_load_of(model),
            )

    def _split_load_of(self, model: CostModel):
        """Per-rank load of a microbatch split across ``k`` ring ranks, in
        the SAME ``sum(len^p)`` units ``budget_of`` packs with — so the
        planner's split-vs-pack comparison is apples to apples.  The comm
        term comes from the fitted model's ``comm_scale``."""
        p, cs = model.p, model.comm_scale

        def f(b, k: int) -> float:
            lengths = getattr(b, "lengths", None)
            if lengths is not None:
                return split_load(lengths, p, k, comm_scale=cs)
            return float(b.load(p)) / k

        return f

    def _capacities_for(self, n_workers: int) -> list[float] | None:
        """The capacity vector to push with a replan — only if it still
        matches the fleet width (rank identities do not survive resizes)."""
        if self._capacities is not None and len(self._capacities) == n_workers:
            return self._capacities
        return None

    def make_planner(
        self, *, seed: int = 0, accumulation: float = 1.0
    ) -> StepPlanner:
        """Build (and attach) the global dispatcher for the current plan.

        ``accumulation`` scales the per-rank step budget in units of
        ``M_comp`` (gradient-accumulation factor).  Once attached, every
        subsequent replan — refit, straggler derate, elastic ``resize()`` —
        is pushed into the planner, so dispatch follows the closed loop.
        """
        p = self.model.p
        self._planner_accumulation = accumulation
        self.planner = StepPlanner(
            self.buckets,
            n_workers=self.n_workers,
            budget=self.policy.m_comp * accumulation,
            budget_of=lambda b: b.load(p),
            strategy=self.config.dispatch,
            seed=seed,
            overlap=self.config.overlap_refine,
            deterministic_refine=self.config.deterministic_refine,
            refine_rounds=self.config.refine_rounds,
            capacities=self._capacities_for(self.n_workers),
            sp_max_ranks=self.config.sp_max_ranks,
            split_load_of=self._split_load_of(self.model),
        )
        return self.planner

    # -- the loop -----------------------------------------------------------

    def observe(self, records: Sequence[WorkerStepRecord]) -> None:
        for r in records:
            self.telemetry.add(r)
        self._steps_seen += 1
        if (
            self._steps_seen % self.config.refit_interval == 0
            and len(self.telemetry) >= self.config.min_samples
        ):
            self._maybe_refit()
        self._check_stragglers()
        if self.config.capacity_planning:
            self._check_capacities()

    def _maybe_refit(self) -> None:
        if self.config.device_classes is not None:
            self._maybe_refit_per_class()
            return
        samples = self.telemetry.bench_samples()
        try:
            new = fit_cost_model(samples)
        except ValueError:
            return
        if new.r2 < self.config.r2_floor:
            return  # telemetry too noisy to trust; keep the old plan
        if new.b <= 0:
            # a slope <= 0 has no compute budget (m_comp_for_target raises):
            # refuse to plan on it, as the per-class refit does.  The
            # reference replans here and its observe() raises.
            return
        new = self._recalibrate_comm_scale(new)
        p_shift = abs(new.p - self.model.p)
        if p_shift >= self.config.p_shift_tol or new.r2 > self.model.r2 + 0.01:
            self._replan(
                self._steps_seen,
                new,
                f"refit: p {self.model.p:.2f}->{new.p:.2f}, R2 {new.r2:.3f}",
            )

    def _recalibrate_comm_scale(self, new: CostModel) -> CostModel:
        """A fresh OLS fit knows nothing about ring traffic: carry the
        current ``comm_scale`` forward, then recalibrate it from whatever
        sequence-parallel shard records the buffer holds."""
        new = dataclasses.replace(new, comm_scale=self.model.comm_scale)
        split_recs = self.telemetry.split_records()
        if split_recs:
            try:
                new = new.fit_comm_scale(split_recs)
            except ValueError:
                pass  # keep the carried-forward value
        return new

    def _maybe_refit_per_class(self) -> None:
        """Heterogeneous-fleet refit: per-class (a, b) on a shared
        exponent.  A mixed fleet's POOLED fit is structurally poor (two
        slopes through one line), so gating it on ``r2_floor`` would lock
        the loop open — the per-class fit is the primary path whenever
        ``device_classes`` declares the composition.

        The scheduler-facing model becomes the SLOWEST class's fit: the
        barrier latches on the slowest rank, so budgets derived from it
        keep every class under the target.  The slope ratios (t ~ b·load,
        so 1/b is speed) replace the static ``DEVICE_CLASSES`` seed with
        measured capacity derates — a class running hot shows up as a
        smaller capacity, not a mystery straggler."""
        classes = self.config.device_classes
        assert classes is not None
        by_worker = self.telemetry.bench_samples_by_worker()
        by_class: dict[str, list] = {}
        for w, samples in by_worker.items():
            if w < len(classes):
                by_class.setdefault(classes[w], []).extend(samples)
        if set(classes) - set(by_class):
            return  # a declared class has not reported yet: keep the plan
        try:
            fits = fit_cost_model_per_class(by_class)
        except ValueError:
            return  # too little telemetry in some class
        pooled_r2 = next(iter(fits.values())).r2  # shared across classes
        if pooled_r2 < self.config.r2_floor:
            return
        if any(m.b <= 0 for m in fits.values()):
            return  # degenerate slope: refuse to plan on it
        slowest = max(fits, key=lambda c: fits[c].b)
        new = self._recalibrate_comm_scale(fits[slowest])
        self.class_models = {
            cls: dataclasses.replace(m, comm_scale=new.comm_scale)
            for cls, m in fits.items()
        }
        speed = {cls: 1.0 / m.b for cls, m in fits.items()}
        caps = [speed[c] for c in classes]
        mean = sum(caps) / len(caps)
        self._capacities = [c / mean for c in caps]
        p_shift = abs(new.p - self.model.p)
        if p_shift >= self.config.p_shift_tol or new.r2 > self.model.r2 + 0.01:
            self._replan(
                self._steps_seen,
                new,
                f"per-class refit ({slowest} slowest): p "
                f"{self.model.p:.2f}->{new.p:.2f}, R2 {new.r2:.3f}",
            )

    def _check_stragglers(self) -> None:
        stragglers = self.telemetry.straggler_workers(
            threshold=self.config.straggler_threshold
        )
        if stragglers and self._derate == 1.0:
            # Derate the compute budget so every bucket's load shrinks and the
            # barrier no longer latches on the degraded worker.
            self._derate = self.config.straggler_derate
            self._replan(
                self._steps_seen,
                self.model,
                f"straggler derate (workers {stragglers})",
            )
        elif not stragglers and self._derate != 1.0:
            self._derate = 1.0
            self._replan(self._steps_seen, self.model, "straggler cleared")

    def _check_capacities(self) -> None:
        """Estimate per-rank capacities from telemetry and push them into
        the planner when they shift materially (hysteresis, like the refit
        path — capacity thrash would churn the plan stream for nothing)."""
        speeds = self.telemetry.worker_speeds()
        if len(speeds) < self.n_workers:
            return  # capacity map incomplete: keep the current vector
        floor = self.config.capacity_floor
        caps = [
            min(max(speeds.get(w, 1.0), floor), 1.0 / floor)
            for w in range(self.n_workers)
        ]
        mean = sum(caps) / len(caps)
        caps = [c / mean for c in caps]  # mean 1.0: budget scale unchanged
        current = self._capacities or [1.0] * self.n_workers
        shift = max(abs(a - b) / b for a, b in zip(caps, current))
        if shift < self.config.capacity_tol:
            return
        self._capacities = caps
        self._replan(
            self._steps_seen,
            self.model,
            "capacity replan ("
            + ", ".join(f"{c:.2f}" for c in caps)
            + ")",
        )

    # -- run-state checkpointing --------------------------------------------

    def state_dict(self) -> dict:
        """JSON-serializable closed-loop state: the fitted cost model, the
        straggler-derate latch, the step counter, and the worker count —
        everything that determines the *current plan*.  The raw telemetry
        buffer is deliberately not captured: it is a refit input that
        re-accumulates within one ``refit_interval``, while the fit it
        already produced (the thing plans are derived from) IS restored."""
        return {
            "version": 1,
            "model": dataclasses.asdict(self.model),
            "derate": self._derate,
            "steps_seen": self._steps_seen,
            "n_workers": self.n_workers,
            "n_updates": len(self.updates),
            "capacities": self._capacities,
            "class_models": (
                {c: dataclasses.asdict(m) for c, m in self.class_models.items()}
                if self.class_models is not None
                else None
            ),
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict`: the policy/bucket table are rebuilt
        from the restored fit + derate and pushed into an attached planner,
        so the closed loop resumes exactly where the checkpoint left it."""
        self.model = CostModel(**sd["model"])
        self._derate = float(sd["derate"])
        self._steps_seen = int(sd["steps_seen"])
        self.n_workers = int(sd["n_workers"])
        caps = sd.get("capacities")  # absent in pre-capacity checkpoints
        self._capacities = [float(c) for c in caps] if caps else None
        cms = sd.get("class_models")  # absent in pre-heterogeneous checkpoints
        self.class_models = (
            {c: CostModel(**m) for c, m in cms.items()} if cms else None
        )
        self.policy = self._policy_from_model(self.model)
        self.buckets = self.policy.make_buckets(self.shapes)
        if self.planner is not None:
            p = self.model.p
            self.planner.update(
                buckets=self.buckets,
                budget=self.policy.m_comp * self._planner_accumulation,
                budget_of=lambda b: b.load(p),
                n_workers=self.n_workers,
                capacities=self._capacities_for(self.n_workers),
                split_load_of=self._split_load_of(self.model),
            )

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Release background resources: the attached planner's overlap
        refiner thread (if any).  Loaders only close planners they own, so
        the owner of a shared ``make_planner()`` planner — this scheduler —
        must be closed by whoever tears the training job down.  Safe to
        call repeatedly; a later ``plan_async()`` would lazily respawn."""
        if self.planner is not None:
            self.planner.close()

    # -- elasticity ---------------------------------------------------------

    def resize(self, n_workers: int) -> None:
        """Elastic scale-up/down: per-device budgets are unchanged, but the
        plan is re-emitted so the data pipeline can re-shard its stream."""
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        old = self.n_workers
        self.n_workers = n_workers
        # rank identities do not survive renumbering: drop the capacity
        # vector and let telemetry on the new fleet rebuild it
        self._capacities = None
        self._replan(self._steps_seen, self.model, f"elastic resize {old}->{n_workers}")

    # -- reporting ----------------------------------------------------------

    def global_batch_tokens(self) -> int:
        """Expected tokens/step across the cluster under the current plan."""
        if not self.buckets:
            return 0
        per_bucket = sum(b.tokens for b in self.buckets) / len(self.buckets)
        return int(per_bucket * self.n_workers)

    def describe(self) -> str:
        bn = self.telemetry.bottleneck()
        return (
            f"AdaptiveLoadScheduler(workers={self.n_workers}, "
            f"p={self.model.p:.2f}, R2={self.model.r2:.3f}, "
            f"M_comp={self.policy.m_comp:.3e}, M_mem={self.config.m_mem:.3e}, "
            f"dispatch={self.config.dispatch}"
            f"{' [planner attached]' if self.planner is not None else ''}, "
            f"bottleneck={bn.verdict}, updates={len(self.updates)})"
        )
