"""AdaptiveLoad core of the port: the paper's contribution as a composable
library, the framework-free numpy modules of ``repro.core`` copied.

Layer map (paper section -> module):
  §3.2 Eq.2 dual-constraint batch sizing  -> bucketing
  §3.2 cost model a + b·B·S^p, p grid     -> cost_model
  §3.2 Shape Benchmark / Throughput Sweep -> shape_bench (an H100 model)
  §4.3 CV metrics + LPT re-alignment      -> balancer
  §4.5 global step-level dispatch         -> dispatch
  Eq.1 T_sync = max_i T_i cluster model   -> simulator
  §3.2 closed loop (telemetry->replan)    -> scheduler, telemetry

``shape_bench`` models one NVIDIA H100 (its peak and memory rate are
fields of ``AnalyticDeviceModel``), not the reference's device.
"""

from .bucketing import (
    Bucket,
    BucketingPolicy,
    DataShape,
    bucket_table,
    dual_constraint_batch_size,
    equal_token_batch_size,
    load_statistics,
)
from .cost_model import (
    BenchSample,
    CostModel,
    correlation_report,
    fit_cost_model,
    pearson,
)
from .balancer import (
    RunningStats,
    StepMetrics,
    assign_lpt,
    assign_random,
    makespan,
    step_metrics,
)
from .shape_bench import (
    AnalyticDeviceModel,
    ModelDims,
    run_analytic_benchmark,
    run_measured_benchmark,
    sweep_grid,
)
from .dispatch import (
    DISPATCH_STRATEGIES,
    PlanRefiner,
    RefineTicket,
    StepPlan,
    StepPlanner,
    assign_pool,
    microbatch_key,
    normalized_weights,
    plan_digest,
    refine_fixed_rounds,
    refine_swaps,
)
from .simulator import (
    CorpusSampler,
    SimulationResult,
    simulate,
    simulate_packed,
    simulate_planned,
)
from .scheduler import AdaptiveLoadScheduler, SchedulerConfig
from .telemetry import BottleneckReport, TelemetryBuffer, WorkerStepRecord

__all__ = [
    "Bucket",
    "BucketingPolicy",
    "DataShape",
    "bucket_table",
    "dual_constraint_batch_size",
    "equal_token_batch_size",
    "load_statistics",
    "BenchSample",
    "CostModel",
    "correlation_report",
    "fit_cost_model",
    "pearson",
    "RunningStats",
    "StepMetrics",
    "assign_lpt",
    "assign_random",
    "makespan",
    "step_metrics",
    "AnalyticDeviceModel",
    "ModelDims",
    "run_analytic_benchmark",
    "run_measured_benchmark",
    "sweep_grid",
    "DISPATCH_STRATEGIES",
    "PlanRefiner",
    "RefineTicket",
    "StepPlan",
    "StepPlanner",
    "assign_pool",
    "microbatch_key",
    "normalized_weights",
    "plan_digest",
    "refine_fixed_rounds",
    "refine_swaps",
    "CorpusSampler",
    "SimulationResult",
    "simulate",
    "simulate_packed",
    "simulate_planned",
    "AdaptiveLoadScheduler",
    "SchedulerConfig",
    "BottleneckReport",
    "TelemetryBuffer",
    "WorkerStepRecord",
]
