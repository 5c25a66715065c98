"""Continuous-batching diffusion serving: the paper's planner aimed at
inference.

* :mod:`repro_torch.serve.request`    — the denoise request lifecycle,
* :mod:`repro_torch.serve.scheduler`  — iteration-level, decode-first
  admission under the dual constraint (token budget, B·S^p ≤ M_comp),
* :mod:`repro_torch.serve.engine`     — :class:`DiffusionServeEngine`,
  batched MMDiT denoise sampling on that scheduler.
"""

from .engine import DiffusionServeEngine
from .request import DenoiseRequest
from .scheduler import ContinuousBatchingScheduler, IterationPlan, ServeConfig

__all__ = [
    "ContinuousBatchingScheduler",
    "DenoiseRequest",
    "DiffusionServeEngine",
    "IterationPlan",
    "ServeConfig",
]
