"""Continuous-batching serving: the paper's planner aimed at inference.

* :mod:`repro_torch.serve.request`    — the LM and denoise request
  lifecycles,
* :mod:`repro_torch.serve.scheduler`  — iteration-level, decode-first
  admission under the dual constraint (token budget, B·S^p ≤ M_comp),
* :mod:`repro_torch.serve.page_pool`  — the free-list allocator of the
  paged KV cache,
* :mod:`repro_torch.serve.engine`     — :class:`ServeEngine` (LM decoding
  over the paged KV cache) and :class:`DiffusionServeEngine` (batched MMDiT
  denoise sampling), both on that scheduler.
"""

from .engine import DiffusionServeEngine, ServeEngine
from .page_pool import OutOfPages, PagePool
from .request import DenoiseRequest, Request
from .scheduler import ContinuousBatchingScheduler, IterationPlan, ServeConfig

__all__ = [
    "ContinuousBatchingScheduler",
    "DenoiseRequest",
    "DiffusionServeEngine",
    "IterationPlan",
    "OutOfPages",
    "PagePool",
    "Request",
    "ServeConfig",
    "ServeEngine",
]
