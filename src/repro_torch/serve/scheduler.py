"""Iteration-level admission control under the paper's dual constraint.

Every engine iteration is priced like a training microbatch: the fitted
cost model says a batch of load L takes ``a + b·L`` seconds, so a target
per-iteration latency back-derives a compute budget ``M_comp = (target -
a) / b`` in B·S^p load units.  The token budget (``m_mem_tokens``) is the
memory half: a request reserves its residency at admission, rounded up to
whole pages.

The policy is **decode-first**: the running wave is always serviced in
full — admission only spends ``M_comp - decode_load`` on new requests.
Waiting requests are considered strictly FCFS (the first one that doesn't
fit blocks the queue).  A request too large to EVER fit beside anything
(``S^p > M_comp``) runs alone once the wave is empty — over-latency, but
scheduled, and flagged in the plan.

Pure policy, no tensors: a copy of ``repro.serve.scheduler`` so both
engines admit the same requests at the same simulated times.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.cost_model import CostModel


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine + admission knobs."""

    target_step: float  # per-iteration latency target (s) -> M_comp
    page_size: int = 16
    num_pages: int = 256
    decode_slots: int = 8  # wave width (slots)
    max_seq: int = 256  # per-request token ceiling
    m_mem_tokens: int | None = None  # token budget; None = pool capacity
    max_prefills_per_step: int = 4  # bounds per-iteration admissions

    def __post_init__(self) -> None:
        if self.page_size < 1 or self.num_pages < 1:
            raise ValueError("page_size and num_pages must be >= 1")
        if self.decode_slots < 1:
            raise ValueError("decode_slots must be >= 1")
        if self.max_seq % self.page_size != 0:
            raise ValueError(
                f"max_seq {self.max_seq} must be a multiple of page_size "
                f"{self.page_size}"
            )

    @property
    def pages_max(self) -> int:
        return self.max_seq // self.page_size

    @property
    def mem_tokens(self) -> int:
        cap = self.num_pages * self.page_size
        return cap if self.m_mem_tokens is None else min(self.m_mem_tokens, cap)

    def page_tokens(self, tokens: int) -> int:
        """Token charge for ``tokens`` slots: whole pages."""
        return -(-int(tokens) // self.page_size) * self.page_size


@dataclasses.dataclass
class IterationPlan:
    """What one engine iteration will run."""

    prefills: list  # admitted waiting requests, FCFS order
    decode_load: float  # B·S^p load of the running wave (always serviced)
    prefill_load: float
    oversize: bool = False  # a >M_comp request scheduled alone

    @property
    def total_load(self) -> float:
        return self.decode_load + self.prefill_load


class ContinuousBatchingScheduler:
    """Decode-first FCFS admission against (M_comp, token budget)."""

    def __init__(self, model: CostModel, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg
        self.m_comp = model.m_comp_for_target(cfg.target_step)

    def decode_load(self, running: Sequence) -> float:
        p = self.model.p
        return float(sum(r.step_load(p) for r in running))

    def plan(
        self,
        waiting: Sequence,
        running: Sequence,
        *,
        free_tokens: int,
        free_slots: int,
    ) -> IterationPlan:
        p = self.model.p
        dload = self.decode_load(running)
        budget = self.m_comp - dload
        admitted: list = []
        pload = 0.0
        oversize = False
        tokens = free_tokens
        slots = free_slots
        for r in waiting:
            if len(admitted) >= self.cfg.max_prefills_per_step:
                break
            load = r.admit_load(p)
            need = self.cfg.page_tokens(r.reserve_tokens)
            if load > self.m_comp:
                # can never co-schedule under the budget: run it alone
                # once nothing is running (FCFS keeps the queue behind it
                # blocked, so the wave ahead drains and it does run)
                if (
                    not running
                    and not admitted
                    and need <= tokens
                    and slots > 0
                ):
                    admitted.append(r)
                    pload += load
                    oversize = True
                break
            if load > budget or need > tokens or slots < 1:
                break  # strict FCFS: the head of the queue blocks it
            admitted.append(r)
            pload += load
            budget -= load
            tokens -= need
            slots -= 1
        return IterationPlan(admitted, dload, pload, oversize=oversize)

    def price(self, plan: IterationPlan) -> float:
        """Predicted latency of one iteration under the fitted model — the
        simulated-clock increment (``a`` charged once per iteration)."""
        return self.model.a + self.model.b * plan.total_load
