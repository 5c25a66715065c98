"""Request lifecycle for the continuous-batching engines: a copy of
``repro.serve.request``.

Both request kinds expose the same three admission quantities, so one
scheduler prices LM prefill/decode and mmdit denoise steps alike:

* ``admit_load(p)``    — the B·S^p load admission must buy to start it,
* ``step_load(p)``     — the load it adds to EVERY subsequent iteration,
* ``reserve_tokens``   — the token-budget reservation while resident.

LM decode's per-iteration load is ``ctx^(p-1)``: one new token attends
``ctx`` cached tokens, so its work is the per-token rate of the fitted
``S^p`` curve.  A denoise step re-evaluates full self-attention over the
clip every iteration, so its step load stays ``S_vis^p``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

WAITING = "waiting"
RUNNING = "running"
DONE = "done"


@dataclasses.dataclass
class Request:
    """One LM generation request."""

    rid: int
    prompt: np.ndarray  # int32 [prompt_len]
    max_new: int
    arrival: float = 0.0

    state: str = WAITING
    ctx: int = 0  # tokens currently in the paged cache
    out: list = dataclasses.field(default_factory=list)  # generated ids
    pages: list = dataclasses.field(default_factory=list)
    slot: int = -1
    t_first: Optional[float] = None  # clock at first token
    t_done: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def reserve_tokens(self) -> int:
        """Worst-case cache residency, reserved at admission so decode can
        never run out of pages mid-generation (no eviction/restart)."""
        return self.prompt_len + self.max_new

    def admit_load(self, p: float) -> float:
        return float(self.prompt_len) ** p

    def step_load(self, p: float) -> float:
        return float(max(self.ctx, 1)) ** (p - 1.0)

    @property
    def latency(self) -> float:
        if self.t_done is None:
            raise ValueError(f"request {self.rid} not finished")
        return self.t_done - self.arrival


@dataclasses.dataclass
class DenoiseRequest:
    """One mmdit diffusion-sampling request (a chain of denoise steps)."""

    rid: int
    latents: np.ndarray  # [S_vis, in_channels*4] noise at t=1
    text: np.ndarray  # [S_txt, text_feature_dim]
    n_steps: int
    arrival: float = 0.0

    state: str = WAITING
    step: int = 0  # denoise steps completed
    slot: int = -1
    result: Optional[np.ndarray] = None  # denoised latents when DONE
    t_first: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def tokens(self) -> int:
        return int(self.latents.shape[0])

    @property
    def reserve_tokens(self) -> int:
        return self.tokens

    def admit_load(self, p: float) -> float:
        return float(self.tokens) ** p

    def step_load(self, p: float) -> float:
        return float(self.tokens) ** p

    @property
    def latency(self) -> float:
        if self.t_done is None:
            raise ValueError(f"request {self.rid} not finished")
        return self.t_done - self.arrival
