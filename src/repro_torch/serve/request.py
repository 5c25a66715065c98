"""Request lifecycle for the diffusion serving engine.

A request exposes the three admission quantities the scheduler prices:

* ``admit_load(p)``    — the B·S^p load admission must buy to start it,
* ``step_load(p)``     — the load it adds to EVERY subsequent iteration,
* ``reserve_tokens``   — the token-budget reservation while resident.

A denoise step re-evaluates full self-attention over the clip every
iteration, so its step load stays ``S_vis^p``.  The LM request of
``repro.serve.request`` comes with the LM serving slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

WAITING = "waiting"
RUNNING = "running"
DONE = "done"


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
