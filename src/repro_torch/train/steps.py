"""Step functions.  Serving needs one: a denoise step (one velocity
evaluation, the unit of diffusion sampling).  The training steps come with
the training slice."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.config import ModelConfig


def make_denoise_step(cfg: ModelConfig) -> Callable:
    """MMDiT serving: one velocity evaluation, without autograd state.  The
    optional segment ids scope attention per clip so the continuous-batching
    engine can pad mixed clip lengths into one wave (-1 = padding)."""
    if cfg.family != "mmdit":
        raise ValueError(f"denoise step needs an mmdit config, got {cfg.family!r}")

    def denoise_step(model, latents, text, t, segment_ids=None,
                     text_segment_ids=None):
        with torch.inference_mode():
            return model(
                latents, text, t,
                segment_ids=segment_ids, text_segment_ids=text_segment_ids,
            )

    return denoise_step
