"""Synthetic data: the mixed image/video corpus and batch materialization
(diffusion latents, LM token streams), the counterpart of
``repro.data.synthetic``.

The paper stress-tests with "a mixed corpus of 10 million samples from
WebDataset and Koala-36m, creating extreme sequence length variance"; this
reproduces the *shape distribution* (images + multi-duration multi-res
videos) and generates synthetic latents and text states on the fly — the
bucketing system only ever sees shapes and the device only ever sees
tensors ("synthetic pixel scans", paper §3.2).  Batches are drawn on the
device they train on, from a ``torch.Generator`` seeded by the loader.
``lm_length_corpus`` draws document lengths with numpy, as the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bucketing import DataShape
from repro_torch.models.config import ModelConfig
from repro_torch.models.mmdit import DTYPES, TEXT_DIM


def wan_mixed_corpus() -> tuple[list[DataShape], list[float]]:
    """Image + video shape mix with paper-like extreme variance
    (S from ~1.6k to ~47k logical tokens)."""
    shapes = [
        DataShape(1, 480, 832, 77),     # image, 480p
        DataShape(1, 720, 1280, 77),    # image, 720p
        DataShape(17, 480, 832, 77),    # 1s video 480p
        DataShape(33, 480, 832, 77),    # 2s video 480p
        DataShape(81, 480, 832, 77),    # 5s video 480p
        DataShape(33, 720, 1280, 77),   # 2s video 720p
        DataShape(81, 720, 1280, 77),   # 5s video 720p
        DataShape(97, 720, 1280, 77),   # 6s video 720p
    ]
    weights = [0.20, 0.13, 0.15, 0.15, 0.12, 0.12, 0.08, 0.05]
    return shapes, weights


def lm_length_corpus(rng: np.random.Generator, n: int, *, lo: int = 64,
                     hi: int = 8192) -> np.ndarray:
    """Document lengths with a heavy tail (lognormal), the LM analogue of
    mixed video shapes."""
    raw = rng.lognormal(mean=np.log(600), sigma=1.1, size=n)
    return np.clip(raw.astype(np.int64), lo, hi)


def make_diffusion_batch(seed: int, bucket_batch: int, seq_len: int, cfg: ModelConfig,
                         device) -> dict:
    """Latent tokens [B, S, in_channels*4] and text states [B, text_len,
    4096] for one MMDiT microbatch, N(0, 1) drawn in f32 on ``device`` from
    ``seed`` and cast to the configuration's dtype."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = DTYPES[cfg.dtype]
    latents = torch.randn((bucket_batch, seq_len, cfg.in_channels * 4), generator=gen,
                          dtype=torch.float32, device=device).to(dt)
    text = torch.randn((bucket_batch, cfg.text_len, TEXT_DIM), generator=gen,
                       dtype=torch.float32, device=device).to(dt)
    return {"latents": latents, "text": text}


def make_lm_batch(seed: int, batch: int, seq_len: int, vocab: int, cfg: ModelConfig,
                  device) -> dict:
    """A Markov-ish token stream (not uniform: the loss has a learnable
    signal), the reference's construction: ``base`` uniform over the
    vocabulary, each token replaced by its predecessor in ``base`` with
    probability 1/2, and ``labels = roll(tokens, -1)``.  ``tokens`` and
    ``labels`` [B, S] int32, drawn on ``device`` from ``seed``.  A VLM's
    batch also holds ``memory`` [B, n_image_tokens, d], the stub image
    frontend's patch embeddings: N(0, 1) drawn in f32 from the same
    generator after the tokens and cast to the configuration's dtype."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randint(0, vocab, (batch, seq_len), generator=gen, device=device)
    shifted = torch.roll(base, 1, dims=1)
    mask = torch.rand((batch, seq_len), generator=gen, device=device) < 0.5
    tokens = torch.where(mask, shifted, base).to(torch.int32)
    out = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.family == "vlm":
        out["memory"] = torch.randn((batch, cfg.n_image_tokens, cfg.d_model), generator=gen,
                                    dtype=torch.float32, device=device).to(DTYPES[cfg.dtype])
    return out
