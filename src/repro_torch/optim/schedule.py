"""Learning-rate schedules (step -> lr functions): the counterpart of
``repro.optim.schedule``, in plain Python arithmetic.

Includes WSD (Warmup-Stable-Decay) — MiniCPM's schedule (arXiv:2404.06395) —
alongside cosine and constant.
"""

from __future__ import annotations

import math


def constant(peak_lr: float, warmup: int = 0):
    def f(step):
        w = min(step / max(warmup, 1), 1.0) if warmup else 1.0
        return peak_lr * w

    return f


def cosine(peak_lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    def f(step):
        if step < warmup:
            return peak_lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0), 1.0)
        return peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * prog)))

    return f


def wsd(peak_lr: float, warmup: int, total_steps: int, decay_frac: float = 0.1,
        final_frac: float = 0.01):
    """Warmup-Stable-Decay: linear warmup, long stable plateau, short
    linear decay over the last ``decay_frac``."""
    decay_start = int(total_steps * (1 - decay_frac))

    def f(step):
        if step < warmup:
            return peak_lr * step / max(warmup, 1)
        if step < decay_start:
            return peak_lr
        prog = min(max((step - decay_start) / max(total_steps - decay_start, 1), 0.0), 1.0)
        return peak_lr * (1.0 - (1.0 - final_frac) * prog)

    return f


def get_schedule(name: str, peak_lr: float, warmup: int, total_steps: int):
    if name == "constant":
        return constant(peak_lr, warmup)
    if name == "cosine":
        return cosine(peak_lr, warmup, total_steps)
    if name == "wsd":
        return wsd(peak_lr, warmup, total_steps)
    raise ValueError(f"unknown schedule {name!r}")
