"""The frozen count of a Wan-2.1 training step's model FLOPs, the numerator
of ``mfu_pct``: the products the forward and the backward need, from the
shapes alone, without the per-block recompute the program runs and without
elementwise work.

A product ``[M, K] @ [K, N]`` is ``2 M K N`` operations forward and twice
that backward (the gradients of both operands), except where no gradient
of its input is needed: the latents' and text states' input projections and
the first time-embedding product take only their weights' gradient (one
more product).  Attention is ``Q K^T`` and ``P V`` forward (``4 Sq Skv``
a head and head dim) and four products of that size backward.
"""

from __future__ import annotations

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (NVIDIA's data sheet)


def microbatch_flops(cfg: dict, b: int, s: int) -> float:
    """Model FLOPs of one ``b x s`` microbatch's forward and backward."""
    d, dff, n = cfg["d_model"], cfg["d_ff"], cfg["text_len"]
    hd = cfg["n_heads"] * cfg["head_dim"]
    c = cfg["in_channels"] * cfg["patch"][0] * cfg["patch"][1] * cfg["patch"][2]
    tok, txt = b * s, b * n
    inputs = 2 * tok * c * d + 2 * txt * cfg["text_dim"] * d + 2 * b * cfg["freq_dim"] * d
    time = 2 * b * d * (6 * d + 2 * d)
    layer = (2 * tok * (3 * d * hd + hd * d + d * hd + hd * d + 3 * d * dff)
             + 2 * txt * d * 2 * hd
             + 4 * b * s * s * hd + 4 * b * s * n * hd)
    head = 2 * tok * d * c
    return 2.0 * inputs + 3.0 * (time + cfg["n_layers"] * layer + head)


def step_flops(cfg: dict, microbatches) -> float:
    """Model FLOPs of a step of ``[(B, S), ...]`` microbatches."""
    return sum(microbatch_flops(cfg, b, s) for b, s in microbatches)
