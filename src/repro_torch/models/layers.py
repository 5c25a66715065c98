"""Base layers of the MMDiT: the initializer, the LayerNorm branch of
``repro.models.layers.apply_norm`` and the SwiGLU MLP.

Weights keep the JAX package's ``x @ W`` meaning: a projection is a
``[d_in, d_out]`` parameter applied with ``x @ w``, not an ``nn.Linear``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float | None = None) -> nn.Parameter:
    """N(0, 1) * d_in^-0.5 (or ``scale``) weights, drawn in f32 from ``gen``."""
    s = scale if scale is not None else d_in**-0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device)
    return nn.Parameter((w * s).to(dtype))


class Norm(nn.Module):
    """LayerNorm affine parameters ``w`` (ones) and ``b`` (zeros), f32."""

    def __init__(self, d: int, device):
        super().__init__()
        self.w = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device))
        self.b = nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))


def apply_norm(p: Norm, x, kind: str, eps: float):
    """LayerNorm over the last axis with fp32 statistics, in x's dtype."""
    if kind != "layernorm":
        raise ValueError(f"the port has only the layernorm branch, got {kind!r}")
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.w + p.b).to(x.dtype)


class MLP(nn.Module):
    """SwiGLU weights: ``w1``, ``w3`` [d, d_ff] and ``w2`` [d_ff, d]."""

    def __init__(self, gen: torch.Generator, d: int, d_ff: int, dtype, device):
        super().__init__()
        self.w1 = dense_init(gen, d, d_ff, dtype, device)
        self.w3 = dense_init(gen, d, d_ff, dtype, device)
        self.w2 = dense_init(gen, d_ff, d, dtype, device)


def apply_mlp(p: MLP, x):
    h = F.silu(x @ p.w1) * (x @ p.w3)
    return h @ p.w2
