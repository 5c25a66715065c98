"""Plain PyTorch version of the fused LayerNorm-Modulate forward (AdaLN).

The operator (paper §3.3): given activations ``x [B, S, D]`` and
per-sample modulation ``scale, shift [B, D]``,

    x_hat = (x - mean(x)) / sqrt(var(x) + eps)        (LayerNorm, no affine)
    y     = x_hat * (1 + scale) + shift               (Modulate)

Statistics are fp32 whatever the input dtype.  This is the counterpart of
``repro.kernels.fused_adaln.ref.adaln_naive``; it also returns the
statistics the CUDA kernel emits for the backward.
"""

from __future__ import annotations

import torch


def adaln_modulate_ref(x, scale, shift, eps: float = 1e-6):
    """Returns ``(y [B,S,D] in x.dtype, mu [B,S] f32, rstd [B,S] f32)``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    x_hat = (xf - mu) * rstd
    y = x_hat * (1.0 + scale.float()[..., None, :]) + shift.float()[..., None, :]
    return y.to(x.dtype), mu[..., 0], rstd[..., 0]


def adaln_bwd_dx_ref(dy, x, mu, rstd, scale):
    """Plain K2: ``dx = (dxhat - mean(dxhat) - x_hat * mean(dxhat * x_hat)) *
    rstd`` with ``dxhat = dy * (1 + scale)``, in fp32, cast to x's dtype
    (``repro.kernels.fused_adaln.adaln._bwd_dx_kernel``)."""
    x_hat = (x.float() - mu[..., None]) * rstd[..., None]
    dxhat = dy.float() * (1.0 + scale.float()[..., None, :])
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * x_hat).mean(dim=-1, keepdim=True)
    return ((dxhat - m1 - x_hat * m2) * rstd[..., None]).to(x.dtype)


def adaln_bwd_dmod_ref(dy, x, mu, rstd):
    """Plain K3 and K10: ``(dscale, dshift) = (sum_s dy * x_hat, sum_s dy)``
    [B, D] f32 (``repro.kernels.fused_adaln.adaln._bwd_dmod_kernel`` and
    ``_bwd_dmod_naive_kernel``, which compute the same sums)."""
    dyf = dy.float()
    x_hat = (x.float() - mu[..., None]) * rstd[..., None]
    return (dyf * x_hat).sum(dim=-2), dyf.sum(dim=-2)
