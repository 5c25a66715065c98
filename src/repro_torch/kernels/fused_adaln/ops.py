"""Autograd wiring of the fused AdaLN: the counterpart of
``repro.kernels.fused_adaln.ops`` (its ``jax.custom_vjp``).

The forward keeps only ``(x, scale, mu, rstd)`` as residuals (the paper's
graph collapse); the backward computes ``dx`` through K2 and ``(dscale,
dshift)`` through K3, cast to ``scale.dtype`` as ``ops.py:75`` does.  The
device of ``x`` picks the kernels (CUDA), their shape functions (``meta``,
``kernels.meta``) or their plain versions (CPU), so the CPU tests run the
same residuals and casts as the card.
"""

from __future__ import annotations

import torch

from ..meta import on_device, pick
from .adaln import adaln_bwd_dmod, adaln_bwd_dx, adaln_fwd
from .ref import adaln_bwd_dmod_ref, adaln_bwd_dx_ref, adaln_modulate_ref


class AdaLNModulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, eps):
        fwd = pick(adaln_fwd, adaln_modulate_ref, x)
        y, mu, rstd = fwd(x, scale, shift, eps)
        ctx.save_for_backward(x, scale, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, mu, rstd = ctx.saved_tensors
        dy = dy.contiguous()
        if x.device.type != "cpu":
            dx = on_device(adaln_bwd_dx, x)(dy, x, mu, rstd, scale)
            dscale, dshift = on_device(adaln_bwd_dmod, x)(dy, x, mu, rstd)
        else:
            dx = adaln_bwd_dx_ref(dy, x, mu, rstd, scale)
            dscale, dshift = adaln_bwd_dmod_ref(dy, x, mu, rstd)
        return dx, dscale.to(scale.dtype), dshift.to(scale.dtype), None


def adaln_modulate(x, scale, shift, eps: float = 1e-6):
    """Differentiable fused LayerNorm-Modulate.  x: [B, S, D]; scale,
    shift: [B, D]."""
    return AdaLNModulate.apply(x, scale, shift, eps)
