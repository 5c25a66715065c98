"""Autograd wiring of the joint q/k RMSNorm (QK-norm): the counterpart of
``repro.kernels.fused_rmsnorm.ops`` (its ``jax.custom_vjp`` around
``rms_norm``, applied once to q and once to k).

The forward keeps ``(q, k, wq, wk, rstd_q, rstd_k)``; the backward computes
dq and dk through K5 and dwq and dwk through K6, each ONE launch for both
tensors, with dw cast to the weight's dtype.  The device of ``q`` picks the
kernels (CUDA) or their plain versions (CPU).
"""

from __future__ import annotations

import torch

from .ref import qk_norm_ref, qk_rms_bwd_ref
from .rmsnorm import qk_rms_bwd_dw, qk_rms_bwd_dx, qk_rms_fwd


class QKNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, wq, wk, eps):
        fwd = qk_rms_fwd if q.device.type == "cuda" else qk_norm_ref
        yq, yk, rq, rk = fwd(q, k, wq, wk, eps)
        ctx.save_for_backward(q, k, wq, wk, rq, rk)
        return yq, yk

    @staticmethod
    def backward(ctx, gq, gk):
        q, k, wq, wk, rq, rk = ctx.saved_tensors
        gq = torch.zeros_like(q) if gq is None else gq.contiguous()
        gk = torch.zeros_like(k) if gk is None else gk.contiguous()
        if q.device.type == "cuda":
            dq, dk = qk_rms_bwd_dx(gq, gk, q, k, wq, wk, rq, rk)
            dwq, dwk = qk_rms_bwd_dw(gq, gk, q, k, rq, rk)
        else:
            dq, dk, dwq, dwk = qk_rms_bwd_ref(gq, gk, q, k, wq, wk, rq, rk)
        return dq, dk, dwq.to(wq.dtype), dwk.to(wk.dtype), None


def qk_norm(q, k, wq, wk, eps: float = 1e-6):
    """Differentiable per-head RMSNorm of q [B, S, Hq, dh] and k [B, S, Hk,
    dh]; returns ``(q_norm, k_norm)``."""
    return QKNorm.apply(q, k, wq, wk, eps)
