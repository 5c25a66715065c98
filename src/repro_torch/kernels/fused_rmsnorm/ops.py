"""Autograd wiring of the RMSNorms: the counterpart of
``repro.kernels.fused_rmsnorm.ops`` (its ``jax.custom_vjp`` around
``rms_norm`` and ``gated_rms_norm``).

* :class:`RMSNorm` on model rows: the forward K4 keeps ``(x, w, rstd)``;
  the backward is K5 (dx) and K6 (dw) on rows.
* :class:`GatedRMSNorm` (Mamba-2's gate + norm): the forward K13 keeps
  ``(x, w, g, rstd)``; the backward forms ``dy_eff = dy * silu(g)``
  rounded to dy's dtype, runs K5 and K6 on rows on it, and computes
  ``dg`` in PyTorch, as the reference's Pallas backward does in jnp
  (``ops.py:95-113``).  The CPU path is the ``ref`` backend's backward,
  which does not round ``dy_eff``: in bf16 the two differ by that one
  rounding.
* :class:`QKNorm`, the joint per-head q/k RMSNorm (applied once to q and
  once to k in the reference): the forward keeps ``(q, k, wq, wk, rstd_q,
  rstd_k)``; the backward computes dq and dk through K5 and dwq and dwk
  through K6, each ONE launch for both tensors.

dw is cast to the weight's dtype.  The device of the input picks the
kernels (CUDA), their shape functions (``meta``, ``kernels.meta``) or
their plain versions (CPU).
"""

from __future__ import annotations

import torch

from ..meta import on_device, pick
from .ref import (
    gated_bwd_split,
    gated_rms_bwd_ref,
    gated_rms_norm_ref,
    qk_norm_ref,
    qk_rms_bwd_ref,
    rms_bwd_ref,
    rms_norm_ref,
)
from .rmsnorm import (
    gated_rms_fwd,
    qk_rms_bwd_dw,
    qk_rms_bwd_dx,
    qk_rms_fwd,
    rms_bwd_dw,
    rms_bwd_dx,
    rms_fwd,
)


class RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        y, rstd = pick(rms_fwd, rms_norm_ref, x)(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensors
        dy = dy.contiguous()
        if x.device.type != "cpu":
            dx = on_device(rms_bwd_dx, x)(dy, x, w, rstd)
            dw = on_device(rms_bwd_dw, x)(dy, x, rstd)
        else:
            dx, dw = rms_bwd_ref(dy, x, w, rstd)
        return dx, dw.to(w.dtype), None


class GatedRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, g, eps):
        fwd = pick(gated_rms_fwd, gated_rms_norm_ref, x)
        y, rstd = fwd(x, w, g, eps)
        ctx.save_for_backward(x, w, g, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, g, rstd = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dw, dg = gated_rms_bwd_ref(dy, x, w, g, rstd)
            return dx, dw.to(w.dtype), dg, None
        d_norm, dg = gated_bwd_split(dy, x, w, g, rstd)
        dy_eff = d_norm.to(dy.dtype).contiguous()
        dx = on_device(rms_bwd_dx, x)(dy_eff, x, w, rstd)
        dw = on_device(rms_bwd_dw, x)(dy_eff, x, rstd)
        return dx, dw.to(w.dtype), dg, None


class QKNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, wq, wk, eps):
        fwd = pick(qk_rms_fwd, qk_norm_ref, q)
        yq, yk, rq, rk = fwd(q, k, wq, wk, eps)
        ctx.save_for_backward(q, k, wq, wk, rq, rk)
        return yq, yk

    @staticmethod
    def backward(ctx, gq, gk):
        q, k, wq, wk, rq, rk = ctx.saved_tensors
        gq = torch.zeros_like(q) if gq is None else gq.contiguous()
        gk = torch.zeros_like(k) if gk is None else gk.contiguous()
        if q.device.type != "cpu":
            dq, dk = on_device(qk_rms_bwd_dx, q)(gq, gk, q, k, wq, wk, rq, rk)
            dwq, dwk = on_device(qk_rms_bwd_dw, q)(gq, gk, q, k, rq, rk)
        else:
            dq, dk, dwq, dwk = qk_rms_bwd_ref(gq, gk, q, k, wq, wk, rq, rk)
        return dq, dk, dwq.to(wq.dtype), dwk.to(wk.dtype), None


def rms_norm(x, w, eps: float = 1e-6):
    """Differentiable RMSNorm of the rows of x [..., D]."""
    return RMSNorm.apply(x, w, eps)


def gated_rms_norm(x, w, g, eps: float = 1e-6):
    """Differentiable ``rms_norm(x, w) * silu(g)`` over the rows of x [...,
    D]; g shaped as x (it may be a strided view)."""
    return GatedRMSNorm.apply(x, w, g, eps)


def qk_norm(q, k, wq, wk, eps: float = 1e-6):
    """Differentiable per-head RMSNorm of q [B, S, Hq, dh] and k [B, S, Hk,
    dh]; returns ``(q_norm, k_norm)``."""
    return QKNorm.apply(q, k, wq, wk, eps)
