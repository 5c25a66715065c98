"""Plain PyTorch versions of the RMSNorm kernels: the forward on model
rows, gated (K13) and as QK-norm, and the backward on rows, gated and on q
and k.

``y = x * rsqrt(mean(x²) + eps) * w`` over the last axis, stats in fp32 —
the counterpart of ``repro.kernels.fused_rmsnorm.ref.rms_norm_naive``
(and ``gated_rms_norm_naive``, times ``silu(g)``), also returning the
``rstd`` rows the CUDA kernels emit.
"""

from __future__ import annotations

import torch


def rms_norm_ref(x, w, eps: float = 1e-6):
    """Returns ``(y in x.dtype, rstd [x.shape[:-1]] f32)``."""
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    y = xf * rstd * w.float()
    return y.to(x.dtype), rstd[..., 0]


def gated_rms_norm_ref(x, w, g, eps: float = 1e-6):
    """Plain K13: ``y = x * rstd * w * silu(g)`` in f32, cast to x's dtype
    (``repro.kernels.fused_rmsnorm.ref.gated_rms_norm_naive``).  Returns
    ``(y, rstd [x.shape[:-1]] f32)``."""
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    gf = g.float()
    y = xf * rstd * w.float() * (gf * torch.sigmoid(gf))
    return y.to(x.dtype), rstd[..., 0]


def qk_norm_ref(q, k, wq, wk, eps: float = 1e-6):
    """Per-head RMSNorm of q and k (paper's QNorm+KNorm).

    q: [..., Hq, dh], k: [..., Hk, dh]; wq/wk: [dh].  Returns
    ``(q_norm, k_norm, rstd_q, rstd_k)``.
    """
    yq, rq = rms_norm_ref(q, wq, eps)
    yk, rk = rms_norm_ref(k, wk, eps)
    return yq, yk, rq, rk


def rms_bwd_ref(dy, x, w, rstd):
    """Plain K5 and K6 for one tensor: ``dx = rstd * (dxhat - x_hat *
    mean(dxhat * x_hat))`` with ``dxhat = dy * w`` (in x's dtype) and ``dw =
    sum_rows dy * x_hat`` [D] f32 (``repro.kernels.fused_rmsnorm.rmsnorm``
    ``_bwd_dx_kernel`` and ``_bwd_dw_kernel``)."""
    r = rstd[..., None]
    x_hat = x.float() * r
    dyf = dy.float()
    dxhat = dyf * w.float()
    m = (dxhat * x_hat).mean(dim=-1, keepdim=True)
    dx = (r * (dxhat - x_hat * m)).to(x.dtype)
    return dx, (dyf * x_hat).reshape(-1, x.shape[-1]).sum(dim=0)


def gated_bwd_split(dy, x, w, g, rstd):
    """The gate's part of the gated norm's backward, in f32: ``d_norm = dy *
    silu(g)``, the cotangent of the norm, and ``dg = dy * x_hat * w *
    silu'(g)`` in g's dtype.  Returns ``(d_norm f32, dg)``."""
    gf = g.float()
    sig = torch.sigmoid(gf)
    dyf = dy.float()
    x_hat = x.float() * rstd[..., None]
    dg = dyf * x_hat * w.float() * (sig * (1.0 + gf * (1.0 - sig)))
    return dyf * (gf * sig), dg.to(g.dtype)


def gated_rms_bwd_ref(dy, x, w, g, rstd):
    """Plain backward of the gated norm, all in f32 (the ``ref`` backend's
    ``_grms_bwd``, ``repro.kernels.fused_rmsnorm.ref``): ``d_norm`` and
    ``dg`` from :func:`gated_bwd_split`, then ``dx`` and ``dw`` as
    :func:`rms_bwd_ref` on ``d_norm`` (not rounded).  Returns ``(dx in x's
    dtype, dw [D] f32, dg in g's dtype)``."""
    d_norm, dg = gated_bwd_split(dy, x, w, g, rstd)
    dx, dw = rms_bwd_ref(d_norm, x, w, rstd)
    return dx, dw, dg


def qk_rms_bwd_ref(dyq, dyk, q, k, wq, wk, rq, rk):
    """Plain K5 and K6 for q and k: ``(dq, dk, dwq, dwk)``."""
    dq, dwq = rms_bwd_ref(dyq, q, wq, rq)
    dk, dwk = rms_bwd_ref(dyk, k, wk, rk)
    return dq, dk, dwq, dwk
