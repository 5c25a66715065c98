"""Plain PyTorch versions of the RMSNorm kernels: the forward on model
rows and as QK-norm, and the q/k backward.

``y = x * rsqrt(mean(x²) + eps) * w`` over the last axis, stats in fp32 —
the counterpart of ``repro.kernels.fused_rmsnorm.ref.rms_norm_naive``,
also returning the ``rstd`` rows the CUDA kernels emit.
"""

from __future__ import annotations

import torch


def rms_norm_ref(x, w, eps: float = 1e-6):
    """Returns ``(y in x.dtype, rstd [x.shape[:-1]] f32)``."""
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    y = xf * rstd * w.float()
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
    sum_rows dy * x_hat`` [dh] f32 (``repro.kernels.fused_rmsnorm.rmsnorm``
    ``_bwd_dx_kernel`` and ``_bwd_dw_kernel``)."""
    r = rstd[..., None]
    x_hat = x.float() * r
    dyf = dy.float()
    dxhat = dyf * w.float()
    m = (dxhat * x_hat).mean(dim=-1, keepdim=True)
    dx = (r * (dxhat - x_hat * m)).to(x.dtype)
    return dx, (dyf * x_hat).reshape(-1, x.shape[-1]).sum(dim=0)


def qk_rms_bwd_ref(dyq, dyk, q, k, wq, wk, rq, rk):
    """Plain K5 and K6 for q and k: ``(dq, dk, dwq, dwk)``."""
    dq, dwq = rms_bwd_ref(dyq, q, wq, rq)
    dk, dwk = rms_bwd_ref(dyk, k, wk, rk)
    return dq, dk, dwq, dwk
