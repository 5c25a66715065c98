"""Wrapper and ctypes binding of the joint q/k RMSNorm forward
(``csrc/rmsnorm_fwd.cu``).

``qk_rms_fwd`` takes CUDA tensors only and normalises q and k in ONE
launch, counted once in ``qk_rms_fwd.launches``.  The plain version is
``ref.qk_norm_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 8 + [_I] * 5 + [_L] * 6 + [ctypes.c_float, _I, _P]
HEAD_DIMS = (32, 64, 128)


def qk_rms_fwd(q, k, wq, wk, eps: float = 1e-6):
    """Per-head RMSNorm of q [B, S, Hq, dh] and k [B, S, Hk, dh] on the card.

    q and k may be strided views (last axis contiguous); dh in {32, 64,
    128}.  Returns ``(q_norm, k_norm, rstd_q, rstd_k)``: contiguous outputs
    in the input dtype and rstd [B, S, H] f32.
    """
    _build.require_cuda("qk_rms_fwd", q, k, wq, wk)
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2]:
        raise ValueError("qk_rms_fwd needs q, k as [B, S, H, dh] with equal B, S")
    b, s, hq, d = q.shape
    hk = k.shape[2]
    if d not in HEAD_DIMS or k.shape[3] != d:
        raise ValueError(f"qk_rms_fwd supports head_dim in {HEAD_DIMS}, got {d}")
    if q.dtype != k.dtype or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("qk_rms_fwd needs q and k both bf16 or both f32")
    for w in (wq, wk):
        if w.shape != (d,) or w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError("qk_rms_fwd needs wq, wk as contiguous [dh] f32")
    if b * s * max(hq, hk) >= 2**31:
        raise ValueError("qk_rms_fwd indexes rows with 32-bit integers")
    per_lane = d // 32
    if not (_build.aligned(q, per_lane) and _build.aligned(k, per_lane)):
        raise ValueError("qk_rms_fwd needs each head row aligned to its lane vector")
    yq = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    yk = torch.empty((b, s, hk, d), dtype=k.dtype, device=k.device)
    rq = torch.empty((b, s, hq), dtype=torch.float32, device=q.device)
    rk = torch.empty((b, s, hk), dtype=torch.float32, device=k.device)
    if b * s == 0:
        return yq, yk, rq, rk
    fn = _build.bind("rmsnorm_fwd", "qk_rms_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), wq.data_ptr(), wk.data_ptr(),
            yq.data_ptr(), yk.data_ptr(), rq.data_ptr(), rk.data_ptr(),
            b, s, hq, hk, d, *q.stride()[:3], *k.stride()[:3], eps,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "qk_rms_fwd")
    qk_rms_fwd.launches += 1
    return yq, yk, rq, rk


qk_rms_fwd.launches = 0
