"""Wrapper and ctypes binding of the fused AdaLN forward (``csrc/adaln_fwd.cu``).

``adaln_fwd`` takes CUDA tensors only: it checks them, allocates the
outputs, launches the kernel on the current stream and counts the launch
in ``adaln_fwd.launches``.  The plain version is ``ref.adaln_modulate_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 6 + [_I] * 3 + [_L] * 2 + [ctypes.c_float, _I, _P]
THREADS = 128  # one block per row, as in the source
MAX_CHUNKS = 8  # 16-byte chunks a thread holds


def adaln_fwd(x, scale, shift, eps: float = 1e-6):
    """y = LayerNorm(x) * (1 + scale) + shift on the card.

    x: [B, S, D] bf16/f32 contiguous; scale, shift: [B, D] f32 (rows may be
    strided, e.g. slices of a [B, 6, D] modulation).  Returns ``(y, mu,
    rstd)`` with ``mu``, ``rstd`` [B, S] f32.
    """
    _build.require_cuda("adaln_fwd", x, scale, shift)
    if x.dim() != 3 or not x.is_contiguous() or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("adaln_fwd needs x contiguous [B, S, D] in bf16 or f32")
    b, s, d = x.shape
    for name, m in (("scale", scale), ("shift", shift)):
        if m.shape != (b, d) or m.dtype != torch.float32 or not _build.aligned(m, 4):
            raise ValueError(f"adaln_fwd needs {name} [B, D] f32 with 16-byte aligned rows")
    vec = 16 // x.element_size()
    if d % vec or d // vec > THREADS * MAX_CHUNKS or x.data_ptr() % 16:
        raise ValueError(f"adaln_fwd: D={d} must be a multiple of {vec} and at most "
                         f"{THREADS * MAX_CHUNKS * vec}, with x 16-byte aligned")
    y = torch.empty_like(x)
    mu = torch.empty((b, s), dtype=torch.float32, device=x.device)
    rstd = torch.empty((b, s), dtype=torch.float32, device=x.device)
    if b * s == 0:
        return y, mu, rstd
    fn = _build.bind("adaln_fwd", "adaln_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            y.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            b * s, s, d, scale.stride(0), shift.stride(0), eps,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "adaln_fwd")
    adaln_fwd.launches += 1
    return y, mu, rstd


adaln_fwd.launches = 0
