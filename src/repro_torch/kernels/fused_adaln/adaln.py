"""Wrappers and ctypes bindings of the fused AdaLN kernels: the forward K1
(``csrc/adaln_fwd.cu``) and the backward K2 (dx), K3 (d scale, d shift)
and K10 (the same sums as K3 with the paper's naive access, which no model
calls: the Fig. 1 yardstick of K3) (``csrc/adaln_bwd.cu``).

Each wrapper takes CUDA tensors only: it checks them, allocates the
outputs and scratch, launches on the current stream and counts the launch
in its ``launches`` attribute.  The plain versions are in ``ref.py``
(``adaln_modulate_ref``, ``adaln_bwd_dx_ref``, ``adaln_bwd_dmod_ref``,
which is K10's too).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 6 + [_I] * 5 + [_L] * 2 + [ctypes.c_float, _I, _P]
_DX_ARGTYPES = [_P] * 6 + [_I] * 3 + [_L, _I, _P]
_DMOD_ARGTYPES = [_P] * 8 + [_I] * 4 + [_P]
_NAIVE_ARGTYPES = [_P] * 6 + [_I] * 7 + [_P]
MAX_ROW_CHUNKS = 1024  # 16-byte chunks of a row: K1's 4 warps or K2's 128 threads, 8 a lane
FWD_WARPS = 8  # K1: warps a block (kThreads / 32 in adaln_fwd.cu)
FWD_BLOCKS = 3 * 132  # K1's grid: three resident blocks on each of the H100's 132 SMs
FWD_MIN_ROWS = 2 * FWD_WARPS  # K1: rows a block takes at least
DMOD_ROW_CHUNK = 32  # rows per partial sum of K3 (kRowChunk in the source)
NAIVE_THREADS = 1024  # K10: most threads a block (kNaiveMaxThreads), a producer warp among them
NAIVE_STAGE_BYTES = 100 * 1024  # K10: dy and x bytes a stage, at most (two stages)


def _check_row(name, x):
    if x.dim() != 3 or not x.is_contiguous() or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} needs x contiguous [B, S, D] in bf16 or f32")
    d = x.shape[2]
    vec = 16 // x.element_size()
    if d % vec or d // vec > MAX_ROW_CHUNKS or x.data_ptr() % 16:
        raise ValueError(f"{name}: D={d} must be a multiple of {vec} and at most "
                         f"{MAX_ROW_CHUNKS * vec}, with x 16-byte aligned")


def fwd_row_blocks(b: int, s: int) -> tuple[int, int]:
    """K1's split of the rows: each block takes a run of ``rows`` rows of
    one sample, ``per_sample`` runs a sample (the grid is ``(per_sample,
    b)``), so that about ``FWD_BLOCKS`` blocks fill the card and no run
    crosses into the next sample.  Returns ``(rows, per_sample)``."""
    per_sample = max(1, min(-(-s // FWD_MIN_ROWS), FWD_BLOCKS // b))
    rows = -(-s // per_sample)
    return rows, -(-s // rows)


def naive_plan(d: int, itemsize: int) -> tuple[int, int, int]:
    """K10's walk of one sample's [S, D] slab: ``(threads, groups,
    rows)``.  The block's consumer threads own the ``cols = D * itemsize
    / 16`` 16-byte columns of a row (two a thread past 992 columns) in
    ``groups`` row groups, as many as fit beside the producer warp; a stage
    holds ``rows`` consecutive rows of dy and of x (a multiple of
    ``groups``: group g takes the rows ``s % groups == g``, in order), and
    the ring two stages (kNaiveStages)."""
    cols = d * itemsize // 16
    consumers = NAIVE_THREADS - 32
    per_group = -(-cols // (1 if cols <= consumers else 2))
    groups = max(1, consumers // per_group)
    pair = 2 * d * itemsize  # a row of dy and of x
    rows = groups * max(1, NAIVE_STAGE_BYTES // (groups * pair))
    return -(-groups * per_group // 32) * 32 + 32, groups, rows


def _check_bwd(name, dy, x, mu, rstd):
    _check_row(name, x)
    b, s, _ = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError(f"{name} needs dy contiguous, 16-byte aligned, shaped and typed as x")
    for nm, t in (("mu", mu), ("rstd", rstd)):
        if t.shape != (b, s) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} needs {nm} contiguous [B, S] f32")


def adaln_fwd(x, scale, shift, eps: float = 1e-6):
    """y = LayerNorm(x) * (1 + scale) + shift on the card.

    x: [B, S, D] bf16/f32 contiguous; scale, shift: [B, D] f32 (rows may be
    strided, e.g. slices of a [B, 6, D] modulation).  Returns ``(y, mu,
    rstd)`` with ``mu``, ``rstd`` [B, S] f32.
    """
    _build.require_cuda("adaln_fwd", x, scale, shift)
    _check_row("adaln_fwd", x)
    b, s, d = x.shape
    for name, m in (("scale", scale), ("shift", shift)):
        if m.shape != (b, d) or m.dtype != torch.float32 or not _build.aligned(m, 4):
            raise ValueError(f"adaln_fwd needs {name} [B, D] f32 with 16-byte aligned rows")
    y = torch.empty_like(x)
    mu = torch.empty((b, s), dtype=torch.float32, device=x.device)
    rstd = torch.empty((b, s), dtype=torch.float32, device=x.device)
    if b * s == 0:
        return y, mu, rstd
    rows, per_sample = fwd_row_blocks(b, s)
    fn = _build.bind("adaln_fwd", "adaln_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            y.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            b, s, d, rows, per_sample, scale.stride(0), shift.stride(0), eps,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "adaln_fwd")
    adaln_fwd.launches += 1
    return y, mu, rstd


adaln_fwd.launches = 0


def adaln_bwd_dx(dy, x, mu, rstd, scale):
    """K2: dx of the fused AdaLN on the card, from K1's residuals.

    dy, x: [B, S, D] contiguous, one dtype; mu, rstd: [B, S] f32; scale:
    [B, D] f32 with 16-byte aligned rows.  Returns dx in x's dtype.
    """
    _build.require_cuda("adaln_bwd_dx", dy, x, mu, rstd, scale)
    _check_bwd("adaln_bwd_dx", dy, x, mu, rstd)
    b, s, d = x.shape
    if scale.shape != (b, d) or scale.dtype != torch.float32 or not _build.aligned(scale, 4):
        raise ValueError("adaln_bwd_dx needs scale [B, D] f32 with 16-byte aligned rows")
    dx = torch.empty_like(x)
    if b * s == 0:
        return dx
    fn = _build.bind("adaln_bwd", "adaln_bwd_dx", _DX_ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(
            dy.data_ptr(), x.data_ptr(), mu.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
            dx.data_ptr(), b * s, s, d, scale.stride(0), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "adaln_bwd_dx")
    adaln_bwd_dx.launches += 1
    return dx


adaln_bwd_dx.launches = 0


def adaln_bwd_dmod(dy, x, mu, rstd):
    """K3: (dscale, dshift) [B, D] f32 of the fused AdaLN on the card:
    ``sum_s dy * x_hat`` and ``sum_s dy``, deterministic (partials per
    chunk of rows, then a fixed-order sum; no atomics)."""
    _build.require_cuda("adaln_bwd_dmod", dy, x, mu, rstd)
    _check_bwd("adaln_bwd_dmod", dy, x, mu, rstd)
    b, s, d = x.shape
    dscale = torch.empty((b, d), dtype=torch.float32, device=x.device)
    dshift = torch.empty((b, d), dtype=torch.float32, device=x.device)
    if b * s == 0:
        return dscale.zero_(), dshift.zero_()
    n_chunks = -(-s // DMOD_ROW_CHUNK)
    part = torch.empty((2, b, n_chunks, d), dtype=torch.float32, device=x.device)
    fn = _build.bind("adaln_bwd", "adaln_bwd_dmod", _DMOD_ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(
            dy.data_ptr(), x.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), dscale.data_ptr(), dshift.data_ptr(),
            b, s, d, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "adaln_bwd_dmod")
    adaln_bwd_dmod.launches += 1
    return dscale, dshift


adaln_bwd_dmod.launches = 0


def adaln_bwd_dmod_naive(dy, x, mu, rstd):
    """K10: (dscale, dshift) [B, D] f32, K3's sums with the paper's naive
    access (Fig. 1): one block per sample sweeps its whole [S, D] slab, no
    D-tiling across blocks and no split over S.  Arguments as
    :func:`adaln_bwd_dmod`; deterministic (row groups summed in order, then
    added in group order: :func:`naive_plan`)."""
    _build.require_cuda("adaln_bwd_dmod_naive", dy, x, mu, rstd)
    _check_bwd("adaln_bwd_dmod_naive", dy, x, mu, rstd)
    b, s, d = x.shape
    dscale = torch.empty((b, d), dtype=torch.float32, device=x.device)
    dshift = torch.empty((b, d), dtype=torch.float32, device=x.device)
    if b * s == 0:
        return dscale.zero_(), dshift.zero_()
    fn = _build.bind("adaln_bwd", "adaln_bwd_dmod_naive", _NAIVE_ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(
            dy.data_ptr(), x.data_ptr(), mu.data_ptr(), rstd.data_ptr(), dscale.data_ptr(),
            dshift.data_ptr(), b, s, d, *naive_plan(d, x.element_size()),
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "adaln_bwd_dmod_naive")
    adaln_bwd_dmod_naive.launches += 1
    return dscale, dshift


adaln_bwd_dmod_naive.launches = 0
