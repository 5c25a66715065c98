"""Wrappers and ctypes bindings of the RMSNorm kernels (``csrc/``): the
forward K4 on model rows (:func:`rms_fwd`) and on per-head q and k rows
(:func:`qk_rms_fwd`), the gated forward K13 (:func:`gated_rms_fwd`), and
the backward K5 (dx) and K6 (dw) on model rows (:func:`rms_bwd_dx`,
:func:`rms_bwd_dw`) and jointly on q and k (:func:`qk_rms_bwd_dx`,
:func:`qk_rms_bwd_dw`).

Each wrapper takes CUDA tensors only and counts each launch in its
``launches`` attribute; the q/k wrappers handle q and k in ONE launch.  The
plain versions are in ``ref.py`` (``rms_norm_ref``, ``gated_rms_norm_ref``,
``qk_norm_ref``, ``rms_bwd_ref``, ``qk_rms_bwd_ref``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 8 + [_I] * 5 + [_L] * 6 + [ctypes.c_float, _I, _P]
_DX_ARGTYPES = [_P] * 10 + [_I] * 5 + [_L] * 6 + [_I, _P]
_DW_ARGTYPES = [_P] * 9 + [_I] * 7 + [_L] * 6 + [_I, _P]
_ROW_ARGTYPES = [_P] * 4 + [_I] * 2 + [ctypes.c_float, _I, _P]
_GATED_ARGTYPES = [_P] * 5 + [_I] * 2 + [_L] * 2 + [ctypes.c_float, _I, _P]
_ROW_BWD_ARGTYPES = [_P] * 5 + [_I] * 3 + [_P]
HEAD_DIMS = (32, 64, 128)
MAX_ROW = 8192  # kMaxD of the source
DW_THREADS = 256  # q/k K6 pass 1: threads a block (kDwThreads in the source)
DW_UNROLL = 4  # q/k K6 pass 1: rows a lane group loads at a time (kDwUnroll)
DW_CHUNKS = 2 * 132  # q/k K6: target chunks a tensor, 4 blocks on each of the H100's 132 SMs
ROW_DW_CHUNK = 32  # rows per partial sum of K6 on rows (kDwRows in the source)


def qk_dw_chunks(b: int, s: int, h: int, dh: int, itemsize: int) -> tuple[int, int, int]:
    """The q/k K6's split of the B*S*H rows of a tensor: ``(groups, chunk,
    n_chunks)``.  A block of pass 1 sums one chunk of ``chunk`` rows, its
    ``groups`` lane groups (one 16-byte vector a lane, dh / vector lanes a
    row) each a contiguous run of ``chunk / groups`` rows in row order; the
    chunk is a multiple of ``groups * DW_UNROLL`` and sized so that about
    ``DW_CHUNKS`` chunks a tensor fill the card.  Both tensors take
    ``n_chunks`` blocks, sized by the larger H."""
    groups = DW_THREADS // (dh * itemsize // 16)
    step = groups * DW_UNROLL
    rows = b * s * h
    chunk = max(1, -(-(-(-rows // DW_CHUNKS)) // step)) * step
    return groups, chunk, -(-rows // chunk)


def _check_inputs(name, q, k):
    """q [B, S, Hq, dh], k [B, S, Hk, dh]: one dtype, dh in HEAD_DIMS, rows
    aligned to the lane vector.  Returns (B, S, Hq, Hk, dh)."""
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2]:
        raise ValueError(f"{name} needs q, k as [B, S, H, dh] with equal B, S")
    b, s, hq, d = q.shape
    hk = k.shape[2]
    if d not in HEAD_DIMS or k.shape[3] != d:
        raise ValueError(f"{name} supports head_dim in {HEAD_DIMS}, got {d}")
    if q.dtype != k.dtype or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} needs q and k both bf16 or both f32")
    if b * s * max(hq, hk) >= 2**31:
        raise ValueError(f"{name} indexes rows with 32-bit integers")
    per_lane = d // 32
    if not (_build.aligned(q, per_lane) and _build.aligned(k, per_lane)):
        raise ValueError(f"{name} needs each head row aligned to its lane vector")
    return b, s, hq, hk, d


def _check_bwd(name, dyq, dyk, q, k, rq, rk):
    dims = _check_inputs(name, q, k)
    for dy, x, r in ((dyq, q, rq), (dyk, k, rk)):
        if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
            raise ValueError(f"{name} needs each dy contiguous, shaped and typed as its input")
        if dy.data_ptr() % 16:
            raise ValueError(f"{name} needs each dy 16-byte aligned")
        if r.shape != x.shape[:3] or r.dtype != torch.float32 or not r.is_contiguous():
            raise ValueError(f"{name} needs each rstd contiguous [B, S, H] f32")
    return dims


def _check_rows(name, x, *, contiguous=True):
    """x [..., D]: bf16 or f32, D a multiple of 8 up to MAX_ROW, fewer than
    2^31 rows.  Returns (rows, D)."""
    d = x.shape[-1]
    if d % 8 or not 8 <= d <= MAX_ROW:
        raise ValueError(f"{name} takes rows of a multiple of 8 up to {MAX_ROW}, got {d}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} needs bf16 or f32 rows, got {x.dtype}")
    if contiguous and (not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"{name} needs its rows contiguous and 16-byte aligned")
    n = x.numel() // d
    if n >= 2**31:
        raise ValueError(f"{name} indexes rows with 32-bit integers")
    return n, d


def _check_w(name, w, d):
    if w.shape != (d,) or w.dtype != torch.float32 or not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"{name} needs w as contiguous, 16-byte aligned [D] f32")


def _row_view(name, t, d):
    """t [..., D] as [N, D] rows with one row stride, each row 16-byte
    aligned and contiguous (a view where torch can give one)."""
    rows = t.reshape(-1, d)
    if not _build.aligned(rows, 16 // t.element_size()):
        raise ValueError(f"{name} needs each row contiguous and 16-byte aligned")
    return rows


def rms_fwd(x, w, eps: float = 1e-6):
    """RMSNorm of the rows of x [..., D] on the card: ``y = x * rsqrt(mean(x²)
    + eps) * w`` with f32 statistics.

    x: contiguous, bf16 or f32, D a multiple of 8 up to 8192; w: contiguous
    [D] f32.  Returns ``(y, rstd)``: y shaped and typed as x, rstd
    [x.shape[:-1]] f32.
    """
    _build.require_cuda("rms_fwd", x, w)
    n, d = _check_rows("rms_fwd", x)
    _check_w("rms_fwd", w, d)
    y = torch.empty_like(x)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if n == 0:
        return y, rstd
    fn = _build.bind("rmsnorm_fwd", "rms_fwd", _ROW_ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), rstd.data_ptr(), n, d, eps,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "rms_fwd")
    rms_fwd.launches += 1
    return y, rstd


rms_fwd.launches = 0


def gated_rms_fwd(x, w, g, eps: float = 1e-6):
    """K13: ``y = x * rsqrt(mean(x²) + eps) * w * silu(g)`` over the rows of
    x [..., D] on the card, f32 statistics (the Mamba-2 mixer's gate + norm).

    x, g: one shape and dtype (bf16 or f32), D a multiple of 8 up to 8192;
    each may be a strided view (the gate is the z slice of the mixer's
    in_proj output) whose rows are contiguous and 16-byte aligned.  w:
    contiguous [D] f32.  Returns ``(y, rstd)``: y contiguous, shaped and
    typed as x; rstd [x.shape[:-1]] f32.
    """
    _build.require_cuda("gated_rms_fwd", x, w, g)
    n, d = _check_rows("gated_rms_fwd", x, contiguous=False)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("gated_rms_fwd needs g shaped and typed as x")
    _check_w("gated_rms_fwd", w, d)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if n == 0:
        return y, rstd
    xr, gr = _row_view("gated_rms_fwd", x, d), _row_view("gated_rms_fwd", g, d)
    fn = _build.bind("rmsnorm_fwd", "gated_rms_fwd", _GATED_ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(
            xr.data_ptr(), gr.data_ptr(), w.data_ptr(), y.data_ptr(), rstd.data_ptr(), n, d,
            xr.stride(0), gr.stride(0), eps, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "gated_rms_fwd")
    gated_rms_fwd.launches += 1
    return y, rstd


gated_rms_fwd.launches = 0


def _check_row_bwd(name, dy, x, rstd):
    n, d = _check_rows(name, x)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError(f"{name} needs dy contiguous, 16-byte aligned, shaped and typed as x")
    if rstd.shape != x.shape[:-1] or rstd.dtype != torch.float32 or not rstd.is_contiguous():
        raise ValueError(f"{name} needs rstd contiguous [x.shape[:-1]] f32")
    return n, d


def rms_bwd_dx(dy, x, w, rstd):
    """K5 on model rows: dx of ``rms_norm(x, w)`` on the card, from the
    forward's residuals (x, w, rstd).

    dy, x: contiguous [..., D], one dtype (bf16 or f32), D a multiple of 8
    up to 8192; w: [D] f32; rstd: [x.shape[:-1]] f32.  Returns dx shaped
    and typed as x.
    """
    _build.require_cuda("rms_bwd_dx", dy, x, w, rstd)
    n, d = _check_row_bwd("rms_bwd_dx", dy, x, rstd)
    _check_w("rms_bwd_dx", w, d)
    dx = torch.empty_like(x)
    if n == 0:
        return dx
    fn = _build.bind("rmsnorm_bwd", "rms_bwd_dx", _ROW_BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(
            dy.data_ptr(), x.data_ptr(), w.data_ptr(), rstd.data_ptr(), dx.data_ptr(), n, d,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "rms_bwd_dx")
    rms_bwd_dx.launches += 1
    return dx


rms_bwd_dx.launches = 0


def rms_bwd_dw(dy, x, rstd):
    """K6 on model rows: dw [D] f32 of ``rms_norm(x, w)`` on the card,
    ``sum_rows dy * x_hat``, deterministic (partials per chunk of 32 rows,
    then a fixed-order sum; no atomics).  Arguments as :func:`rms_bwd_dx`."""
    _build.require_cuda("rms_bwd_dw", dy, x, rstd)
    n, d = _check_row_bwd("rms_bwd_dw", dy, x, rstd)
    dw = torch.empty(d, dtype=torch.float32, device=x.device)
    if n == 0:
        return dw.zero_()
    part = torch.empty((-(-n // ROW_DW_CHUNK), d), dtype=torch.float32, device=x.device)
    fn = _build.bind("rmsnorm_bwd", "rms_bwd_dw", _ROW_BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(
            dy.data_ptr(), x.data_ptr(), rstd.data_ptr(), part.data_ptr(), dw.data_ptr(), n, d,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "rms_bwd_dw")
    rms_bwd_dw.launches += 1
    return dw


rms_bwd_dw.launches = 0


def qk_rms_fwd(q, k, wq, wk, eps: float = 1e-6):
    """Per-head RMSNorm of q [B, S, Hq, dh] and k [B, S, Hk, dh] on the card.

    q and k may be strided views (last axis contiguous); dh in {32, 64,
    128}.  Returns ``(q_norm, k_norm, rstd_q, rstd_k)``: contiguous outputs
    in the input dtype and rstd [B, S, H] f32.
    """
    _build.require_cuda("qk_rms_fwd", q, k, wq, wk)
    b, s, hq, hk, d = _check_inputs("qk_rms_fwd", q, k)
    for w in (wq, wk):
        if w.shape != (d,) or w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError("qk_rms_fwd needs wq, wk as contiguous [dh] f32")
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


def qk_rms_bwd_dx(dyq, dyk, q, k, wq, wk, rq, rk):
    """K5: dq and dk of the joint q/k RMSNorm on the card, in ONE launch.

    dyq, dyk: contiguous, shaped and typed as q [B, S, Hq, dh] and k
    [B, S, Hk, dh] (which may be strided views); wq, wk: [dh] f32; rq, rk:
    [B, S, H] f32 (K4's).  Returns contiguous (dq, dk) in the input dtype.
    """
    _build.require_cuda("qk_rms_bwd_dx", dyq, dyk, q, k, wq, wk, rq, rk)
    b, s, hq, hk, d = _check_bwd("qk_rms_bwd_dx", dyq, dyk, q, k, rq, rk)
    for w in (wq, wk):
        if w.shape != (d,) or w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError("qk_rms_bwd_dx needs wq, wk as contiguous [dh] f32")
    dq = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hk, d), dtype=k.dtype, device=k.device)
    if b * s == 0:
        return dq, dk
    fn = _build.bind("rmsnorm_bwd", "qk_rms_bwd_dx", _DX_ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(
            dyq.data_ptr(), dyk.data_ptr(), q.data_ptr(), k.data_ptr(),
            wq.data_ptr(), wk.data_ptr(), rq.data_ptr(), rk.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), b, s, hq, hk, d,
            *q.stride()[:3], *k.stride()[:3], int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "qk_rms_bwd_dx")
    qk_rms_bwd_dx.launches += 1
    return dq, dk


qk_rms_bwd_dx.launches = 0


def qk_rms_bwd_dw(dyq, dyk, q, k, rq, rk):
    """K6: (dwq, dwk) [dh] f32 of the joint q/k RMSNorm on the card, in ONE
    launch: ``sum_rows dy * x_hat``, deterministic (partials per chunk of
    rows as :func:`qk_dw_chunks` splits them, then a fixed-order sum; no
    atomics)."""
    _build.require_cuda("qk_rms_bwd_dw", dyq, dyk, q, k, rq, rk)
    b, s, hq, hk, d = _check_bwd("qk_rms_bwd_dw", dyq, dyk, q, k, rq, rk)
    vec = 16 // q.element_size()
    if not (_build.aligned(q, vec) and _build.aligned(k, vec)):
        raise ValueError("qk_rms_bwd_dw needs each head row 16-byte aligned")
    if rq.data_ptr() % 16 or rk.data_ptr() % 16:
        raise ValueError("qk_rms_bwd_dw needs each rstd 16-byte aligned")
    dw = torch.empty((2, d), dtype=torch.float32, device=q.device)
    if b * s == 0:
        return dw[0].zero_(), dw[1].zero_()
    _, chunk, n_chunks = qk_dw_chunks(b, s, max(hq, hk), d, q.element_size())
    part = torch.empty((2, n_chunks, d), dtype=torch.float32, device=q.device)
    fn = _build.bind("rmsnorm_bwd", "qk_rms_bwd_dw", _DW_ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(
            dyq.data_ptr(), dyk.data_ptr(), q.data_ptr(), k.data_ptr(),
            rq.data_ptr(), rk.data_ptr(), part.data_ptr(), dw[0].data_ptr(), dw[1].data_ptr(),
            chunk, n_chunks, b, s, hq, hk, d, *q.stride()[:3], *k.stride()[:3],
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "qk_rms_bwd_dw")
    qk_rms_bwd_dw.launches += 1
    return dw[0], dw[1]


qk_rms_bwd_dw.launches = 0
