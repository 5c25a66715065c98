"""Wrappers and ctypes bindings of the segment-aware flash-attention
kernels: the forward K7 (``csrc/flash_fwd.cu``) and the backward K8 (dq,
``csrc/flash_bwd_dq.cu``) and K9 (dk, dv, ``csrc/flash_bwd_dkv.cu``), both
kernels in ``csrc/flash_bwd.cuh``.

Each wrapper takes CUDA tensors only, in the model's ``[B, S, H, dh]``
layout (strided views are fine as long as the last axis is contiguous), and
counts each launch in its ``launches`` attribute.  The plain versions are
``ref.attention_ref`` and ``ref.attention_bwd_ref``.
:func:`live_tile_pairs` counts the (q tile, kv tile) pairs the kernels'
skip rule keeps, 64 x 64 for the work bound (``BOUND_TILE``) or at a
kernel's own tile.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 7 + [_I] * 6 + [_L] * 9 + [ctypes.c_float, _I, _I, _I, _P]
_STRIDES = ctypes.POINTER(_L)
_DQ_ARGTYPES = [_P] * 10 + [_I] * 6 + [_STRIDES, ctypes.c_float, _I, _I, _P]
_DKV_ARGTYPES = [_P] * 10 + [_I] * 6 + [_STRIDES, ctypes.c_float, _I, _I, _P]
HEAD_DIMS = (32, 64, 128)
# The work bounds count 64 x 64 (q, kv) tile pairs, what the inputs need,
# whatever tile a kernel runs (K8, K9 and K7 on f32 run 64 x 64 tiles,
# flash_common.cuh; K7 on bf16 128 x 128, FWD_TILE).
BOUND_TILE = 64
FWD_TILE = 128  # BQ = BK of K7 on bf16 inputs (flash_fwd.cu, namespace wg)


def _check(name, q, k, v, segs):
    """Shapes, dtypes and alignment the kernels take; returns (B, Sq, Hq,
    dh, Skv, Hkv)."""
    _build.require_cuda(name, q, k, v, *segs)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name} needs q [B, Sq, Hq, dh] and k, v [B, Skv, Hkv, dh]")
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or dh not in HEAD_DIMS:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}; "
                         f"head_dim must be one of {HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got Hq={hq}, Hkv={hkv}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} needs q, k, v all bf16 or all f32")
    vec = 16 // q.element_size()
    if not all(_build.aligned(t, vec) for t in (q, k, v)):
        raise ValueError(f"{name} needs 16-byte aligned rows of q, k and v")
    if segs:
        for ids, n in zip(segs, (sq, skv)):
            if ids.shape != (b, n) or ids.dtype != torch.int32 or not ids.is_contiguous():
                raise ValueError(f"{name} needs contiguous int32 segment ids [B, S]")
    return b, sq, hq, dh, skv, hkv


def _segs(q_segment_ids, kv_segment_ids):
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids, or neither")
    return () if q_segment_ids is None else (q_segment_ids, kv_segment_ids)


def flash_fwd(q, k, v, q_segment_ids=None, kv_segment_ids=None, *,
              causal: bool = False, scale: float | None = None, out_dtype=None):
    """Segment-aware attention on the card.

    q: [B, Sq, Hq, dh]; k, v: [B, Skv, Hkv, dh] (Hq % Hkv == 0); dh in
    {32, 64, 128}; bf16 or f32.  Segment ids: int32 [B, Sq] / [B, Skv],
    both or neither.  ``out_dtype`` is q's dtype (default) or f32, the
    unrounded output the training forward keeps for the backward.  Returns
    ``(out [B, Sq, Hq, dh], lse [B, Hq, Sq] f32)``.
    """
    segs = _segs(q_segment_ids, kv_segment_ids)
    b, sq, hq, dh, skv, hkv = _check("flash_fwd", q, k, v, segs)
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"flash_fwd writes out in q's dtype or f32, not {out_dtype}")
    scale = float(scale) if scale is not None else dh**-0.5
    out = torch.empty((b, sq, hq, dh), dtype=out_dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if b * sq == 0:
        return out, lse
    fn = _build.bind("flash_fwd", "flash_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            segs[0].data_ptr() if segs else None,
            segs[1].data_ptr() if segs else None,
            out.data_ptr(), lse.data_ptr(),
            b, hq, hkv, sq, skv, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            scale, int(causal), int(q.dtype == torch.bfloat16),
            int(out_dtype != q.dtype), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _check_bwd(name, q, do, lse, rows):
    b, sq, hq, dh = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or not _build.aligned(do, 16 // q.element_size()):
        raise ValueError(f"{name} needs do shaped and typed as q, with 16-byte aligned rows")
    for nm, t in (("lse", lse), *rows):
        if t.shape != (b, hq, sq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} needs {nm} contiguous [B, Hq, Sq] f32")


def _strides(q, k, v, do):
    return (_L * 12)(*(st for t in (q, k, v, do) for st in t.stride()[:3]))


def flash_bwd_dq(q, k, v, out, do, lse, q_segment_ids=None, kv_segment_ids=None, *,
                 causal: bool = False, scale: float | None = None):
    """K8: dq of segment-aware attention on the card, by a kv sweep.

    q, k, v, segment ids and ``causal`` as the forward (K7); out: the
    forward's output, contiguous [B, Sq, Hq, dh] f32; do: the output's
    gradient, shaped and typed as q; lse: [B, Hq, Sq] f32 (K7's).  Returns
    ``(dq, delta)``: dq contiguous in q's dtype, and ``delta = sum(do *
    out)`` [B, Hq, Sq] f32, which K9 reads.
    """
    segs = _segs(q_segment_ids, kv_segment_ids)
    b, sq, hq, dh, skv, hkv = _check("flash_bwd_dq", q, k, v, segs)
    _check_bwd("flash_bwd_dq", q, do, lse, ())
    if out.shape != q.shape or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError("flash_bwd_dq needs out contiguous [B, Sq, Hq, dh] f32")
    scale = float(scale) if scale is not None else dh**-0.5
    dq = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if b * sq == 0:
        return dq, delta
    fn = _build.bind("flash_bwd_dq", "flash_bwd_dq", _DQ_ARGTYPES)
    strides = _strides(q, k, v, do)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), out.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            segs[0].data_ptr() if segs else None, segs[1].data_ptr() if segs else None,
            dq.data_ptr(), b, hq, hkv, sq, skv, dh, strides,
            scale, int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq, delta


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, q_segment_ids=None, kv_segment_ids=None, *,
                  causal: bool = False, scale: float | None = None):
    """K9: (dk, dv) of segment-aware attention on the card, by a q sweep
    that sums the GQA group on chip.  Arguments as :func:`flash_bwd_dq`,
    with K8's ``delta`` in place of ``out``.  Returns contiguous (dk, dv)
    [B, Skv, Hkv, dh] in k's dtype."""
    segs = _segs(q_segment_ids, kv_segment_ids)
    b, sq, hq, dh, skv, hkv = _check("flash_bwd_dkv", q, k, v, segs)
    _check_bwd("flash_bwd_dkv", q, do, lse, (("delta", delta),))
    scale = float(scale) if scale is not None else dh**-0.5
    dk = torch.empty((b, skv, hkv, dh), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, skv, hkv, dh), dtype=v.dtype, device=v.device)
    if b * skv == 0:
        return dk, dv
    if sq == 0:
        return dk.zero_(), dv.zero_()
    fn = _build.bind("flash_bwd_dkv", "flash_bwd_dkv", _DKV_ARGTYPES)
    strides = _strides(q, k, v, do)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(),
            segs[0].data_ptr() if segs else None, segs[1].data_ptr() if segs else None,
            dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, skv, dh, strides,
            scale, int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def _tile_ranges(ids, tile: int):
    """Per-tile (min, max) of ids [B, S]; a ragged last tile covers its real
    entries only, as in the kernel."""
    b, s = ids.shape
    pad = -s % tile
    if pad:
        ids = torch.cat([ids, ids[:, -1:].expand(b, pad)], dim=1)
    t = ids.reshape(b, -1, tile)
    return t.amin(dim=-1), t.amax(dim=-1)


def live_tile_pairs(sq: int, skv: int, q_segment_ids=None, kv_segment_ids=None,
                    *, causal: bool = False, batch: int = 1, tile: int = BOUND_TILE) -> int:
    """Number of (q tile, kv tile) pairs of ``tile`` rows each that the skip
    rule keeps, summed over the batch (multiply by the head count for a
    whole launch).  A pair runs unless the causal triangle excludes it or
    its segment-id ranges are disjoint."""
    nq, nk = -(-sq // tile), -(-skv // tile)
    live = torch.ones((1, nq, nk), dtype=torch.bool)
    if causal:
        qi = torch.arange(nq)[:, None]
        kj = torch.arange(nk)[None, :]
        live = live & ((qi + 1) * tile - 1 >= kj * tile)[None]
    if q_segment_ids is not None:
        q_lo, q_hi = _tile_ranges(q_segment_ids.cpu(), tile)
        k_lo, k_hi = _tile_ranges(kv_segment_ids.cpu(), tile)
        live = live & (q_lo[:, :, None] <= k_hi[:, None, :]) & (k_lo[:, None, :] <= q_hi[:, :, None])
        return int(live.sum())
    return int(live.sum()) * batch
