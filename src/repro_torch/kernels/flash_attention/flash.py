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
kernel's own tiles; :func:`bwd_tile_walk` lists the pairs K8 and K9 visit
on bf16 inputs, in their order.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 7 + [_I] * 6 + [_L] * 9 + [ctypes.c_float, _I, _I, _I, _P]
_STRIDES = ctypes.POINTER(_L)
_DQ_ARGTYPES = [_P] * 11 + [_I] * 6 + [_STRIDES, ctypes.c_float, _I, _I, _P]
_DKV_ARGTYPES = [_P] * 12 + [_I] * 7 + [_STRIDES, ctypes.c_float, _I, _I, _P]
HEAD_DIMS = (32, 64, 128)
# The work bounds count 64 x 64 (q, kv) tile pairs, what the inputs need,
# whatever tile a kernel runs (K7, K8 and K9 on f32 run 64 x 64 tiles,
# flash_common.cuh; K7 on bf16 128 x 128, FWD_TILE; K8 and K9 on bf16 128
# resident rows against streamed tiles of 64, BWD_TILES).
BOUND_TILE = 64
FWD_TILE = 128  # BQ = BK of K7 on bf16 inputs (flash_fwd.cu, namespace wg)
BWD_RES_TILE, BWD_STREAM_TILE = 128, 64  # BR, BT of K8 and K9 on bf16 (flash_bwd.cuh, wg)
# (q tile, kv tile) of each bf16 backward kernel: K8 holds q, K9 holds kv
BWD_TILES = {"dq": (BWD_RES_TILE, BWD_STREAM_TILE), "dkv": (BWD_STREAM_TILE, BWD_RES_TILE)}
DKV_MAX_SPLITS = 4


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


def _ranges(q, segs, s: int):
    """Scratch for the bf16 kernels' pre-pass: the (min, max) segment id of
    each streamed tile of ``s`` rows' ids, or None (one segment, f32)."""
    if not segs or q.dtype != torch.bfloat16:
        return None
    return torch.empty((q.shape[0], -(-s // BWD_STREAM_TILE), 2), dtype=torch.int32, device=q.device)


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
    ranges = _ranges(q, segs, skv)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), out.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            segs[0].data_ptr() if segs else None, segs[1].data_ptr() if segs else None,
            None if ranges is None else ranges.data_ptr(), dq.data_ptr(),
            b, hq, hkv, sq, skv, dh, strides, scale, int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(code, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq, delta


flash_bwd_dq.launches = 0


def dkv_splits(b: int, skv: int, hkv: int, sms: int) -> int:
    """Blocks that share one K9 item's q sweep on bf16 inputs: enough for
    the items to fill ``sms`` SMs where they are few (cross-attention's 512
    text keys make 4 items a head), at most ``DKV_MAX_SPLITS``."""
    items = -(-skv // BWD_RES_TILE) * hkv * b
    return max(1, min(DKV_MAX_SPLITS, sms // max(items, 1)))


def flash_bwd_dkv(q, k, v, do, lse, delta, q_segment_ids=None, kv_segment_ids=None, *,
                  causal: bool = False, scale: float | None = None):
    """K9: (dk, dv) of segment-aware attention on the card, by a q sweep
    that sums the GQA group on chip.  Arguments as :func:`flash_bwd_dq`,
    with K8's ``delta`` in place of ``out``.  Returns contiguous (dk, dv)
    [B, Skv, Hkv, dh] in k's dtype.  On bf16 inputs with few kv items
    (:func:`dkv_splits`) the q sweep is split over blocks into f32 partial
    sums in a scratch buffer, which a second launch adds in a fixed order."""
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
    splits, part = 1, None
    if q.dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = dkv_splits(b, skv, hkv, sms)
    if splits > 1:
        part = torch.empty((2, splits, b, skv, hkv, dh), dtype=torch.float32, device=q.device)
    ranges = _ranges(q, segs, sq)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(),
            segs[0].data_ptr() if segs else None, segs[1].data_ptr() if segs else None,
            None if ranges is None else ranges.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), splits,
            b, hq, hkv, sq, skv, dh, strides, scale, int(causal), int(q.dtype == torch.bfloat16),
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


def live_tile_mask(sq: int, skv: int, q_segment_ids=None, kv_segment_ids=None, *,
                   causal: bool = False, q_tile: int = BOUND_TILE, kv_tile: int = BOUND_TILE):
    """[B or 1, n_q, n_kv] bool: which (q tile, kv tile) pairs of q_tile x
    kv_tile rows the skip rule keeps.  A pair runs unless the causal cut
    excludes it (its last q row is before its first kv row) or its
    segment-id ranges are disjoint."""
    nq, nk = -(-sq // q_tile), -(-skv // kv_tile)
    live = torch.ones((1, nq, nk), dtype=torch.bool)
    if causal:
        qi = torch.arange(nq)[:, None]
        kj = torch.arange(nk)[None, :]
        live = live & ((qi + 1) * q_tile - 1 >= kj * kv_tile)[None]
    if q_segment_ids is not None:
        q_lo, q_hi = _tile_ranges(q_segment_ids.cpu(), q_tile)
        k_lo, k_hi = _tile_ranges(kv_segment_ids.cpu(), kv_tile)
        live = live & (q_lo[:, :, None] <= k_hi[:, None, :]) & (k_lo[:, None, :] <= q_hi[:, :, None])
    return live


def live_tile_pairs(sq: int, skv: int, q_segment_ids=None, kv_segment_ids=None,
                    *, causal: bool = False, batch: int = 1, tile: int = BOUND_TILE,
                    q_tile: int | None = None, kv_tile: int | None = None) -> int:
    """Number of (q tile, kv tile) pairs that the skip rule keeps
    (:func:`live_tile_mask`), summed over the batch (multiply by the head
    count for a whole launch).  Tiles are ``tile`` rows on both sides
    unless ``q_tile`` or ``kv_tile`` says otherwise."""
    live = live_tile_mask(sq, skv, q_segment_ids, kv_segment_ids, causal=causal,
                          q_tile=q_tile or tile, kv_tile=kv_tile or tile)
    return int(live.sum()) * (batch if q_segment_ids is None else 1)


def bwd_tile_walk(which: str, sq: int, skv: int, hq: int, hkv: int, q_segment_ids=None,
                  kv_segment_ids=None, *, causal: bool = False, batch: int = 1, splits: int = 1):
    """The streamed tiles K8 (``which="dq"``) or K9 (``"dkv"``) visits on
    bf16 inputs, in the order of its work items (heaviest first) and of its
    producer's walk: a list of ``(b, q head, q tile, kv tile)`` at the
    kernel's tiles (``BWD_TILES``).  K8's item is 128 q rows of one q head,
    the q tiles from the last down, walking the kv tiles of 64 rows that the
    causal cut leaves; K9's is 128 kv rows of one kv head, the kv tiles from
    the first up, walking for each q head of the GQA group the q tiles of 64
    rows from the first that the causal cut leaves, in ``splits`` parts
    (:func:`dkv_splits`) that share those q tiles.  Either skips a tile
    whose segment-id range (of its real rows) misses the item's.  A mirror
    of ``produce`` in ``csrc/flash_bwd.cuh``, so that the CPU tests hold it
    to :func:`live_tile_mask`."""
    res, st = BWD_RES_TILE, BWD_STREAM_TILE
    n_res, n_str = (sq, skv) if which == "dq" else (skv, sq)
    heads = hq if which == "dq" else hkv
    group = hq // hkv
    segs = None if q_segment_ids is None else (q_segment_ids.cpu(), kv_segment_ids.cpu())
    rseg, sseg = (None, None) if segs is None else (segs if which == "dq" else segs[::-1])
    nb = batch if segs is None else segs[0].shape[0]

    def ids_range(ids, r0, tile, n):
        rows = ids[[min(r, n - 1) for r in range(r0, r0 + tile)]]  # past n: the last id
        return int(rows.min()), int(rows.max())

    n_r, n_s = -(-n_res // res), -(-n_str // st)
    parts = 1 if which == "dq" else splits
    walk = []
    for n in range(n_r * heads * nb * parts):  # the kernel's item numbering
        split, n = n % parts, n // parts
        hb = heads * nb
        tile = n_r - 1 - n // hb if which == "dq" else n // hb
        head, b = n % heads, n % hb // heads
        r0 = tile * res
        if which == "dq":
            j_first, j_end = 0, (min(n_s, (r0 + res - 1) // st + 1) if causal else n_s)
            q_heads = [head]
        else:
            j_first, j_end = (r0 // st if causal else 0), n_s
            span = max(j_end - j_first, 0)
            j_first, j_end = j_first + span * split // parts, j_first + span * (split + 1) // parts
            q_heads = [head * group + gi for gi in range(group)]
        r_lo, r_hi = ids_range(rseg[b], r0, res, n_res) if segs else (0, 0)
        for h in q_heads:
            for j in range(j_first, j_end):
                if segs:
                    t_lo, t_hi = ids_range(sseg[b], j * st, st, n_str)
                    if not (t_hi >= r_lo and t_lo <= r_hi):
                        continue
                walk.append((b, h, tile, j) if which == "dq" else (b, h, j, tile))
    return walk
