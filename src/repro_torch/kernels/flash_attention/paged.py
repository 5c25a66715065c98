"""Wrapper and ctypes binding of the paged decode-attention kernel K12
(``csrc/paged_decode.cu``): one new query token per decode slot attends
the slot's cached tokens in a shared paged KV pool.

The wrapper takes CUDA tensors only and counts each call in its
``launches`` attribute.  The kernel splits each slot's page sweep into
chunks fixed by :func:`split_plan` from shapes alone (the host never reads
``kv_lens``) and merges the chunks' partials on the card.  The plain
version is ``ref.paged_attention_ref``; :func:`live_pages` counts the pages
the kernel's skip rule reads, for the bytes bound.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .. import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 8 + [ctypes.c_float, _I, _P]
HEAD_DIMS = (64, 128)
MAX_PAGE = 64  # kMaxPage of the source
MAX_GROUP = 16  # kMaxGroup: query heads a kv head, the mma's 16 rows
CHUNK_TOKENS = 256  # kChunkTokens: four warps of 64 tokens a block

# (device index, stream) -> (f32 partials, int32 counts): the kernel's
# scratch, grown on demand and kept from call to call; the counts are zero
# between calls (the kernel's merging block resets its own)
_workspace: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def split_plan(pages_max: int, page_size: int) -> tuple[int, int]:
    """The kernel's split of a slot's page sweep: ``(chunk_pages,
    n_chunks)``, chunks of ``chunk_pages`` consecutive logical pages (at
    most ``CHUNK_TOKENS`` tokens) and ``n_chunks = ceil(pages_max /
    chunk_pages)`` of them for each (slot, kv head).  It depends on shapes
    only, so the grid is fixed without reading ``kv_lens``; blocks whose
    chunk starts past a slot's live pages exit at once."""
    chunk_pages = max(1, CHUNK_TOKENS // page_size)
    return chunk_pages, -(-pages_max // chunk_pages)


def _scratch(device, stream: int, n_part: int, n_count: int):
    key = (device.index, stream)
    ws = _workspace.get(key)
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < n_count:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(n_part, old[0]), dtype=torch.float32, device=device),
              torch.zeros(max(n_count, old[1]), dtype=torch.int32, device=device))
        _workspace[key] = ws
    return ws


def paged_decode(q, k_pages, v_pages, page_table, kv_lens, *, scale: float | None = None):
    """Decode attention over a paged KV pool on the card.

    q: contiguous [B, Hq, dh]; k_pages, v_pages: contiguous [P, ps, Hkv,
    dh] (Hq % Hkv == 0; dh in {64, 128}; ps a multiple of 8 up to 64);
    page_table: contiguous [B, pages_max] int32, every entry a page of the
    pool (point unused entries at a scratch page); kv_lens: [B] int32.  bf16
    or f32; Hq / Hkv at most 16.  Returns ``out [B, Hq, dh]`` in q's dtype; a
    slot with ``kv_len = 0`` gives exact zeros.  One launch; its scratch is
    kept for the next call on the same stream.
    """
    _build.require_cuda("paged_decode", q, k_pages, v_pages, page_table, kv_lens)
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("paged_decode needs q [B, Hq, dh] and k_pages, v_pages [P, ps, Hkv, dh]")
    b, hq, dh = q.shape
    _, ps, hkv, dh_k = k_pages.shape
    if dh_k != dh or dh not in HEAD_DIMS:
        raise ValueError(f"paged_decode: head_dim must be one of {HEAD_DIMS} in q and the pools, "
                         f"got {dh} and {dh_k}")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"paged_decode needs Hq a multiple of Hkv, at most {MAX_GROUP} times "
                         f"it, got Hq={hq}, Hkv={hkv}")
    if ps % 8 or not 8 <= ps <= MAX_PAGE:
        raise ValueError(f"paged_decode takes a page size that is a multiple of 8 up to "
                         f"{MAX_PAGE}, got {ps}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) or q.dtype not in (torch.bfloat16,
                                                                         torch.float32):
        raise ValueError("paged_decode needs q and the pools all bf16 or all f32")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_decode needs q and the pools contiguous and 16-byte aligned")
    if (page_table.dim() != 2 or page_table.shape[0] != b or page_table.dtype != torch.int32
            or not page_table.is_contiguous()):
        raise ValueError("paged_decode needs a contiguous int32 page_table [B, pages_max]")
    if kv_lens.shape != (b,) or kv_lens.dtype != torch.int32 or not kv_lens.is_contiguous():
        raise ValueError("paged_decode needs contiguous int32 kv_lens [B]")
    scale = float(scale) if scale is not None else dh**-0.5
    out = torch.empty_like(q)
    if b == 0:
        return out
    pages_max = page_table.shape[1]
    chunk_pages, n_chunks = split_plan(pages_max, ps)
    fn = _build.bind("paged_decode", "paged_decode", _ARGTYPES)
    # the decode wave is host-bound: enter q's device only when it is not
    # the current one (the context costs a few microseconds a call)
    on_q = q.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if on_q else torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part, count = _scratch(q.device, stream, b * hq * n_chunks * (dh + 2), b * hkv)
        code = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), part.data_ptr(), count.data_ptr(),
            b, hq, hkv, dh, ps, pages_max, chunk_pages, n_chunks,
            scale, int(q.dtype == torch.bfloat16), stream,
        )
    _build.check(code, "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


def live_pages(kv_lens, page_size: int, pages_max: int) -> int:
    """Pages the kernel reads, summed over the slots (multiply by Hkv for
    the page tiles of a whole launch): ``min(ceil(kv_len / ps),
    pages_max)`` a slot (``repro.kernels.flash_attention.paged
    .paged_tile_counts``)."""
    lens = kv_lens.detach().to("cpu", torch.int64).clamp_min(0)
    return int(torch.clamp(-(-lens // page_size), max=pages_max).sum())
