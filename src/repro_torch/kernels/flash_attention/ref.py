"""Plain PyTorch segment-aware attention, forward and backward: the
counterpart of ``repro.kernels.flash_attention.ref.attention_reference`` and
``repro.models.attention.blocked_attention``, and of the Pallas backward's
recompute formulas (``flash.py`` ``_recompute_p_ds``); and plain paged
decode attention (:func:`paged_attention_ref`, K12's plain version).

Takes the model's ``[B, S, H, dh]`` layout.  Scores are computed one kv
block at a time with a running fp32 (max, sum, acc) softmax state, so memory
stays O(Sq · kv_block) even at the serving shapes (6240 × 6240 per head).

Visibility is segment-id equality (``-1`` is an id like any other: padding
attends padding) and, with ``causal``, ``q_pos >= k_pos``.  A row that sees
no key at all gives exact zeros and ``lse = NEG_INF`` (the kernel's
``LSE_FLOOR`` guard).
"""

from __future__ import annotations

import torch

NEG_INF = -2.0e38  # finite: exp(NEG_INF - NEG_INF) must stay a number
LSE_FLOOR = 1e-37  # guards log/div on rows that see no key


def attention_ref(
    q,  # [B, Sq, Hq, dh]
    k,  # [B, Skv, Hkv, dh]  (GQA: Hq % Hkv == 0)
    v,
    q_segment_ids=None,  # [B, Sq] int; None = one segment
    kv_segment_ids=None,  # [B, Skv]
    *,
    causal: bool = False,
    scale: float | None = None,
    kv_block: int = 1024,
    out_dtype=None,
):
    """Returns ``(out [B, Sq, Hq, dh] in out_dtype (default q.dtype), lse
    [B, Hq, Sq] f32)``."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids, or neither")
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hq % hkv != 0:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got Hq={hq}, Hkv={hkv}")
    g = hq // hkv
    scale = scale if scale is not None else dh**-0.5

    qf = q.float().transpose(1, 2) * scale  # [B, Hq, Sq, dh]
    q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, dh), dtype=torch.float32, device=q.device)
    for j0 in range(0, skv, kv_block):
        j1 = min(j0 + kv_block, skv)
        kj = k[:, j0:j1].float().transpose(1, 2).repeat_interleave(g, dim=1)
        vj = v[:, j0:j1].float().transpose(1, 2).repeat_interleave(g, dim=1)
        s = qf @ kj.transpose(-1, -2)  # [B, Hq, Sq, kb]
        mask = _visible(q_pos, j0, j1, causal, q_segment_ids, kv_segment_ids)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)  # exp(NEG_INF - NEG_INF) guard
        denom = denom * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vj
        m = m_new
    denom = torch.clamp(denom, min=LSE_FLOOR)
    out = (acc / denom[..., None]).transpose(1, 2).to(out_dtype or q.dtype)
    return out, m + torch.log(denom)


def _visible(q_pos, j0, j1, causal, q_segment_ids, kv_segment_ids):
    """[B or 1, 1, Sq, kb] visibility of keys j0..j1, or None (all)."""
    mask = None
    if causal:
        k_pos = torch.arange(j0, j1, device=q_pos.device)
        mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
    if q_segment_ids is not None:
        seg = q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, j0:j1]
        mask = seg if mask is None else (mask & seg)
    return mask


def attention_delta_ref(do, out):
    """``delta = sum(do * out)`` over dh: [B, Hq, Sq] f32 from the output's
    gradient and the f32 output, both [B, Sq, Hq, dh]."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2)


def attention_bwd_ref(q, k, v, do, lse, delta, q_segment_ids=None, kv_segment_ids=None,
                      *, causal: bool = False, scale: float | None = None,
                      kv_block: int = 1024):
    """Plain K8 and K9: ``(dq, dk, dv)`` in the inputs' dtypes.

    Recomputes, one kv block at a time and in fp32, ``p = exp(s * scale -
    lse)`` and ``ds = p * (do v^T - delta)`` with masked entries exactly 0
    (rows that see no key have ``lse = NEG_INF``); ``dq = scale * ds k``,
    ``dk = scale * ds^T q`` and ``dv = p^T do``, dk and dv summed over each
    GQA group.  lse, delta: [B, Hq, Sq] f32.
    """
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids, or neither")
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else dh**-0.5
    qf = q.float().transpose(1, 2)  # [B, Hq, Sq, dh]
    dof = do.float().transpose(1, 2)
    q_pos = torch.arange(sq, device=q.device)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j0 in range(0, skv, kv_block):
        j1 = min(j0 + kv_block, skv)
        kj = k[:, j0:j1].float().transpose(1, 2).repeat_interleave(g, dim=1)
        vj = v[:, j0:j1].float().transpose(1, 2).repeat_interleave(g, dim=1)
        mask = _visible(q_pos, j0, j1, causal, q_segment_ids, kv_segment_ids)
        p = torch.exp((qf @ kj.transpose(-1, -2)) * scale - lse[..., None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        ds = p * (dof @ vj.transpose(-1, -2) - delta[..., None])
        dq += (ds @ kj) * scale
        # [B, Hq, kb, dh] -> summed over the group of each kv head
        dks.append(((ds.transpose(-1, -2) @ qf) * scale).unflatten(1, (hkv, g)).sum(2))
        dvs.append((p.transpose(-1, -2) @ dof).unflatten(1, (hkv, g)).sum(2))
    dk = torch.cat(dks, dim=2) if dks else torch.zeros((b, hkv, 0, dh), device=q.device)
    dv = torch.cat(dvs, dim=2) if dvs else torch.zeros((b, hkv, 0, dh), device=q.device)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def paged_attention_ref(
    q,  # [B, Hq, dh]: one new token per decode slot
    k_pages,  # [P, page_size, Hkv, dh]: the shared pool
    v_pages,
    page_table,  # [B, pages_max] int32, every entry a page of the pool
    kv_lens,  # [B] int32 valid tokens per slot (0: exact zeros)
    *,
    scale: float | None = None,
):
    """Plain K12, the counterpart of ``repro.kernels.flash_attention.paged
    .paged_attention_ref``: gather each slot's pages into a contiguous view
    and take a masked fp32 softmax.  Returns ``[B, Hq, dh]`` in q's dtype;
    ``kv_lens == 0`` rows are exact zeros (the ``LSE_FLOOR`` guard).  The
    GQA group is a view of q's heads, not a copy of the cache."""
    b, hq, dh = q.shape
    _, ps, hkv, _ = k_pages.shape
    g = hq // hkv
    pages_max = page_table.shape[1]
    scale = scale if scale is not None else dh**-0.5
    idx = page_table.long()
    # [B, pages_max, ps, Hkv, dh] -> [B, S_max, Hkv, dh]
    k = k_pages[idx].reshape(b, pages_max * ps, hkv, dh).float()
    v = v_pages[idx].reshape(b, pages_max * ps, hkv, dh).float()
    qg = (q.float() * scale).reshape(b, hkv, g, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k).reshape(b, hq, pages_max * ps)
    valid = torch.arange(pages_max * ps, device=q.device)[None, :] < kv_lens[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid[:, None, :], p, 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=LSE_FLOOR)
    pg = (p / denom).reshape(b, hkv, g, pages_max * ps)
    out = torch.einsum("bkgs,bskd->bkgd", pg, v).reshape(b, hq, dh)
    return out.to(q.dtype)
