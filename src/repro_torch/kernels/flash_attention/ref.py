"""Plain PyTorch segment-aware attention: the counterpart of
``repro.kernels.flash_attention.ref.attention_reference`` and of
``repro.models.attention.blocked_attention``.

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
):
    """Returns ``(out [B, Sq, Hq, dh] in q.dtype, lse [B, Hq, Sq] f32)``."""
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
        mask = None
        if causal:
            k_pos = torch.arange(j0, j1, device=q.device)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        if q_segment_ids is not None:
            seg = (
                q_segment_ids[:, None, :, None]
                == kv_segment_ids[:, None, None, j0:j1]
            )
            mask = seg if mask is None else (mask & seg)
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
    out = (acc / denom[..., None]).transpose(1, 2).to(q.dtype)
    return out, m + torch.log(denom)
