"""Attention outside the kernels: the counterpart of
``repro.models.attention``'s ``repeat_kv``, ``blocked_attention``,
``local_attention`` and ``decode_attention``.

* ``blocked_attention`` — a flash-style loop over KV blocks with a running
  (m, l, acc) softmax state, each block recomputed in the backward; the
  short-sequence branch of ``local_attention``;
* ``local_attention`` — Griffin's causal sliding-window attention by
  chunks (each chunk of ``window`` queries attends to itself and the
  previous chunk), memory O(S * 2w);
* ``decode_attention`` — one query token against a KV cache under a
  validity mask over its slots (a masked single-shot softmax; the scores
  are only [B, H, Smax]): a global layer's first ``pos + 1`` positions, or
  the slots of a local layer's ring that hold one of its last w positions.

The JAX model leaves all three to XLA outside any Pallas kernel (its local
attention never calls the flash kernel, on any backend), so they are plain
PyTorch here too: the local-attention layers of RecurrentGemma run the
first two, contiguous decoding (``transformer.decode_step``) the last, and
paged decoding runs the K12 kernel instead.  All softmax math is f32
whatever the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.data.packing import PAD_SEGMENT_ID

NEG_INF = -2.0e38


def repeat_kv(x, n_rep: int):
    """[B, S, Hkv, dh] -> [B, S, Hkv * n_rep, dh] (GQA head replication)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _block_step(qf, kj, vj, segj, q_seg, m, denom, acc, j: int, kv_block: int, skv: int,
                q_pos):
    """One KV block of :func:`blocked_attention`: the new ``(m, denom, acc)``."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kj.float())
    k_pos = j * kv_block + torch.arange(kv_block, device=qf.device)
    mask = ((q_pos[:, None] >= k_pos[None, :]) & (k_pos < skv)[None, :])[None, None]
    if q_seg is not None:
        mask = mask & (q_seg[:, None, :, None] == segj[:, None, None, :])
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    p = torch.where(mask, p, 0.0)  # exact zeros on fully-masked rows
    denom_new = denom * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vj.float())
    return m_new, denom_new, acc_new


def blocked_attention(q, k, v, *, kv_block: int = 1024, scale: float | None = None,
                      q_segment_ids=None, kv_segment_ids=None):
    """Causal attention, queries and keys both from position 0: q [B, Sq,
    H, dh], k and v [B, Skv, H, dh] (one head count: GQA callers repeat kv
    first) -> [B, Sq, H, dh] in q's dtype.  (The reference's ``causal`` and
    ``q_offset`` options are left out: the port's one caller, the short
    branch of :func:`local_attention`, keeps their defaults.)

    Segment ids ([B, Sq] and [B, Skv] int, -1 = padding; both or neither)
    make equal ids visibility.  A Skv that is not a multiple of
    ``kv_block`` is padded on the KV side with masked keys, so score memory
    stays O(Sq * kv_block).  Under autograd each block is recomputed in the
    backward (the reference's ``jax.checkpoint`` on its scan body), so no
    block's f32 scores are kept."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids, or neither")
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    kv_block = min(kv_block, skv)
    pad = -skv % kv_block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_segment_ids is not None:
            kv_segment_ids = F.pad(kv_segment_ids, (0, pad), value=PAD_SEGMENT_ID)
    n_blocks = (skv + pad) // kv_block
    scale = scale if scale is not None else dh**-0.5

    qf = q.float() * scale
    q_pos = torch.arange(sq, device=q.device)
    q_seg = q_segment_ids.int() if q_segment_ids is not None else None
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    for j in range(n_blocks):
        sl = slice(j * kv_block, (j + 1) * kv_block)
        segj = kv_segment_ids[:, sl].int() if kv_segment_ids is not None else None
        args = (qf, k[:, sl], v[:, sl], segj, q_seg, m, denom, acc, j, kv_block, skv, q_pos)
        if torch.is_grad_enabled():
            m, denom, acc = checkpoint(_block_step, *args, use_reentrant=False)
        else:
            m, denom, acc = _block_step(*args)
    out = acc / torch.clamp_min(denom, 1e-37)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # [B, Sq, H, dh]


def local_attention(q, k, v, *, window: int, scale: float | None = None, segment_ids=None):
    """Causal sliding-window attention (Griffin's local layers): a token at
    position t attends to positions (t - window, t].  q, k, v [B, S, H, dh]
    (kv repeated to H by the caller) -> [B, S, H, dh] in q's dtype.

    S <= window runs :func:`blocked_attention` (KV blocks of
    ``min(S, 1024)``); an S that is not a multiple of ``window`` is padded
    at the end (padding keys lie in the future of every real query, so the
    first S outputs are exact; padded ids are -1); otherwise each chunk of
    ``window`` queries attends to itself and the previous chunk under the
    window mask.  With ``segment_ids`` [B, S] (packed windows, -1 =
    padding) the window also stops at document boundaries."""
    b, s, h, dh = q.shape
    w = window
    if s <= w:
        return blocked_attention(q, k, v, kv_block=min(s, 1024), scale=scale,
                                 q_segment_ids=segment_ids, kv_segment_ids=segment_ids)
    if s % w != 0:
        pad = w - s % w
        if segment_ids is not None:
            segment_ids = F.pad(segment_ids, (0, pad), value=PAD_SEGMENT_ID)
        padw = (0, 0, 0, 0, 0, pad)
        out = local_attention(F.pad(q, padw), F.pad(k, padw), F.pad(v, padw), window=window,
                              scale=scale, segment_ids=segment_ids)
        return out[:, :s]
    t = s // w
    scale = scale if scale is not None else dh**-0.5

    qc = q.reshape(b, t, w, h, dh)
    kc = k.reshape(b, t, w, h, dh)
    vc = v.reshape(b, t, w, h, dh)
    # previous chunk (zeros for chunk 0)
    kprev = F.pad(kc[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0))
    vprev = F.pad(vc[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0))
    k2 = torch.cat([kprev, kc], dim=2)  # [B, T, 2w, H, dh]
    v2 = torch.cat([vprev, vc], dim=2)

    sjk = torch.einsum("btqhd,btkhd->bthqk", qc.float() * scale, k2.float())
    a_idx = torch.arange(w, device=q.device)[:, None]  # query offset in chunk
    b_idx = torch.arange(2 * w, device=q.device)[None, :]  # key offset in the pair
    # global rel = w + a - b; valid iff 0 <= rel < w  <=>  a < b <= a + w
    mask = (b_idx > a_idx) & (b_idx <= a_idx + w)
    # chunk 0 has no previous chunk: keys with b < w are padding
    chunk_ids = torch.arange(t, device=q.device)[:, None, None]
    mask = (mask[None] & ((b_idx[None] >= w) | (chunk_ids > 0)))[None]  # [1, T, w, 2w]
    if segment_ids is not None:
        segc = segment_ids.int().reshape(b, t, w)
        segprev = F.pad(segc[:, :-1], (0, 0, 1, 0), value=PAD_SEGMENT_ID)
        seg2 = torch.cat([segprev, segc], dim=2)  # [B, T, 2w]
        mask = mask & (segc[:, :, :, None] == seg2[:, :, None, :])  # [B, T, w, 2w]
    sjk = torch.where(mask[:, :, None], sjk, NEG_INF)  # [B, T, H, w, 2w]
    p = torch.softmax(sjk, dim=-1)
    out = torch.einsum("bthqk,btkhd->btqhd", p, v2.float())
    return out.reshape(b, s, h, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid):
    """q [B, 1, H, dh] against caches [B, Smax, H, dh] under a validity
    mask [Smax] bool over the cache slots, shared by every row (a global
    layer passes ``arange(Smax) < pos + 1``, a local layer the slots of its
    ring that hold one of its last w positions); scores scaled by dh^-0.5.
    Returns [B, 1, H, dh] in q's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * q.shape[-1] ** -0.5,
                     k_cache.float())  # [B, H, 1, Smax]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v_cache.float()).to(q.dtype)
