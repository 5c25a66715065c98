"""Attention outside the kernels: the counterpart of
``repro.models.attention``'s ``repeat_kv`` and ``decode_attention``.

``decode_attention`` is one query token against a contiguous KV cache (a
masked single-shot softmax; the scores are only [B, H, Smax]).  The JAX
model leaves it to XLA outside any Pallas kernel, so it is plain PyTorch
here too: contiguous decoding (``transformer.decode_step``) runs it, and
paged decoding runs the K12 kernel instead.  All softmax math is f32
whatever the input dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def repeat_kv(x, n_rep: int):
    """[B, S, Hkv, dh] -> [B, S, Hkv * n_rep, dh] (GQA head replication)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def decode_attention(q, k_cache, v_cache, cache_len: int):
    """q [B, 1, H, dh]; caches [B, Smax, H, dh]; cache positions ``>=
    cache_len`` are masked out (every row at one length, as contiguous
    decoding holds them); scores scaled by dh^-0.5.  Returns [B, 1, H, dh]
    in q's dtype."""
    smax = k_cache.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * q.shape[-1] ** -0.5,
                     k_cache.float())  # [B, H, 1, Smax]
    s = torch.where(torch.arange(smax, device=q.device) < cache_len, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v_cache.float()).to(q.dtype)
