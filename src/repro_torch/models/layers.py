"""Base layers (``repro.models.layers``): the initializers, both branches
of ``apply_norm`` (LayerNorm in PyTorch, RMSNorm through the kernel
dispatch), RoPE and the document-relative positions of packed windows
(``repro.models.attention.segment_relative_positions``), the SwiGLU MLP,
the LM head and the chunked LM loss.

Weights keep the JAX package's ``x @ W`` meaning: a projection is a
``[d_in, d_out]`` parameter applied with ``x @ w``, not an ``nn.Linear``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import kernels

#: parameter and activation dtype of a configuration's ``dtype`` string
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def init_generator(seed: int, device) -> torch.Generator | None:
    """The generator a model's weights are drawn from, seeded; None on the
    ``meta`` device, where a model is built from shapes and nothing is
    drawn (the dry run)."""
    device = torch.device(device)
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def draw(gen: torch.Generator | None, shape, device, scale: float, dtype) -> torch.Tensor:
    """N(0, 1) * ``scale`` drawn in f32 from ``gen`` and stored in
    ``dtype``; on ``meta`` an empty tensor of that shape and dtype."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def dense_init(gen: torch.Generator | None, d_in: int, d_out: int, dtype, device,
               scale: float | None = None) -> nn.Parameter:
    """N(0, 1) * d_in^-0.5 (or ``scale``) weights, drawn in f32 from ``gen``."""
    s = scale if scale is not None else d_in**-0.5
    return nn.Parameter(draw(gen, (d_in, d_out), device, s, dtype))


def embed_init(gen: torch.Generator | None, vocab: int, d: int, dtype, device) -> nn.Parameter:
    """N(0, 1) * 0.02 embeddings, drawn in f32 from ``gen``."""
    return nn.Parameter(draw(gen, (vocab, d), device, 0.02, dtype))


class Norm(nn.Module):
    """Norm parameters, f32: ``w`` (ones) and, for a LayerNorm, ``b``
    (zeros) (``repro.models.layers.norm_params``)."""

    def __init__(self, d: int, device, kind: str = "layernorm"):
        super().__init__()
        if kind not in ("layernorm", "rmsnorm"):
            raise ValueError(kind)
        self.w = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device))
        if kind == "layernorm":
            self.b = nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))


def apply_norm(p: Norm, x, kind: str, eps: float, ops=kernels):
    """Norm over the last axis with fp32 statistics, in x's dtype: RMSNorm
    through ``ops.rms_norm`` (the kernel dispatch, or ``kernels.plain``),
    LayerNorm in PyTorch."""
    if kind == "rmsnorm":
        return ops.rms_norm(x, p.w, eps)
    if kind != "layernorm":
        raise ValueError(kind)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.w + p.b).to(x.dtype)


def segment_relative_positions(segment_ids):
    """[B, S] segment ids (contiguous runs) -> int32 position within each
    run (``repro.models.attention.segment_relative_positions``): packed
    windows restart RoPE at every document boundary; padding (-1) runs
    restart too, which is harmless."""
    b, s = segment_ids.shape
    idx = torch.arange(s, dtype=torch.int32, device=segment_ids.device).expand(b, s)
    boundary = torch.ones((b, s), dtype=torch.bool, device=segment_ids.device)
    boundary[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    run_start = torch.cummax(torch.where(boundary, idx, 0), dim=1).values
    return idx - run_start


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )


def apply_rope(x, positions, theta: float):
    """Half-split rotary embedding with f32 angles.  x: [B, S, H, dh];
    positions: [B, S] or [S] integers."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [dh/2]
    ang = positions.float()[..., None] * freqs  # [..., S, dh/2]
    if ang.dim() == 2:  # [S, dh/2] -> broadcast over batch
        ang = ang[None]
    cos = torch.cos(ang)[..., None, :]  # [B, S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2 :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class MLP(nn.Module):
    """SwiGLU weights: ``w1``, ``w3`` [d, d_ff] and ``w2`` [d_ff, d]."""

    def __init__(self, gen: torch.Generator, d: int, d_ff: int, dtype, device):
        super().__init__()
        self.w1 = dense_init(gen, d, d_ff, dtype, device)
        self.w3 = dense_init(gen, d, d_ff, dtype, device)
        self.w2 = dense_init(gen, d_ff, d, dtype, device)


def apply_mlp(p: MLP, x):
    h = F.silu(x @ p.w1) * (x @ p.w3)
    return h @ p.w2


def last_token_logits(x_last, emb):
    """[B, D] x [V, D] -> [B, V] f32 logits (the decode / prefill head): the
    product in the model's dtype, then cast."""
    return (x_last @ emb.T).float()


def _chunk_xent(xi, emb, li):
    # f32 logits of the bf16 (or f32) product, as the reference's
    # preferred_element_type=f32: the operands are widened, so no rounding
    # to the model's dtype happens before the logsumexp
    logits = xi.float() @ emb.float().T  # [B, c, V]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, li[..., None].long())[..., 0]
    return (lse - gold).sum()


def chunked_softmax_xent(x, emb, labels, *, chunk: int = 512):
    """Mean cross-entropy of ``x @ emb.T`` against ``labels`` without
    materializing [B, S, V] logits: chunks of ``chunk`` positions, each
    recomputed in the backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``).  x [B, S, D]; emb [V, D]; labels [B, S]; S must be
    a multiple of ``chunk``."""
    b, s, _ = x.shape
    n_chunks = s // chunk
    if n_chunks * chunk != s:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_xent, x[:, sl], emb, labels[:, sl], use_reentrant=False)
    return total / (b * s)
