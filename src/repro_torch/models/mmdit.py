"""Wan-2.1-style video diffusion transformer (the paper's home architecture).

Block layout (Wan 2.1 / DiT-with-cross-attn, AdaLN conditioning):

    m = t_emb-derived modulation (6 x [B, d]: shift/scale/gate x 2)
    x = x + gate1 * self_attn( adaln_modulate(x, scale1, shift1) )   <- K1, K4, K7
    x = x + cross_attn( norm3(x), text )                             <- K7
    x = x + gate2 * mlp( adaln_modulate(x, scale2, shift2) )         <- K1

The counterpart of ``repro.models.mmdit``: the same parameters under the
same names (a Python loop over ``n_layers`` block modules takes the place
of ``lax.scan`` over the stacked ``blocks`` axis), the same arithmetic,
and the three fused operators routed through ``repro_torch.kernels``,
which picks the CUDA kernel or the plain version by the tensors' device
(and, under autograd, runs the backward kernels).  ``forward(remat=True)``
recomputes each block in the backward (``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint``), as training does;
:func:`rectified_flow_loss` is the training objective.

Activations run in the configuration's dtype: the latents and text are cast
to it on entry.  (The JAX forward promotes to f32 when handed f32 latents
with bf16 weights; for an f32 configuration the two are the same.)
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import kernels, resolve_device

from .config import ModelConfig
from .layers import DTYPES, MLP, Norm, apply_mlp, apply_norm, dense_init, init_generator

TEXT_DIM = 4096  # umt5-xxl width of the text-encoder states


def timestep_embedding(t, dim: int, max_period: float = 10_000.0):
    """Sinusoidal embedding of diffusion time t in [0, 1] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    ang = t.float()[:, None] * 1000.0 * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class Block(nn.Module):
    """One MMDiT block's parameters (``repro.models.mmdit._block_params``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype, device):
        super().__init__()
        d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
        self.wqkv = dense_init(gen, d, 3 * h * dh, dtype, device)
        self.wo = dense_init(gen, h * dh, d, dtype, device)
        self.qnorm = nn.Parameter(torch.ones(dh, dtype=torch.float32, device=device))
        self.knorm = nn.Parameter(torch.ones(dh, dtype=torch.float32, device=device))
        self.xq = dense_init(gen, d, h * dh, dtype, device)
        self.xkv = dense_init(gen, d, 2 * h * dh, dtype, device)
        self.xo = dense_init(gen, h * dh, d, dtype, device)
        self.norm3 = Norm(d, device)
        self.mlp = MLP(gen, d, cfg.d_ff, dtype, device)
        # per-block learned bias on the 6 shared modulation signals (Wan-style)
        self.mod_bias = nn.Parameter(torch.zeros((6, d), dtype=torch.float32, device=device))


def _block(bp: Block, x, txt, mod, cfg: ModelConfig, ops,
           segment_ids=None, text_segment_ids=None, policy=None):
    """mod: [B, 6, d] modulation signals (shared t-emb + per-block bias).

    ``segment_ids`` ([B, S] int32, -1 = padding) scope self-attention;
    ``text_segment_ids`` ([B, S_txt] int32) additionally scope
    cross-attention to each clip's own prompt.  Without them the text
    stream is shared and cross-attention stays unsegmented.  ``policy``
    constrains the residual stream and q, k, v (the reference's hooks).
    """
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    if policy is not None:
        x = policy.constrain(x, "resid")
    m = mod + bp.mod_bias[None]
    shift1, scale1, gate1 = m[:, 0], m[:, 1], m[:, 2]
    shift2, scale2, gate2 = m[:, 3], m[:, 4], m[:, 5]

    # --- self attention with fused AdaLN-modulate; q, k, v stay views of qkv
    hmod = ops.adaln_modulate(x, scale1, shift1)
    qkv = hmod @ bp.wqkv
    q = qkv[..., : h * dh].reshape(b, s, h, dh)
    k = qkv[..., h * dh : 2 * h * dh].reshape(b, s, h, dh)
    v = qkv[..., 2 * h * dh :].reshape(b, s, h, dh)
    q, k = ops.qk_norm(q, k, bp.qnorm, bp.knorm)
    if policy is not None:
        q = policy.constrain(q, "attn_q")
        k = policy.constrain(k, "attn_kv")
        v = policy.constrain(v, "attn_kv")
    ctx = ops.attention(
        q, k, v, causal=False,
        q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
    )
    x = x + gate1[:, None, :].to(x.dtype) * (ctx.reshape(b, s, h * dh) @ bp.wo)

    # --- cross attention to text (segment-scoped for packed windows)
    hn = apply_norm(bp.norm3, x, "layernorm", cfg.norm_eps)
    qx = (hn @ bp.xq).reshape(b, s, h, dh)
    n = txt.shape[1]
    kvx = txt @ bp.xkv
    kx = kvx[..., : h * dh].reshape(b, n, h, dh)
    vx = kvx[..., h * dh :].reshape(b, n, h, dh)
    ctx2 = ops.attention(
        qx, kx, vx, causal=False,
        q_segment_ids=segment_ids if text_segment_ids is not None else None,
        kv_segment_ids=text_segment_ids,
    )
    x = x + ctx2.reshape(b, s, h * dh) @ bp.xo

    # --- MLP with fused AdaLN-modulate
    hmod2 = ops.adaln_modulate(x, scale2, shift2)
    return x + gate2[:, None, :].to(x.dtype) * apply_mlp(bp.mlp, hmod2)


class MMDiT(nn.Module):
    """The Wan-2.1-style MMDiT with weights drawn from ``seed``.

    Runs on CUDA unless ``device`` names another device; raises when no GPU
    is visible and no device is named.  On ``meta`` the parameters have
    their shapes and dtypes and nothing is drawn.
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None):
        super().__init__()
        if cfg.family != "mmdit":
            raise ValueError(f"MMDiT needs an mmdit config, got {cfg.family!r}")
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]
        gen = init_generator(seed, device)
        d, dt = cfg.d_model, self.dtype
        in_dim = cfg.in_channels * 4  # 1x2x2 latent patchify
        self.x_in = dense_init(gen, in_dim, d, dt, device)
        self.txt_in = dense_init(gen, TEXT_DIM, d, dt, device)
        self.t_mlp1 = dense_init(gen, 256, d, dt, device)
        self.t_mlp2 = dense_init(gen, d, 6 * d, dt, device)
        self.final_mod = dense_init(gen, d, 2 * d, dt, device)
        self.x_out = dense_init(gen, d, in_dim, dt, device)
        self.blocks = nn.ModuleList(Block(cfg, gen, dt, device) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.x_in.device

    def forward(
        self,
        latents,  # [B, S_vis, in_channels*4] patchified latent tokens
        text,  # [B, S_txt, 4096] precomputed text-encoder states (stub)
        t,  # [B] diffusion time in [0, 1]
        *,
        segment_ids=None,  # [B, S_vis] int32: packed-window doc ids (-1 = pad)
        text_segment_ids=None,  # [B, S_txt] int32: per-clip prompt ids (-1 = pad)
        ops: str = "kernel",  # "plain": the plain versions on any device
        remat: bool = False,  # recompute each block in the backward (training)
        policy=None,  # sharding hooks (distributed.sharding.ShardingPolicy)
    ):
        if text_segment_ids is not None and segment_ids is None:
            raise ValueError(
                "text_segment_ids scope cross-attention per packed clip, which "
                "needs the visual segment_ids to match against; pass both"
            )
        if ops not in ("kernel", "plain"):
            raise ValueError(f"ops must be 'kernel' or 'plain', got {ops!r}")
        K = kernels if ops == "kernel" else kernels.plain
        cfg = self.cfg
        x = latents.to(self.dtype) @ self.x_in
        txt = text.to(self.dtype) @ self.txt_in
        temb = timestep_embedding(t, 256).to(self.dtype)
        temb = F.silu(temb @ self.t_mlp1)
        mod = (temb @ self.t_mlp2).reshape(-1, 6, cfg.d_model).float()
        for bp in self.blocks:
            if remat:
                x = checkpoint(_block, bp, x, txt, mod, cfg, K, segment_ids, text_segment_ids,
                               policy, use_reentrant=False)
            else:
                x = _block(bp, x, txt, mod, cfg, K, segment_ids, text_segment_ids, policy)
        fm = (temb @ self.final_mod).reshape(-1, 2, cfg.d_model).float()
        x = K.adaln_modulate(x, fm[:, 0], fm[:, 1])
        return x @ self.x_out


def decays(name: str, p) -> bool:
    """AdamW's weight-decay rule (``ndim >= 2``) in the JAX layout, where
    every per-block tensor carries the stacked ``blocks`` axis: so the
    per-block norm gains and biases decay, as in the reference, and only
    top-level vectors would not."""
    stacked = 1 if name.startswith("blocks.") else 0
    return p.ndim + stacked >= 2


def rectified_flow_loss(
    model: MMDiT,
    x0,  # clean latent tokens [B, S, in_dim]
    text,
    *,
    t=None,  # [B] f32 diffusion times; drawn from ``generator`` when None
    eps=None,  # noise shaped as x0 (f32); drawn from ``generator`` when None
    generator: torch.Generator | None = None,
    segment_ids=None,
    text_segment_ids=None,
    ops: str = "kernel",
    remat: bool = True,
    policy=None,
):
    """Rectified-flow velocity loss with the reference's casts
    (``repro.models.mmdit.rectified_flow_loss``): ``t ~ U[0, 1)``, ``eps ~
    N(0, 1)`` cast to x0's dtype, ``xt = (1 - t) x0 + t eps`` formed in f32
    and cast to x0's dtype, ``v_target = eps - x0`` in f32, and the loss the
    mean of the squared f32 differences.  The draws (t first, then eps) come
    from ``generator``; a test injects the JAX draws as ``t`` and ``eps``."""
    b = x0.shape[0]
    if t is None:
        t = torch.rand((b,), generator=generator, dtype=torch.float32, device=x0.device)
    if eps is None:
        eps = torch.randn(x0.shape, generator=generator, dtype=torch.float32, device=x0.device)
    eps = eps.to(x0.dtype)
    tt = t.float()[:, None, None]
    xt = ((1.0 - tt) * x0.float() + tt * eps.float()).to(x0.dtype)
    v_target = eps.float() - x0.float()
    v_pred = model(xt, text, t, segment_ids=segment_ids, text_segment_ids=text_segment_ids,
                   ops=ops, remat=remat, policy=policy)
    return ((v_pred.float() - v_target) ** 2).mean()
