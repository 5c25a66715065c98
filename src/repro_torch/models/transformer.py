"""Decoder-only LM: global-attention, MoE, local-attention, RG-LRU,
Mamba-2 and cross-attention blocks, trained, served over a paged KV cache
(global-attention and MoE blocks) or served from contiguous per-layer
caches (every kind).

The counterpart of ``repro.models.transformer`` for global-attention
transformer blocks (``"attn"``), MoE blocks (``"moe"``: ``norm1``,
``attn``, ``norm2`` and the routed ``moe`` of ``models.moe`` in place of
the MLP), Griffin's sliding-window attention blocks
(``"local"``: the attention block's parameters, ``local_attention``) and
RG-LRU blocks (``"rglru"``: ``norm1``, the recurrent ``mixer``, ``norm2``
and the MLP), SSD mixer blocks (``"ssm"``: ``norm1`` and ``mixer``, no
MLP half), and Llama-3.2-Vision's cross-attention blocks (``"cross"``:
``norm1``, an ``attn`` of ``wq``, ``wkv``, ``wo`` and a tanh ``gate``
over the image ``memory``, ``norm2`` and the MLP): the same parameters
under the same names (one
``blocks.<i>`` module per layer, run in one Python loop, where the JAX
model scans the stacked superblocks), the same arithmetic, and the fused
operators routed through ``repro_torch.kernels``, which picks the CUDA
kernel or the plain version by the tensors' device.  ``ops="plain"`` runs
the plain versions on any device (the on-card comparison).

Entry points:

* :meth:`Transformer.forward` — the full-sequence forward, each block
  optionally recomputed in the backward (``remat``, training), or
  collecting each layer's decode cache (prefill); packed windows pass
  ``segment_ids`` (attention scoped to each document, RoPE restarting at
  each), and a sequence-parallel shard passes its ring ``seq_group`` and
  the whole window's ``positions``; ``return_aux`` adds the MoE layers'
  summed router loss; a model with cross-attention layers takes the
  image ``memory`` [B, n_image_tokens, d] in the model's dtype;
* :func:`lm_loss` — the chunked next-token cross-entropy plus the router
  loss (training);
* :func:`prefill` and :func:`decode_step` — contiguous serving: prompts
  of one length through ``forward``, their caches grown to a capacity
  (:func:`init_cache` gives zero ones), then one new token per row at a
  position ``pos`` that every row shares, a Python int, so decoding never
  waits on the device for an index;
* :func:`paged_prefill` — prompts through ``forward``, their k and v
  scattered into pool pages, logits at each prompt's last true token;
* :func:`paged_decode_step` — one decode wave, one new token per slot,
  every slot at its own depth (``kv_lens``), its k and v written into the
  slot's current page before the paged attention.

Caches are one dict per layer, in a list: ``{"k", "v"}`` [B, cap, Hkv,
dh] for an attention layer (a cross layer's holds the memory's k and v,
[B, n_image_tokens, Hkv, dh], and keeps its length); a local layer's ring ``{"k", "v"}`` [B, w,
Hkv, dh] with ``"pos"`` [w] int32 (the position each slot holds, -1 where
empty; position t lives in slot t mod w); ``{"h", "conv"}`` for an RG-LRU
layer and ``{"conv", "state"}`` for a Mamba-2 layer
(``convert.caches_to_numpy`` gives the JAX tree).  Attention caches, local
rings and the pools (:func:`init_paged_pools`: one k and one v pool per
layer, ``[num_pages + 1, page_size, Hkv, dh]``, the last page a scratch
sink) are updated in place, where the JAX model builds new arrays with
``dynamic_update_slice`` and ``.at[].set``: the decode steps return the
caches and pools they were given (a recurrent layer's cache is new each
step).  Paged serving takes ``"attn"`` and ``"moe"`` blocks only, as the
reference's ``_paged_kinds`` takes global-attention kinds only, and
sequence parallelism the same two at the block level.  The MoE blocks
route with capacity in the full-sequence forward (training, prefill) and
without drops in the decode steps (``no_drop``), as the reference does,
in ``n_groups`` dispatch groups (the steps pass the sharding policy's
``n_dispatch_groups``, 1 without a policy).  With a ``policy``, the
embedding output, each block's normed input and residual update and the
attention's q, k and v go through ``policy.constrain`` at the reference's
hook points.  A cross layer attends from every
position to every image token (non-causal, no segment ids, also in a
packed window, as the reference), and decodes against the cached memory
with kv repeated to every query head.  Where the reference would promote
f32 memory against bf16 weights, the port requires the memory in the
model's dtype, and a cross layer called without memory raises by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import kernels, resolve_device

from .config import ModelConfig, lm_layers
from .layers import (
    DTYPES,
    MLP,
    Norm,
    apply_mlp,
    apply_norm,
    apply_rope,
    chunked_softmax_xent,
    dense_init,
    embed_init,
    init_generator,
    last_token_logits,
    segment_relative_positions,
)
from .attention import decode_attention, local_attention, repeat_kv
from .moe import MoE, apply_moe
from .rglru import RGLRU, apply_rglru, apply_rglru_decode, rglru_cache_init
from .ssm import SSM, apply_ssm, apply_ssm_decode, ssm_cache_init

KINDS = ("attn", "moe", "ssm", "local", "rglru", "cross")  # the block kinds of the port
PAGED_KINDS = ("attn", "moe")  # the kinds paged serving takes
SP_KINDS = ("attn", "moe")  # the kinds sequence parallelism takes


def _ops(ops: str):
    if ops not in ("kernel", "plain"):
        raise ValueError(f"ops must be 'kernel' or 'plain', got {ops!r}")
    return kernels if ops == "kernel" else kernels.plain


def _model_kinds(cfg: ModelConfig) -> list[str]:
    """The layer plan, refusing unknown kinds."""
    kinds = cfg.layer_kinds()
    bad = sorted({k for k in kinds if k not in KINDS})
    if bad:
        raise ValueError(
            f"the port runs global-attention, MoE, local-attention, RG-LRU, "
            f"Mamba-2 and cross-attention blocks only ({KINDS}); config {cfg.name} "
            f"has {bad}"
        )
    return kinds


def paged_kinds(cfg: ModelConfig) -> list[str]:
    """The layer plan of paged serving (the reference's ``_paged_kinds``),
    refusing every kind but global attention and MoE."""
    kinds = _model_kinds(cfg)
    bad = sorted({k for k in kinds if k not in PAGED_KINDS})
    if bad:
        raise ValueError(
            f"paged serving supports global-attention transformer blocks only "
            f"({PAGED_KINDS}); config {cfg.name} has {bad}"
        )
    return kinds


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------


class Attention(nn.Module):
    """Self-attention parameters (``_attn_params``): the fused ``wqkv``
    [d, (h + 2 hkv) dh], optional ``bqkv``, ``wo`` [h dh, d], and the
    optional per-head ``qnorm`` / ``knorm`` gains (f32)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype, device):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wqkv = dense_init(gen, d, (h + 2 * hkv) * dh, dtype, device)
        if cfg.qkv_bias:
            self.bqkv = nn.Parameter(torch.zeros((h + 2 * hkv) * dh, dtype=dtype, device=device))
        self.wo = dense_init(gen, h * dh, d, dtype, device)
        if cfg.qk_norm:
            self.qnorm = nn.Parameter(torch.ones(dh, dtype=torch.float32, device=device))
            self.knorm = nn.Parameter(torch.ones(dh, dtype=torch.float32, device=device))


class CrossAttention(nn.Module):
    """Cross-attention parameters (``_attn_params(cross=True)``): ``wq``
    [d, h dh], ``wkv`` [d, 2 hkv dh] (applied to the image memory), ``wo``
    [h dh, d], and the f32 scalar ``gate`` of the tanh-gated residual, 0 at
    init (so the layer adds nothing until the gate moves)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype, device):
        super().__init__()
        if cfg.qk_norm:
            raise ValueError("cross-attention layers hold no q/k norm gains (the reference's "
                             "_cross_attn_full never applies them)")
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = dense_init(gen, d, h * dh, dtype, device)
        self.wkv = dense_init(gen, d, 2 * hkv * dh, dtype, device)
        self.gate = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device))
        self.wo = dense_init(gen, h * dh, d, dtype, device)


class Block(nn.Module):
    """One attention block's parameters (``block_params`` for ``"attn"``
    and ``"local"``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype, device):
        super().__init__()
        self.norm1 = Norm(cfg.d_model, device, cfg.norm)
        self.attn = Attention(cfg, gen, dtype, device)
        self.norm2 = Norm(cfg.d_model, device, cfg.norm)
        self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, dtype, device)


class MoEBlock(nn.Module):
    """One MoE block's parameters (``block_params`` for ``"moe"``): the
    attention half of :class:`Block`, and the routed ``moe`` in place of the
    MLP."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype, device):
        super().__init__()
        self.norm1 = Norm(cfg.d_model, device, cfg.norm)
        self.attn = Attention(cfg, gen, dtype, device)
        self.norm2 = Norm(cfg.d_model, device, cfg.norm)
        self.moe = MoE(cfg.d_model, cfg.moe, gen, dtype, device)


class SSMBlock(nn.Module):
    """One Mamba-2 block's parameters (``block_params`` for ``"ssm"``):
    ``norm1`` and the ``mixer``; the block has no MLP half."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype, device):
        super().__init__()
        self.norm1 = Norm(cfg.d_model, device, cfg.norm)
        self.mixer = SSM(cfg.d_model, cfg.ssm, gen, dtype, device)


class RGLRUBlock(nn.Module):
    """One RG-LRU block's parameters (``block_params`` for ``"rglru"``):
    ``norm1``, the recurrent ``mixer``, ``norm2`` and the MLP."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype, device):
        super().__init__()
        self.norm1 = Norm(cfg.d_model, device, cfg.norm)
        self.mixer = RGLRU(cfg, gen, dtype, device)
        self.norm2 = Norm(cfg.d_model, device, cfg.norm)
        self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, dtype, device)


class CrossBlock(nn.Module):
    """One cross-attention block's parameters (``block_params`` for
    ``"cross"``): ``norm1``, the :class:`CrossAttention`, ``norm2`` and the
    MLP."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype, device):
        super().__init__()
        self.norm1 = Norm(cfg.d_model, device, cfg.norm)
        self.attn = CrossAttention(cfg, gen, dtype, device)
        self.norm2 = Norm(cfg.d_model, device, cfg.norm)
        self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, dtype, device)


BLOCKS = {"attn": Block, "moe": MoEBlock, "local": Block, "ssm": SSMBlock,
          "rglru": RGLRUBlock, "cross": CrossBlock}


class Transformer(nn.Module):
    """The decoder-only LM with weights drawn from ``seed`` (tied
    embeddings: ``embed`` is also the LM head).

    Runs on CUDA unless ``device`` names another device; raises when no GPU
    is visible and no device is named.  On ``meta`` the parameters have
    their shapes and dtypes and nothing is drawn.
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None):
        super().__init__()
        self.kinds = _model_kinds(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]
        gen = init_generator(seed, device)
        self.embed = embed_init(gen, cfg.vocab, cfg.d_model, self.dtype, device)
        self.blocks = nn.ModuleList(BLOCKS[k](cfg, gen, self.dtype, device) for k in self.kinds)
        self.final_norm = Norm(cfg.d_model, device, cfg.norm)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, *, memory=None, collect_cache: bool = False, ops: str = "kernel",
                remat: bool = False, segment_ids=None, positions=None, seq_group=None,
                return_aux: bool = False, policy=None, n_groups: int = 1):
        """Token ids [B, S] -> ``(hidden [B, S, d] after the final norm,
        caches)``, or with ``return_aux`` ``(hidden, aux, caches)``, aux the
        f32 sum of the MoE layers' router losses (0 without MoE layers):
        with ``collect_cache``, one decode cache per layer
        (``{"k", "v"}`` [B, S, Hkv, dh], k after RoPE, for an attention or
        MoE layer; a cross layer's memory k and v [B, n_image_tokens, Hkv,
        dh]; a local layer's ring; the RG-LRU's ``{"h", "conv"}``; the
        SSM's ``{"conv", "state"}``), else None.  ``memory`` [B,
        n_image_tokens, d], in the model's dtype, is what the cross layers
        attend to (the VLM's image patch embeddings).  ``remat``
        recomputes each block in the backward (``torch.utils.checkpoint``,
        the reference's per-superblock ``jax.checkpoint``), as training
        does.

        ``segment_ids`` [B, S] int32 (packed windows, -1 = padding) scope
        attention to each document, and RoPE restarts at each document
        unless ``positions`` ([B, S] or [S]) are given.  Under sequence
        parallelism (``seq_group``, a ring of ``kernels.flash_attention
        .ring``) the tokens and ids are contiguous shards of one window and
        ``positions`` must be the whole window's, sliced: recomputed per
        shard they would restart at the shard boundary.  ``policy`` and
        ``n_groups``: the sharding hooks and MoE dispatch groups (module
        docstring)."""
        K = _ops(ops)
        cfg = self.cfg
        if seq_group is not None and positions is None:
            raise ValueError(
                "sequence-parallel forward needs globally computed positions "
                "(per-shard recomputation would restart at the shard boundary)"
            )
        x = self.embed[tokens.long()]
        if policy is not None:
            x = policy.constrain(x, "resid")
        if positions is None:
            positions = (segment_relative_positions(segment_ids) if segment_ids is not None
                         else torch.arange(tokens.shape[1], device=x.device))
        caches = [] if collect_cache else None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for bp, kind in zip(self.blocks, self.kinds):
            if remat:
                x, a, cache = checkpoint(apply_block, bp, x, cfg, positions, K, kind,
                                         memory=memory, segment_ids=segment_ids,
                                         seq_group=seq_group, policy=policy, n_groups=n_groups,
                                         use_reentrant=False)
            else:
                x, a, cache = apply_block(bp, x, cfg, positions, K, kind, memory=memory,
                                          collect_cache=collect_cache,
                                          segment_ids=segment_ids, seq_group=seq_group,
                                          policy=policy, n_groups=n_groups)
            if a is not None:
                aux = aux + a
            if collect_cache:
                caches.append(cache)
        h = apply_norm(self.final_norm, x, cfg.norm, cfg.norm_eps, K)
        return (h, aux, caches) if return_aux else (h, caches)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------


def _project_qkv(bp: Attention, x, cfg: ModelConfig, K):
    """q [B, S, h, dh], k and v [B, S, hkv, dh] as views of the fused
    projection (q and k normalised per head when the config asks)."""
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv = x @ bp.wqkv
    if cfg.qkv_bias:
        qkv = qkv + bp.bqkv
    b, s, _ = qkv.shape
    q = qkv[..., : h * dh].reshape(b, s, h, dh)
    k = qkv[..., h * dh : (h + hkv) * dh].reshape(b, s, hkv, dh)
    v = qkv[..., (h + hkv) * dh :].reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q, k = K.qk_norm(q, k, bp.qnorm, bp.knorm, cfg.norm_eps)
    return q, k, v


def _self_attn_full(bp: Attention, x, cfg: ModelConfig, positions, K, *, local: bool = False,
                    segment_ids=None, seq_group=None, policy=None):
    """Causal self-attention over the whole sequence, scoped to each
    document by ``segment_ids``, or over this rank's shard of the ring
    ``seq_group``; with ``local``, Griffin's sliding window of
    ``cfg.local_window`` positions (:func:`local_attention`, kv repeated to
    every query head).  Returns ``(out [B, S, d], (k, v))``, k after RoPE."""
    q, k, v = _project_qkv(bp, x, cfg, K)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if policy is not None:
        q = policy.constrain(q, "attn_q")
        k = policy.constrain(k, "attn_kv")
        v = policy.constrain(v, "attn_kv")
    if local:
        g = cfg.n_heads // cfg.n_kv_heads
        ctx = local_attention(q, repeat_kv(k, g), repeat_kv(v, g), window=cfg.local_window,
                              segment_ids=segment_ids)
    else:
        ctx = K.attention(q, k, v, causal=True, q_segment_ids=segment_ids,
                          kv_segment_ids=segment_ids, seq_group=seq_group)
    b, s = x.shape[:2]
    return ctx.reshape(b, s, cfg.n_heads * cfg.head_dim) @ bp.wo, (k, v)


def _cross_attn_full(bp: CrossAttention, x, memory, cfg: ModelConfig, K):
    """Attention from every position of x to every row of ``memory`` (non-
    causal, no segment ids): q from x, k and v views of ``memory @ wkv``.
    Returns ``(tanh(gate) * out [B, S, d], (k, v))``, the tanh taken in f32
    and cast to the output's dtype."""
    if memory is None:
        raise ValueError(f"config {cfg.name}: a cross-attention layer needs the image memory "
                         f"[B, n_image_tokens, d] (memory=)")
    if memory.dtype != bp.wkv.dtype:
        raise ValueError(f"config {cfg.name}: the memory must come in the model's dtype "
                         f"{bp.wkv.dtype}, got {memory.dtype}")
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    n = memory.shape[1]
    q = (x @ bp.wq).reshape(b, s, h, dh)
    kv = memory @ bp.wkv
    k = kv[..., : hkv * dh].reshape(b, n, hkv, dh)
    v = kv[..., hkv * dh :].reshape(b, n, hkv, dh)
    ctx = K.attention(q, k, v, causal=False)
    out = ctx.reshape(b, s, h * dh) @ bp.wo
    return torch.tanh(bp.gate).to(out.dtype) * out, (k, v)


def apply_block(bp: Block | MoEBlock | SSMBlock | RGLRUBlock | CrossBlock, x, cfg: ModelConfig,
                positions, K, kind: str = "attn", *, memory=None, collect_cache: bool = False,
                segment_ids=None, seq_group=None, policy=None, n_groups: int = 1):
    """One block over a full sequence (or a ring shard of one, with
    ``seq_group``).  Returns ``(x, aux, cache or None)``, aux the MoE
    layer's router loss (None for the other kinds).  As in the reference,
    ``segment_ids`` reach the self-attention kinds only: in a packed window
    the RG-LRU's and the SSM's conv and recurrence run across documents,
    the MoE routes each token alone (its capacity counts every token of
    the group, padding included), and a cross layer's positions all see
    the whole ``memory``."""
    if seq_group is not None and kind not in SP_KINDS:
        raise ValueError(
            f"sequence parallelism does not support {kind!r} blocks "
            f"(global-attention transformer blocks only)"
        )
    h = apply_norm(bp.norm1, x, cfg.norm, cfg.norm_eps, K)
    if policy is not None:
        h = policy.constrain(h, "resid")
    if kind == "ssm":
        if collect_cache:
            out, cache = apply_ssm(bp.mixer, h, cfg.ssm, K, return_cache=True)
            return x + out, None, cache
        return x + apply_ssm(bp.mixer, h, cfg.ssm, K), None, None
    cache = None
    if kind == "rglru":
        if collect_cache:
            out, cache = apply_rglru(bp.mixer, h, cfg, return_cache=True)
        else:
            out = apply_rglru(bp.mixer, h, cfg)
    elif kind == "cross":
        out, (k, v) = _cross_attn_full(bp.attn, h, memory, cfg, K)
        if collect_cache:
            cache = {"k": k, "v": v}
    else:
        out, (k, v) = _self_attn_full(bp.attn, h, cfg, positions, K, local=kind == "local",
                                      segment_ids=segment_ids, seq_group=seq_group,
                                      policy=policy)
        if collect_cache:
            cache = _make_attn_cache(k, v, kind, cfg)
    x = x + out
    h2 = apply_norm(bp.norm2, x, cfg.norm, cfg.norm_eps, K)
    aux = None
    if kind == "moe":
        out2, aux = apply_moe(bp.moe, h2, cfg.moe, n_groups=n_groups, policy=policy)
    else:
        out2 = apply_mlp(bp.mlp, h2)
    if policy is not None:
        out2 = policy.constrain(out2, "resid")
    return x + out2, aux, cache


def _make_attn_cache(k, v, kind: str, cfg: ModelConfig) -> dict:
    """An attention layer's prefill cache: its k and v [B, S, Hkv, dh]; for
    a local layer the ring of the last ``min(S, w)`` positions, position t
    in slot t mod w, and ``"pos"`` [w] int32 (-1 where empty)."""
    if kind != "local":
        return {"k": k, "v": v}
    w = cfg.local_window
    s = k.shape[1]
    n = min(s, w)
    pos = torch.arange(s - n, s, device=k.device)
    slots = pos % w
    ring_k = k.new_zeros((k.shape[0], w) + k.shape[2:])
    ring_v = v.new_zeros((v.shape[0], w) + v.shape[2:])
    ring_k[:, slots] = k[:, s - n:]
    ring_v[:, slots] = v[:, s - n:]
    pos_arr = torch.full((w,), -1, dtype=torch.int32, device=k.device)
    pos_arr[slots] = pos.int()
    return {"k": ring_k, "v": ring_v, "pos": pos_arr}


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def lm_loss(model: Transformer, tokens, labels, *, memory=None, loss_chunk: int = 512,
            ops: str = "kernel", remat: bool = True, segment_ids=None, positions=None,
            seq_group=None, policy=None, n_groups: int = 1):
    """Mean next-token cross-entropy of ``tokens`` [B, S] against ``labels``
    [B, S] (``repro.models.transformer.lm_loss``): the forward with each
    block recomputed in the backward, then :func:`chunked_softmax_xent`
    over chunks of ``min(loss_chunk, S)`` positions against the tied
    embedding, plus ``router_aux_weight`` times the MoE layers' summed
    router loss where the config has MoE.  ``memory``, ``segment_ids``,
    ``positions``, ``seq_group``, ``policy`` and ``n_groups`` as in
    :meth:`Transformer.forward`; on a
    ``LocalRing`` the k shards are stacked along the batch axis, so the
    mean over all their tokens is the mean of the k shard means."""
    h, aux, _ = model(tokens, memory=memory, ops=ops, remat=remat, segment_ids=segment_ids,
                      positions=positions, seq_group=seq_group, return_aux=True, policy=policy,
                      n_groups=n_groups)
    ce = chunked_softmax_xent(h, model.embed, labels, chunk=min(loss_chunk, tokens.shape[1]))
    if model.cfg.moe is None:
        return ce
    return ce + model.cfg.moe.router_aux_weight * aux


def decays(cfg: ModelConfig):
    """AdamW's weight-decay rule (``ndim >= 2``) in the JAX layout of this
    LM: the per-layer tensors of the ``blocks.s<i>`` superblocks carry the
    stacked repeat axis, so their 1-D gains, biases and SSM vectors decay
    as in the reference; ``lead`` and ``tail`` layers are unstacked, and
    top-level vectors (``final_norm.w``) do not decay.  Returns the
    ``decay(name, p)`` predicate of :func:`repro_torch.optim.adamw.adamw_update`."""
    stacked = {i for i, (where, _) in enumerate(lm_layers(cfg)) if where not in ("lead", "tail")}

    def decay(name: str, p) -> bool:
        parts = name.split(".", 2)
        extra = 1 if parts[0] == "blocks" and int(parts[1]) in stacked else 0
        return p.ndim + extra >= 2

    return decay


# --------------------------------------------------------------------------
# contiguous caches: prefill and decode
# --------------------------------------------------------------------------


def kind_cache_init(kind: str, batch: int, cap: int, cfg: ModelConfig, *, device) -> dict:
    """One layer's zero decode cache: k and v [B, cap, Hkv, dh] in the
    model's dtype (``"attn"`` and ``"moe"``; ``max(n_image_tokens, 1)``
    rows for ``"cross"``), an empty ring of ``cfg.local_window`` slots
    (``"local"``: every ``pos`` -1), or the recurrent state and conv rows
    of an RG-LRU (``"rglru"``) or SSM (``"ssm"``) layer."""
    dt = DTYPES[cfg.dtype]
    if kind in ("attn", "moe", "local", "cross"):
        n = {"local": cfg.local_window, "cross": max(cfg.n_image_tokens, 1)}.get(kind, cap)
        shape = (batch, n, cfg.n_kv_heads, cfg.head_dim)
        c = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
        if kind == "local":
            c["pos"] = torch.full((n,), -1, dtype=torch.int32, device=device)
        return c
    if kind == "rglru":
        return rglru_cache_init(batch, cfg, dt, device)
    if kind == "ssm":
        return ssm_cache_init(batch, cfg.d_model, cfg.ssm, dt, device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, cap: int, *, device=None) -> list:
    """Zero decode caches, one per layer, for ``batch`` rows of up to
    ``cap`` tokens."""
    device = resolve_device(device)
    return [kind_cache_init(k, batch, cap, cfg, device=device) for k in _model_kinds(cfg)]


def _pad_attn_caches(caches: list, cfg: ModelConfig, cap: int) -> list:
    """Grow the global-attention (and MoE) layers' k and v along the
    sequence to ``cap`` (never shorter: a longer prompt keeps its length);
    local rings keep their window, cross layers their memory's rows."""
    out = []
    for c, kind in zip(caches, cfg.layer_kinds()):
        s = c["k"].shape[1] if kind in ("attn", "moe") else cap
        if s < cap:
            pad = (0, 0, 0, 0, 0, cap - s)
            c = {"k": F.pad(c["k"], pad), "v": F.pad(c["v"], pad)}
        out.append(c)
    return out


def prefill(model: Transformer, tokens, cache_cap: int, *, memory=None, ops: str = "kernel",
            policy=None, n_groups: int = 1):
    """Run the prompts tokens [B, S] (one length: the logits are at the
    last position of every row), the cross layers over ``memory``.
    Returns ``(logits [B, V] f32, caches)``, the attention caches grown to
    ``cache_cap`` positions.  The MoE layers route the B * S tokens with
    capacity, as in training."""
    h, caches = model(tokens, memory=memory, collect_cache=True, ops=ops, policy=policy,
                      n_groups=n_groups)
    return last_token_logits(h[:, -1], model.embed), _pad_attn_caches(caches, model.cfg,
                                                                      cache_cap)


def apply_block_decode(bp: Block | MoEBlock | SSMBlock | RGLRUBlock | CrossBlock, x,
                       cfg: ModelConfig, cache: dict, pos: int, K, kind: str = "attn", *,
                       policy=None, n_groups: int = 1):
    """One block for one new token per row at position ``pos``.  Returns
    ``(x, cache)``: an attention (or MoE) layer's k and v are written at
    ``pos`` in place before attending over ``pos + 1`` positions; a local
    layer's at slot ``pos mod w`` of its ring, in place, with ``pos``
    recorded there, before attending over the slots that hold one of the
    last w positions; a cross layer projects q only and attends over every
    row of its cached memory k and v (kv repeated to every query head, as
    the reference's ``repeat_kv``), its cache unchanged; a recurrent
    layer's cache is new.  An MoE layer routes the B new tokens without
    drops."""
    h = apply_norm(bp.norm1, x, cfg.norm, cfg.norm_eps, K)
    if kind == "ssm":
        out, cache = apply_ssm_decode(bp.mixer, h, cache, cfg.ssm, K)
        return x + out, cache
    if kind == "rglru":
        out, cache = apply_rglru_decode(bp.mixer, h, cache, cfg)
        x = x + out
    elif kind in ("attn", "moe", "local"):
        b = x.shape[0]
        q, k, v = _project_qkv(bp.attn, h, cfg, K)
        posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
        kc, vc = cache["k"], cache["v"]
        slot = pos % cfg.local_window if kind == "local" else pos
        kc[:, slot] = k[:, 0].to(kc.dtype)
        vc[:, slot] = v[:, 0].to(vc.dtype)
        if kind != "local":
            valid = torch.arange(kc.shape[1], device=x.device) <= pos
        else:
            pos_arr = cache["pos"]
            pos_arr[slot] = pos
            # valid = stored position within (pos - w, pos]
            valid = (pos_arr >= 0) & (pos - pos_arr < cfg.local_window) & (pos_arr <= pos)
        g = cfg.n_heads // cfg.n_kv_heads
        ctx = decode_attention(q, repeat_kv(kc, g), repeat_kv(vc, g), valid)
        x = x + ctx.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ bp.attn.wo
    elif kind == "cross":
        b, hq, dh = x.shape[0], cfg.n_heads, cfg.head_dim
        q = (h @ bp.attn.wq).reshape(b, 1, hq, dh)
        kc, vc = cache["k"], cache["v"]
        g = hq // cfg.n_kv_heads
        valid = torch.ones(kc.shape[1], dtype=torch.bool, device=x.device)
        ctx = decode_attention(q, repeat_kv(kc, g), repeat_kv(vc, g), valid)
        out = ctx.reshape(b, 1, hq * dh) @ bp.attn.wo
        x = x + torch.tanh(bp.attn.gate).to(out.dtype) * out
    else:
        raise ValueError(kind)
    h2 = apply_norm(bp.norm2, x, cfg.norm, cfg.norm_eps, K)
    if kind == "moe":
        return x + apply_moe(bp.moe, h2, cfg.moe, n_groups=n_groups, policy=policy,
                             no_drop=True)[0], cache
    return x + apply_mlp(bp.mlp, h2), cache


def decode_step(model: Transformer, caches: list, token, pos: int, *, ops: str = "kernel",
                policy=None, n_groups: int = 1):
    """One new token per row: token [B, 1] at position ``pos``, a Python
    int that every row shares.  Returns ``(logits [B, V] f32, caches)``.

    Raises where ``pos`` is not below a global-attention cache's length:
    JAX's ``dynamic_update_slice`` would clamp the write to the last slot
    and overwrite it.  A local layer's ring wraps, so it takes any
    ``pos``."""
    if isinstance(pos, torch.Tensor):
        raise TypeError("decode_step takes pos as a Python int (the host never reads it back)")
    for c, kind in zip(caches, model.kinds):
        if kind in ("attn", "moe") and not 0 <= pos < c["k"].shape[1]:
            raise ValueError(f"decode_step: position {pos} is outside the attention cache's "
                             f"{c['k'].shape[1]} positions")
    K = _ops(ops)
    cfg = model.cfg
    x = model.embed[token.long()]
    new = []
    for bp, kind, c in zip(model.blocks, model.kinds, caches):
        x, c = apply_block_decode(bp, x, cfg, c, pos, K, kind, policy=policy, n_groups=n_groups)
        new.append(c)
    x = apply_norm(model.final_norm, x, cfg.norm, cfg.norm_eps, K)
    return last_token_logits(x[:, -1], model.embed), new


# --------------------------------------------------------------------------
# paged KV-cache pools (continuous-batching serving)
# --------------------------------------------------------------------------


def init_paged_pools(cfg: ModelConfig, num_pages: int, page_size: int, *, device=None) -> list:
    """One ``{"k", "v"}`` pool pair per layer, ``[num_pages + 1, page_size,
    Hkv, dh]`` zeros in the model's dtype.  ONE page table addresses every
    layer: a request's logical page j lives at the same physical page in
    all of them.  The extra final page (index ``num_pages``) is the scratch
    sink inactive decode slots and padding page-table entries point at; it
    is written but never read unmasked."""
    kinds = paged_kinds(cfg)
    device = resolve_device(device)
    shape = (num_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
    dt = DTYPES[cfg.dtype]
    return [
        {"k": torch.zeros(shape, dtype=dt, device=device),
         "v": torch.zeros(shape, dtype=dt, device=device)}
        for _ in kinds
    ]


def _scatter_pages(pool, cache, page_table, page_size: int) -> None:
    """Write a contiguous prefill cache leaf into pool pages, in place.

    pool ``[P, ps, Hkv, dh]``, cache ``[B, S, Hkv, dh]`` with S a multiple
    of ``page_size``; request b's pages come from ``page_table[b]``.
    Entries past a request's allocation point at the scratch page, which
    absorbs the padding rows (duplicate scratch writes race, but scratch
    content is never read unmasked)."""
    b, s = cache.shape[:2]
    n = s // page_size
    src = cache.reshape(b * n, page_size, *cache.shape[2:]).to(pool.dtype)
    idx = page_table[:, :n].reshape(-1).long()
    pool.index_copy_(0, idx, src)


def scatter_caches_into_pools(caches: list, pools: list, cfg: ModelConfig, page_table,
                              page_size: int) -> list:
    """Move ``forward(collect_cache=True)`` caches into the paged pools (in
    place); returns the pools."""
    paged_kinds(cfg)
    for pool, cache in zip(pools, caches):
        _scatter_pages(pool["k"], cache["k"], page_table, page_size)
        _scatter_pages(pool["v"], cache["v"], page_table, page_size)
    return pools


def apply_block_paged_decode(bp: Block | MoEBlock, x, cfg: ModelConfig, pool: dict, page_table,
                             kv_lens, K, kind: str = "attn", *, policy=None, n_groups: int = 1):
    """One block for one new token per decode slot, KV in paged pools; an
    MoE layer routes the slots' tokens without drops (inactive slots
    included: with no drop they cannot displace an active slot's token).

    Every slot carries its own position (``kv_lens[b]``, the tokens already
    cached).  The new token's k and v go into its slot's current page
    before attending over ``kv_lens + 1`` tokens.  Inactive slots
    (``kv_lens == 0`` with a scratch-page table row) write to and read
    from scratch; their logits are garbage the engine never reads.
    """
    b = x.shape[0]
    h = apply_norm(bp.norm1, x, cfg.norm, cfg.norm_eps, K)
    q, k, v = _project_qkv(bp.attn, h, cfg, K)
    posv = kv_lens[:, None]  # [B, 1] per-slot positions
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    kc, vc = pool["k"], pool["v"]
    p_pool, ps = kc.shape[0], kc.shape[1]
    lens = kv_lens.long()
    page = page_table[torch.arange(b, device=x.device), lens // ps].long()
    flat = page * ps + lens % ps  # [B] slot in the flattened pool
    kc.view(p_pool * ps, *kc.shape[2:]).index_copy_(0, flat, k[:, 0].to(kc.dtype))
    vc.view(p_pool * ps, *vc.shape[2:]).index_copy_(0, flat, v[:, 0].to(vc.dtype))
    ctx = K.paged_attention(q[:, 0].contiguous(), kc, vc, page_table, kv_lens + 1)
    x = x + ctx.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ bp.attn.wo
    h2 = apply_norm(bp.norm2, x, cfg.norm, cfg.norm_eps, K)
    if kind == "moe":
        return x + apply_moe(bp.moe, h2, cfg.moe, n_groups=n_groups, policy=policy,
                             no_drop=True)[0]
    return x + apply_mlp(bp.mlp, h2)


def paged_decode_step(model: Transformer, pools: list, page_table, kv_lens, token, *,
                      ops: str = "kernel", policy=None, n_groups: int = 1):
    """One decode wave over paged pools.  page_table [B, pages_max] int32,
    kv_lens [B] int32, token [B, 1].  Returns ``(logits [B, V] f32,
    pools)``, the pools updated in place."""
    K = _ops(ops)
    cfg = model.cfg
    x = model.embed[token.long()]
    for bp, kind, pool in zip(model.blocks, model.kinds, pools):
        x = apply_block_paged_decode(bp, x, cfg, pool, page_table, kv_lens, K, kind,
                                     policy=policy, n_groups=n_groups)
    x = apply_norm(model.final_norm, x, cfg.norm, cfg.norm_eps, K)
    return last_token_logits(x[:, -1], model.embed), pools


def paged_prefill(model: Transformer, tokens, true_len, page_table, pools: list, *,
                  ops: str = "kernel", policy=None, n_groups: int = 1):
    """Run prompts and scatter their KV into pool pages.

    tokens [B, S_pad] padded to a page multiple; true_len [B] the prompt
    lengths (padding at the end); page_table [B, S_pad / page_size].
    Returns ``(logits at each prompt's last true token [B, V] f32, pools)``.
    Padding rows run causally after the real tokens, so real tokens never
    attend them; their KV lands wherever the page table points (scratch for
    entries past a request's allocation) and is masked by ``kv_lens``
    forever after.  The MoE layers route every row of the padded width with
    capacity, padding included, as the reference does.
    """
    paged_kinds(model.cfg)
    ps = pools[0]["k"].shape[1]
    s = tokens.shape[1]
    if s % ps != 0:
        raise ValueError(f"prompt width {s} not a multiple of page_size {ps}")
    h, caches = model(tokens, collect_cache=True, ops=ops, policy=policy, n_groups=n_groups)
    scatter_caches_into_pools(caches, pools, model.cfg, page_table, ps)
    b = tokens.shape[0]
    last = h[torch.arange(b, device=h.device), true_len.long() - 1]
    return last_token_logits(last, model.embed), pools
