"""Mixture-of-Experts layer (``repro.models.moe``): top-k routing with
sort-based capacity dispatch, the expert products as batched matrix
products, and a shared expert.

Tokens are split into ``n_groups`` dispatch groups (the sharding policy's
``n_dispatch_groups``, 1 without a policy).  Each group routes its own ``t_loc``
tokens: a softmax over the f32 router logits, the top-k experts, weights
renormalised over the k; the ``t_loc * k`` assignments (flattened as
``t * k + j``) are sorted by expert with a stable sort and ranked within
each expert, and an assignment ranked at or past the capacity ``C`` is
dropped (capacity-factor MoE, GShard / Switch).  The kept ones fill the
group's ``[E * C, d]`` buffer, the experts run ``silu(x w1) * (x w3)``
then ``w2`` over ``[E, G * C, d]`` at once, and each token sums its k
outputs weighted by their probabilities.  ``no_drop`` sizes ``C`` at
``t_loc * k``, the most one expert can receive, so nothing drops (the
decode paths).  The auxiliary loss is Switch's ``E * sum_e f_e P_e``, with
``f`` counted from the top-k choices of every group before any drop.
With a ``policy``, the token groups, the gathered stream, the expert
buffer, the experts' operand and output and the combine's gather go
through ``policy.constrain`` in the reference's shapes.

Every shape is fixed by the input's shape and the config, and nothing is
read back to the host: no boolean indexing, no ``nonzero``.  The one
difference from the reference is where a dropped assignment goes.  The
reference scatter-adds it, weighted by zero, into its expert's slot
``C - 1`` (``unique_indices=True``, while several share that slot); here
the kept assignments are copied into their slots (unique) and the dropped
ones into one scratch row past the buffer, which the experts never read.
The buffer's values are the reference's, and no slot a kernel reads
depends on the order of a parallel write.  The combine gathers at the
reference's clamped slot with the reference's zero weight, so its
backward adds exact zeros besides the one kept contribution of a slot.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import MoEConfig
from .layers import MLP, apply_mlp, dense_init

#: values of one f32 draw when the expert weights are made (bounds the
#: temporary of a 5.6 G-value leaf to 1 GiB)
DRAW_VALUES = 2**28


def _expert_init(gen: torch.Generator, shape: tuple[int, int, int], scale: float, dtype,
                 device) -> nn.Parameter:
    """N(0, 1) * scale weights ``[E, d_in, d_out]``, drawn in f32 from
    ``gen`` a few experts at a time and stored in ``dtype``."""
    w = torch.empty(shape, dtype=dtype, device=device)
    if w.device.type == "meta":  # shapes only: nothing is drawn
        return nn.Parameter(w)
    step = max(1, DRAW_VALUES // (shape[1] * shape[2]))
    for i in range(0, shape[0], step):
        n = min(step, shape[0] - i)
        draw = torch.randn((n, *shape[1:]), generator=gen, dtype=torch.float32, device=device)
        w[i : i + n] = (draw * scale).to(dtype)
    return nn.Parameter(w)


class MoE(nn.Module):
    """MoE parameters (``moe_params``): ``router`` [d, E] f32, the experts'
    ``w1`` and ``w3`` [E, d, f] and ``w2`` [E, f, d] in the model's dtype,
    and with ``n_shared`` a ``shared`` SwiGLU MLP of width ``n_shared * f``."""

    def __init__(self, d: int, cfg: MoEConfig, gen: torch.Generator, dtype, device):
        super().__init__()
        e, f = cfg.n_experts, cfg.d_expert
        self.router = dense_init(gen, d, e, torch.float32, device)
        self.w1 = _expert_init(gen, (e, d, f), d**-0.5, dtype, device)
        self.w3 = _expert_init(gen, (e, d, f), d**-0.5, dtype, device)
        self.w2 = _expert_init(gen, (e, f, d), f**-0.5, dtype, device)
        if cfg.n_shared > 0:
            self.shared = MLP(gen, d, cfg.n_shared * f, dtype, device)


def capacity(t_loc: int, cfg: MoEConfig, *, no_drop: bool = False) -> int:
    """Slots an expert has in a group of ``t_loc`` tokens: ``max(k,
    int(t_loc k / E * capacity_factor + 0.999))`` in the reference's Python
    float arithmetic, or ``t_loc * k`` with ``no_drop``."""
    if no_drop:
        return t_loc * cfg.top_k
    return max(cfg.top_k, int(t_loc * cfg.top_k / cfg.n_experts * cfg.capacity_factor + 0.999))


def _group_rank(sorted_e):
    """[G, N] expert ids sorted along N -> each element's rank within its
    run of equal ids (index minus the run's first index)."""
    n = sorted_e.shape[1]
    idx = torch.arange(n, device=sorted_e.device).expand_as(sorted_e)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    return idx - torch.cummax(torch.where(is_start, idx, 0), dim=1).values


def route(logits, cfg: MoEConfig, cap: int):
    """Routing of every group: logits [G, T, E] -> ``(slot, keep, top_p,
    probs, top_e)``: ``slot`` [G, T k] int64 (expert * cap + rank, the rank
    clamped to cap - 1), ``keep`` [G, T k] (rank < cap), ``top_p`` and
    ``top_e`` [G, T, k], ``probs`` [G, T, E] f32.  The top k come from a
    stable descending sort, so equal probabilities keep the lower expert
    first, as ``jax.lax.top_k`` does."""
    g = logits.shape[0]
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., : cfg.top_k], top_e[..., : cfg.top_k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_e.reshape(g, -1)
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    ranks = torch.empty_like(flat_e).scatter_(1, order, _group_rank(sorted_e))
    keep = ranks < cap
    slot = flat_e * cap + ranks.clamp(max=cap - 1)
    return slot, keep, top_p, probs, top_e


def aux_load_balance_loss(probs, top_e, n_experts: int):
    """Switch's load-balancing loss ``E * sum_e f_e P_e``: f the share of
    the top-k choices on each expert, P the mean router probability."""
    flat = top_e.reshape(-1)
    f = torch.zeros(n_experts, dtype=torch.float32, device=probs.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=probs.device))
    f = f / f.sum().clamp_min(1.0)
    return n_experts * (f * probs.reshape(-1, n_experts).mean(dim=0)).sum()


def apply_moe(p: MoE, x, cfg: MoEConfig, *, n_groups: int = 1, policy=None,
              no_drop: bool = False):
    """x [B, S, d] -> ``(y [B, S, d] in x's dtype, aux f32 scalar)``.

    ``n_groups`` must divide B * S; ``no_drop`` keeps every assignment."""
    def hook(t, kind):
        return t if policy is None else policy.constrain(t, kind)

    b, s, d = x.shape
    if (b * s) % n_groups:
        raise ValueError(f"{b * s} tokens not divisible into {n_groups} groups")
    t_loc = b * s // n_groups
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(t_loc, cfg, no_drop=no_drop)
    ec, tk = e * cap, t_loc * k
    xg = hook(x.reshape(n_groups, t_loc, d), "moe_tokens")
    # the product in x's dtype, then lifted: the router's gradient chain
    # stays in x's dtype, as in the reference
    logits = (xg @ p.router.to(x.dtype)).float()
    slot, keep, top_p, probs, top_e = route(logits, cfg, cap)

    # dispatch: assignment t*k + j carries token t; kept ones land in their
    # group's slot, dropped ones in the scratch row n_groups * ec
    gathered = hook(xg[:, :, None, :].expand(n_groups, t_loc, k, d).reshape(n_groups, tk, d),
                    "moe_gathered").reshape(n_groups * tk, d)
    base = torch.arange(n_groups, device=x.device)[:, None] * ec
    dest = torch.where(keep, slot + base, n_groups * ec).reshape(-1)
    buf = x.new_zeros(n_groups * ec + 1, d).index_copy(0, dest, gathered)

    # the experts over every group's slots at once: [E, G*C, d] x [E, d, f]
    buf = hook(buf[: n_groups * ec].view(n_groups, e, cap, d), "moe_buffer")
    bufe = hook(buf.transpose(0, 1).reshape(e, n_groups * cap, d), "moe_expert_tokens")
    h = F.silu(torch.matmul(bufe, p.w1)) * torch.matmul(bufe, p.w3)
    out = hook(torch.matmul(h, p.w2).view(e, n_groups, cap, d).transpose(0, 1), "moe_buffer")
    out = out.reshape(n_groups * ec, d)

    # combine: each assignment's output, weighted, summed over k in x's dtype
    back = hook(out.index_select(0, (slot + base).reshape(-1)).view(n_groups, tk, d),
                "moe_gathered")
    w = (top_p.reshape(n_groups, tk) * keep).to(x.dtype)
    y = (back * w[..., None]).view(n_groups, t_loc, k, d).sum(dim=2).reshape(b, s, d)

    aux = aux_load_balance_loss(probs, top_e, e)
    if cfg.n_shared > 0:
        y = y + apply_mlp(p.shared, x)
    return y.to(x.dtype), aux
