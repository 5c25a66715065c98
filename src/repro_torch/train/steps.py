"""Step functions of the port: the counterpart of ``repro.train.steps`` for
training the mmdit, dense, moe, ssm, hybrid (RecurrentGemma), audio
(MusicGen) and vlm (Llama-3.2-Vision) families and for serving the mmdit
and the LMs.

Diffusion serving needs a denoise step (one velocity evaluation, the unit
of diffusion sampling); LM serving a paged prefill and a paged decode wave
(continuous batching, attention LMs), or a contiguous prefill and decode
step (one batch of equal-length prompts at one position; every LM kind,
and the yardstick paged serving is held to).
Training needs the state, the loss (the rectified-flow loss, or the LM
loss of ``tokens`` against ``labels``, packed windows with their
``segment_ids``, a VLM's batches with their image ``memory``), the pool microbatch's gradient step, the one-batch train
step, and the sequence-parallel step of one packed window split over a
ring of ranks (:func:`make_sp_pool_grad_step`, fed by
``data.packing.split_packed_batch`` shards).

Every step maker but the sequence-parallel ones takes the reference's
``policy`` (``distributed.sharding.ShardingPolicy``): the model calls
``policy.constrain`` at the reference's hook points, and the MoE layers
route in ``policy.n_dispatch_groups`` groups (1 without a policy).

Randomness follows the reference's rule with numpy's ``SeedSequence`` in
place of ``jax.random``: a step key is an integer, and a pool microbatch's
generator is seeded by :func:`fold_in` ``(step_key, pool_index)`` with the
pool enumerated rank-major (``steps.py:94-96``).  The port's draws differ
from JAX's for the same seed, so a parity test injects the JAX draws
through the ``noise`` hook.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.spans import span
from repro_torch.models.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.mmdit import MMDiT, decays, rectified_flow_loss
from repro_torch.optim.adamw import OptimizerConfig, adamw_update, init_opt_state

#: noise hook: (step_key, pool_index, batch) -> injected (t, eps) or None
NoiseHook = Callable[[int, int, dict], "tuple[torch.Tensor, torch.Tensor] | None"]


#: the families the port trains
TRAINED = ("mmdit", "dense", "moe", "ssm", "hybrid", "audio", "vlm")


def _mmdit_only(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "mmdit":
        raise ValueError(f"{what} needs an mmdit config, got {cfg.family!r}")


def _trained(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in TRAINED:
        raise ValueError(
            f"{what}: the port trains the {', '.join(TRAINED)} families, not "
            f"{cfg.name} ({cfg.family!r})"
        )


def decay_rule(cfg: ModelConfig) -> Callable:
    """AdamW's ``decay(name, p)`` predicate for the model of ``cfg``: the
    ``ndim >= 2`` rule in the JAX package's stacked layout."""
    return decays if cfg.family == "mmdit" else T.decays(cfg)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and an integer (``jax.random.fold_in``)."""
    return int(np.random.SeedSequence([key, data]).generate_state(1, np.uint64)[0])


# -- state ---------------------------------------------------------------------


def init_state(cfg: ModelConfig, opt: OptimizerConfig, *, seed: int = 0, device=None) -> dict:
    """``{"model": MMDiT or Transformer, "opt": {"m", "v"}, "step": 0}``;
    the model's parameters are the state's parameters
    (``dict(model.named_parameters())``)."""
    _trained(cfg, "init_state")
    build = MMDiT if cfg.family == "mmdit" else T.Transformer
    model = build(cfg, seed=seed, device=resolve_device(device))
    return {
        "model": model,
        "opt": init_opt_state(dict(model.named_parameters()), opt),
        "step": 0,
    }


# -- train -----------------------------------------------------------------------


def _n_groups(policy) -> int:
    return policy.n_dispatch_groups if policy is not None else 1


def make_loss_fn(cfg: ModelConfig, policy=None) -> Callable:
    """``loss_fn(model, batch, rng, noise=None)``, with blocks recomputed in
    the backward: for the mmdit, the rectified-flow loss of one batch
    (``latents``, ``text`` and optional ``segment_ids`` /
    ``text_segment_ids``), ``rng`` a ``torch.Generator`` and ``noise`` an
    injected ``(t, eps)``; for the LM, ``lm_loss`` of ``tokens`` against
    ``labels`` (the router loss included), scoped per document by the
    optional ``segment_ids`` of a packed batch, the cross layers over the
    batch's ``memory`` (a VLM's; no draws: ``rng`` and ``noise`` are
    unused)."""
    _trained(cfg, "make_loss_fn")
    n_groups = _n_groups(policy)
    if cfg.family != "mmdit":
        def lm_loss_fn(model, batch, rng, noise=None):
            return T.lm_loss(model, batch["tokens"], batch["labels"], memory=batch.get("memory"),
                             segment_ids=batch.get("segment_ids"), policy=policy,
                             n_groups=n_groups)

        return lm_loss_fn

    def loss_fn(model, batch, rng, noise=None):
        t, eps = noise if noise is not None else (None, None)
        return rectified_flow_loss(
            model, batch["latents"], batch["text"], t=t, eps=eps, generator=rng,
            segment_ids=batch.get("segment_ids"),
            text_segment_ids=batch.get("text_segment_ids"), policy=policy,
        )

    return loss_fn


def make_pool_grad_step(cfg: ModelConfig, noise: NoiseHook | None = None, *,
                        policy=None) -> Callable:
    """One pool microbatch's gradient step, shared by every executor:
    ``grad_step(model, batch, step_key, pool_index) -> (loss, grads)`` with
    grads a dict by parameter name in the parameters' dtypes.  The draws
    come from a generator seeded by ``fold_in(step_key, pool_index)``
    unless ``noise`` returns them (mmdit only).  While tracing is on
    (``core.spans``), the loss and the gradient are device-timed
    ``engine.forward`` and ``engine.backward`` spans."""
    loss_fn = make_loss_fn(cfg, policy)
    if noise is not None:
        _mmdit_only(cfg, "the noise hook")

    def grad_step(model, batch, step_key: int, pool_index: int):
        rng = torch.Generator(device=model.device).manual_seed(fold_in(step_key, pool_index))
        injected = noise(step_key, pool_index, batch) if noise is not None else None
        names, params = zip(*model.named_parameters())
        with span("engine.forward", model.device):
            loss = loss_fn(model, batch, rng, injected)
        with span("engine.backward", model.device):
            grads = torch.autograd.grad(loss, params)
        return loss.detach(), dict(zip(names, grads))

    return grad_step


def make_sp_loss_fn(cfg: ModelConfig, group) -> Callable:
    """``loss_fn(model, batch, rng)`` of a sequence-parallel split
    microbatch: the batch holds the ring ``group``'s local shards of ONE
    packed window (``tokens``, ``labels``, ``segment_ids`` and the whole
    window's ``positions``, sliced; a ``LocalRing``'s k shards stacked
    along the batch axis, :func:`sp_batch`).  Returns the mean token loss
    of the local shards; with equal shard widths the mean over the ring is
    the whole window's mean token loss."""
    if cfg.family != "dense":
        raise ValueError(
            f"sequence parallelism supports the dense transformer LM path "
            f"only (got family={cfg.family!r})"
        )

    def loss_fn(model, batch, rng):
        del rng  # the LM path is deterministic given the batch
        return T.lm_loss(model, batch["tokens"], batch["labels"],
                         segment_ids=batch.get("segment_ids"), positions=batch["positions"],
                         seq_group=group)

    return loss_fn


def make_sp_pool_grad_step(cfg: ModelConfig, group) -> Callable:
    """The gradient step of a split microbatch on the ring ``group``:
    ``grad_step(model, batch, step_key, pool_index) -> (loss, grads)``,
    where every rank of the ring returns the same whole-window mean loss
    and its gradient: each rank's loss and grads, summed over the ring and
    divided by k (one ``all_reduce`` each on a ``ProcessRing``; a
    ``LocalRing`` holds every shard and already has the mean).  The
    cross-shard attention terms travel through the ring's backward.  The
    generator is seeded by ``fold_in(step_key, pool_index)`` as in
    :func:`make_pool_grad_step`, so a split entry folds into the pool
    enumeration like an unsplit one."""
    loss_fn = make_sp_loss_fn(cfg, group)

    def grad_step(model, batch, step_key: int, pool_index: int):
        rng = torch.Generator(device=model.device).manual_seed(fold_in(step_key, pool_index))
        names, params = zip(*model.named_parameters())
        loss = loss_fn(model, batch, rng)
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        return group.mean(loss.detach(), grads)

    return grad_step


def sp_batch(shards: list[dict], group, device) -> dict:
    """The batch of ``group``'s local ring ranks from the k shards of
    ``data.packing.split_packed_batch``: rank r's shard for a
    ``ProcessRing``, all k stacked rank-major along the batch axis for a
    ``LocalRing``; numpy or tensors, moved to ``device``."""
    if len(shards) != group.k:
        raise ValueError(f"{len(shards)} shards for a ring of {group.k} ranks")
    local = [shards[r] for r in group.local_ranks]
    return {name: torch.cat([torch.as_tensor(sh[name]) for sh in local], dim=0).to(device)
            for name in local[0]}


def make_train_step(cfg: ModelConfig, opt: OptimizerConfig, policy=None) -> Callable:
    """``train_step(state, batch, rng) -> (state, metrics)``: one batch's
    loss and gradient, then one AdamW update (in place)."""
    loss_fn = make_loss_fn(cfg, policy)
    decay = decay_rule(cfg)

    def train_step(state, batch, rng):
        model = state["model"]
        names, params = zip(*model.named_parameters())
        loss = loss_fn(model, batch, rng)
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        _, _, stats = adamw_update(dict(zip(names, params)), grads, state["opt"],
                                   state["step"], opt, decay=decay)
        state["step"] += 1
        return state, {"loss": loss.detach(), **stats}

    return train_step


# -- serve -----------------------------------------------------------------------


def make_denoise_step(cfg: ModelConfig, policy=None) -> Callable:
    """MMDiT serving: one velocity evaluation, without autograd state.  The
    optional segment ids scope attention per clip so the continuous-batching
    engine can pad mixed clip lengths into one wave (-1 = padding)."""
    _mmdit_only(cfg, "denoise step")

    def denoise_step(model, latents, text, t, segment_ids=None,
                     text_segment_ids=None):
        with torch.inference_mode():
            return model(
                latents, text, t,
                segment_ids=segment_ids, text_segment_ids=text_segment_ids, policy=policy,
            )

    return denoise_step


def _lm_only(cfg: ModelConfig, what: str) -> None:
    if cfg.family == "mmdit":
        raise ValueError(f"{what} needs an LM config, got {cfg.family!r}")


def make_prefill_step(cfg: ModelConfig, cache_cap: int, policy=None) -> Callable:
    """Contiguous prefill without autograd state: run the prompts [B, S]
    (one length), a VLM's cross layers over ``memory``, and return
    ``(logits at the last position [B, V] f32, caches)``, the attention
    caches grown to ``cache_cap`` positions."""
    _lm_only(cfg, "prefill")
    n_groups = _n_groups(policy)

    def prefill_step(model, tokens, memory=None):
        with torch.inference_mode():
            return T.prefill(model, tokens, cache_cap, memory=memory, policy=policy,
                             n_groups=n_groups)

    return prefill_step


def make_decode_step(cfg: ModelConfig, policy=None) -> Callable:
    """One contiguous decode step without autograd state: token [B, 1] at
    position ``pos`` (a Python int every row shares).  Returns ``(logits
    [B, V] f32, caches)``, the attention caches updated in place."""
    _lm_only(cfg, "decode")
    n_groups = _n_groups(policy)

    def decode_step(model, caches, token, pos: int):
        with torch.inference_mode():
            return T.decode_step(model, caches, token, pos, policy=policy, n_groups=n_groups)

    return decode_step


def make_paged_prefill_step(cfg: ModelConfig, policy=None) -> Callable:
    """Prefill into paged KV pools (continuous-batching serving), without
    autograd state: run the padded prompts, scatter their caches into pool
    pages, and return the logits at each request's true last token."""
    _lm_only(cfg, "paged prefill")
    n_groups = _n_groups(policy)

    def paged_prefill_step(model, tokens, true_len, page_table, pools):
        with torch.inference_mode():
            return T.paged_prefill(model, tokens, true_len, page_table, pools, policy=policy,
                                   n_groups=n_groups)

    return paged_prefill_step


def make_paged_decode_step(cfg: ModelConfig, policy=None) -> Callable:
    """One decode wave over paged pools, without autograd state: every slot
    carries its own position (``kv_lens``), so one step serves requests at
    mixed depths, the iteration unit of continuous batching."""
    _lm_only(cfg, "paged decode")
    n_groups = _n_groups(policy)

    def paged_decode_step(model, pools, page_table, kv_lens, token):
        with torch.inference_mode():
            return T.paged_decode_step(model, pools, page_table, kv_lens, token, policy=policy,
                                       n_groups=n_groups)

    return paged_decode_step
