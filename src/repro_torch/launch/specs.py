"""Meta-device stand-ins for every (arch x shape) dry-run cell: the
counterpart of ``repro.launch.specs``.

Everything here is shape-only: the step's arguments as ``meta`` tensors at
their global shapes (the model and its AdamW moments built on ``meta``,
where nothing is drawn), with the VLM's image ``memory`` where the
reference adds it, and beside them the policy's DTensor placements for
every tensor argument, in the same structure.  Arguments that the port
passes as Python values (the train step's ``step`` and generator, the
decode step's ``pos``) have no placements (``None``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.distributed.sharding import ShardingPolicy, placements, sanitize_spec, spec
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DTYPES
from repro_torch.models.mmdit import TEXT_DIM, MMDiT
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.steps import init_state

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _placed(policy: ShardingPolicy, shape, spec_) -> tuple:
    return placements(sanitize_spec(shape, spec_, policy.mesh), policy.mesh)


def param_placements(policy: ShardingPolicy, params) -> dict:
    """The placements of each of a model's parameters (or of a moment's
    tensors), by name."""
    return {n: placements(s, policy.mesh) for n, s in policy.param_sharding(params).items()}


def _model(cfg: ModelConfig):
    return (MMDiT if cfg.family == "mmdit" else T.Transformer)(cfg, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, policy: ShardingPolicy):
    """Training-batch stand-ins + placements."""
    b, s = shape.global_batch, shape.seq_len
    bx = tuple(policy.batch_axes)
    dt = DTYPES[cfg.dtype]
    if cfg.family == "mmdit":
        shapes = {"latents": (b, s, cfg.in_channels * 4), "text": (b, cfg.text_len, TEXT_DIM)}
        batch = {k: _meta(v, dt) for k, v in shapes.items()}
        return batch, {k: _placed(policy, v, spec(bx, None, None)) for k, v in shapes.items()}
    batch = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32)}
    pls = {k: _placed(policy, (b, s), spec(bx, None)) for k in batch}
    if cfg.family == "vlm":
        mshape = (b, cfg.n_image_tokens, cfg.d_model)
        batch["memory"] = _meta(mshape, dt)
        pls["memory"] = _placed(policy, mshape, spec(bx, None, None))
    return batch, pls


def train_specs(cfg: ModelConfig, shape: ShapeSpec, policy: ShardingPolicy,
                opt: OptimizerConfig | None = None):
    """``((state, batch, rng), (state placements, batch placements, None),
    opt)``: the state of ``train.steps.init_state`` on ``meta`` (``step``
    a Python int), and no generator (``rng`` None: on ``meta`` nothing is
    drawn)."""
    opt = opt or OptimizerConfig(state_dtype=cfg.opt_state_dtype)
    state = init_state(cfg, opt, device=META)
    pp = param_placements(policy, state["model"])
    st_pl = {"params": pp, "opt": {"m": pp, "v": pp}, "step": None}
    batch, batch_pl = batch_specs(cfg, shape, policy)
    return (state, batch, None), (st_pl, batch_pl, None), opt


def prefill_specs(cfg: ModelConfig, shape: ShapeSpec, policy: ShardingPolicy):
    """``((model, tokens[, memory]), placements)``."""
    b, s = shape.global_batch, shape.seq_len
    bx = tuple(policy.batch_axes)
    model = _model(cfg)
    args = [model, _meta((b, s), torch.int32)]
    pls = [param_placements(policy, model), _placed(policy, (b, s), spec(bx, None))]
    if cfg.family == "vlm":
        mshape = (b, cfg.n_image_tokens, cfg.d_model)
        args.append(_meta(mshape, DTYPES[cfg.dtype]))
        pls.append(_placed(policy, mshape, spec(bx, None, None)))
    return tuple(args), tuple(pls)


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, policy: ShardingPolicy):
    """``((model, caches, token, pos), placements)``: caches of
    ``shape.seq_len`` positions, and ``pos`` the last of them (a Python
    int, as ``transformer.decode_step`` takes it)."""
    b, cap = shape.global_batch, shape.seq_len
    bx = tuple(policy.batch_axes)
    model = _model(cfg)
    caches = T.init_cache(cfg, b, cap, device=META)
    c_pl = [{k: placements(s, policy.mesh) for k, s in layer.items()}
            for layer in policy.cache_sharding(caches)]
    token = _meta((b, 1), torch.int32)
    args = (model, caches, token, cap - 1)
    pls = (param_placements(policy, model), c_pl, _placed(policy, (b, 1), spec(bx, None)), None)
    return args, pls


__all__ = ["batch_specs", "decode_specs", "param_placements", "prefill_specs", "train_specs"]
