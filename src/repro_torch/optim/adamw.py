"""AdamW with configurable state dtype and global-norm clipping: the
counterpart of ``repro.optim.adamw``.

Parameters, gradients and moments are dicts keyed by parameter name
(``dict(model.named_parameters())``).  The rules are the reference's:

* the gradient is clipped to ``clip_norm`` by its global f32 norm;
* bias correction uses ``step + 1``;
* weight decay applies to tensors of two or more dimensions only, judged by
  the ``decay`` predicate (default ``p.ndim >= 2``; the MMDiT passes its
  stacked-layout rule, :func:`repro_torch.models.mmdit.decays`);
* moments are stored in ``state_dtype``; the update runs in f32 and the
  parameter is cast back to its dtype;
* a leaf of more than ``CHUNK_THRESHOLD_ELEMS`` values is updated a block
  of leading-axis rows at a time, as the reference maps its update over
  the leading axis: each element's arithmetic is the same, and the f32
  temporaries are a block's (256 MiB each), not the leaf's (an MoE
  layer's ``w1`` of 671 M values, an embedding of 1 G).  Its squares are
  summed into the global norm by block too (that sum's order differs).
  On ``meta`` tensors (the dry run), where nothing is computed, one block
  of each shape stands for the rest.

Unlike the JAX version, the update is in place: the parameters and moments
of the arguments are overwritten (and returned), so a 1.3B model's state is
never held twice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .schedule import get_schedule

#: leaves above this many values are updated by blocks of leading-axis rows
#: (the reference's ``CHUNK_THRESHOLD_ELEMS``)
CHUNK_THRESHOLD_ELEMS = 64 * 2**20


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"  # constant | cosine | wsd
    warmup: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"

    def schedule_fn(self) -> Callable:
        return get_schedule(self.schedule, self.peak_lr, self.warmup, self.total_steps)


def init_opt_state(params: dict, config: OptimizerConfig) -> dict:
    dt = getattr(torch, config.state_dtype)
    return {
        "m": {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in params.items()},
    }


def _blocks(t: torch.Tensor):
    """``t`` whole, or for a leaf above the threshold, views of blocks of
    its leading-axis rows holding at most the threshold's values each."""
    if t.numel() <= CHUNK_THRESHOLD_ELEMS or t.ndim < 2 or t.shape[0] <= 1:
        return [t]
    rows = max(1, CHUNK_THRESHOLD_ELEMS // (t.numel() // t.shape[0]))
    blocks = list(torch.split(t, rows))
    if t.device.type == "meta":
        # shapes only (the dry run's trace): every block but the last has
        # the first's shape, so one of each shape makes the same temporaries
        return blocks[:1] + [b for b in blocks[-1:] if b.shape != blocks[0].shape]
    return blocks


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(b.float().square().sum() for g in tree.values() for b in _blocks(g)))


def _ndim_decays(name: str, p) -> bool:
    return p.ndim >= 2


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict, step: int,
                 config: OptimizerConfig, decay: Callable[[str, torch.Tensor], bool] | None = None):
    """One AdamW step, in place.  Returns ``(params, opt_state, stats)``
    with ``stats = {"grad_norm": tensor, "lr": float}``."""
    decay = decay or _ndim_decays
    lr = config.schedule_fn()(step)
    gnorm = global_norm(grads)
    clip = torch.clamp(config.clip_norm / gnorm.clamp_min(1e-9), max=1.0)
    stepf = step + 1.0
    bc1 = 1.0 - config.beta1**stepf
    bc2 = 1.0 - config.beta2**stepf
    for name, p in params.items():
        decays = decay(name, p)
        for pb, gb, m, v in zip(_blocks(p), _blocks(grads[name]), _blocks(opt_state["m"][name]),
                                _blocks(opt_state["v"][name])):
            gf = gb.float() * clip
            mf = config.beta1 * m.float() + (1 - config.beta1) * gf
            vf = config.beta2 * v.float() + (1 - config.beta2) * gf * gf
            delta = (mf / bc1) / (torch.sqrt(vf / bc2) + config.eps)
            pf = pb.float()
            if decays:
                delta = delta + config.weight_decay * pf
            pb.copy_(pf - lr * delta)
            m.copy_(mf)
            v.copy_(vf)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
