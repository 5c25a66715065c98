"""Parameters of the JAX MMDiT -> state of the port's :class:`MMDiT`.

``from_jax_params`` takes the JAX parameter tree as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``) and returns a state dict for
``MMDiT.load_state_dict``:

* nested keys join with ``.`` (``blocks/mlp/w1`` -> ``blocks.<i>.mlp.w1``),
* the stacked per-layer ``blocks`` axis (``repro.models.mmdit.init_params``
  stacks blocks with ``vmap``) is split into one entry per layer,
* every weight keeps its ``[d_in, d_out]`` layout: the port applies
  projections as ``x @ w`` exactly as the JAX model does, so nothing is
  transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

from .models.config import ModelConfig


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def from_jax_params(params_np: dict, cfg: ModelConfig, *, device=None) -> dict:
    """The JAX MMDiT parameter tree (numpy leaves) as the port's state dict."""
    device = resolve_device(device)
    state = {}
    for name, leaf in _flatten(params_np):
        if name.startswith("blocks."):
            if leaf.shape[0] != cfg.n_layers:
                raise ValueError(
                    f"{name}: stacked axis {leaf.shape[0]} != n_layers {cfg.n_layers}"
                )
            rest = name[len("blocks."):]
            for i in range(cfg.n_layers):
                state[f"blocks.{i}.{rest}"] = _to_torch(leaf[i], device)
        else:
            state[name] = _to_torch(leaf, device)
    return state
