"""Parameters and optimizer state between the JAX MMDiT and the port.

``from_jax_params`` takes the JAX parameter tree as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``) and returns a state dict for
``MMDiT.load_state_dict``:

* nested keys join with ``.`` (``blocks/mlp/w1`` -> ``blocks.<i>.mlp.w1``),
* the stacked per-layer ``blocks`` axis (``repro.models.mmdit.init_params``
  stacks blocks with ``vmap``) is split into one entry per layer,
* every weight keeps its ``[d_in, d_out]`` layout: the port applies
  projections as ``x @ w`` exactly as the JAX model does, so nothing is
  transposed.

``from_jax_opt_state`` does the same for the AdamW moments (``{"m", "v"}``
trees), and ``to_numpy`` goes back: the port's tensors by name -> the JAX
tree of numpy arrays, with the per-layer entries stacked again, so a test
compares parameter trees leaf by leaf.
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


def from_jax_opt_state(opt_np: dict, cfg: ModelConfig, *, device=None) -> dict:
    """The JAX AdamW state ``{"m": tree, "v": tree}`` (numpy leaves) as the
    port's ``{"m": {name: tensor}, "v": {name: tensor}}``."""
    return {k: from_jax_params(opt_np[k], cfg, device=device) for k in ("m", "v")}


def to_numpy(tensors: dict, cfg: ModelConfig) -> dict:
    """Tensors by parameter name (a state dict, gradients, a moment) as the
    JAX tree of numpy arrays: per-layer ``blocks.<i>.*`` entries stacked on
    a leading ``n_layers`` axis.  bf16 comes back as f32 (numpy has no
    bf16), which holds every bf16 value exactly."""
    tree: dict = {}
    stacked: dict = {}
    for name, t in tensors.items():
        a = t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            stacked.setdefault(rest, {})[int(i)] = a
        else:
            _insert(tree, name, a)
    for rest, by_layer in stacked.items():
        if sorted(by_layer) != list(range(cfg.n_layers)):
            raise ValueError(f"blocks.*.{rest}: layers {sorted(by_layer)} != {cfg.n_layers}")
        _insert(tree, "blocks." + rest, np.stack([by_layer[i] for i in range(cfg.n_layers)]))
    return tree


def _insert(tree: dict, name: str, leaf) -> None:
    *path, last = name.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[last] = leaf
