"""Parameters and optimizer state between the JAX models and the port.

``from_jax_params`` takes the JAX parameter tree as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``) and returns a state dict for the
port's module (``MMDiT`` or ``Transformer``) ``load_state_dict``:

* nested keys join with ``.`` (``blocks/mlp/w1`` -> ``blocks.<i>.mlp.w1``),
* the MMDiT's stacked per-layer ``blocks`` axis (``repro.models.mmdit
  .init_params`` stacks blocks with ``vmap``) is split into one entry per
  layer;
* the LM's tree (``repro.models.transformer.init_params``) keeps the layer
  plan of ``cfg.superblocks()``: unrolled ``lead`` and ``tail`` lists and
  ``blocks.s<i>.*`` stacked over ``n_rep`` superblocks; layer ``len(lead)
  + r * len(pattern) + i`` of the port is ``blocks.s<i>`` entry r, and the
  lists take the layers before and after (attention blocks and Mamba-2
  blocks, whose ``mixer.*`` leaves map like any other);
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

from .models.config import ModelConfig, lm_layers


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
    """The JAX parameter tree (numpy leaves) as the port's state dict."""
    device = resolve_device(device)
    state = {}
    if cfg.family != "mmdit":
        top = {k: v for k, v in params_np.items() if k not in ("lead", "tail", "blocks")}
        for name, leaf in _flatten(top):
            state[name] = _to_torch(leaf, device)
        for layer, (where, j) in enumerate(lm_layers(cfg)):
            if where in ("lead", "tail"):
                for name, leaf in _flatten(params_np[where][j]):
                    state[f"blocks.{layer}.{name}"] = _to_torch(leaf, device)
            else:
                for name, leaf in _flatten(params_np["blocks"][where]):
                    state[f"blocks.{layer}.{name}"] = _to_torch(leaf[j], device)
        return state
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
    a leading ``n_layers`` axis (MMDiT), or placed in the LM's ``lead`` /
    ``blocks.s<i>`` / ``tail`` layout.  bf16 comes back as f32 (numpy has
    no bf16), which holds every bf16 value exactly."""
    tree: dict = {}
    stacked: dict = {}
    for name, t in tensors.items():
        a = t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            stacked.setdefault(rest, {})[int(i)] = a
        else:
            _insert(tree, name, a)
    if cfg.family != "mmdit":
        return _lm_tree(tree, stacked, cfg)
    for rest, by_layer in stacked.items():
        if sorted(by_layer) != list(range(cfg.n_layers)):
            raise ValueError(f"blocks.*.{rest}: layers {sorted(by_layer)} != {cfg.n_layers}")
        _insert(tree, "blocks." + rest, np.stack([by_layer[i] for i in range(cfg.n_layers)]))
    return tree


def _lm_tree(tree: dict, stacked: dict, cfg: ModelConfig) -> dict:
    places = lm_layers(cfg)
    tree["lead"] = [{} for where, _ in places if where == "lead"]
    tree["tail"] = [{} for where, _ in places if where == "tail"]
    tree["blocks"] = {}
    for rest, by_layer in stacked.items():
        if sorted(by_layer) != list(range(len(places))):
            raise ValueError(f"blocks.*.{rest}: layers {sorted(by_layer)} != {len(places)}")
        reps: dict = {}
        for layer, (where, j) in enumerate(places):
            if where in ("lead", "tail"):
                _insert(tree[where][j], rest, by_layer[layer])
            else:
                reps.setdefault(where, []).append(by_layer[layer])
        for where, leaves in reps.items():  # appended in superblock order
            _insert(tree["blocks"], f"{where}.{rest}", np.stack(leaves))
    return tree


def _insert(tree: dict, name: str, leaf) -> None:
    *path, last = name.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[last] = leaf
