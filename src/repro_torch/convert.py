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
  lists take the layers before and after (Kimi-K2's dense first layer
  leads its MoE layers); every kind's leaves map alike, each in its own
  dtype (the RG-LRU's ``lam`` and the MoE ``router`` stay f32; the
  experts' ``moe.w1`` / ``w3`` [E, d, f] and ``w2`` [E, f, d] are stacked
  to [n_rep, E, ...] like any other leaf);
* every weight keeps its ``[d_in, d_out]`` layout: the port applies
  projections as ``x @ w`` exactly as the JAX model does, so nothing is
  transposed.

``from_jax_opt_state`` does the same for the AdamW moments (``{"m", "v"}``
trees), and ``to_numpy`` goes back: the port's tensors by name -> the JAX
tree of numpy arrays, with the per-layer entries stacked again, so a test
compares parameter trees leaf by leaf.  ``jax_keys`` names the JAX leaf
(its ``/``-joined tree path, the checkpoint store's key) and the stacked
index of each of the port's parameters, with no copy of their data.

``caches_from_jax`` and ``caches_to_numpy`` carry the LM's decode caches
(``repro.models.transformer.init_cache`` / ``prefill`` / ``decode_step``)
across the same way: the JAX ``lead`` / ``blocks.s<i>`` (stacked over
``n_rep``) / ``tail`` tree against the port's list of one cache dict a
layer, leaves in their own dtypes (bf16 as raw bits with ``keep_dtype``;
a local layer's int32 ring positions ``pos`` [w], stacked to [n_rep, w]).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

from .models.config import ModelConfig, lm_layers


#: bf16 as numpy holds it without ml_dtypes: the raw bits in a 2-byte void
#: dtype, the kind ("V") ml_dtypes' bfloat16 has too
BF16_BITS = np.dtype("V2")


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16" or a.dtype == BF16_BITS:
        # ml_dtypes' bfloat16 or to_numpy's kept bits: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy_leaf(t: torch.Tensor, *, keep_dtype: bool = False) -> np.ndarray:
    """One tensor on the host.  bf16 widens to f32 (which holds every bf16
    value exactly), or with ``keep_dtype`` comes back as its raw bits in
    :data:`BF16_BITS`: numpy has no bf16, and a checkpoint must keep the
    leaf's dtype."""
    t = t.detach()
    if t.dtype != torch.bfloat16:
        return t.cpu().numpy()
    if keep_dtype:
        return t.cpu().view(torch.int16).numpy().view(BF16_BITS)
    return t.float().cpu().numpy()


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


def jax_keys(names, cfg: ModelConfig) -> dict[str, tuple[str, int | None]]:
    """For each of the port's parameter names, the JAX tree path of its leaf
    (``/``-joined, as ``repro.checkpoint.store`` keys leaves) and its index
    on the leaf's stacked axis, ``None`` where the leaf is not stacked: the
    MMDiT's ``blocks/*`` over its layers, the LM's ``blocks/s<i>/*`` over
    its superblocks, its ``lead/<j>/*`` and ``tail/<j>/*`` one a layer."""
    places = lm_layers(cfg) if cfg.family != "mmdit" else None
    out = {}
    for name in names:
        if not name.startswith("blocks."):
            out[name] = (name.replace(".", "/"), None)
            continue
        _, i, rest = name.split(".", 2)
        rest = rest.replace(".", "/")
        if places is None:
            out[name] = (f"blocks/{rest}", int(i))
            continue
        where, j = places[int(i)]
        if where in ("lead", "tail"):
            out[name] = (f"{where}/{j}/{rest}", None)
        else:
            out[name] = (f"blocks/{where}/{rest}", j)
    return out


def _stack_len(cfg: ModelConfig) -> int:
    """The length of every stacked axis: layers (MMDiT) or superblocks (LM)."""
    return cfg.n_layers if cfg.family == "mmdit" else cfg.superblocks()[2]


def to_numpy(tensors: dict, cfg: ModelConfig, *, keep_dtype: bool = False) -> dict:
    """Tensors by parameter name (a state dict, gradients, a moment) as the
    JAX tree of numpy arrays: per-layer ``blocks.<i>.*`` entries stacked on
    a leading ``n_layers`` axis (MMDiT), or placed in the LM's ``lead`` /
    ``blocks.s<i>`` / ``tail`` layout (:func:`jax_keys`).  bf16 comes back
    as f32, or with ``keep_dtype`` as its bits (:func:`to_numpy_leaf`)."""
    parts: dict = {}
    for name, (key, idx) in jax_keys(tensors, cfg).items():
        parts.setdefault(key, {})[idx] = to_numpy_leaf(tensors[name], keep_dtype=keep_dtype)
    tree: dict = {}
    if cfg.family != "mmdit":
        places = lm_layers(cfg)
        tree["lead"] = [{} for where, _ in places if where == "lead"]
        tree["tail"] = [{} for where, _ in places if where == "tail"]
        tree["blocks"] = {}
    n = _stack_len(cfg)
    for key, by_index in parts.items():
        if None in by_index:
            _insert(tree, key, by_index[None])
            continue
        if sorted(by_index) != list(range(n)):
            raise ValueError(f"{key}: stacked entries {sorted(by_index)} != {n}")
        _insert(tree, key, np.stack([by_index[i] for i in range(n)]))
    return tree


def _insert(tree, key: str, leaf) -> None:
    *path, last = key.split("/")
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree.setdefault(k, {})
    tree[last] = leaf


def caches_from_jax(cache_np: dict, cfg: ModelConfig, *, device=None) -> list:
    """The JAX LM's cache tree (numpy leaves) as the port's per-layer list
    (``repro_torch.models.transformer.init_cache``'s layout)."""
    device = resolve_device(device)
    caches = []
    for where, j in lm_layers(cfg):
        if where in ("lead", "tail"):
            caches.append({k: _to_torch(v, device) for k, v in cache_np[where][j].items()})
        else:
            caches.append({k: _to_torch(v[j], device)
                           for k, v in cache_np["blocks"][where].items()})
    return caches


def caches_to_numpy(caches: list, cfg: ModelConfig, *, keep_dtype: bool = False) -> dict:
    """The port's per-layer caches as the JAX LM's cache tree of numpy
    arrays, the superblocks' leaves stacked again (bf16 as in
    :func:`to_numpy_leaf`)."""
    tree: dict = {"lead": [], "tail": [], "blocks": {}}
    stacked: dict = {}
    for (where, _), cache in zip(lm_layers(cfg), caches):
        leaf = {k: to_numpy_leaf(v, keep_dtype=keep_dtype) for k, v in cache.items()}
        if where in ("lead", "tail"):
            tree[where].append(leaf)
        else:
            stacked.setdefault(where, []).append(leaf)
    for where, leaves in stacked.items():
        tree["blocks"][where] = {k: np.stack([leaf[k] for leaf in leaves]) for k in leaves[0]}
    return tree
