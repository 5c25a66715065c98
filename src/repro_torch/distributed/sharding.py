"""Divisibility-aware sharding rules for all assigned architectures: the
counterpart of ``repro.distributed.sharding``.

The production mesh is ``("data", "model")`` (single pod, 16x16) or
``("pod", "data", "model")`` (2x16x16).  Batch/FSDP dims shard over
``batch_axes`` (("pod","data") when the pod axis exists); tensor/expert
parallelism uses the ``model`` axis.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), an
axis name, or a tuple of axis names (a 1-tuple reads as its name, as a JAX
``PartitionSpec`` normalises it).  Policies are *best-effort*: every rule
is sanitized against the actual dim sizes, so a dim that an axis doesn't
divide falls back to replicated on that dim.  This is what makes one rule
table serve head counts like 36 and 40 (non-divisible by 16): those archs
drop head-sharding and the attention constraint switches to sequence
parallelism instead.

The policy reads only the mesh's axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names`` and
``shape``) or any object with a ``shape`` mapping axis -> size and
``axis_names``.  What needs a real mesh is the rest:

* :func:`placements` turns a spec into DTensor placements, ``Shard(dim)``
  on each mesh dim a tensor dim names and ``Replicate()`` elsewhere;
* :func:`distribute_state` places a train state's parameters and moments
  as DTensors (the dry run reads their exact local shapes);
* :meth:`ShardingPolicy.constrain` redistributes a DTensor to the hook's
  spec.  A plain tensor passes through only on a mesh of one device,
  which is what ``with_sharding_constraint`` does there; on a larger mesh
  it raises, so a multi-device constraint is never silently dropped.

Parameters are named by their JAX leaf path (``convert.jax_keys``): the
rule table keys on it, and a stacked leaf's leading ``None`` (the
reference's scan axis) is dropped, since the port keeps one tensor a layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.convert import jax_keys
from repro_torch.models.config import ModelConfig, lm_layers

Spec = tuple


def mesh_axes(mesh) -> dict[str, int]:
    """The mesh's axis sizes by name, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def mesh_devices(mesh) -> int:
    return math.prod(mesh_axes(mesh).values())


def _entry(entry):
    """A spec entry as ``PartitionSpec`` keeps it: a 1-tuple is its name."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


def spec(*entries) -> Spec:
    return tuple(_entry(e) for e in entries)


def axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in axes)


def sanitize_spec(shape, spec_: Spec, mesh) -> Spec:
    """Drop axis assignments that don't evenly divide the dim."""
    out = []
    for i, entry in enumerate(tuple(spec_)[: len(shape)]):  # clip to rank
        if entry is not None and shape[i] % axes_size(mesh, entry) == 0:
            out.append(_entry(entry))
        else:
            out.append(None)
    out += [None] * (len(shape) - len(out))  # pad to rank
    return tuple(out)


def placements(spec_: Spec, mesh) -> tuple:
    """DTensor placements of ``spec_`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that tensor dim ``d`` names, ``Replicate()`` on the others.
    A dim named by several axes (``("pod", "data")``) is split by each of
    them in mesh order, as JAX splits it, so their order in the entry must
    be the mesh's."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh_axes(mesh))
    out = [Replicate()] * len(order)
    for d, entry in enumerate(spec_):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [order.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {order}")
        for p in pos:
            out[p] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Activation-constraint + parameter-spec provider for one (cfg, mesh).

    ``resid_mode`` controls the residual-stream layout between blocks:
      'feature'    — d sharded on the model axis (baseline for SP archs)
      'replicated' — batch-only sharding (Megatron-style: activations enter
                     column-parallel matmuls replicated on d; row-parallel
                     outputs all-reduce once per mixer/MLP)
      'seq'        — sequence dim sharded on the model axis (Megatron-SP:
                     norms run local, all-gather at qkv, reduce-scatter after
                     wo/w2)
    """

    mesh: Any
    cfg: ModelConfig
    batch_axes: tuple[str, ...]  # ("data",) or ("pod", "data")
    fsdp_axes: tuple[str, ...] | None = ("data",)
    model_axis: str = "model"
    resid_mode: str = "feature"

    # ---- activation constraints -----------------------------------------

    @property
    def tp_heads(self) -> bool:
        return self.cfg.n_heads % mesh_axes(self.mesh)[self.model_axis] == 0

    def spec(self, *entries) -> Spec:
        return spec(*entries)

    def activation_spec(self, shape, kind: str) -> Spec | None:
        """The sanitized spec of the ``kind`` hook for an activation of
        ``shape``, None for a kind the policy does not constrain."""
        b = tuple(self.batch_axes)
        m = self.model_axis
        if kind == "resid":
            if self.resid_mode == "replicated" or self.tp_heads:
                s = spec(b, None, None)
            elif self.resid_mode == "seq":
                s = spec(b, m, None)
            else:  # 'feature'
                s = spec(b, None, m)
        elif kind == "attn_q":
            # [B, S, H, dh]: heads over model, else sequence parallel
            s = spec(b, None, m, None) if self.tp_heads else spec(b, m, None, None)
        elif kind == "attn_kv":
            kv_ok = self.cfg.n_kv_heads % mesh_axes(self.mesh)[m] == 0
            if self.tp_heads and kv_ok:
                s = spec(b, None, m, None)
            else:
                s = spec(b, None, None, None)  # kv replicated under SP
        elif kind in ("moe_tokens", "moe_gathered"):
            # [G, T_loc, d] / [G, Tk, d]: groups over batch axes, d on model
            s = spec(b, None, m)
        elif kind == "moe_buffer":
            # [G, E, C, d]: groups over batch axes, features on model — the
            # d->E reshard at the expert matmul is the EP all-to-all
            s = spec(b, None, None, m)
        elif kind == "moe_expert_tokens":
            # [E, G*C, d]: expert-parallel matmul operand (E on model, d full)
            s = spec(m, b, None)
        else:
            return None
        return sanitize_spec(shape, s, self.mesh)

    def constrain(self, x, kind: str):
        """``x`` laid out as the ``kind`` hook asks: a DTensor is
        redistributed; a plain tensor is returned as it is on a one-device
        mesh, and refused on a larger one."""
        s = self.activation_spec(x.shape, kind)
        if s is None:
            return x
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            return x.redistribute(x.device_mesh, placements(s, self.mesh))
        n = mesh_devices(self.mesh)
        if n == 1:
            return x
        raise ValueError(
            f"constrain({kind!r}): a plain tensor on a mesh of {n} devices; pass DTensors "
            f"placed on the mesh (a {n}-device constraint is never dropped)"
        )

    # ---- parameter specs --------------------------------------------------

    def param_spec(self, path: str, shape) -> Spec:
        """The sanitized spec of the JAX leaf at ``path`` (stacked leaves
        with their leading scan axis)."""
        return sanitize_spec(shape, self._match(path, self.fsdp_axes, self.model_axis),
                             self.mesh)

    def _match(self, path: str, f, m) -> Spec:
        """Rule table keyed on parameter-leaf path substrings."""
        leaf = path.split("/")[-1]
        stacked = "blocks" in path  # scan-stacked: leading n_rep dim
        lead = (None,) if stacked else ()

        # MoE expert tensors [E, d, f] / [E, f, d]  (shared expert is a plain
        # dense MLP and falls through to the column/row rules below)
        if "moe" in path and "shared" not in path and leaf in ("w1", "w3"):
            return spec(*lead, m, f, None)
        if "moe" in path and "shared" not in path and leaf == "w2":
            return spec(*lead, m, None, f)
        if leaf == "router":
            return spec(*lead, f, m)

        if leaf == "embed":
            return spec(m, f)  # big-vocab fallback in leaf_spec
        # column-parallel (out-dim on model)
        if leaf in (
            "wqkv", "wq", "wkv", "w1", "w3", "in_proj", "in_x", "in_y",
            "w_a", "w_i", "x_in", "txt_in", "t_mlp1", "t_mlp2", "xq", "xkv",
            "final_mod", "x_out",
        ):
            return spec(*lead, f, m)
        # row-parallel (in-dim on model)
        if leaf in ("wo", "w2", "out_proj", "out", "xo"):
            return spec(*lead, m, f)
        if leaf == "conv_w":
            return spec(*lead, None, m)
        if leaf in ("bqkv", "conv_b", "norm_w"):
            return spec(*lead, m)
        # everything else (norm scales, A_log, dt_bias, D, lam, gates, mod_bias)
        return spec(*lead)

    def leaf_spec(self, path: str, shape) -> Spec:
        """:meth:`param_spec` with the embedding fallback: a vocabulary the
        model axis does not divide (minicpm's 122753) shards the feature
        dim instead."""
        s = self.param_spec(path, shape)
        if path.endswith("embed") and shape[0] % mesh_axes(self.mesh)[self.model_axis] != 0:
            s = sanitize_spec(shape, spec(None, self.model_axis), self.mesh)
        return s

    def param_sharding(self, params) -> dict[str, Spec]:
        """The spec of each of the port's parameters, by name: ``params`` is
        the model or any dict of tensors by parameter name (a moment)."""
        if isinstance(params, torch.nn.Module):
            params = dict(params.named_parameters())
        out = {}
        for name, (path, idx) in jax_keys(params, self.cfg).items():
            shape = tuple(params[name].shape)
            if idx is None:
                out[name] = self.leaf_spec(path, shape)
            else:  # the reference's stacked leaf, its scan axis dropped
                out[name] = self.leaf_spec(path, (1, *shape))[1:]
        return out

    # ---- data / cache specs -------------------------------------------------

    def data_sharding(self, tree: dict) -> dict[str, Spec]:
        """Batch-leading leaves: the batch dim over ``batch_axes``."""
        b = tuple(self.batch_axes)
        return {k: sanitize_spec(tuple(t.shape), spec(b), self.mesh) for k, t in tree.items()}

    def _cache_spec(self, shape, stacked: bool) -> Spec:
        # caches built by init_cache have batch at dim 0, or dim 1 when
        # scan-stacked; the model axis on the largest other dim it divides
        msz = mesh_axes(self.mesh)[self.model_axis]
        entries: list = [None] * len(shape)
        bdim = 1 if stacked else 0
        if bdim < len(shape):
            entries[bdim] = tuple(self.batch_axes)
        cand = [i for i in range(len(shape)) if i != bdim and shape[i] % msz == 0]
        if cand:
            entries[max(cand, key=lambda i: shape[i])] = self.model_axis
        return sanitize_spec(shape, spec(*entries), self.mesh)

    def cache_sharding(self, caches: list) -> list[dict[str, Spec]]:
        """KV caches [B, S, Hkv, dh] / states, one dict a layer: batch over
        ``batch_axes``, then best-effort model-axis sharding on the widest
        remaining dim, judged as the reference judges its stacked leaf."""
        out = []
        for (where, _), cache in zip(lm_layers(self.cfg), caches):
            stacked = where not in ("lead", "tail")
            out.append({
                k: (self._cache_spec((1, *t.shape), True)[1:] if stacked
                    else self._cache_spec(tuple(t.shape), False))
                for k, t in cache.items()
            })
        return out

    def scalar_sharding(self) -> Spec:
        return ()

    @property
    def n_dispatch_groups(self) -> int:
        return axes_size(self.mesh, tuple(self.batch_axes))


def make_policy(mesh, cfg: ModelConfig, *, resid_mode: str = "seq") -> ShardingPolicy:
    """Default residual mode is 'seq' (sequence-parallel residual); tp_heads
    archs are unaffected (batch-only resid)."""
    axes = tuple(mesh_axes(mesh))
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    fsdp_axes = ("data",) if "data" in axes else None
    return ShardingPolicy(
        mesh=mesh, cfg=cfg, batch_axes=batch_axes, fsdp_axes=fsdp_axes,
        resid_mode=resid_mode,
    )


def place(t: torch.Tensor, pls, mesh):
    """``t`` as a DTensor with placements ``pls`` on ``mesh`` (a
    DeviceMesh), with no communication: every rank holds ``t`` whole and
    keeps its shard (a meta tensor gives a meta shard)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.detach(), mesh, pls, src_data_rank=None)


def distribute_state(state: dict, policy: ShardingPolicy) -> dict:
    """The train state's parameters and AdamW moments as DTensors on
    ``policy.mesh`` under the parameter specs: ``{"params", "opt": {"m",
    "v"}, "step"}``, each a dict by parameter name."""
    mesh = policy.mesh
    pls = {n: placements(s, mesh) for n, s in policy.param_sharding(state["model"]).items()}
    params = dict(state["model"].named_parameters())
    return {
        "params": {n: place(p, pls[n], mesh) for n, p in params.items()},
        "opt": {k: {n: place(t, pls[n], mesh) for n, t in state["opt"][k].items()}
                for k in ("m", "v")},
        "step": state["step"],
    }


__all__ = [
    "ShardingPolicy", "Spec", "axes_size", "distribute_state", "make_policy", "mesh_axes",
    "mesh_devices", "place", "placements", "sanitize_spec", "spec",
]
