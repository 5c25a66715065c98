"""Gradient compression for data-parallel sync, with error feedback: the
counterpart of ``repro.distributed.compression``.

Two wire formats:

* ``bf16`` — cast before the reduce (2x against f32);
* ``int8`` — per-tensor absmax-scaled int8 with **error feedback** (EF):
  the quantisation residual is carried into the next step's gradient,
  which keeps SGD/Adam convergence (the error-feedback SignSGD line of
  work).  4x against f32, 2x against bf16.

Pure functions over dicts of tensors (nested dicts too), on the tensors'
own device, so they compose with any optimizer.  As in the reference,
nothing in the port's training paths calls them yet.
"""

from __future__ import annotations

from typing import Callable

import torch

#: bytes a value of each wire format takes
WIRE_BYTES = {"none": 4, "bf16": 2, "int8": 1}


def _map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn`` applied leaf by leaf over dicts of the same structure."""
    out = {}
    for key, val in tree.items():
        others = [r[key] for r in rest]
        out[key] = _map(fn, val, *others) if isinstance(val, dict) else fn(val, *others)
    return out


def _leaves(tree: dict):
    for val in tree.values():
        if isinstance(val, dict):
            yield from _leaves(val)
        else:
            yield val


def init_error_feedback(params: dict) -> dict:
    """Zero f32 residuals shaped like ``params``, on their devices."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _int8(g, ef):
    gf = g.float() + ef
    scale = torch.clamp_min(gf.abs().amax(), 1e-12) / 127.0
    # torch.round, like jnp.round, rounds half to even
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.float() * scale


def compress_int8(grads: dict, ef_state: dict) -> tuple[dict, dict, dict]:
    """``(q int8, scales f32 0-d, new error feedback)`` by leaf: each
    gradient plus its carried residual, scaled by its absmax / 127 (at
    least 1e-12 / 127), rounded half to even and clipped to +-127; the new
    residual is what the int8 values do not hold."""
    out = _map(_int8, grads, ef_state)
    q = _map(lambda t: t[0], out)
    scales = _map(lambda t: t[1], out)
    ef = _map(lambda t: t[2], out)
    return q, scales, ef


def decompress_int8(q_grads: dict, scales: dict, out_dtype=torch.bfloat16) -> dict:
    """The int8 values times their scales, in f32, cast to ``out_dtype``."""
    return _map(lambda q, s: (q.float() * s).to(out_dtype), q_grads, scales)


def compress_bf16(grads: dict) -> dict:
    return _map(lambda g: g.to(torch.bfloat16), grads)


def wire_bytes(grads: dict, method: str) -> int:
    """Bytes a data-parallel all-reduce would move a worker for these
    gradients in the wire format ``method`` (``none``, ``bf16``, ``int8``)."""
    per = WIRE_BYTES[method]
    return sum(g.numel() * per for g in _leaves(grads))
