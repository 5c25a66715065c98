"""The third route of the kernel dispatch: ``meta`` tensors (the dry run).

A CUDA tensor goes to the hand kernel and a CPU tensor to its plain
version; a ``meta`` tensor goes to the kernel's *shape function*, which
returns the kernel's outputs (residuals included) as empty ``meta``
tensors, allocates and drops the scratch the wrapper allocates on the card
(so a trace sees the same live bytes), and adds the kernel's operations to
:func:`flops` and the bytes it reads and writes (each input once, each
output once) to :func:`bytes_moved`.  The operations are the bounds' of
``PERF.md`` §6: a flash kernel counts its live 64 x 64 (q, kv) tile pairs
times the products a pair costs (K7 two, K8 three, K9 four products of
2 * 64 * 64 * dh), and a norm counts none.  A kernel without a shape function raises on ``meta``.

The live tiles are read from shapes only: a call with segment ids raises,
since which tiles live would depend on their values.
"""

from __future__ import annotations

import functools

import torch

from .flash_attention.flash import BOUND_TILE, dkv_splits, live_tile_pairs
from .fused_adaln.adaln import DMOD_ROW_CHUNK
from .fused_rmsnorm.rmsnorm import ROW_DW_CHUNK, qk_dw_chunks

#: streaming multiprocessors of the H100 SXM, which sets K9's split
H100_SMS = 132

_count = {"flops": 0, "bytes": 0}


def flops() -> int:
    """The kernels' operations counted on ``meta`` since the last reset."""
    return _count["flops"]


def bytes_moved() -> int:
    """The kernels' input and output bytes counted on ``meta`` since the
    last reset."""
    return _count["bytes"]


def reset_flops() -> None:
    """Zero :func:`flops` and :func:`bytes_moved`."""
    _count["flops"] = _count["bytes"] = 0


def _io(fn):
    """Count the bytes of a shape function's tensor inputs and outputs."""
    @functools.wraps(fn)
    def counted(*args, **kwargs):
        out = fn(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        tensors = (*args, *kwargs.values(), *outs)
        _count["bytes"] += sum(t.numel() * t.element_size() for t in tensors
                               if isinstance(t, torch.Tensor))
        return out

    return counted


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _scratch(shape) -> None:
    """The f32 scratch a wrapper allocates for the length of its call."""
    _empty(shape, torch.float32)


# -- fused AdaLN (K1-K3) -------------------------------------------------------


def adaln_fwd(x, scale, shift, eps: float = 1e-6):
    b, s, _ = x.shape
    return torch.empty_like(x), _empty((b, s), torch.float32), _empty((b, s), torch.float32)


def adaln_bwd_dx(dy, x, mu, rstd, scale):
    return torch.empty_like(x)


def adaln_bwd_dmod(dy, x, mu, rstd):
    b, s, d = x.shape
    out = _empty((b, d), torch.float32), _empty((b, d), torch.float32)
    _scratch((2, b, -(-s // DMOD_ROW_CHUNK), d))
    return out


# -- fused RMSNorm (K4-K6, K13) ------------------------------------------------


def rms_fwd(x, w, eps: float = 1e-6):
    return torch.empty_like(x), _empty(x.shape[:-1], torch.float32)


def gated_rms_fwd(x, w, g, eps: float = 1e-6):
    return _empty(x.shape, x.dtype), _empty(x.shape[:-1], torch.float32)


def rms_bwd_dx(dy, x, w, rstd):
    return torch.empty_like(x)


def rms_bwd_dw(dy, x, rstd):
    d = x.shape[-1]
    dw = _empty((d,), torch.float32)
    _scratch((-(-(x.numel() // d) // ROW_DW_CHUNK), d))
    return dw


def qk_rms_fwd(q, k, wq, wk, eps: float = 1e-6):
    b, s, hq, d = q.shape
    hk = k.shape[2]
    return (_empty(q.shape, q.dtype), _empty(k.shape, k.dtype),
            _empty((b, s, hq), torch.float32), _empty((b, s, hk), torch.float32))


def qk_rms_bwd_dx(dyq, dyk, q, k, wq, wk, rq, rk):
    return _empty(q.shape, q.dtype), _empty(k.shape, k.dtype)


def qk_rms_bwd_dw(dyq, dyk, q, k, rq, rk):
    b, s, hq, d = q.shape
    dw = _empty((2, d), torch.float32)
    _, _, n_chunks = qk_dw_chunks(b, s, max(hq, k.shape[2]), d, q.element_size())
    _scratch((2, n_chunks, d))
    return dw[0], dw[1]


# -- flash attention (K7-K9) ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def _live_tiles(sq: int, skv: int, causal: bool) -> int:
    return live_tile_pairs(sq, skv, causal=causal)


def _tile_products(name, q, k, segs, causal: bool) -> int:
    """Live 64 x 64 tile pairs of the call, all heads and rows, times the
    operations of one 64 x 64 x dh product."""
    if any(s is not None for s in segs):
        raise ValueError(f"{name} on meta tensors takes no segment ids: its live tiles "
                         f"would depend on their values")
    b, sq, hq, dh = q.shape
    return _live_tiles(sq, k.shape[1], bool(causal)) * b * hq * 2 * BOUND_TILE**2 * dh


def flash_fwd(q, k, v, q_segment_ids=None, kv_segment_ids=None, *,
              causal: bool = False, scale: float | None = None, out_dtype=None):
    b, sq, hq, dh = q.shape
    _count["flops"] += 2 * _tile_products("flash_fwd", q, k, (q_segment_ids, kv_segment_ids),
                                          causal)
    return _empty(q.shape, out_dtype or q.dtype), _empty((b, hq, sq), torch.float32)


def flash_bwd_dq(q, k, v, out, do, lse, q_segment_ids=None, kv_segment_ids=None, *,
                 causal: bool = False, scale: float | None = None):
    b, sq, hq, dh = q.shape
    _count["flops"] += 3 * _tile_products("flash_bwd_dq", q, k,
                                          (q_segment_ids, kv_segment_ids), causal)
    return _empty(q.shape, q.dtype), _empty((b, hq, sq), torch.float32)


def flash_bwd_dkv(q, k, v, do, lse, delta, q_segment_ids=None, kv_segment_ids=None, *,
                  causal: bool = False, scale: float | None = None):
    b, skv, hkv, dh = k.shape
    _count["flops"] += 4 * _tile_products("flash_bwd_dkv", q, k,
                                          (q_segment_ids, kv_segment_ids), causal)
    out = _empty(k.shape, k.dtype), _empty(v.shape, v.dtype)
    splits = dkv_splits(b, skv, hkv, H100_SMS) if q.dtype == torch.bfloat16 else 1
    if splits > 1:
        _scratch((2, splits, b, skv, hkv, dh))
    return out


#: the shape function of each kernel wrapper, by the wrapper's name
SHAPES = {fn.__name__: _io(fn) for fn in (
    adaln_fwd, adaln_bwd_dx, adaln_bwd_dmod, rms_fwd, gated_rms_fwd, rms_bwd_dx, rms_bwd_dw,
    qk_rms_fwd, qk_rms_bwd_dx, qk_rms_bwd_dw, flash_fwd, flash_bwd_dq, flash_bwd_dkv,
)}


def shape_fn(kernel):
    """The shape function of a kernel wrapper; raises for a kernel that has
    none."""
    fn = SHAPES.get(kernel.__name__)
    if fn is None:
        raise NotImplementedError(
            f"kernel {kernel.__name__} has no shape function: it does not run on meta tensors"
        )
    return fn


def on_device(kernel, x):
    """What runs ``kernel`` for tensors on ``x``'s device: the kernel on
    CUDA, its shape function on ``meta``; any other device raises."""
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "meta":
        return shape_fn(kernel)
    raise ValueError(f"no kernel for tensors on {x.device}")


def pick(kernel, plain, x):
    """:func:`on_device`, or the plain version for a CPU tensor."""
    return plain if x.device.type == "cpu" else on_device(kernel, x)


__all__ = ["H100_SMS", "SHAPES", "bytes_moved", "flops", "on_device", "pick", "reset_flops",
           "shape_fn"]
