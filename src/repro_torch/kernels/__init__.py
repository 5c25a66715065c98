"""Kernel dispatch layer of the port.

Models call these six functions.  The device of the tensor chooses:

* a CPU tensor goes to the plain PyTorch version (``plain.py``),
* a CUDA tensor goes to the hand-written Hopper kernel, which launches or
  raises,
* a ``meta`` tensor (the dry run's trace) goes to the kernel's shape
  function (``meta.py``): its outputs as empty ``meta`` tensors, and its
  operations counted in ``meta.flops()``; a kernel without one raises.

Where autograd records the call (grad enabled and an input that requires
grad), the operator runs as its ``torch.autograd.Function`` (``ops.py`` of
each family): the forward kernel keeps its residuals and the backward runs
the backward kernels, again by device.  Otherwise (serving, inference) the
forward kernel runs alone and keeps nothing.  Paged decode attention
(:func:`paged_attention`) serves the LM and has no backward kernel: on the
card, autograd recording it is an error.

There is no backend setting and no fallback: a shape the kernel does not
take is an error on the card, not a quiet detour through PyTorch.

Each kernel wrapper counts its launches in a plain integer attribute
(``adaln_fwd.launches`` ...); :func:`launch_counts` and
:func:`reset_launch_counts` read and clear them all.
"""

from __future__ import annotations

import torch

from . import meta, plain
from .flash_attention import ops as flash_ops
from .flash_attention.flash import flash_bwd_dkv, flash_bwd_dq, flash_fwd
from .flash_attention.paged import paged_decode
from .flash_attention.ring import ring_attention, ring_finalize, ring_merge
from .fused_adaln import ops as adaln_ops
from .fused_adaln.adaln import adaln_bwd_dmod, adaln_bwd_dmod_naive, adaln_bwd_dx, adaln_fwd
from .fused_rmsnorm import ops as rms_ops
from .fused_rmsnorm.rmsnorm import (
    gated_rms_fwd,
    qk_rms_bwd_dw,
    qk_rms_bwd_dx,
    qk_rms_fwd,
    rms_bwd_dw,
    rms_bwd_dx,
    rms_fwd,
)

#: every CUDA kernel wrapper of the port, by kernel name
KERNELS = {
    "adaln_fwd": adaln_fwd,  # K1
    "adaln_bwd_dx": adaln_bwd_dx,  # K2
    "adaln_bwd_dmod": adaln_bwd_dmod,  # K3
    "qk_rms_fwd": qk_rms_fwd,  # K4 (per-head q/k rows)
    "rms_fwd": rms_fwd,  # K4 (model rows)
    "qk_rms_bwd_dx": qk_rms_bwd_dx,  # K5 (per-head q/k rows)
    "qk_rms_bwd_dw": qk_rms_bwd_dw,  # K6 (per-head q/k rows)
    "rms_bwd_dx": rms_bwd_dx,  # K5 (model rows)
    "rms_bwd_dw": rms_bwd_dw,  # K6 (model rows)
    "flash_fwd": flash_fwd,  # K7
    "flash_bwd_dq": flash_bwd_dq,  # K8
    "flash_bwd_dkv": flash_bwd_dkv,  # K9
    "adaln_bwd_dmod_naive": adaln_bwd_dmod_naive,  # K10 (no model calls it)
    "ring_attention": ring_attention,  # K11: ring passes over K7-K9 (sequence parallel)
    "ring_merge": ring_merge,  # K11's per-hop log-sum-exp merge
    "ring_finalize": ring_finalize,  # K11's final normalisation
    "paged_decode": paged_decode,  # K12
    "gated_rms_fwd": gated_rms_fwd,  # K13
}


def _recorded(*tensors) -> bool:
    """Whether autograd records a call on these tensors."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def adaln_modulate(x, scale, shift, eps: float = 1e-6):
    """Fused LayerNorm-Modulate (paper §3.3).  x: [B, S, D]; scale/shift: [B, D]."""
    if _recorded(x, scale, shift):
        return adaln_ops.adaln_modulate(x, scale, shift, eps)
    if x.device.type == "cpu":
        return plain.adaln_modulate(x, scale, shift, eps)
    return meta.on_device(adaln_fwd, x)(x, scale, shift, eps)[0]


def _forward_only(name: str, *tensors) -> None:
    if _recorded(*tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel on the card: call it under "
            f"torch.inference_mode() or torch.no_grad()"
        )


def rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm over the last axis (the LM's norm1, norm2 and final_norm)."""
    if _recorded(x, w):
        return rms_ops.rms_norm(x, w, eps)
    if x.device.type == "cpu":
        return plain.rms_norm(x, w, eps)
    return meta.on_device(rms_fwd, x)(x, w, eps)[0]


def gated_rms_norm(x, w, g, eps: float = 1e-6):
    """``rms_norm(x, w) * silu(g)`` over the last axis — the paper's
    Gate+Norm fusion (Mamba-2's norm before the out-projection)."""
    if _recorded(x, w, g):
        return rms_ops.gated_rms_norm(x, w, g, eps)
    if x.device.type == "cpu":
        return plain.gated_rms_norm(x, w, g, eps)
    return meta.on_device(gated_rms_fwd, x)(x, w, g, eps)[0]


def qk_norm(q, k, wq, wk, eps: float = 1e-6):
    """Joint per-head q/k RMSNorm — paper's QNorm+KNorm fusion (one launch)."""
    if _recorded(q, k, wq, wk):
        return rms_ops.qk_norm(q, k, wq, wk, eps)
    if q.device.type == "cpu":
        return plain.qk_norm(q, k, wq, wk, eps)
    return meta.on_device(qk_rms_fwd, q)(q, k, wq, wk, eps)[:2]


def attention(q, k, v, *, causal: bool, q_segment_ids=None,
              kv_segment_ids=None, scale: float | None = None, seq_group=None):
    """Segment-aware self/cross attention in the model's [B, S, H, dh] layout.

    Visibility is segment-id equality (``-1`` pads, and padding attends
    padding), plus ``q_pos >= k_pos`` when ``causal``.  With ``seq_group``
    (a ``LocalRing`` or ``ProcessRing``) the call holds contiguous sequence
    shards of one packed window and runs the ring (K11): its hops run K7-K9
    and the merge kernels on the card, their plain versions on the CPU.
    """
    if seq_group is not None:  # the ring has no shape function: it refuses meta
        return ring_attention(q, k, v, q_segment_ids, kv_segment_ids, group=seq_group,
                              causal=causal, scale=scale)
    if _recorded(q, k, v):
        return flash_ops.attention(q, k, v, causal=causal, q_segment_ids=q_segment_ids,
                                   kv_segment_ids=kv_segment_ids, scale=scale)
    if q.device.type == "cpu":
        return plain.attention(q, k, v, causal=causal, q_segment_ids=q_segment_ids,
                               kv_segment_ids=kv_segment_ids, scale=scale)
    return meta.on_device(flash_fwd, q)(q, k, v, q_segment_ids, kv_segment_ids,
                                        causal=causal, scale=scale)[0]


def paged_attention(q, k_pages, v_pages, page_table, kv_lens, *, scale: float | None = None):
    """Decode attention over a paged KV pool (continuous batching).

    q: [B, Hq, dh], one new token per decode slot; k_pages, v_pages: [P,
    page_size, Hkv, dh]; page_table: [B, pages_max] int32 (unused entries
    at a scratch page); kv_lens: [B] int32 (0: an inactive slot, exact
    zeros).
    """
    if q.device.type == "cpu":
        return plain.paged_attention(q, k_pages, v_pages, page_table, kv_lens, scale=scale)
    _forward_only("paged_attention", q, k_pages, v_pages)
    return meta.on_device(paged_decode, q)(q, k_pages, v_pages, page_table, kv_lens, scale=scale)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "adaln_modulate",
    "attention",
    "gated_rms_norm",
    "launch_counts",
    "meta",
    "paged_attention",
    "plain",
    "qk_norm",
    "reset_launch_counts",
    "rms_norm",
]
