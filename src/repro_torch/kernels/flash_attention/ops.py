"""Autograd wiring of segment-aware flash attention: the counterpart of
``repro.kernels.flash_attention.ops`` (its ``jax.custom_vjp``).

The forward asks K7 for an f32 ``out`` and keeps it as the residual with
``(q, k, v, segment ids, lse)``, returning ``out`` in q's dtype
(``ops.py:56-64``): the backward's ``delta = sum(do * out)`` rows see the
unrounded output.  The backward runs K8 (dq, and delta) then K9 (dk, dv).
The device of ``q`` picks the kernels (CUDA), their shape functions
(``meta``, ``kernels.meta``) or their plain versions (CPU), so the CPU
tests run the same residuals and casts as the card.
"""

from __future__ import annotations

import torch

from ..meta import on_device, pick
from .flash import flash_bwd_dkv, flash_bwd_dq, flash_fwd
from .ref import attention_bwd_ref, attention_delta_ref, attention_ref


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, causal, scale):
        fwd = pick(flash_fwd, attention_ref, q)
        out, lse = fwd(q, k, v, q_segment_ids, kv_segment_ids, causal=causal, scale=scale,
                       out_dtype=torch.float32)
        ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors
        do = do.contiguous()
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        if q.device.type != "cpu":
            dq, delta = on_device(flash_bwd_dq, q)(q, k, v, out, do, lse, q_seg, kv_seg, **kw)
            dk, dv = on_device(flash_bwd_dkv, q)(q, k, v, do, lse, delta, q_seg, kv_seg, **kw)
        else:
            delta = attention_delta_ref(do, out)
            dq, dk, dv = attention_bwd_ref(q, k, v, do, lse, delta, q_seg, kv_seg, **kw)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, *, causal: bool, q_segment_ids=None, kv_segment_ids=None,
              scale: float | None = None):
    """Differentiable segment-aware attention in the [B, S, H, dh] layout."""
    return FlashAttention.apply(q, k, v, q_segment_ids, kv_segment_ids, causal, scale)
