"""The plain PyTorch versions of the kernels, under the dispatch
layer's names: what ``repro_torch.kernels`` runs for CPU tensors, and what
a model forward runs on any device when asked for ``ops="plain"`` (the
on-card whole-model comparison)."""

from __future__ import annotations

from .flash_attention.ref import attention_ref, paged_attention_ref
from .flash_attention.ring import ring_attention
from .fused_adaln.ref import adaln_modulate_ref
from .fused_rmsnorm.ref import gated_rms_norm_ref, qk_norm_ref, rms_norm_ref


def adaln_modulate(x, scale, shift, eps: float = 1e-6):
    return adaln_modulate_ref(x, scale, shift, eps)[0]


def rms_norm(x, w, eps: float = 1e-6):
    return rms_norm_ref(x, w, eps)[0]


def gated_rms_norm(x, w, g, eps: float = 1e-6):
    return gated_rms_norm_ref(x, w, g, eps)[0]


def qk_norm(q, k, wq, wk, eps: float = 1e-6):
    return qk_norm_ref(q, k, wq, wk, eps)[:2]


def attention(q, k, v, *, causal: bool, q_segment_ids=None,
              kv_segment_ids=None, scale: float | None = None, seq_group=None):
    if seq_group is not None:  # the ring's schedule with its plain blocks and merge
        return ring_attention(q, k, v, q_segment_ids, kv_segment_ids, group=seq_group,
                              causal=causal, scale=scale, plain=True)
    return attention_ref(
        q, k, v, q_segment_ids, kv_segment_ids, causal=causal, scale=scale
    )[0]


def paged_attention(q, k_pages, v_pages, page_table, kv_lens, *, scale: float | None = None):
    return paged_attention_ref(q, k_pages, v_pages, page_table, kv_lens, scale=scale)
