"""Kernel dispatch layer of the port.

Models call these three functions.  The device of the tensor chooses:

* a CPU tensor goes to the plain PyTorch version (``plain.py``),
* a CUDA tensor goes to the hand-written Hopper kernel, which launches or
  raises.

There is no backend setting and no fallback: a shape the kernel does not
take is an error on the card, not a quiet detour through PyTorch.

Each kernel wrapper counts its launches in a plain integer attribute
(``adaln_fwd.launches`` ...); :func:`launch_counts` and
:func:`reset_launch_counts` read and clear them all.
"""

from __future__ import annotations

from . import plain
from .flash_attention.flash import flash_fwd
from .fused_adaln.adaln import adaln_fwd
from .fused_rmsnorm.rmsnorm import qk_rms_fwd

#: every CUDA kernel wrapper of the port, by kernel name
KERNELS = {"adaln_fwd": adaln_fwd, "qk_rms_fwd": qk_rms_fwd, "flash_fwd": flash_fwd}


def _on_card(x) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {x.device}")


def adaln_modulate(x, scale, shift, eps: float = 1e-6):
    """Fused LayerNorm-Modulate (paper §3.3).  x: [B, S, D]; scale/shift: [B, D]."""
    if _on_card(x):
        return adaln_fwd(x, scale, shift, eps)[0]
    return plain.adaln_modulate(x, scale, shift, eps)


def qk_norm(q, k, wq, wk, eps: float = 1e-6):
    """Joint per-head q/k RMSNorm — paper's QNorm+KNorm fusion (one launch)."""
    if _on_card(q):
        return qk_rms_fwd(q, k, wq, wk, eps)[:2]
    return plain.qk_norm(q, k, wq, wk, eps)


def attention(q, k, v, *, causal: bool, q_segment_ids=None,
              kv_segment_ids=None, scale: float | None = None):
    """Segment-aware self/cross attention in the model's [B, S, H, dh] layout.

    Visibility is segment-id equality (``-1`` pads, and padding attends
    padding), plus ``q_pos >= k_pos`` when ``causal``.
    """
    if _on_card(q):
        return flash_fwd(q, k, v, q_segment_ids, kv_segment_ids,
                         causal=causal, scale=scale)[0]
    return plain.attention(q, k, v, causal=causal, q_segment_ids=q_segment_ids,
                           kv_segment_ids=kv_segment_ids, scale=scale)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "adaln_modulate",
    "attention",
    "launch_counts",
    "plain",
    "qk_norm",
    "reset_launch_counts",
]
