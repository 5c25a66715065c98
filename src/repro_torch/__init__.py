"""PyTorch / CUDA port of the AdaptiveLoad system for NVIDIA Hopper.

The package mirrors ``repro``'s layout module for module, so each piece has
an obvious counterpart in the JAX reference, but it imports neither ``jax``
nor anything of ``repro``: what it needs of the framework-free modules it
keeps as its own copy.

Entry points run on the GPU.  A caller that wants the CPU (the parity
tests) says so with ``device="cpu"``; with no GPU and no explicit device an
entry point raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises ``RuntimeError`` when no device is named and no GPU is visible,
    so a missing card never turns silently into a CPU run.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return torch.device("cuda")


__all__ = ["resolve_device"]
