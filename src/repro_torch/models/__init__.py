"""Models of the port: the paper's Wan-2.1-style MMDiT and the
decoder-only LM (global-attention and Mamba-2 blocks)."""

from .config import ModelConfig, MoEConfig, SSMConfig
from . import layers, mmdit, ssm, transformer

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "layers", "mmdit", "ssm", "transformer"]
