"""Models of the port: the paper's Wan-2.1-style MMDiT and the dense
decoder-only LM."""

from .config import ModelConfig, MoEConfig, SSMConfig
from . import layers, mmdit, transformer

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "layers", "mmdit", "transformer"]
