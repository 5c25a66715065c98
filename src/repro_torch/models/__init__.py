"""Models of the port: the paper's Wan-2.1-style MMDiT."""

from .config import ModelConfig, MoEConfig, SSMConfig
from . import layers, mmdit

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "layers", "mmdit"]
