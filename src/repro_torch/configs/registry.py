"""Architecture registry: ``--arch <id>`` resolution for the ported models."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig

ARCHS = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "llama-3.2-vision-90b": "repro_torch.configs.llama3_2_vision_90b",
    "wan2.1-1.3b": "repro_torch.configs.wan2_1_mmdit",
}


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(ARCHS[arch]).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(ARCHS[arch]).smoke_config()


def get_optimizer(arch: str) -> OptimizerConfig:
    mod = importlib.import_module(ARCHS[arch])
    return mod.optimizer() if hasattr(mod, "optimizer") else OptimizerConfig()
