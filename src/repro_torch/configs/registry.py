"""Architecture registry: ``--arch <id>`` resolution for the ported models,
and the dry run's shape catalogue (``repro.configs.registry``)."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig

ARCHS = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama3_2_vision_90b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "wan2.1-1.3b": "repro_torch.configs.wan2_1_mmdit",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def arch_ids() -> list[str]:
    return list(ARCHS)


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(ARCHS[arch]).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(ARCHS[arch]).smoke_config()


def get_optimizer(arch: str) -> OptimizerConfig:
    mod = importlib.import_module(ARCHS[arch])
    return mod.optimizer() if hasattr(mod, "optimizer") else OptimizerConfig()


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell.

    long_500k needs sub-quadratic sequence mixing: full-softmax-attention
    archs skip it; SSM/hybrid run it.
    """
    if cfg.family == "mmdit" and shape.kind != "train":
        return False, "mmdit serves via denoise_step; LM decode shapes n/a"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full attention at 524k context: skipped per assignment"
    return True, ""
