"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385; hf]."""

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=64,
        d_ff=5632,
        vocab=32000,
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        dtype="float32",
    )


def optimizer() -> OptimizerConfig:
    return OptimizerConfig(peak_lr=4e-4, schedule="cosine")
