"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B]."""

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab=128_256,
        rope_theta=500_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=192,
        vocab=256,
        dtype="float32",
    )


def optimizer() -> OptimizerConfig:
    return OptimizerConfig(peak_lr=4e-4, schedule="cosine")
