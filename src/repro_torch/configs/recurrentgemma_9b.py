"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn per 2
recurrent blocks [arXiv:2402.19427].  Subquadratic: runs long_500k."""

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,  # MQA on the local-attention layers
        head_dim=256,
        d_ff=12288,
        vocab=256_000,
        pattern=("rglru", "rglru", "local"),
        local_window=2048,
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=192,
        vocab=256,
        pattern=("rglru", "rglru", "local"),
        local_window=16,
        dtype="float32",
    )


def optimizer() -> OptimizerConfig:
    return OptimizerConfig(peak_lr=3e-4, schedule="cosine")
