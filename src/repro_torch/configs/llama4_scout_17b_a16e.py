"""llama4-scout-17b-a16e [moe] — 16 experts top-1, shared expert, early
fusion [hf:meta-llama/Llama-4-Scout-17B-16E]."""

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.optim.adamw import OptimizerConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab=202_048,
        pattern=("moe",),
        rope_theta=500_000.0,
        moe=MoEConfig(
            n_experts=16,
            top_k=1,
            d_expert=8192,
            n_shared=1,
            capacity_factor=1.25,
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        pattern=("moe",),
        dtype="float32",
        moe=MoEConfig(n_experts=4, top_k=1, d_expert=128, n_shared=1,
                      capacity_factor=8.0),
    )


def optimizer() -> OptimizerConfig:
    return OptimizerConfig(peak_lr=3e-4, schedule="cosine")
