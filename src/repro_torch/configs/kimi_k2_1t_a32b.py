"""kimi-k2-1t-a32b [moe] — trillion-param MoE: 384 experts top-8, one dense
lead layer, shared expert [arXiv:2501.kimi2].

1T total parameters.  Optimizer moments are stored in bf16
(``opt_state_dtype``): weights, gradients and both moments take 8 bytes a
parameter.  Head dim is the decoupled 128 (DeepSeek-style), not
d_model/n_heads.  One MoE layer holds 17.1 B parameters (34.2 GB in bf16,
137 GB of training state), so one 80 GB card serves the dense lead layer
and one MoE layer, and trains none at full width.
"""

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.optim.adamw import OptimizerConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=2048,
        vocab=163_840,
        pattern=("moe",),
        rope_theta=50_000.0,
        opt_state_dtype="bfloat16",
        moe=MoEConfig(
            n_experts=384,
            top_k=8,
            d_expert=2048,
            n_shared=1,
            first_dense=1,
            capacity_factor=1.25,
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab=256,
        pattern=("moe",),
        dtype="float32",
        opt_state_dtype="bfloat16",
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=1,
                      first_dense=1, capacity_factor=8.0),
    )


def optimizer() -> OptimizerConfig:
    return OptimizerConfig(
        peak_lr=2e-4, schedule="wsd", warmup=500, state_dtype="bfloat16"
    )
