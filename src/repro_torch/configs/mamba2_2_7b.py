"""mamba2-2.7b [ssm] — SSD state-space duality, attention-free
[arXiv:2405.21060].  Subquadratic: runs long_500k."""

from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.optim.adamw import OptimizerConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=80,  # d_inner / head_dim (informational; attn-free)
        n_kv_heads=80,
        head_dim=64,
        d_ff=0,
        vocab=50_280,
        pattern=("ssm",),
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=8,
        head_dim=16,
        d_ff=0,
        vocab=256,
        pattern=("ssm",),
        dtype="float32",
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=16),
    )


def optimizer() -> OptimizerConfig:
    return OptimizerConfig(peak_lr=5e-4, schedule="cosine")
