"""wan2.1 [mmdit] — the paper's own architecture: Wan-2.1-style video
diffusion transformer with AdaLN-modulate conditioning [arXiv:2503.20314].

The same three sizes as ``repro.configs.wan2_1_mmdit``: the 1.3B (the
served and trained model), the 14B, and a two-layer smoke size for the CPU
tests; and the same optimizer.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig


def config() -> ModelConfig:  # 1.3B
    return ModelConfig(
        name="wan2.1-1.3b",
        family="mmdit",
        n_layers=30,
        d_model=1536,
        n_heads=12,
        n_kv_heads=12,
        head_dim=128,
        d_ff=8960,
        vocab=0,
        text_len=512,
        in_channels=16,
    )


def config_14b() -> ModelConfig:
    return ModelConfig(
        name="wan2.1-14b",
        family="mmdit",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        head_dim=128,
        d_ff=13824,
        vocab=0,
        text_len=512,
        in_channels=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="wan2.1-smoke",
        family="mmdit",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab=0,
        text_len=16,
        in_channels=16,
        dtype="float32",
    )


def optimizer() -> OptimizerConfig:
    return OptimizerConfig(peak_lr=1e-4, schedule="constant", warmup=100)
