"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision].

The vision frontend is a stub: the model takes precomputed patch
embeddings [B, n_image_tokens, d_model] as its ``memory``; the config
covers the 100-layer transformer backbone (80 self + 20 cross-attn layers).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab=128_256,
        pattern=("attn", "attn", "attn", "attn", "cross"),
        rope_theta=500_000.0,
        n_image_tokens=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-vision-smoke",
        family="vlm",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab=256,
        pattern=("attn", "attn", "attn", "attn", "cross"),
        n_image_tokens=16,
        dtype="float32",
    )


def optimizer() -> OptimizerConfig:
    return OptimizerConfig(peak_lr=2e-4, schedule="cosine")
