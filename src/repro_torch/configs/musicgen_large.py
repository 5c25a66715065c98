"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

The EnCodec frontend is a stub: the backbone consumes token ids from the
audio codec's vocabulary (2048 codes) as plain token streams.  Full MHA
(kv == heads), LayerNorm like the original transformer-LM stack.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab=2048,
        norm="layernorm",
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=192,
        vocab=128,
        norm="layernorm",
        dtype="float32",
    )


def optimizer() -> OptimizerConfig:
    return OptimizerConfig(peak_lr=3e-4, schedule="cosine")
