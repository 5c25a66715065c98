"""minicpm-2b [dense] — WSD schedule, llama-like arch [arXiv:2404.06395; hf].

36 heads are not divisible by the 16-way model axis: the sharding policy
automatically falls back to sequence-parallel attention (see
distributed/sharding.py).  The 122753 vocab is likewise non-divisible, so
the embedding shards its feature dim instead.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        family="dense",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        head_dim=64,
        d_ff=5760,
        vocab=122_753,
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-smoke",
        family="dense",
        n_layers=2,
        d_model=72,  # keeps the 36-head ratio quirk (dh=2? no: heads 6)
        n_heads=6,
        n_kv_heads=6,
        head_dim=12,
        d_ff=144,
        vocab=251,  # prime-ish vocab, like the real one
        dtype="float32",
    )


def optimizer() -> OptimizerConfig:
    # MiniCPM trains with WSD (Warmup-Stable-Decay)
    return OptimizerConfig(peak_lr=1e-3, schedule="wsd", warmup=200)
