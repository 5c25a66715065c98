"""Model configuration schema: a copy of ``repro.models.config``'s
dataclasses, field for field, so a configuration reads the same in both
packages.  Only the validation the diffusion path relies on is kept; the
layer-plan helpers of the LM families come with their slices of the port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    first_dense: int = 0  # leading dense layers (kimi-k2: 1)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio | mmdit
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple[str, ...] = ("attn",)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    qkv_bias: bool = False  # qwen2.5
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    local_window: int = 2048
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # vlm: length of the precomputed patch-embedding stub fed by input_specs()
    n_image_tokens: int = 0
    # diffusion (mmdit): text conditioning length; latent patch channels
    text_len: int = 0
    in_channels: int = 16
    # optimizer-state dtype override ('float32' default; kimi uses bfloat16)
    opt_state_dtype: str = "float32"

    def __post_init__(self):
        if self.n_heads % max(self.n_kv_heads, 1) != 0 and self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads must be divisible by n_kv_heads")
        if self.family == "moe" and self.moe is None:
            raise ValueError(f"{self.name}: moe family needs MoEConfig")
        if "ssm" in self.pattern and self.ssm is None:
            raise ValueError(f"{self.name}: ssm blocks need SSMConfig")
