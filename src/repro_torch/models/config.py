"""Model configuration schema: a copy of ``repro.models.config``'s
dataclasses, field for field, so a configuration reads the same in both
packages, with the layer plan (``layer_kinds``, ``superblocks``) the LM
resolves its blocks and the JAX parameter tree's stacking from
(:func:`lm_layers`), whether the plan is ``subquadratic`` (the dry run's
``long_500k`` cells), and the SSM widths (``d_inner``, ``ssm_heads``).
Only the validation the ported paths rely on is kept.
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

    # -- layer plan -----------------------------------------------------

    def layer_kinds(self) -> list[str]:
        """The concrete per-layer block kinds, pattern cycled over n_layers,
        with MoE ``first_dense`` leading layers downgraded to dense attn."""
        kinds = [self.pattern[i % len(self.pattern)] for i in range(self.n_layers)]
        if self.moe is not None and self.moe.first_dense > 0:
            for i in range(min(self.moe.first_dense, self.n_layers)):
                if kinds[i] == "moe":
                    kinds[i] = "attn"
        return kinds

    def superblocks(self) -> tuple[list[str], list[str], int, list[str]]:
        """Split the layer plan into (leading, pattern, n_repeats, trailing),
        the JAX model's ``lax.scan`` layout:

            leading (unrolled) -> scan(n_repeats x pattern) -> trailing (unrolled)

        Leading layers are those that deviate from the cycle (e.g. kimi's
        first dense layer); trailing layers are a partial final cycle.  The
        port runs the layers in this order in one loop; the split tells
        ``convert`` how the JAX tree stacks them.
        """
        kinds = self.layer_kinds()
        pat = list(self.pattern)
        lead = 0
        while lead < len(kinds) and kinds[lead] != pat[lead % len(pat)]:
            lead += 1
        body = kinds[lead:]
        n_rep = len(body) // len(pat)
        for i, k in enumerate(body[: n_rep * len(pat)]):
            if k != pat[i % len(pat)]:
                return kinds, [], 0, []  # not a cycle: everything unrolled
        trailing = body[n_rep * len(pat) :]
        return kinds[:lead], pat, n_rep, trailing

    @property
    def subquadratic(self) -> bool:
        """True if no block kind needs a full O(S^2)/O(S)-KV global attention
        — the archs eligible for the long_500k shape."""
        quadratic = {"attn", "moe", "cross"}
        return not any(k in quadratic for k in self.layer_kinds())

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0


def lm_layers(cfg: ModelConfig) -> list[tuple[str, int]]:
    """The place in the JAX LM tree of each of the port's layers, in layer
    order: ``("lead", j)``, ``("s<i>", r)`` (superblock r, stacked) or
    ``("tail", j)``."""
    lead, pat, n_rep, tail = cfg.superblocks()
    places = [("lead", j) for j in range(len(lead))]
    places += [(f"s{i}", r) for r in range(n_rep) for i in range(len(pat))]
    places += [("tail", j) for j in range(len(tail))]
    return places
