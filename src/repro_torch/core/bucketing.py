"""Dual-constraint adaptive bucket batch sizing (AdaptiveLoad Eq. 2).

The paper's first contribution: for a bucket whose samples have logical
sequence length ``S`` (text tokens + VAE/patchify-compressed visual tokens),
the per-device batch size is the intersection of a *linear memory* bound and
a *polynomial compute* bound::

    B_shape = max(1, min(floor(M_mem / S), floor(M_comp / S**p)))

``M_mem`` is the token budget implied by HBM capacity (activations scale
~linearly in tokens once attention is memory-efficient), ``M_comp`` is the
compute budget in ``B * S**p`` units, and ``p`` is the fitted empirical
exponent of attention complexity (paper: grid-searched in [1.6, 2.4]).

Shapes are (n_frames, height, width) pixel-space descriptors; images are
``n_frames == 1``.  The logical length follows the paper's VAE/patchify
factors: temporal 8x, spatial 16x.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, Sequence

# Paper §3.2: "S_visual is compressed according to temporal and spatial
# downsampling factors (8 and 16, respectively)".
TEMPORAL_FACTOR = 8
SPATIAL_FACTOR = 16


@dataclasses.dataclass(frozen=True)
class DataShape:
    """A raw media shape prior to VAE encoding (images have n_frames == 1)."""

    n_frames: int
    height: int
    width: int
    text_len: int = 0

    def __post_init__(self) -> None:
        if self.n_frames < 1 or self.height < 1 or self.width < 1:
            raise ValueError(f"invalid shape {self}")

    @property
    def visual_tokens(self) -> int:
        """Latent token count after temporal/spatial compression + patchify."""
        t = (self.n_frames - 1) // TEMPORAL_FACTOR + 1
        h = max(1, self.height // SPATIAL_FACTOR)
        w = max(1, self.width // SPATIAL_FACTOR)
        return t * h * w

    @property
    def seq_len(self) -> int:
        """Logical sequence length S = S_text + S_visual (paper §3.2)."""
        return self.text_len + self.visual_tokens

    @property
    def is_image(self) -> bool:
        return self.n_frames == 1


def dual_constraint_batch_size(
    seq_len: int,
    *,
    m_mem: float,
    m_comp: float,
    p: float,
) -> int:
    """Eq. 2 of the paper.

    Short sequences are governed by the memory bound (high throughput);
    long sequences trigger the compute bound, actively shrinking B so the
    bucket's O(S^p) load cannot stretch the global synchronization step.
    """
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    if m_mem <= 0 or m_comp <= 0:
        raise ValueError("budgets must be positive")
    if not 1.0 <= p <= 4.0:
        raise ValueError(f"implausible complexity exponent p={p}")
    b_mem = math.floor(m_mem / seq_len)
    b_comp = math.floor(m_comp / seq_len**p)
    return max(1, min(b_mem, b_comp))


def equal_token_batch_size(seq_len: int, *, m_mem: float) -> int:
    """Industry baseline: constant token budget B*S = M_mem (paper §2.2)."""
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    return max(1, math.floor(m_mem / seq_len))


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A bucket = one media shape + the batch size the policy assigned it."""

    shape: DataShape
    batch_size: int

    @property
    def seq_len(self) -> int:
        return self.shape.seq_len

    @property
    def tokens(self) -> int:
        return self.batch_size * self.seq_len

    def load(self, p: float) -> float:
        """Physical load pressure O = B * S^p (paper §4.1 uses p=2)."""
        return self.batch_size * float(self.seq_len) ** p


@dataclasses.dataclass(frozen=True)
class BucketingPolicy:
    """Batch-size policy for a family of buckets.

    ``mode='adaptive'`` is the paper's dual constraint; ``mode='equal_token'``
    is the baseline it improves upon.
    """

    m_mem: float
    m_comp: float = float("inf")
    p: float = 2.0
    mode: str = "adaptive"  # 'adaptive' | 'equal_token'

    def batch_size(self, seq_len: int) -> int:
        if self.mode == "equal_token":
            return equal_token_batch_size(seq_len, m_mem=self.m_mem)
        if self.mode == "adaptive":
            return dual_constraint_batch_size(
                seq_len, m_mem=self.m_mem, m_comp=self.m_comp, p=self.p
            )
        raise ValueError(f"unknown bucketing mode {self.mode!r}")

    def make_buckets(self, shapes: Iterable[DataShape]) -> list[Bucket]:
        return [Bucket(s, self.batch_size(s.seq_len)) for s in shapes]

    def with_m_comp(self, m_comp: float) -> "BucketingPolicy":
        return dataclasses.replace(self, m_comp=m_comp)

    def with_p(self, p: float) -> "BucketingPolicy":
        return dataclasses.replace(self, p=p)


def bucket_table(buckets: Sequence[Bucket], p: float = 2.0) -> str:
    """Human-readable summary (used by examples and the closed-loop logs)."""
    lines = [
        f"{'shape':>18} {'S':>8} {'B':>5} {'tokens':>9} {'load B*S^p':>14}"
    ]
    for b in sorted(buckets, key=lambda x: x.seq_len):
        sh = f"{b.shape.n_frames}x{b.shape.height}x{b.shape.width}"
        lines.append(
            f"{sh:>18} {b.seq_len:>8} {b.batch_size:>5} {b.tokens:>9} "
            f"{b.load(p):>14.3e}"
        )
    return "\n".join(lines)


def load_statistics(
    buckets: Sequence[Bucket], p: float = 2.0
) -> Mapping[str, float]:
    """Dispersion statistics of per-bucket load — the quantity the dual
    constraint is designed to flatten across buckets."""
    loads = [b.load(p) for b in buckets]
    n = len(loads)
    if n == 0:
        raise ValueError("no buckets")
    mean = sum(loads) / n
    var = sum((x - mean) ** 2 for x in loads) / n
    cv = math.sqrt(var) / mean if mean > 0 else 0.0
    return {
        "mean": mean,
        "std": math.sqrt(var),
        "cv": cv,
        "max": max(loads),
        "min": min(loads),
        "spread": (max(loads) - min(loads)) / max(loads) if max(loads) else 0.0,
    }
