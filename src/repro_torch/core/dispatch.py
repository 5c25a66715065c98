"""Global step planning of the port.  So far only the validation of a
bucket table's sampling weights, which the loaders share: a copy of
``repro.core.dispatch.normalized_weights``.  The planner comes with the
multi-rank slice."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .bucketing import Bucket


def normalized_weights(
    buckets: Sequence[Bucket], weights: Sequence[float] | None
) -> np.ndarray:
    """Validate a bucket table + sampling weights, return draw probabilities.

    Shared by the planner and both loaders so empty tables and malformed
    weights fail loudly at the call site instead of crashing (or dividing
    by zero) inside a prefetch thread."""
    if len(buckets) == 0:
        raise ValueError("bucket table is empty: nothing to draw from")
    w = np.asarray(
        weights if weights is not None else [1.0] * len(buckets),
        dtype=np.float64,
    )
    if len(w) != len(buckets):
        raise ValueError(f"{len(w)} weights for {len(buckets)} buckets")
    if (w < 0).any() or w.sum() <= 0:
        raise ValueError(
            "bucket weights must be non-negative with a positive sum"
        )
    return w / w.sum()
