"""The fitted step-time model ``t = a + b·B·S^p`` (paper §3.2), as serving
uses it: prediction, and the compute budget ``M_comp = (target - a) / b``
back-derived from a latency target.  Fitting comes with the training slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Fitted ``t = a + b * B * S^p`` model."""

    a: float
    b: float
    p: float
    r2: float
    n_samples: int = 0
    #: ring-communication weight for sequence-parallel split microbatches;
    #: kept so a fit serialized by either package loads in the other.
    comm_scale: float = 0.0

    def predict(self, batch_size: float, seq_len: float) -> float:
        return self.a + self.b * batch_size * float(seq_len) ** self.p

    def m_comp_for_target(self, target_sync: float) -> float:
        """Back-derive the compute budget M_comp = (target - a) / b."""
        if target_sync <= self.a:
            raise ValueError(
                f"target_sync={target_sync} is below fixed overhead a={self.a}"
            )
        if self.b <= 0:
            raise ValueError(f"degenerate slope b={self.b}")
        return (target_sync - self.a) / self.b
