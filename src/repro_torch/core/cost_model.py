"""Parameterized step-time cost model with automated fitting (paper §3.2):
the port's copy of ``repro.core.cost_model`` (framework-free numpy).

The paper replaces manual empirical tuning with a data-driven fit:

    step_time_sync ≈ a + b * B * S**p

``p`` is grid-searched over [1.6, 2.4] maximizing the coefficient of
determination R²; ``a`` and ``b`` come from ordinary least squares at each
candidate ``p``.  The compute budget is then back-derived from a target step
latency: ``M_comp = (target_sync - a) / b``.

Implemented in numpy only — this runs on the scheduler host, not on device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np

P_GRID_LO = 1.6
P_GRID_HI = 2.4
P_GRID_STEP = 0.02


@dataclasses.dataclass(frozen=True)
class BenchSample:
    """One shape-benchmark observation: a (B, S) cell and its step time."""

    batch_size: int
    seq_len: int
    step_time: float

    def feature(self, p: float) -> float:
        return self.batch_size * float(self.seq_len) ** p


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Fitted ``t = a + b * B * S^p`` model."""

    a: float
    b: float
    p: float
    r2: float
    n_samples: int = 0
    #: ring-communication weight for sequence-parallel split microbatches,
    #: in load units per transferred token (see :func:`split_load`).  0.0
    #: (and absent from old JSON fits) = comm-free splitting.
    comm_scale: float = 0.0

    def predict(self, batch_size: float, seq_len: float) -> float:
        return self.a + self.b * batch_size * float(seq_len) ** self.p

    def predict_packed(self, batch_size: float, seg_lengths: Sequence[int]) -> float:
        """Step time for a packed variable-length window.

        With a segment-aware attention kernel the quadratic term follows the
        per-segment load Σ len_i^p, not the window total (Σ len_i)^p — the
        naive ``predict(B, sum(lengths))`` over-charges packed windows by up
        to the packing factor, which would make the StepPlanner's B·S^p
        dispatch systematically misweight them.
        """
        return self.a + self.b * batch_size * packed_load(seg_lengths, self.p)

    def predict_split(
        self, batch_size: float, seg_lengths: Sequence[int], k: int
    ) -> float:
        """Per-rank step time when one packed window spans ``k`` ring ranks.

        The compute term divides evenly (each rank owns a contiguous 1/k Q
        shard and the segment-aware tile skip prices remote KV blocks the
        same way the packed kernel prices local ones); the ring adds one
        KV rotation per step, ``S * (k-1)/k`` tokens of traffic per rank,
        weighted by ``comm_scale``.  ``k=1`` is exactly
        :meth:`predict_packed`."""
        return self.a + self.b * batch_size * split_load(
            seg_lengths, self.p, k, comm_scale=self.comm_scale
        )

    def load_of(self, bucket) -> float:
        """Predicted step time of one pool microbatch — the ``load_of`` the
        ``StepPlanner`` should pack on when a pool mixes bucket kinds.

        Rectangular ``Bucket``s are costed ``predict(B, S)``; packed
        variable-length microbatches (anything exposing per-document
        ``lengths``, i.e. ``data.packing.PackedBucket``) are costed by the
        per-segment ``predict_packed`` so packing density is priced in."""
        lengths = getattr(bucket, "lengths", None)
        if lengths is not None:
            return self.predict_packed(1, lengths)
        return self.predict(bucket.batch_size, bucket.seq_len)

    def m_comp_for_target(self, target_sync: float) -> float:
        """Back-derive the compute budget M_comp = (target - a) / b."""
        if target_sync <= self.a:
            raise ValueError(
                f"target_sync={target_sync} is below fixed overhead a={self.a}"
            )
        if self.b <= 0:
            raise ValueError(f"degenerate slope b={self.b}")
        return (target_sync - self.a) / self.b

    def fit_comm_scale(self, records: Sequence) -> "CostModel":
        """Calibrate ``comm_scale`` from sequence-parallel telemetry.

        Each record is one rank's shard of a split bucket (``ring_ranks =
        k > 1``; ``seq_len`` is the per-shard width ``S_full / k``).  Under
        the rectangular split model the measured time is::

            t = a + b·B·( S_full^p / k  +  cs·S_full·(k-1)/k )

        With ``(a, b, p)`` already fitted from unsplit samples, ``cs`` is
        one more least-squares slope, through the origin, on the residual
        load ``(t - a)/b - B·S_full^p/k`` against the per-rank ring
        traffic ``B·S_full·(k-1)/k``.  Clamped at 0 (a negative fit means
        the ring was free within noise).  Returns a new model; raises
        ``ValueError`` when no split records (or a degenerate ``b``) make
        the fit impossible.
        """
        if self.b <= 0:
            raise ValueError(f"degenerate slope b={self.b}")
        xs: list[float] = []
        ys: list[float] = []
        for r in records:
            k = int(getattr(r, "ring_ranks", 1))
            if k < 2:
                continue
            s_full = float(r.seq_len) * k
            resid = (r.compute_time - self.a) / self.b - (
                r.batch_size * s_full**self.p / k
            )
            xs.append(r.batch_size * s_full * (k - 1) / k)
            ys.append(resid)
        if not xs:
            raise ValueError("no split (ring_ranks > 1) records to fit from")
        xa = np.asarray(xs, dtype=np.float64)
        ya = np.asarray(ys, dtype=np.float64)
        sxx = float((xa * xa).sum())
        if sxx == 0.0:
            raise ValueError("split records carry zero ring traffic")
        cs = float((xa * ya).sum()) / sxx
        return dataclasses.replace(self, comm_scale=max(0.0, cs))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "CostModel":
        return CostModel(**json.loads(s))


def packed_load(seg_lengths: Sequence[int], p: float) -> float:
    """Per-segment load Σ len_i^p of a packed window.

    The single source of truth for scoring packed variable-length windows:
    ``data/packing.py`` stamps it on every ``PackedWindow`` and the
    segment-aware attention kernel's executed tiles scale with it (p = 2 is
    exact attention FLOPs; the fitted p folds in the linear terms).
    """
    return float(sum(float(n) ** p for n in seg_lengths))


def split_load(
    seg_lengths: Sequence[int],
    p: float,
    k: int,
    *,
    comm_scale: float = 0.0,
) -> float:
    """Per-rank load of one packed window split across ``k`` ring ranks:
    ``sum(len^p) / k + comm_scale * S * (k-1)/k``.

    The comm term is the per-rank ring traffic — every rank forwards its
    KV shard ``k-1`` times, ``S/k`` tokens per hop — expressed in the same
    load units the planner packs on, so split and unsplit microbatches
    compare on one scale."""
    if k < 1:
        raise ValueError(f"split fan-out k must be >= 1, got {k}")
    total = float(sum(seg_lengths))
    return packed_load(seg_lengths, p) / k + comm_scale * total * (k - 1) / k


def _ols_r2(x: np.ndarray, y: np.ndarray) -> tuple[float, float, float]:
    """OLS fit y = a + b x, returning (a, b, r2)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xm, ym = x.mean(), y.mean()
    sxx = float(((x - xm) ** 2).sum())
    if sxx == 0.0:
        return float(ym), 0.0, 0.0
    b = float(((x - xm) * (y - ym)).sum()) / sxx
    a = float(ym - b * xm)
    resid = y - (a + b * x)
    sst = float(((y - ym) ** 2).sum())
    r2 = 1.0 - float((resid**2).sum()) / sst if sst > 0 else 1.0
    return a, b, r2


def fit_cost_model(
    samples: Sequence[BenchSample],
    *,
    p_lo: float = P_GRID_LO,
    p_hi: float = P_GRID_HI,
    p_step: float = P_GRID_STEP,
) -> CostModel:
    """Grid-search p maximizing R² of the OLS fit (paper §3.2)."""
    if len(samples) < 3:
        raise ValueError(f"need >= 3 samples to fit, got {len(samples)}")
    y = np.array([s.step_time for s in samples], dtype=np.float64)
    best: CostModel | None = None
    p = p_lo
    while p <= p_hi + 1e-9:
        x = np.array([s.feature(p) for s in samples], dtype=np.float64)
        a, b, r2 = _ols_r2(x, y)
        if best is None or r2 > best.r2:
            best = CostModel(a=a, b=b, p=round(p, 4), r2=r2, n_samples=len(samples))
        p += p_step
    assert best is not None
    return best


def fit_cost_model_per_class(
    samples_by_class: dict[str, Sequence[BenchSample]],
    *,
    p_lo: float = P_GRID_LO,
    p_hi: float = P_GRID_HI,
    p_step: float = P_GRID_STEP,
) -> dict[str, CostModel]:
    """Per-device-class fits sharing ONE exponent (heterogeneous fleets).

    The accelerator class changes the constant and the slope — clocks,
    overheads, memory bandwidth — but not the arithmetic-intensity
    exponent of the workload, so ``p`` is grid-searched once maximizing
    the POOLED R² (residuals summed across classes against the pooled
    variance) while ``(a, b)`` come from per-class OLS at each candidate.
    Every class needs >= 3 samples; classes are fitted in sorted-name
    order so the result is deterministic.
    """
    if not samples_by_class:
        raise ValueError("no classes to fit")
    for cls, samples in samples_by_class.items():
        if len(samples) < 3:
            raise ValueError(
                f"class {cls!r} has {len(samples)} samples, need >= 3"
            )
    items = sorted(samples_by_class.items())
    ys = {cls: np.array([s.step_time for s in ss]) for cls, ss in items}
    y_all = np.concatenate([ys[cls] for cls, _ in items])
    sst = float(((y_all - y_all.mean()) ** 2).sum())
    best_p: float | None = None
    best_r2 = -np.inf
    best_fits: dict[str, tuple[float, float]] = {}
    p = p_lo
    while p <= p_hi + 1e-9:
        ssr = 0.0
        fits: dict[str, tuple[float, float]] = {}
        for cls, samples in items:
            x = np.array([s.feature(p) for s in samples], dtype=np.float64)
            a, b, _ = _ols_r2(x, ys[cls])
            fits[cls] = (a, b)
            ssr += float(((ys[cls] - (a + b * x)) ** 2).sum())
        r2 = 1.0 - ssr / sst if sst > 0 else 1.0
        if best_p is None or r2 > best_r2:
            best_p, best_r2, best_fits = round(p, 4), r2, fits
        p += p_step
    assert best_p is not None
    return {
        cls: CostModel(
            a=best_fits[cls][0],
            b=best_fits[cls][1],
            p=best_p,
            r2=best_r2,
            n_samples=len(samples_by_class[cls]),
        )
        for cls, _ in items
    }


def pearson(x: Sequence[float], y: Sequence[float]) -> float:
    xa = np.asarray(x, dtype=np.float64)
    ya = np.asarray(y, dtype=np.float64)
    xs = xa.std()
    ys = ya.std()
    if xs == 0 or ys == 0:
        return 0.0
    return float(((xa - xa.mean()) * (ya - ya.mean())).mean() / (xs * ys))


def correlation_report(samples: Sequence[BenchSample], p: float) -> dict[str, float]:
    """Paper's headline observation: corr(t, B*S) ≈ 0.35 vs corr(t, B*S^p) ≈ 0.92.

    Returns both correlations for the given dataset so benchmarks can verify
    the claim on our synthetic telemetry.
    """
    t = [s.step_time for s in samples]
    tokens = [s.batch_size * s.seq_len for s in samples]
    load = [s.feature(p) for s in samples]
    return {
        "corr_tokens": pearson(tokens, t),
        "corr_load_p": pearson(load, t),
        "p": p,
    }
