"""Step telemetry + bottleneck analysis feeding the closed loop (paper §3.2):
the port's copy of ``repro.core.telemetry`` (framework-free numpy).

The paper: "it monitors the waiting time wait_sync of each GPU in real-time,
identifies the primary bottleneck using bottleneck analysis tools, and
dynamically recalibrates bucket configurations."

``TelemetryBuffer`` accumulates per-step, per-worker records (compute time,
data-wait, barrier-wait) and exposes:

* cost-model training pairs ``(B, S, t)``,
* per-worker health (persistent-straggler detection),
* a bottleneck verdict: compute-imbalance vs data-starvation vs
  communication-bound.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque

import numpy as np

from .cost_model import BenchSample


@dataclasses.dataclass(frozen=True)
class WorkerStepRecord:
    step: int
    worker: int
    batch_size: int
    seq_len: int
    compute_time: float
    data_wait: float = 0.0
    comm_time: float = 0.0
    # provenance of ``compute_time``: "host" = the host clock bracketed a
    # blocking computation (the CPU); "device" = CUDA events bracketed the
    # microbatch's work on the stream.  The scheduler treats both the same;
    # the field exists so telemetry consumers can tell which clock produced
    # a sample.
    timing: str = "host"
    # ring size when this record is one rank's shard of a sequence-parallel
    # split bucket (seq_len is then the PER-SHARD width, and compute_time
    # includes the ring's KV-rotation traffic).  1 = plain unsplit work.
    # Split records are excluded from ``bench_samples`` — their time does
    # not follow ``a + b·B·S^p`` in the recorded S — and instead feed
    # ``CostModel.fit_comm_scale``.
    ring_ranks: int = 1

    @property
    def total(self) -> float:
        return self.compute_time + self.data_wait + self.comm_time


@dataclasses.dataclass(frozen=True)
class BottleneckReport:
    verdict: str  # 'compute_imbalance' | 'data_starvation' | 'communication' | 'balanced'
    mean_wait_sync: float
    mean_data_wait: float
    mean_comm: float
    mean_compute: float
    detail: str


class TelemetryBuffer:
    def __init__(self, capacity: int = 4096):
        self._records: Deque[WorkerStepRecord] = deque(maxlen=capacity)
        self._step_times: dict[int, list[float]] = {}

    def add(self, rec: WorkerStepRecord) -> None:
        self._records.append(rec)
        self._step_times.setdefault(rec.step, []).append(rec.total)
        # keep the per-step index bounded like the deque
        if len(self._step_times) > 8192:
            for k in sorted(self._step_times)[:1024]:
                del self._step_times[k]

    def __len__(self) -> int:
        return len(self._records)

    def bench_samples(self) -> list[BenchSample]:
        """(B, S) -> compute_time pairs for cost-model (re)fitting.

        Sequence-parallel split records are excluded: their compute time is
        ``load/k`` plus ring traffic, which would bias the ``a + b·B·S^p``
        fit if charged to the per-shard S.  They feed
        :meth:`split_records` -> ``CostModel.fit_comm_scale`` instead."""
        return [
            BenchSample(r.batch_size, r.seq_len, r.compute_time)
            for r in self._records
            if r.ring_ranks <= 1
        ]

    def split_records(self) -> list[WorkerStepRecord]:
        """Sequence-parallel shard records (``ring_ranks > 1``) — the
        training pairs for ``CostModel.fit_comm_scale``."""
        return [r for r in self._records if r.ring_ranks > 1]

    def bench_samples_by_worker(self) -> dict[int, list[BenchSample]]:
        """Unsplit fit pairs grouped by worker — the input to per-device-
        class refits (each worker maps to a class via the scheduler's
        ``device_classes`` table)."""
        out: dict[int, list[BenchSample]] = {}
        for r in self._records:
            if r.ring_ranks > 1:
                continue
            out.setdefault(r.worker, []).append(
                BenchSample(r.batch_size, r.seq_len, r.compute_time)
            )
        return out

    def wait_sync(self, step: int) -> list[float]:
        ts = self._step_times.get(step, [])
        if not ts:
            return []
        m = max(ts)
        return [m - t for t in ts]

    def straggler_workers(
        self, *, window: int = 64, threshold: float = 1.25
    ) -> list[int]:
        """Workers whose median *shape-normalized* compute time exceeds
        threshold x the cluster median over the trailing window.

        Each record's time is divided by the *peer* median for its own
        (B, S) cell — the median over every OTHER worker's samples of that
        shape — before comparing workers.  Raw times would confound
        hardware health with dispatch (LPT-style packing systematically
        hands the heaviest microbatch of every step to one rank), and an
        all-workers median would let the straggler contaminate its own
        baseline: at 2 workers half of each cell's samples are the sick
        rank's, which pulls the median up and hides slowdowns below
        ~2x threshold - 1.  Leave-one-out medians keep the baseline honest
        at any worker count.  Shapes only one worker has seen are skipped
        (no peer baseline to compare against)."""
        by_worker, med_all = self._worker_ratios(window=window)
        if med_all is None:
            return []
        return sorted(
            w
            for w, ts in by_worker.items()
            if len(ts) >= 8 and float(np.median(ts)) > threshold * med_all
        )

    def _worker_ratios(
        self, *, window: int
    ) -> tuple[dict[int, list[float]], float | None]:
        """Per-worker shape-normalized (leave-one-out) compute-time ratios
        over the trailing window, plus the all-samples median ratio (None
        when no shape has peer coverage) — shared by straggler detection
        and capacity estimation."""
        recent = list(self._records)[-window * 16 :]
        # ring_ranks joins the shape key: a split shard's time includes comm,
        # so it only normalizes against peers running the same ring width
        by_shape_worker: dict[tuple[int, int, int], dict[int, list[float]]] = {}
        for r in recent:
            by_shape_worker.setdefault(
                (r.batch_size, r.seq_len, r.ring_ranks), {}
            ).setdefault(r.worker, []).append(r.compute_time)
        by_worker: dict[int, list[float]] = {}
        ratios: list[float] = []
        for per_worker in by_shape_worker.values():
            if len(per_worker) < 2:
                continue  # single-worker shape: no peers to normalize by
            for w, ts in per_worker.items():
                peers = [
                    t for pw, pts in per_worker.items() if pw != w for t in pts
                ]
                m = float(np.median(peers))
                if m <= 0:
                    continue
                for t in ts:
                    ratio = t / m
                    by_worker.setdefault(w, []).append(ratio)
                    ratios.append(ratio)
        if not ratios:
            return by_worker, None
        med_all = float(np.median(ratios))
        return by_worker, (med_all if med_all > 0 else None)

    def worker_speeds(
        self, *, window: int = 64, min_samples: int = 8
    ) -> dict[int, float]:
        """Per-worker relative speed estimates (1.0 = cluster-typical;
        0.5 = takes twice as long on the same shapes).

        The inverse of the same shape-normalized leave-one-out ratios the
        straggler detector uses, so a chaos-injected 2x slowdown shows up
        as speed 0.5 regardless of which microbatch shapes the rank was
        dealt.  Workers with fewer than ``min_samples`` normalized samples
        are omitted — the capacity feed treats an incomplete map as "not
        yet known" rather than guessing."""
        by_worker, med_all = self._worker_ratios(window=window)
        if med_all is None:
            return {}
        out: dict[int, float] = {}
        for w, ts in by_worker.items():
            if len(ts) < min_samples:
                continue
            m = float(np.median(ts))
            if m > 0:
                out[w] = med_all / m
        return out

    def bottleneck(self) -> BottleneckReport:
        recs = list(self._records)
        if not recs:
            return BottleneckReport("balanced", 0, 0, 0, 0, "no data")
        data_wait = float(np.mean([r.data_wait for r in recs]))
        comm = float(np.mean([r.comm_time for r in recs]))
        compute = float(np.mean([r.compute_time for r in recs]))
        waits = []
        for s in self._step_times.values():
            m = max(s)
            waits.extend(m - t for t in s)
        wait_sync = float(np.mean(waits)) if waits else 0.0
        total = max(compute + data_wait + comm, 1e-12)
        if data_wait > 0.25 * total:
            verdict, detail = "data_starvation", "data pipeline slower than step"
        elif comm > 0.4 * total:
            verdict, detail = "communication", "collectives dominate step time"
        elif wait_sync > 0.15 * compute:
            verdict, detail = (
                "compute_imbalance",
                "barrier wait >15% of compute: bucket loads are uneven",
            )
        else:
            verdict, detail = "balanced", "no dominant bottleneck"
        return BottleneckReport(verdict, wait_sync, data_wait, comm, compute, detail)
