"""Step telemetry of the port: the per-worker, per-microbatch record that
the closed-loop scheduler consumes (a copy of
``repro.core.telemetry.WorkerStepRecord``; the buffer and bottleneck
analysis come with the scheduler's slice).

The engine fills ``compute_time`` from CUDA events on the card
(``timing="device"``) and from the host clock on the CPU (``"host"``).
"""

from __future__ import annotations

import dataclasses


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
