"""Shape Benchmark of the port: automated (B, S) -> step_time telemetry
(paper §3.2), the counterpart of ``repro.core.shape_bench``.

The paper captures execution traces "in a live distributed environment ...
via synthetic pixel scans that exclude data-loading I/O jitter", then fits
the cost model on them.  Two backends:

* :class:`AnalyticDeviceModel`: a roofline of one training step on one
  NVIDIA H100.  Given a transformer's dimensions it counts the step's
  FLOPs and HBM bytes (attention's quadratic term included) with the
  reference's formulas and turns them into time through the card's peak
  rate and memory rate, each scaled by an achievable fraction, plus a fixed
  overhead a step.  The peak and the memory rate are fields here
  (``peak_flops``, ``hbm_bw``; the reference keeps them as module
  constants), defaulting to the card's published dense bf16 peak and HBM3
  rate.  The reference's third constant, a link rate, is read by none of
  its formulas, so the port leaves it out.  ``overhead`` (11.4 ms),
  ``efficiency`` (0.3349) and ``attn_efficiency`` (0.2931) default to what
  ``chip_smoke.py`` phase 12 (a) fitted on an ``NVIDIA H100 80GB HBM3,
  700.00 W``: Wan-2.1 1.3B at full width and 2 of 30 layers, bf16, the
  gradient step of ``train.steps.make_pool_grad_step`` timed over 26
  ``sweep_grid`` cells of the corpus's eight lengths (S 1,637 to 46,877),
  ``step_time`` fitted by least squares on the relative error (median
  4.3%, worst 46% at the smallest cell).  The fractions are of the
  model's own FLOP count (50.7 M of a Wan layer's 60.2 M parameters, no
  recompute), not the kernels' shares of the peak.  These defaults
  describe that model at that depth only: the 11.4 ms is one 2-layer
  call's fixed cost, which neither scales to 30 layers nor carries over
  to another model.  Refit them (phase 12 (a)'s fit, at the depth and on
  the model in question) before a planner or simulator prices steps with
  them.
* :func:`measure_step_time`: the time of a real step function on the
  device, with CUDA events around ``iters`` calls after ``warmup`` calls on
  the card, the host clock on the CPU.

:func:`sweep_grid` is the paper's "Throughput Sweep mode, prioritizing
multi-level batch size tests for long-sequence buckets where S >= 20,000".
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cost_model import BenchSample

#: NVIDIA H100 SXM, published: dense bf16 tensor-core peak and HBM3 rate
H100_PEAK_FLOPS_BF16 = 989e12  # FLOP/s
H100_HBM_BW = 3.35e12  # B/s

LONG_SEQ_THRESHOLD = 20_000  # paper: dense B-sweeps above this S


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Minimal dims needed for the analytic cost of one DiT/LM block stack."""

    n_layers: int
    d_model: int
    d_ff: int
    n_heads: int
    head_dim: int
    vocab: int = 0  # 0 for diffusion (no LM head)

    @property
    def params_per_layer(self) -> float:
        attn = self.d_model * self.n_heads * self.head_dim * 4
        mlp = self.d_model * self.d_ff * 3
        return attn + mlp


@dataclasses.dataclass(frozen=True)
class AnalyticDeviceModel:
    """Roofline-style step-time estimator for one training step on one card.

    ``t = overhead + max(t_matmul + t_attention, t_hbm)`` with a small
    multiplicative lognormal jitter (cluster noise).  Dense matmuls and
    attention get *separate* achievable fractions of ``peak_flops``:
    attention sustains a lower fraction of peak than large GEMMs, which is
    why wall-clock latency correlates with ``B*S^p``, p > 1, rather than
    with token count (paper §1).  The step covers fwd + bwd (3x fwd FLOPs,
    standard accounting)."""

    dims: ModelDims
    overhead: float = 0.0114  # s; fixed launch + collective latency per step
    efficiency: float = 0.3349  # dense-GEMM achievable fraction of peak
    attn_efficiency: float = 0.2931  # attention achievable fraction of peak
    jitter: float = 0.0  # lognormal sigma; 0 = deterministic
    bwd_multiplier: float = 3.0
    peak_flops: float = H100_PEAK_FLOPS_BF16
    hbm_bw: float = H100_HBM_BW

    def matmul_flops(self, batch_size: int, seq_len: int) -> float:
        d = self.dims
        tokens = batch_size * seq_len
        mm = 2.0 * d.params_per_layer * d.n_layers * tokens
        lm = 2.0 * tokens * d.d_model * d.vocab
        return self.bwd_multiplier * mm + lm

    def attention_flops(self, batch_size: int, seq_len: int) -> float:
        d = self.dims
        # scores + context: 2 * 2 * B * S^2 * H * dh per layer
        attn = 4.0 * batch_size * float(seq_len) ** 2 * d.n_heads * d.head_dim
        return self.bwd_multiplier * attn * d.n_layers

    def flops(self, batch_size: int, seq_len: int) -> float:
        return self.matmul_flops(batch_size, seq_len) + self.attention_flops(
            batch_size, seq_len
        )

    def bytes_moved(self, batch_size: int, seq_len: int) -> float:
        d = self.dims
        tokens = batch_size * seq_len
        # activations streamed per layer (resident working set, bf16) +
        # parameter reads (fwd + bwd) + gradient writes.
        act = 2.0 * tokens * d.d_model * 12 * d.n_layers
        par = 3.0 * 2.0 * d.params_per_layer * d.n_layers
        return act + par

    def step_time(
        self,
        batch_size: int,
        seq_len: int,
        rng: np.random.Generator | None = None,
    ) -> float:
        compute = self.matmul_flops(batch_size, seq_len) / (
            self.peak_flops * self.efficiency
        ) + self.attention_flops(batch_size, seq_len) / (
            self.peak_flops * self.attn_efficiency
        )
        memory = self.bytes_moved(batch_size, seq_len) / self.hbm_bw
        t = self.overhead + max(compute, memory)
        if self.jitter > 0 and rng is not None:
            t *= float(rng.lognormal(mean=0.0, sigma=self.jitter))
        return t


def sweep_grid(
    seq_lens: Sequence[int],
    *,
    max_batch: int = 64,
    long_seq_levels: int = 6,
    short_seq_levels: int = 3,
    m_mem: float | None = None,
) -> list[tuple[int, int]]:
    """(B, S) grid for the Throughput Sweep.

    Long-sequence buckets (S >= 20k) get a denser multi-level batch sweep to
    capture the compute-bound regime precisely (paper §3.2).  When ``m_mem``
    is given, batch levels are capped at the memory-feasible ceiling
    ``floor(m_mem / S)``: the live benchmark can only run cells that fit."""
    cells: list[tuple[int, int]] = []
    for s in seq_lens:
        levels = long_seq_levels if s >= LONG_SEQ_THRESHOLD else short_seq_levels
        cap = max_batch
        if m_mem is not None:
            cap = max(1, min(cap, int(m_mem // s)))
        bs = sorted(
            {
                min(cap, max(1, int(round(cap ** (i / (levels - 1))))))
                for i in range(levels)
            }
        )
        cells.extend((b, s) for b in bs)
    return cells


def run_analytic_benchmark(
    device: AnalyticDeviceModel,
    cells: Iterable[tuple[int, int]],
    *,
    seed: int = 0,
    repeats: int = 3,
) -> list[BenchSample]:
    """Collect telemetry from the analytic device (median of ``repeats``)."""
    rng = np.random.default_rng(seed)
    out: list[BenchSample] = []
    for b, s in cells:
        ts = [device.step_time(b, s, rng) for _ in range(repeats)]
        out.append(BenchSample(batch_size=b, seq_len=s, step_time=float(np.median(ts))))
    return out


def measure_step_time(
    step_fn: Callable[..., object],
    args_factory: Callable[[int, int], tuple],
    batch_size: int,
    seq_len: int,
    *,
    warmup: int = 1,
    iters: int = 3,
    device=None,
) -> float:
    """Seconds per call of ``step_fn(*args_factory(batch_size, seq_len))``
    (the real measurement path): ``warmup`` untimed calls, then ``iters``
    timed ones, between two CUDA events on the card (``device`` defaults to
    CUDA and raises without a GPU) and on the host clock on the CPU.
    Synthetic inputs exclude data-loading jitter, as in the paper."""
    if iters < 1:
        raise ValueError("iters must be >= 1")
    device = resolve_device(device)
    args = args_factory(batch_size, seq_len)
    for _ in range(warmup):
        step_fn(*args)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            step_fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn(*args)
    return (time.perf_counter() - t0) / iters


def run_measured_benchmark(
    step_fn: Callable[..., object],
    args_factory: Callable[[int, int], tuple],
    cells: Iterable[tuple[int, int]],
    **kw,
) -> list[BenchSample]:
    return [
        BenchSample(b, s, measure_step_time(step_fn, args_factory, b, s, **kw))
        for b, s in cells
    ]


__all__ = [
    "H100_HBM_BW",
    "H100_PEAK_FLOPS_BF16",
    "LONG_SEQ_THRESHOLD",
    "AnalyticDeviceModel",
    "ModelDims",
    "measure_step_time",
    "run_analytic_benchmark",
    "run_measured_benchmark",
    "sweep_grid",
]
