"""The port's Shape Benchmark against the JAX package's: the analytic
device model (given the reference's device constants, read here so the
port names none of them) equal to the reference's formulas exactly, the
sweep grid equal, seeded jittered samples equal, and the measured path's
call counts.  No process is spawned."""

import dataclasses

import numpy as np
import pytest

from repro.core import shape_bench as ref  # noqa: E402
from repro_torch.core import shape_bench as port  # noqa: E402

DIMS = [
    dict(n_layers=30, d_model=1536, d_ff=8960, n_heads=12, head_dim=128),
    dict(n_layers=2, d_model=128, d_ff=256, n_heads=4, head_dim=32),
    dict(n_layers=16, d_model=2048, d_ff=8192, n_heads=32, head_dim=64, vocab=128256),
    dict(n_layers=40, d_model=5120, d_ff=13824, n_heads=40, head_dim=128, vocab=0),
]
GRID = [(b, s) for b in (1, 2, 3, 10, 64) for s in (256, 1637, 7877, 20000, 46877)]


def _models(dims: dict, **kw):
    """(port, reference) devices of the same dims and settings; the port
    is given the reference's peak and memory rate."""
    theirs = ref.AnalyticDeviceModel(ref.ModelDims(**dims), **kw)
    ours = port.AnalyticDeviceModel(port.ModelDims(**dims), peak_flops=ref.PEAK_FLOPS_BF16,
                                    hbm_bw=ref.HBM_BW, **kw)
    return ours, theirs


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"L{d['n_layers']}d{d['d_model']}")
@pytest.mark.parametrize("kw", [dict(overhead=0.08, efficiency=0.55, attn_efficiency=0.22),
                                dict(overhead=0.0, efficiency=0.3, attn_efficiency=0.9,
                                     bwd_multiplier=2.0)], ids=["defaults", "other"])
def test_analytic_model_equals_the_reference(dims, kw):
    ours, theirs = _models(dims, **kw)
    assert ours.dims.params_per_layer == theirs.dims.params_per_layer
    for b, s in GRID:
        for name in ("matmul_flops", "attention_flops", "flops", "bytes_moved", "step_time"):
            assert getattr(ours, name)(b, s) == getattr(theirs, name)(b, s), (name, b, s)


def test_memory_bound_cells_equal_the_reference():
    """A tiny model at a large batch is bound by bytes: the max() takes the
    memory branch on both sides."""
    dims = dict(n_layers=1, d_model=64, d_ff=64, n_heads=1, head_dim=64)
    ours, theirs = _models(dims, overhead=0.0, efficiency=1.0, attn_efficiency=1.0)
    b, s = 4096, 16
    assert theirs.bytes_moved(b, s) / ref.HBM_BW > theirs.flops(b, s) / ref.PEAK_FLOPS_BF16
    assert ours.step_time(b, s) == theirs.step_time(b, s)


@pytest.mark.parametrize("seed", [0, 3])
def test_jittered_benchmark_equals_the_reference(seed):
    ours, theirs = _models(DIMS[0], overhead=0.08, efficiency=0.55, attn_efficiency=0.22,
                           jitter=0.05)
    got = port.run_analytic_benchmark(ours, GRID, seed=seed, repeats=5)
    want = ref.run_analytic_benchmark(theirs, GRID, seed=seed, repeats=5)
    assert [dataclasses.astuple(x) for x in got] == [dataclasses.astuple(x) for x in want]
    again = port.run_analytic_benchmark(ours, GRID, seed=seed, repeats=5)
    assert got == again
    assert len({x.step_time for x in got}) > 1


@pytest.mark.parametrize("seq_lens", [[19_999, 20_000, 20_001], [1637, 3677, 4757, 7877, 17237,
                                                                 18077, 39677, 46877], [512]])
@pytest.mark.parametrize("max_batch", [1, 16, 64])
@pytest.mark.parametrize("levels", [(6, 3), (4, 2), (2, 5)])
@pytest.mark.parametrize("m_mem", [None, 196_608, 30_000])
def test_sweep_grid_equals_the_reference(seq_lens, max_batch, levels, m_mem):
    kw = dict(max_batch=max_batch, long_seq_levels=levels[0], short_seq_levels=levels[1],
              m_mem=m_mem)
    assert port.sweep_grid(seq_lens, **kw) == ref.sweep_grid(seq_lens, **kw)


def test_sweep_grid_of_the_card_run():
    """chip_smoke.py phase 12 (a)'s cells: the long buckets get {1, 2, 3, 4}."""
    cells = port.sweep_grid([1637, 3677, 4757, 7877, 17237, 18077, 39677, 46877],
                            max_batch=16, m_mem=196_608)
    assert [b for b, s in cells if s >= port.LONG_SEQ_THRESHOLD] == [1, 2, 3, 4] * 2
    assert port.LONG_SEQ_THRESHOLD == ref.LONG_SEQ_THRESHOLD


@pytest.mark.parametrize("warmup,iters", [(0, 1), (1, 2), (3, 4)])
def test_measure_step_time_counts_its_calls(warmup, iters):
    calls, made = [], []

    def args_factory(b, s):
        made.append((b, s))
        return (np.zeros((b, s)),)

    def step(x):
        calls.append(x.shape)

    t = port.measure_step_time(step, args_factory, 2, 8, warmup=warmup, iters=iters,
                               device="cpu")
    assert made == [(2, 8)] and calls == [(2, 8)] * (warmup + iters)
    assert t > 0 and np.isfinite(t)
    samples = port.run_measured_benchmark(step, args_factory, [(1, 4), (2, 8)], warmup=warmup,
                                          iters=iters, device="cpu")
    assert [(x.batch_size, x.seq_len) for x in samples] == [(1, 4), (2, 8)]
    assert all(x.step_time > 0 for x in samples)


def test_h100_defaults_are_the_published_peaks():
    m = port.AnalyticDeviceModel(port.ModelDims(**DIMS[0]))
    assert m.peak_flops == 989e12 and m.hbm_bw == 3.35e12
    assert 0 < m.efficiency <= 1 and 0 < m.attn_efficiency <= 1 and m.overhead >= 0
    assert port.H100_PEAK_FLOPS_BF16 == 989e12 and port.H100_HBM_BW == 3.35e12
    assert not hasattr(port, "ICI_BW") and not hasattr(port, "PEAK_FLOPS_BF16")
