"""CPU tests of the benchmark's frozen arithmetic, its names, its bucket
order and its imports."""

from __future__ import annotations

import ast
import json
import pathlib
import re

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import feed, flops, tiny
from portbench.reference import mmdit as ref
from portbench.rooflines import kernels as rl

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_microbatch_flops_match_a_counted_reference_step():
    """The frozen count against torch's own count of the plain reference's
    forward and backward of one sample (small enough to run without
    recompute)."""
    cfg = dict(tiny.CONFIG, n_layers=2)
    s = 40
    p = {n: w.requires_grad_() for n, w in feed.draw_weights(1, cfg, "cpu").items()}
    batch = feed.make_batch(1, 0, 0, 1, s, cfg, "cpu")
    with FlopCounterMode(display=False) as counter:
        ref.sample_loss(p, cfg, batch, 0, torch.matmul).backward()
    assert counter.get_total_flops() == flops.microbatch_flops(cfg, 1, s)


def test_flops_scale_with_batch_and_layers():
    cfg = dict(tiny.CONFIG)
    assert flops.microbatch_flops(cfg, 4, 24) == 4 * flops.microbatch_flops(cfg, 1, 24)
    assert flops.step_flops(cfg, [(4, 24), (2, 40)]) == (flops.microbatch_flops(cfg, 4, 24)
                                                         + flops.microbatch_flops(cfg, 2, 40))


def test_kernel_bounds_by_hand():
    # K1 at [2, 3, 8]: 2*48*2 + 2*2*8*4 + 2*6*4 bytes against 8*48 f32 operations
    assert rl.adaln_fwd(2, 3, 8) == max((192 + 128 + 48) / rl.HBM_BYTES_PER_S,
                                        384 / rl.F32_FLOPS)
    # K7 at Wan-2.1 1.3B's image bucket is bound by its 2 products
    b, s, h, dh = 10, 1637, 12, 128
    assert rl.flash_fwd(b, s, s, h, dh) == 4 * b * h * s * s * dh / rl.BF16_FLOPS
    # the backward the function needs: five products, whatever kernels run it
    assert rl.flash_bwd(b, s, s, h, dh) == 2.5 * rl.flash_fwd(b, s, s, h, dh)
    per = rl.launches(30)
    assert (per["adaln_fwd"], per["flash_fwd"], per["qk_rms_bwd_dw"]) == (121, 120, 30)
    cfg = dict(tiny.CONFIG, n_layers=30, d_model=1536, n_heads=12, head_dim=128, text_len=512)
    assert rl.flash_bound(cfg, b, s) == 30 * (rl.attention(b, s, s, h, dh)
                                              + rl.attention(b, s, 512, h, dh))
    # one call's 7 products, against the 11 that K7 twice, K8 and K9 run
    assert rl.attention(b, s, s, h, dh) == 3.5 * rl.flash_fwd(b, s, s, h, dh)
    norms = rl.norm_bounds(cfg, b, s)
    assert norms > 121 * rl.adaln_fwd(b, s, 1536) + 30 * rl.qk_rms_bwd_dw(b, s, h, dh)


def test_benchmark_names_units_and_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = ([m["name"] for m in metrics] + [c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == cfg["reduced"] and all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "portbench" / "cells" / f"{w['name']}.json").exists()
    for m in bench["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" not in p.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT))), p


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_its_package(path):
    """Top-level names compared whole: ``repro_torch`` is not ``repro``; the
    reference imports nothing of the program either."""
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    if "reference" in path.parts:
        assert "repro_torch" not in tops


def test_weights_are_drawn_per_group_and_again_alike():
    cfg = tiny.CONFIG
    w = feed.draw_weights(5, cfg, "cpu")
    groups = feed.param_groups(cfg)
    assert sorted(w) == sorted(n for _, specs in groups for n, _, _ in specs)
    again = feed.draw_group(5, 2, groups[2][1], torch.float32, "cpu")
    assert all(torch.equal(again[n], w[n]) for n in again)
    assert torch.equal(w["blocks.0.qnorm"], torch.ones(32))
    scale = float(w["blocks.1.mlp.w2"].std()) * np.sqrt(cfg["d_ff"])
    assert 0.8 < scale < 1.2


def test_trace_busy_idle_and_labelled_gaps():
    from portbench import trace

    tr = trace.Trace(
        kernels=[("flash_fwd_wg_kernel", 0.0, 40.0), ("nvjet_tst_x", 30.0, 60.0),
                 ("adaln_fwd_kernel", 70.0, 80.0), ("adaln_bwd_dmod_reduce_kernel", 95.0, 100.0)],
        spans=[("trainer.step", 0.0, 82.0), ("loader.next", 78.0, 96.0)],
        window_s=120e-6)
    assert tr.busy_intervals() == [(0.0, 60.0), (70.0, 80.0), (95.0, 100.0)]
    assert abs(tr.busy_s - 75e-6) < 1e-12
    gaps = tr.gaps()
    assert [g[0] for g in gaps] == ["trainer.step", "loader.next", "edges"]
    assert abs(sum(g[1] for g in gaps) + tr.busy_s - tr.window_s) < 1e-12
    assert trace.family("void wg::flash_bwd_dkv_wg_kernel<128>(Params)") == "K9 flash_bwd_dkv"
    out = trace.breakdown(tr)
    assert out["device_ops"][0] == ["K7 flash_fwd | flash_fwd_wg_kernel", 40e-6]
