"""CPU tests of whole runs of the harness on a tiny cell that a copy of the
benchmark gains by new files alone, with the timed path sound and broken,
and of the plain reference against the port's plain path."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from portbench import feed, harness, tiny
from portbench.reference import mmdit as ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = harness.forbidden_modules


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def jax_of_other_tests(monkeypatch):
    """A test process may hold JAX from other test files: the harness's
    check then reports only what a run loads itself."""
    before = set(FORBIDDEN())
    monkeypatch.setattr(harness, "forbidden_modules", lambda: sorted(set(FORBIDDEN()) - before))


def test_the_check_names_jax_and_its_package_by_whole_top_level_names(monkeypatch):
    import types

    for name in ("jax", "repro.models", "repro_torch_extra"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = FORBIDDEN()
    assert {"jax", "repro"} <= set(found) and "repro_torch_extra" not in found
    assert "repro_torch" not in found


def _run(root, seed=123456789012):
    return harness.run("tiny-train", seed, 0.3, False, t_start=time.perf_counter(), root=root,
                       device="cpu")


def test_a_copy_gains_a_config_a_mix_a_cell_and_a_metric_by_files(root):
    spec = harness.load_spec("tiny-train", root)
    assert spec["cfg"]["name"] == "tiny" and spec["traffic"]["name"] == "tiny-mix"
    assert "window_steps" in spec["readers"]
    assert [m["name"] for m in spec["end_to_end"]] == ["tokens_per_s", "peak_gib", "setup_s"]
    # the real cells do not read the test's metric
    real = harness.load_spec("wan1.3b-train-mix", root)["readers"]
    assert "window_steps" not in real
    rec = harness.Run(spec["cfg"])
    rec.step_times = [0.1, 0.2]
    assert spec["readers"]["window_steps"].read(rec) == 2.0
    # the readers of the device find nothing to read without a trace
    for name in ("device_idle_pct", "flash_roofline", "adaln_norm_roofline"):
        assert real[name].read(rec) is None


def test_a_sound_run_is_correct_and_its_order_is_the_replay(root):
    out = _run(root)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"tokens_per_s", "peak_gib", "setup_s"}
    assert list(out)[-1] == "checks"
    assert out["detail"]["compared_steps"] == tiny.COMPARED
    assert out["detail"]["compared_as_set"]


def test_replayed_order_is_the_loaders_and_the_same_for_every_seed(root):
    """Two --seeds compare the same steps of the loader's draw, with
    different rows."""
    a, b = _run(root, seed=11), _run(root, seed=2**31 + 5)
    assert a["detail"]["compared_steps"] == b["detail"]["compared_steps"] == tiny.COMPARED
    assert a["detail"]["window_microbatches"][:2] == b["detail"]["window_microbatches"][:2]
    assert a["detail"]["program"]["losses"] != b["detail"]["program"]["losses"]
    cfg = tiny.CONFIG
    x = feed.make_batch(11, feed.LOADER_STREAM, 3, 2, 24, cfg, "cpu")
    y = feed.make_batch(2**31 + 5, feed.LOADER_STREAM, 3, 2, 24, cfg, "cpu")
    again = feed.make_batch(11, feed.LOADER_STREAM, 3, 2, 24, cfg, "cpu")
    for k in x:
        assert torch.equal(x[k], again[k]) and not torch.equal(x[k], y[k])


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(root, monkeypatch):
    from repro_torch.train import engine

    monkeypatch.setattr(engine, "adamw_update", lambda *a, **k: None)
    out = _run(root)
    assert not out["correct"] and out["checks"]["change"]["value"] > 0.99


def test_half_the_batch_left_out_is_not_correct(root, monkeypatch):
    from repro_torch.train import engine

    whole = engine.make_pool_grad_step

    def halved(cfg, noise=None, **kw):
        step = whole(cfg, noise, **kw)

        def grad_step(model, batch, key, index):
            n = -(-batch["latents"].shape[0] // 2)
            return step(model, {k: v[:n] for k, v in batch.items()}, key, index)

        return grad_step

    monkeypatch.setattr(engine, "make_pool_grad_step", halved)
    out = _run(root)
    assert not out["correct"]


def test_the_fp8_control_fails_the_limits_of_every_cell():
    """The reference computed with float8 products, put in the program's
    place at the tiny size in bf16, reads above every cell's limit on at
    least one number."""
    cfg = dict(tiny.CONFIG, dtype="bfloat16")
    steps = [[tuple(mb) for mb in step] for step in tiny.COMPARED]
    want = ref.follow(cfg, cfg["optimizer"], 7, steps, "cpu")
    got = ref.follow(cfg, cfg["optimizer"], 7, steps, "cpu", precision="fp8")
    gaps = ref.gaps(got, want)
    for path in sorted((ROOT / "portbench" / "cells").glob("*.json")):
        limits = json.loads(path.read_text())["limits"]
        assert any(gaps[k] > limits[k] for k in limits), (path.name, gaps)


def test_reference_matches_the_ports_plain_path():
    """At the port's smoke size in f32: the loss and every gradient of one
    microbatch, the reference against ``rectified_flow_loss`` on the plain
    kernels with the same weights and draws."""
    from repro_torch.configs import wan2_1_mmdit
    from repro_torch.models.mmdit import MMDiT, rectified_flow_loss

    mc = wan2_1_mmdit.smoke_config()
    cfg = dict(tiny.CONFIG, n_layers=mc.n_layers, d_model=mc.d_model, n_heads=mc.n_heads,
               head_dim=mc.head_dim, d_ff=mc.d_ff, text_len=mc.text_len, dtype="float32")
    model = MMDiT(mc, device="meta")
    model.load_state_dict(feed.draw_weights(3, cfg, "cpu"), assign=True)
    batch = feed.make_batch(3, 0, 0, 3, 24, cfg, "cpu")
    loss = rectified_flow_loss(model, batch["latents"], batch["text"], t=batch["t"],
                               eps=batch["eps"], ops="plain")
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    p = {n: w.detach().clone().requires_grad_() for n, w in model.named_parameters()}
    want = sum(ref.sample_loss(p, cfg, batch, r, torch.matmul) for r in range(3)) / 3
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    for n, g in grads.items():
        assert float((g - p[n].grad).norm()) <= 1e-4 * float(p[n].grad.norm()) + 1e-12, n


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "wan1.3b-train-image480", "--seed", "1", "--seconds", "1"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.card
def test_control_and_faults_on_the_card():
    """The control's and the half-batch fault's readings at each cell's own
    size on three seeds (``portbench/control.py``); the card alone runs it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import control

    for cell in ("wan1.3b-train-image480",):
        rows = control.readings(cell, [1, 2, 3])
        limits = harness.load_spec(cell)["limits"]
        for row in rows:
            assert any(row["control"][k] > limits[k] for k in limits), row
