"""A tiny cell for the CPU tests: a two-block MMDiT of width 64 and two
buckets of 24 and 40 tokens, written as files into a copy of the
benchmark's tree, so that the harness finds it by name as it finds the
real cells."""

from __future__ import annotations

import json
import pathlib
import shutil

ROOT = pathlib.Path(__file__).resolve().parents[1]

CONFIG = {
    "name": "tiny", "source": "a test size", "family": "mmdit", "n_layers": 2, "d_model": 64,
    "n_heads": 2, "head_dim": 32, "d_ff": 128, "freq_dim": 256, "in_channels": 16,
    "patch": [1, 2, 2], "text_len": 16, "text_dim": 4096, "norm_eps": 1e-6, "dtype": "float32",
    "optimizer": {"peak_lr": 1e-3, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8,
                  "weight_decay": 0.1, "clip_norm": 1.0},
    "reduced": [],
}
TRAFFIC = {
    "name": "tiny-mix", "shapes": [[1, 64, 64, 8], [9, 64, 64, 8]], "weights": [0.5, 0.5],
    "policy": {"m_mem": 100, "m_comp": 1e9, "p": 2.0}, "budget_tokens": 100,
}
LIMITS = {"loss": 1e-4, "grad": 1e-3, "change": 1e-3}
#: the loader's first two steps (its draw from the harness's trace seed),
#: then one step that set-up draws itself
COMPARED = [[[2, 40, 0, 0], [4, 24, 0, 1]], [[4, 24, 0, 2], [4, 24, 0, 3]], [[2, 40, 2, 0]]]


def make_root(tmp: pathlib.Path, *, dtype: str = "float32") -> pathlib.Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` under ``tmp`` that
    gains the tiny configuration, mix, cell and a metric by new files and
    entries alone.  Returns the copy's root."""
    root = tmp / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    (pb / "configs" / "tiny.json").write_text(json.dumps(dict(CONFIG, dtype=dtype)))
    (pb / "traffic" / "tiny-mix.json").write_text(json.dumps(TRAFFIC))
    (pb / "cells" / "tiny-train.json").write_text(json.dumps({"compared_steps": COMPARED,
                                                                 "limits": LIMITS}))
    (pb / "metrics" / "window_steps.py").write_text(
        'UNIT = "steps"\nLAYER = "trainer"\nSOURCE = "program_counter"\n'
        'MOVES = "tokens_per_s"\n\n\ndef read(run):\n    return float(len(run.step_times))\n')
    bench["configs"].append({"name": "tiny", "source": "a test size",
                             "file": "portbench/configs/tiny.json", "reduced": []})
    bench["workloads"].append({"name": "tiny-train", "config": "tiny", "traffic": "tiny-mix",
                               "chips": 1, "why": "the CPU tests' cell"})
    bench["per_layer"].append({"name": "window_steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "trainer",
                               "moves": "tokens_per_s", "workloads": ["tiny-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
