"""Where a training step's device time goes, measured with ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_train

Builds Wan-2.1 1.3B (random weights from seed 0, bf16, 30 layers) on the
GPU and a step of two microbatches from the 480p buckets of
``chip_smoke.py`` phase 5: the image bucket (B 10 x S 1637) and the
33-frame bucket (B 1 x S 7877).  Runs the step once to meet both batch
signatures, then profiles one more through the same ``EmulatedEngine``.
Prints one JSON object: device time by kernel family (the port's nine
kernels, cuBLAS matrix products, elementwise/reduction, copies, other),
the device's busy time, and its idle share of the window from the first
kernel's start to the last kernel's end.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.configs.registry import get_config, get_optimizer
from repro_torch.core.bucketing import Bucket, DataShape
from repro_torch.data.synthetic import make_diffusion_batch
from repro_torch.launch.profile_serve import profile
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.engine import EmulatedEngine
from repro_torch.train.steps import init_state

BUCKETS = (Bucket(DataShape(1, 480, 832, 77), 10), Bucket(DataShape(33, 480, 832, 77), 1))


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train measures the GPU; no CUDA device is visible")
    cfg = get_config("wan2.1-1.3b")
    opt = OptimizerConfig(peak_lr=get_optimizer("wan2.1-1.3b").peak_lr, schedule="constant",
                          warmup=0, total_steps=2)
    state = init_state(cfg, opt, seed=0)
    dev = state["model"].device
    rng = np.random.default_rng(0)
    step = [[(b, make_diffusion_batch(int(rng.integers(2**31)), b.batch_size, b.seq_len, cfg,
                                      dev)) for b in BUCKETS]]
    engine = EmulatedEngine(cfg, opt)
    engine.execute_step(state, step, step_key=0, step=0)  # first signatures
    torch.cuda.synchronize()
    out = {"device": torch.cuda.get_device_name(0),
           "microbatches": [[b.batch_size, b.seq_len] for b in BUCKETS],
           "tokens_per_step": sum(b.tokens for b in BUCKETS),
           **profile(lambda: engine.execute_step(state, step, step_key=1, step=1))}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
