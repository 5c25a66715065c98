"""Where a training step's device time goes, measured with ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--arch wan2.1-1.3b]
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch mamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch llama3.2-1b

``wan2.1-1.3b`` (the default): builds Wan-2.1 1.3B (random weights from
seed 0, bf16, 30 layers) on the GPU and a step of two microbatches from
the 480p buckets of ``chip_smoke.py`` phase 5: the image bucket (B 10 x S
1637) and the 33-frame bucket (B 1 x S 7877).

``mamba2-2.7b``: builds Mamba-2 2.7B (64 layers, bf16, random weights from
seed 0) and a step of one B 4 x S 2048 microbatch of synthetic tokens, the
step of ``chip_smoke.py`` phase 8 (b).  It also times the SSD scan of one
layer (``models.ssm.ssd``: the einsums, cumulative sums and exponentials
between the conv and the gated norm) and one whole block, forward and
forward + backward, with CUDA events at the step's shape, and reports
their share of the step: each runs forward, recompute and backward.

``llama3.2-1b``: builds Llama-3.2-1B (16 layers, bf16, random weights from
seed 0) and profiles two steps of ``chip_smoke.py`` phase 9: one dense
packed step (one microbatch of two 8192-token windows of
``materialize_packed_windows`` over ``lm_length_corpus`` documents,
through ``EmulatedEngine``) and one sequence-parallel gradient step
(``make_sp_pool_grad_step`` on a ``LocalRing`` of 4, one 32768-token
window in shards of 8192), each run once before.

Both run the step once to meet its batch signatures, then profile one more
through the same ``EmulatedEngine``.  Prints one JSON object: device time
by kernel family (the port's kernels, cuBLAS matrix products in bf16 and
f32, elementwise/reduction, copies, other), the 12 kernels with the most
device time, the device's busy time, and its idle share of the window
from the first kernel's start to the last kernel's end.

``--streams``: where the planned loader's draws run.  Wan-2.1 1.3B at 10
of its 30 layers trains on 4 emulated ranks (``ShardedBucketedLoader``
over ``chip_smoke.py`` phase 10 (b)'s 480p buckets, 16384 tokens a rank),
once with ``make_batch`` on the default stream and once through
``data.pipeline.on_side_stream``; two steps meet the batch signatures,
two more are profiled.  From the trace (``build/streams_*.json``) it
reports, for each way, the kernels by stream that the trainer's thread,
the loader's thread (each known by a ``record_function`` range it opens)
and the others (autograd's backward) launched, how many of the loader's
ran on the
engine's timed stream inside the profiled steps and their device ms, and
the engine's mean microbatch ms by shape.
"""

from __future__ import annotations

import argparse
import dataclasses
from collections import Counter
import json
import pathlib
import sys
import types

import numpy as np
import torch

from repro_torch.configs.registry import get_config, get_optimizer
from repro_torch.core.bucketing import Bucket, BucketingPolicy, DataShape
from repro_torch.data.packing import split_packed_batch
from repro_torch.data.pipeline import (
    ShardedBucketedLoader,
    materialize_packed_windows,
    on_side_stream,
    to_device,
)
from repro_torch.data.synthetic import (
    lm_length_corpus,
    make_diffusion_batch,
    make_lm_batch,
    wan_mixed_corpus,
)
from repro_torch.kernels.flash_attention.ring import LocalRing
from repro_torch.launch.profile_serve import profile
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.engine import EmulatedEngine
from repro_torch.train.loop import Trainer
from repro_torch.train.steps import init_state, make_sp_pool_grad_step, sp_batch

BUCKETS = (Bucket(DataShape(1, 480, 832, 77), 10), Bucket(DataShape(33, 480, 832, 77), 1))
LM_BATCH, LM_SEQ = 4, 2048
DENSE_WINDOW, DENSE_WINDOWS = 8192, 2  # chip_smoke.py phase 9 (b)
SP_WINDOW, SP_RANKS = 32768, 4  # phase 9 (c)


TAIL = 100  # padding slots (-1) at the end of every packed window


def packed_microbatches(cfg, window: int, n_windows: int, count: int, seed: int = 0) -> list:
    """``count`` microbatches (numpy) of ``n_windows`` packed windows of
    ``window`` tokens each: ``lm_length_corpus`` documents (at most 8192
    tokens) packed first-fit-decreasing by ``materialize_packed_windows``
    into ``window - TAIL`` slots, then a padding tail of ``TAIL`` (segment
    id -1, token and label 0) on every window."""
    rng = np.random.default_rng(seed)
    need = 2 * count * n_windows * window // 1000  # documents of about 1,100 tokens
    lengths = lm_length_corpus(rng, need, hi=min(8192, window - TAIL))
    mbs = materialize_packed_windows(lengths, window=window - TAIL, vocab=cfg.vocab,
                                     batch_windows=n_windows, seed=seed)
    if len(mbs) < count or mbs[count - 1]["tokens"].shape[0] < n_windows:
        raise ValueError(f"the corpus packed into too few windows: {len(mbs)}")
    pad = ((0, 0), (0, TAIL))
    return [{"tokens": np.pad(mb["tokens"], pad), "labels": np.pad(mb["labels"], pad),
             "segment_ids": np.pad(mb["segment_ids"], pad, constant_values=-1)}
            for mb in mbs[:count]]


def _events_ms(fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def ssm_layer_times(model, cfg, tokens) -> dict:
    """ms of one layer's SSD scan and of one whole block at the step's
    shape, forward alone and forward + backward, and their per-step totals
    (``n_layers x (2 forward + backward)``: forward, recompute, backward)."""
    bp = model.blocks[0]
    p = bp.mixer
    x = model.embed[tokens.long()].detach().requires_grad_()
    with torch.no_grad():
        _, *ins = S.ssd_inputs(p, T.apply_norm(bp.norm1, x, cfg.norm, cfg.norm_eps), cfg.ssm)
    leaves = [t.contiguous().requires_grad_() for t in ins]
    q = min(cfg.ssm.chunk, tokens.shape[1])

    def ssd_fwd():
        return S.ssd(*leaves, p, q, cfg.ssm.head_dim)[0]

    def block_fwd():
        return T.apply_block(bp, x, cfg, None, T.kernels, "ssm")[0]

    out = {}
    for name, fwd in (("ssd", ssd_fwd), ("block", block_fwd)):
        y = fwd()
        dy = torch.randn_like(y)
        del y
        f = _events_ms(fwd)
        fb = _events_ms(lambda: torch.autograd.backward(fwd(), dy))
        out[name] = {"fwd_ms": f, "fwd_bwd_ms": fb,
                     "per_step_ms": cfg.n_layers * (f + fb)}  # fwd + (recompute + bwd)
    model.zero_grad(set_to_none=True)
    return out


def _main_mmdit() -> dict:
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
    return {"device": torch.cuda.get_device_name(0),
            "microbatches": [[b.batch_size, b.seq_len] for b in BUCKETS],
            "tokens_per_step": sum(b.tokens for b in BUCKETS),
            **profile(lambda: engine.execute_step(state, step, step_key=1, step=1))}


def _main_ssm() -> dict:
    cfg = get_config("mamba2-2.7b")
    opt = OptimizerConfig(peak_lr=get_optimizer("mamba2-2.7b").peak_lr, schedule="constant",
                          warmup=0, total_steps=2)
    state = init_state(cfg, opt, seed=0)
    dev = state["model"].device
    bucket = types.SimpleNamespace(batch_size=LM_BATCH, seq_len=LM_SEQ, tokens=LM_BATCH * LM_SEQ)
    batch = make_lm_batch(0, LM_BATCH, LM_SEQ, cfg.vocab, cfg, dev)
    step = [[(bucket, batch)]]
    engine = EmulatedEngine(cfg, opt)
    engine.execute_step(state, step, step_key=0, step=0)  # first signature
    torch.cuda.synchronize()
    out = {"device": torch.cuda.get_device_name(0),
           "microbatches": [[LM_BATCH, LM_SEQ]], "tokens_per_step": bucket.tokens,
           **profile(lambda: engine.execute_step(state, step, step_key=1, step=1))}
    layer = ssm_layer_times(state["model"], cfg, batch["tokens"])
    out["layer"] = layer
    out["ssd_share_of_busy"] = layer["ssd"]["per_step_ms"] / out["busy_ms"]
    out["blocks_share_of_busy"] = layer["block"]["per_step_ms"] / out["busy_ms"]
    return out


def _main_dense() -> dict:
    cfg = get_config("llama3.2-1b")
    opt = OptimizerConfig(peak_lr=get_optimizer("llama3.2-1b").peak_lr, schedule="constant",
                          warmup=0, total_steps=2)
    state = init_state(cfg, opt, seed=0)
    model = state["model"]
    dev = model.device
    arrays = packed_microbatches(cfg, DENSE_WINDOW, DENSE_WINDOWS, 1)[0]
    bucket = types.SimpleNamespace(batch_size=DENSE_WINDOWS, seq_len=DENSE_WINDOW,
                                   tokens=DENSE_WINDOWS * DENSE_WINDOW)
    step = [[(bucket, to_device(arrays, dev))]]
    engine = EmulatedEngine(cfg, opt)
    engine.execute_step(state, step, step_key=0, step=0)  # first signature
    torch.cuda.synchronize()
    out = {"device": torch.cuda.get_device_name(0),
           "dense": {"microbatches": [[DENSE_WINDOWS, DENSE_WINDOW]],
                     "tokens_per_step": bucket.tokens,
                     **profile(lambda: engine.execute_step(state, step, step_key=1, step=1))}}
    group = LocalRing(SP_RANKS)
    window = packed_microbatches(cfg, SP_WINDOW, 1, 1, seed=1)[0]
    batch = sp_batch(split_packed_batch(window, SP_RANKS), group, dev)
    sp = make_sp_pool_grad_step(cfg, group)

    def sp_step():
        loss, grads = sp(model, batch, 0, 0)
        del grads

    sp_step()
    torch.cuda.synchronize()
    out["sp"] = {"window": SP_WINDOW, "ranks": SP_RANKS, "table": group.table(
        batch["segment_ids"], batch["segment_ids"], True).astype(int).tolist(),
        **profile(sp_step)}
    return out


TRAINER_RANGE, LOADER_RANGE = "streams.trainer", "streams.make_batch"


def stream_report(trace: dict) -> dict:
    """Kernels of a Chrome trace by the thread that launched them (the
    runtime call with the kernel's correlation id; the trainer's and the
    loader's threads are those of the ``TRAINER_RANGE`` and ``LOADER_RANGE``
    annotations, autograd's backward thread and the rest are "other"):
    their streams, and the loader's kernels on a stream of the trainer's
    between its first and last kernel, with their device ms."""
    events = trace["traceEvents"]
    tids = {name: {e.get("tid") for e in events if e.get("name") == name}
            for name in (TRAINER_RANGE, LOADER_RANGE)}
    tid_of = {e["args"]["correlation"]: e.get("tid") for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by = {"trainer": [], "loader": [], "other": []}
    for k in kernels:
        tid = tid_of.get(k["args"].get("correlation"))
        by["trainer" if tid in tids[TRAINER_RANGE] else
           "loader" if tid in tids[LOADER_RANGE] else "other"].append(k)
    if not by["trainer"]:  # the trace names threads otherwise: say which it saw
        return {"unresolved": {"ranges": {k: sorted(map(str, v)) for k, v in tids.items()},
                               "launching": sorted(set(map(str, tid_of.values())))}}
    timed = {k["args"]["stream"] for k in by["trainer"]}
    lo = min(k["ts"] for k in by["trainer"])
    hi = max(k["ts"] + k["dur"] for k in by["trainer"])
    inside = [k for k in by["loader"] if k["args"]["stream"] in timed and lo <= k["ts"] <= hi]
    return {"kernels_by_stream": {who: dict(Counter(k["args"]["stream"] for k in ks))
                                  for who, ks in by.items()},
            "loader_kernels_on_timed_stream_in_steps": len(inside),
            "loader_ms_on_timed_stream_in_steps": sum(k["dur"] for k in inside) / 1e3}


def _main_streams() -> dict:
    cfg = dataclasses.replace(get_config("wan2.1-1.3b"), n_layers=10)
    opt = OptimizerConfig(peak_lr=get_optimizer("wan2.1-1.3b").peak_lr, schedule="constant",
                          warmup=0, total_steps=4)
    shapes, weights = wan_mixed_corpus()
    sel = [0, 2, 3]  # the 480p image, 17 and 33 frames: S = 1637, 4757, 7877
    buckets = BucketingPolicy(m_mem=16384, m_comp=6.4e7, p=2.0).make_buckets(
        [shapes[i] for i in sel])
    out_dir = pathlib.Path("build")  # the traces run to hundreds of MB
    out_dir.mkdir(exist_ok=True)
    out = {"device": torch.cuda.get_device_name(0), "layers": cfg.n_layers, "ranks": 4}
    for way in ("default", "side"):
        state = init_state(cfg, opt, seed=0)
        dev = state["model"].device

        def make_batch(rng, b):
            with torch.profiler.record_function(LOADER_RANGE):
                return make_diffusion_batch(int(rng.integers(2**31)), b.batch_size, b.seq_len,
                                            cfg, dev)

        loader = ShardedBucketedLoader(
            buckets, [weights[i] for i in sel],
            on_side_stream(make_batch, dev) if way == "side" else make_batch,
            n_workers=4, budget=16384.0, budget_of=lambda b: float(b.tokens),
            load_of=lambda b: b.load(2.0), strategy="lpt", seed=0)
        trace = out_dir / f"streams_{way}.json"
        try:
            trainer = Trainer(cfg, opt)
            data = iter(loader)
            state, _ = trainer.run(state, data, 2, rng=1, log_every=0)  # first signatures
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            # the loader's thread too, not only the one that starts the profile
            every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
            with torch.profiler.profile(activities=acts, experimental_config=every_thread) as prof:
                with torch.profiler.record_function(TRAINER_RANGE):
                    state, hist = trainer.run(state, data, 2, rng=2, log_every=0)
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(trace))
        finally:
            loader.close()
        rep = stream_report(json.loads(trace.read_text()))
        ms: dict[str, list] = {}
        for r in hist.records:
            ms.setdefault(f"{r.batch_size}x{r.seq_len}", []).append(1e3 * r.compute_time)
        rep["microbatch_ms"] = {k: float(np.mean(v)) for k, v in sorted(ms.items())}
        out[way] = rep
        del state
        torch.cuda.empty_cache()
    return out


def main(argv=()) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="wan2.1-1.3b",
                    choices=("wan2.1-1.3b", "mamba2-2.7b", "llama3.2-1b"))
    ap.add_argument("--streams", action="store_true",
                    help="where the planned loader's draws run (Wan-2.1, 4 ranks)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train measures the GPU; no CUDA device is visible")
    if args.streams:
        out = _main_streams()
        print(json.dumps(out))
        return out
    out = {"wan2.1-1.3b": _main_mmdit, "mamba2-2.7b": _main_ssm,
           "llama3.2-1b": _main_dense}[args.arch]()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
