"""One run of one cell: set-up, the measured window, the traced steps, and
the comparison with the reference that decides ``correct``.

The entry the window drives is ``repro_torch``'s ``Trainer.run`` on an
``EmulatedEngine`` at one rank, fed by ``BucketedLoader`` (its producer
thread drawing on a side stream, ``on_side_stream``) over the buckets of
``BucketingPolicy.make_buckets``, as ``launch/train.py --adaptive`` builds
them.  The engine's noise hook hands the loss the diffusion times and noise
that ``feed.make_batch`` drew with the batch.

Set-up builds the train state once from the seed's weights and runs, one
``Trainer.run`` step at a time, the steps the reference follows: the
cell's ``compared_steps`` (in ``cells/<cell>.json``, beside the limits
read at them), the loader's first steps and then any step of a
microbatch that set-up draws itself (another stream), such as one of the
longest bucket where the loader's first steps miss it.  It reads the
program's first moments after step 1 and each leaf's change after the last
compared step, before the next step overwrites them, then runs one warm-up
step holding a microbatch of every bucket those steps did not meet.  The
window then runs whole steps from where set-up left off until one finishes
at or after ``--seconds``; it meets no first-signature step.  With
``--trace 1`` the window is followed by ``PROFILE_STEPS`` steps under
``torch.profiler``.  The result's ``detail`` keeps the window's steps and
times, the set-up's marks and the reference's time, for the records, and
whether the loader's compared steps are those the limits were read at.
Once the window has closed and the program's state is freed, the
reference follows the compared steps and the gaps are held against the
cell's limits.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 2.0**30
TRACE_SEED = 0  # the loader's seed: the bucket order, the same for every --seed
PROFILE_STEPS = 3  # steps under the profiler after the window, with --trace 1


class Refused(RuntimeError):
    """A run that must end without a result (no card, a forbidden module)."""


# -- what the benchmark names --------------------------------------------------------


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(path: pathlib.Path):
    """The module of one per-layer metric's reader."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(entries: list, workload: str) -> list[dict]:
    return [m for m in entries if "workloads" not in m or workload in m["workloads"]]


def load_spec(workload: str, root: pathlib.Path = ROOT) -> dict:
    """Everything one cell names: its entry, configuration, traffic mix,
    limits and metrics, found by name under ``root``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    per_layer = metrics_of(bench["per_layer"], workload)
    limits = load_json(root / "portbench" / "cells" / f"{workload}.json")
    return {
        "cell": cell,
        "cfg": load_json(root / config["file"]),
        "traffic": load_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json"),
        "limits": limits["limits"],
        "compared_steps": [[tuple(mb) for mb in step] for step in limits["compared_steps"]],
        "end_to_end": metrics_of(bench["end_to_end"], workload),
        "per_layer": per_layer,
        "readers": {m["name"]: load_reader(root / "portbench" / "metrics" / f"{m['name']}.py")
                    for m in per_layer},
    }


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that belong to JAX or its package,
    each compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fix_caches(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own kernels build under ``build/repro_torch_kernels``)."""
    base = root / "build" / "portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


# -- the program's side --------------------------------------------------------------


class Tap:
    """The loader as the trainer sees it: each item taken is recorded as
    ``[(B, S, stream, index), ...]`` (the index its batch was drawn with),
    under a ``loader.next`` span."""

    def __init__(self, loader, index_of: dict, record_function):
        self.loader, self.index_of, self.rf = loader, index_of, record_function
        self.taken: list[list[tuple[int, int, int, int]]] = []

    def __iter__(self):
        return self

    def __next__(self):
        with self.rf("loader.next"):
            item = next(self.loader)
        self.taken.append([(b.batch_size, b.seq_len, *self.index_of.pop(id(batch)))
                           for b, batch in item])
        return item


class Run:
    """What the per-layer readers read."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.window_s = 0.0
        self.step_times: list[float] = []
        self.step_microbatches: list[list[tuple[int, int]]] = []
        self.trace = None
        self.traced_microbatches: list[tuple[int, int]] = []
        self.traced_launches: dict[str, int] = {}


def model_config(cfg: dict):
    from repro_torch.models.config import ModelConfig

    fixed = {"text_dim": 4096, "freq_dim": 256, "patch": [1, 2, 2]}  # repro_torch.models.mmdit
    for k, v in fixed.items():
        if cfg[k] != v:
            raise ValueError(f"the program's MMDiT has {k} {v}, the configuration {cfg[k]}")
    return ModelConfig(
        name=cfg["name"], family="mmdit", n_layers=cfg["n_layers"], d_model=cfg["d_model"],
        n_heads=cfg["n_heads"], n_kv_heads=cfg["n_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["d_ff"], vocab=0, text_len=cfg["text_len"], in_channels=cfg["in_channels"],
        norm_eps=cfg["norm_eps"], dtype=cfg["dtype"])


def optimizer_config(cfg: dict):
    from repro_torch.optim.adamw import OptimizerConfig

    o = cfg["optimizer"]
    return OptimizerConfig(peak_lr=o["peak_lr"], beta1=o["beta1"], beta2=o["beta2"],
                           eps=o["eps"], weight_decay=o["weight_decay"],
                           clip_norm=o["clip_norm"], schedule="constant", warmup=0,
                           total_steps=10**9, state_dtype="float32")


def _norms(pairs) -> dict[str, float]:
    import torch

    names = [n for n, _ in pairs]
    return dict(zip(names, torch.stack([t.float().norm() for _, t in pairs]).tolist()))


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        root: pathlib.Path = ROOT, device=None) -> dict:
    """One run; returns the result line's object.  ``device`` is for the
    CPU tests alone: without it the run needs the card and raises
    :class:`Refused` when there is none."""
    spec = load_spec(workload, root)
    cell, cfg, traffic = spec["cell"], spec["cfg"], spec["traffic"]
    fix_caches(root)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{workload} needs {cell['chips']} CUDA device(s); "
                          f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
        torch.set_num_threads(2)
    device = torch.device(device)
    on_card = device.type == "cuda"
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from torch.profiler import record_function

    from portbench import feed
    from portbench.reference import mmdit as ref
    from repro_torch import kernels
    from repro_torch.core.bucketing import BucketingPolicy, DataShape
    from repro_torch.data.pipeline import BucketedLoader, on_side_stream
    from repro_torch.models.mmdit import MMDiT
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.engine import EmulatedEngine
    from repro_torch.train.loop import Trainer, deserialize_rng_key

    card = power_limit() if on_card else None
    if on_card:
        from repro_torch.kernels import _build

        _build.build_all()  # every kernel at once; a no-op once built in this checkout

    mcfg, opt = model_config(cfg), optimizer_config(cfg)
    weights = feed.draw_weights(seed, cfg, device)
    model = MMDiT(mcfg, device="meta")
    shapes = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    if shapes != {n: (tuple(w.shape), w.dtype) for n, w in weights.items()}:
        raise RuntimeError("the program's parameters differ from the benchmark's list")
    model.load_state_dict(weights, assign=True)
    del weights
    state = {"model": model, "opt": init_opt_state(dict(model.named_parameters()), opt),
             "step": 0}

    policy = BucketingPolicy(m_mem=traffic["policy"]["m_mem"], m_comp=traffic["policy"]["m_comp"],
                             p=traffic["policy"]["p"], mode="adaptive")
    buckets = policy.make_buckets([DataShape(*sh) for sh in traffic["shapes"]])
    index_of: dict[int, tuple[int, int]] = {}
    drawn = [0]

    def make_batch(_rng, bucket):
        # one producer thread: the loader's stream is numbered in draw order
        i = drawn[0]
        drawn[0] += 1
        batch = feed.make_batch(seed, feed.LOADER_STREAM, i, bucket.batch_size, bucket.seq_len,
                                cfg, device)
        index_of[id(batch)] = (feed.LOADER_STREAM, i)
        return batch

    loader = BucketedLoader(buckets, traffic["weights"], on_side_stream(make_batch, device),
                            budget=float(traffic["budget_tokens"]),
                            budget_of=lambda b: float(b.tokens), seed=TRACE_SEED)
    try:
        tap = Tap(loader, index_of, record_function)
        engine = EmulatedEngine(mcfg, opt, noise=lambda key, idx, batch: (batch["t"], batch["eps"]))
        trainer = Trainer(mcfg, opt, engine=engine)
        at = {"rng": 1, "step": 0, "state": state}
        del state, model

        def step(data):
            with record_function("trainer.step"):
                at["state"], hist = trainer.run(at["state"], data, 1, rng=at["rng"],
                                                start_step=at["step"], log_every=0)
            at["rng"] = deserialize_rng_key(trainer.last_run_state["trainer"]["rng"])
            at["step"] += 1
            return hist

        # -- set-up: the compared steps, then the warm-up ----------------------------
        marks = {"state": time.perf_counter() - t_start}
        by_shape = {(b.batch_size, b.seq_len): b for b in buckets}
        prog = {"losses": []}
        compared = []
        for k, planned in enumerate(spec["compared_steps"]):
            if planned[0][2] == feed.LOADER_STREAM:
                prog["losses"] += step(tap).losses
                compared.append(tap.taken[-1])
            else:  # microbatches that set-up draws itself
                item = [(by_shape[(b, s)], feed.make_batch(seed, stream, i, b, s, cfg, device))
                        for b, s, stream, i in planned]
                prog["losses"] += step(iter([item])).losses
                compared.append(planned)
                del item
            if k == 0:
                prog["m"] = _norms(at["state"]["opt"]["m"].items())
        params = dict(at["state"]["model"].named_parameters())
        prog["change"] = {}
        with torch.no_grad():
            for i, (_, specs) in enumerate(feed.param_groups(cfg)):
                w0 = feed.draw_group(seed, i, specs, feed.DTYPES[cfg["dtype"]], device)
                prog["change"].update(_norms([(n, params[n].float() - w0[n].float())
                                              for n in w0]))
                del w0
        del params
        marks["compared_steps"] = time.perf_counter() - t_start
        seen = {(b, s) for item in compared for b, s, _, _ in item}
        warm = [b for b in buckets if (b.batch_size, b.seq_len) not in seen]
        if warm:
            with record_function("warmup"):
                item = [(b, feed.make_batch(seed, feed.WARMUP_STREAM, j, b.batch_size,
                                            b.seq_len, cfg, device)) for j, b in enumerate(warm)]
                step(iter([item]))
                del item
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

        # -- the window ---------------------------------------------------------------
        rec = Run(cfg)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        first = len(tap.taken)
        losses = []
        t0 = time.perf_counter()
        while True:
            hist = step(tap)
            if hist.compile_steps:
                raise RuntimeError(f"step {at['step'] - 1} of the window ran a batch signature "
                                   f"for the first time: the warm-up missed it")
            rec.step_times += hist.step_times
            losses += hist.losses
            if time.perf_counter() - t0 >= seconds:
                break
        rec.window_s = time.perf_counter() - t0
        window = tap.taken[first:]
        rec.step_microbatches = [[(b, s) for b, s, _, _ in item] for item in window]
        window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

        if trace:
            from portbench import trace as tr

            kernels.reset_launch_counts()
            before = len(tap.taken)
            acts = [torch.profiler.ProfilerActivity.CUDA if on_card
                    else torch.profiler.ProfilerActivity.CPU]
            with torch.profiler.profile(activities=acts) as prof:
                t_traced = time.perf_counter()
                with record_function(tr.WINDOW_SPAN):
                    for _ in range(PROFILE_STEPS):
                        losses += step(tap).losses
                    if on_card:
                        torch.cuda.synchronize()
                traced_s = time.perf_counter() - t_traced
            rec.traced_launches = kernels.launch_counts()
            rec.traced_microbatches = [(b, s) for item in tap.taken[before:] for b, s, _, _ in item]
            rec.trace = tr.from_profiler(prof, traced_s)
            del prof
        memory_peak = max(setup_peak, window_peak,
                          torch.cuda.max_memory_allocated(device) if on_card else 0)
    finally:
        loader.close()
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or its package are loaded: {found}")

    # -- the comparison, with the program's state freed -------------------------------
    compared_steps = [[list(mb) for mb in item] for item in compared]
    as_set = compared == spec["compared_steps"]
    del at, trainer, engine, tap, loader
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = ref.follow(cfg, cfg["optimizer"], seed, compared_steps, device)
    reference_s = time.perf_counter() - t_ref
    nums = ref.gaps(prog, reference)
    limits = spec["limits"]
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in nums}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in checks.values())

    tokens = sum(b * s for mbs in rec.step_microbatches for b, s in mbs)
    values = {"tokens_per_s": tokens / rec.window_s, "peak_gib": window_peak / GIB,
              "setup_s": setup_s}
    out_metrics = {}
    if trace:
        for m in spec["per_layer"]:
            v = spec["readers"][m["name"]].read(rec)
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            out_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else str(device),
           "count": cell["chips"], "memory_peak_bytes": int(memory_peak),
           "name_power_limit": card}
    result = {"correct": correct, "attempted": len(losses),
              "failed": sum(1 for x in losses if not math.isfinite(x)),
              "metrics": out_metrics, "device": dev}
    if trace and rec.trace is not None and rec.trace.kernels:
        from portbench import trace as tr

        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = tr.breakdown(rec.trace)
    result["detail"] = {"window_steps": len(window), "window_s": rec.window_s,
                        "window_tokens": tokens, "compared_steps": compared_steps,
                        "compared_as_set": as_set,
                        "setup_marks": marks, "reference_s": reference_s,
                        "step_times": rec.step_times,
                        "window_microbatches": rec.step_microbatches,
                        "program": {"losses": prog["losses"]},
                        "reference": {"losses": reference["losses"]}}
    result["checks"] = checks
    return result
