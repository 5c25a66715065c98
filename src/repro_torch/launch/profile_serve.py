"""Where a serving iteration's device time goes, measured with
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--arch wan2.1-1.3b]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch llama3.2-1b

``wan2.1-1.3b`` (the default): builds Wan-2.1 1.3B (random weights from
seed 0) on the GPU, admits three clips of 1, 2 and 3 latent frames at
480x832 into a 4-slot engine (the fourth slot stays empty, as in
``chip_smoke.py``'s first waves), runs one wave to warm up, then profiles
two more.

``llama3.2-1b``: builds Llama-3.2-1B (16 layers, bf16, random weights from
seed 0) and a ``ServeEngine`` with 8 decode slots over 4096 pages of 16
tokens; admits eight requests with prompts of 64 to 2000 tokens, runs one
wave to warm up, then profiles one steady decode wave over the 8 slots at
their different depths, and one B = 1 prefill of 2048 tokens into free
pages (run once before to warm up).

Prints one JSON object: device time by kernel family (the port's kernels,
cuBLAS matrix products, elementwise/reduction, copies, other), the
device's busy time, and its idle share of the window from the first
kernel's start to the last kernel's end.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import DEMO_MODEL
from repro_torch.models.mmdit import MMDiT
from repro_torch.models.transformer import Transformer
from repro_torch.serve import DiffusionServeEngine, ServeConfig, ServeEngine
from repro_torch.train.steps import make_paged_prefill_step

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("K7 flash_fwd", ("flash_fwd_",)),  # flash_fwd_wg_kernel (bf16), flash_fwd_f32_kernel
    ("K8 flash_bwd_dq", ("flash_bwd_dq_",)),  # flash_bwd_dq_wg_kernel (bf16), flash_bwd_dq_kernel (f32)
    ("K9 flash_bwd_dkv", ("flash_bwd_dkv_",)),  # flash_bwd_dkv_wg_kernel, flash_bwd_dkv_kernel
    ("K11 ring_merge", ("merge_kernel",)),
    ("K11 ring_finalize", ("finalize_kernel",)),
    ("K1 adaln_fwd", ("adaln_fwd_kernel",)),
    ("K2 adaln_bwd_dx", ("adaln_bwd_dx_kernel",)),
    ("K10 adaln_bwd_dmod_naive", ("adaln_bwd_dmod_naive_kernel",)),
    ("K3 adaln_bwd_dmod", ("adaln_bwd_dmod_",)),
    ("K4 qk_rms_fwd", ("qk_rms_fwd_kernel",)),
    ("K13 gated_rms_fwd", ("gated_rms_fwd_kernel",)),
    ("K4 rms_fwd (rows)", ("rms_fwd_kernel",)),
    ("K12 paged_decode", ("paged_decode_",)),  # paged_decode_chunk_kernel (bf16, f32)
    ("K5 qk_rms_bwd_dx", ("qk_rms_bwd_dx_kernel",)),
    ("K6 qk_rms_bwd_dw", ("qk_rms_bwd_dw_",)),
    ("K5 rms_bwd_dx (rows)", ("rms_bwd_dx_kernel",)),
    ("K6 rms_bwd_dw (rows)", ("rms_bwd_dw_",)),
    # f32 products (the SSD einsums, the LM head's f32 logits)
    ("matmul f32 (cuBLAS)", ("sgemm", "f32f32_f32f32", "gemm_f32")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")),
    ("copy", ("memcpy", "memset", "copy")),
    ("elementwise / reduce", ("elementwise", "reduce", "vectorized", "cat", "index")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def breakdown(kernels: list[tuple[str, float, float]]) -> dict:
    """``kernels``: (name, start_us, end_us) of every device kernel.  Busy
    time is the union of their intervals; idle is the rest of the window."""
    by_family: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for name, t0, t1 in kernels:
        by_family[family(name)] = by_family.get(family(name), 0.0) + (t1 - t0)
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
    spans = sorted((t0, t1) for _, t0, t1 in kernels)
    busy, cur0, cur1 = 0.0, *spans[0]
    for t0, t1 in spans[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    window = max(t1 for _, t1 in spans) - spans[0][0]
    return {
        "device_ms_by_family": {k: v / 1e3 for k, v in sorted(by_family.items())},
        "busy_ms": busy / 1e3,
        "window_ms": window / 1e3,
        "idle_share": 1.0 - busy / window,
        # the 12 kernels with the most device time, by name (ms)
        "top_kernels": {k[:120]: v / 1e3 for k, v in
                        sorted(by_name.items(), key=lambda kv: -kv[1])[:12]},
    }


def profile(work) -> dict:
    """:func:`breakdown` of the device kernels ``work()`` launches, from
    ``torch.profiler`` over the call and a final synchronisation."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        work()
        torch.cuda.synchronize()
    kernels = [
        (e.name, e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernel")
    return breakdown(kernels)


WAVES = 2
FRAME = 1560  # latent tokens per frame at 480x832

#: the LM route: prompt lengths of the eight resident requests, and the
#: width of the profiled prefill
LM_PROMPTS = (64, 128, 256, 512, 768, 1024, 1536, 2000)
LM_PREFILL = 2048


def lm_workload(cfg, device, *, prompts=LM_PROMPTS, prefill=LM_PREFILL, page_size=16):
    """The LM route's two iterations as closures on a live engine:
    ``(decode_wave, prefill, engine)``.  ``decode_wave()`` runs one engine
    step over the 8 resident requests (no admission left); ``prefill()``
    runs one B = 1 prefill of ``prefill`` tokens into pages no request
    holds."""
    model = Transformer(cfg, seed=0, device=device)
    serve = ServeConfig(target_step=1.0, page_size=page_size, num_pages=4096,
                        decode_slots=len(prompts), max_seq=4096)
    eng = ServeEngine(model, cfg, DEMO_MODEL, serve)
    rng = np.random.default_rng(0)
    for n in prompts:
        eng.submit(rng.integers(0, cfg.vocab, size=n).astype(np.int32), max_new=64)
    while eng.waiting:  # admission, and the first waves
        eng.step()
    pages = eng.pool.alloc(prefill // page_size, owner=-1)
    dev = eng.device
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, prefill)).astype(np.int32)).to(dev)
    true_len = torch.tensor([prefill], dtype=torch.int32, device=dev)
    table = torch.tensor([pages], dtype=torch.int32, device=dev)
    step = make_paged_prefill_step(cfg)

    def prefill_once():
        return step(model, tokens, true_len, table, eng.pools)

    return eng.step, prefill_once, eng


def _main_mmdit() -> dict:
    cfg = get_config("wan2.1-1.3b")
    mmdit = MMDiT(cfg, seed=0)
    max_seq = 4 * FRAME
    serve = ServeConfig(target_step=1e9, page_size=FRAME, num_pages=16,
                        decode_slots=4, max_seq=max_seq)
    eng = DiffusionServeEngine(mmdit, cfg, DEMO_MODEL, serve)
    rng = np.random.default_rng(0)
    for frames in (1, 2, 3):
        eng.submit(
            rng.standard_normal((frames * FRAME, cfg.in_channels * 4)).astype(np.float32),
            rng.standard_normal((cfg.text_len, eng.TEXT_DIM)).astype(np.float32),
            n_steps=WAVES + 1,
        )
    eng.step()  # admission and the first wave
    torch.cuda.synchronize()
    return {"device": torch.cuda.get_device_name(0), "arch": cfg.name, "waves": WAVES,
            "tokens_per_wave": 4 * max_seq,
            **profile(lambda: [eng.step() for _ in range(WAVES)])}


def _main_lm() -> dict:
    cfg = get_config("llama3.2-1b")
    decode_wave, prefill, eng = lm_workload(cfg, None)
    decode_wave()  # warm-up wave
    prefill()  # warm-up prefill
    torch.cuda.synchronize()
    depths = [int(n) for n in eng.kv_lens]
    return {"device": torch.cuda.get_device_name(0), "arch": cfg.name,
            "decode_wave": {"slots": len(depths), "kv_lens": depths, **profile(decode_wave)},
            "prefill": {"tokens": LM_PREFILL, **profile(prefill)}}


def main(argv=()) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="wan2.1-1.3b", choices=("wan2.1-1.3b", "llama3.2-1b"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_serve measures the GPU; no CUDA device is visible")
    out = _main_lm() if args.arch == "llama3.2-1b" else _main_mmdit()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
