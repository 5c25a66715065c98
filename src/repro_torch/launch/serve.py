"""Serving launcher: plan-driven continuous batching on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --requests 8 --gen 16

    PYTHONPATH=src python -m repro_torch.launch.serve --arch wan2.1-1.3b \
        --requests 4

runs on CUDA; ``--device cpu --smoke`` runs the plain PyTorch path on the
CPU at the smoke size.  LM requests stream through
:class:`repro_torch.serve.ServeEngine` (iteration-level admission against
the ``a + b·B·S^p`` cost model, paged KV-cache pool); mmdit configs route
denoise sampling through :class:`repro_torch.serve.DiffusionServeEngine`
on the same scheduler.  Paged serving takes global-attention and MoE LMs
(MusicGen-large among them) only: a model with other block kinds
(Mamba-2, RecurrentGemma, Llama-3.2-Vision's cross layers) is refused
before it is built, as the reference's engine refuses it; those serve
contiguously
(``train.steps.make_prefill_step`` / ``make_decode_step``).  The cost model here is a synthetic seed (no fitted
telemetry on a demo host).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.cost_model import CostModel
from repro_torch.models.mmdit import MMDiT
from repro_torch.models.transformer import Transformer, paged_kinds
from repro_torch.serve import DiffusionServeEngine, ServeConfig, ServeEngine

#: synthetic seed fit for demo runs: ~5 ms fixed overhead, p = 2 attention
DEMO_MODEL = CostModel(a=0.005, b=2e-7, p=2.0, r2=1.0)


def _lat(reqs) -> tuple[float, float, float]:
    lats = sorted(r.latency for r in reqs)
    p50 = lats[len(lats) // 2]
    p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
    return lats[-1], p50, p99


def _serve_config(args) -> ServeConfig:
    return ServeConfig(
        target_step=args.target_step,
        page_size=args.page_size,
        num_pages=args.num_pages,
        decode_slots=args.slots,
        max_seq=args.max_seq,
    )


def serve_lm(cfg, args) -> ServeEngine:
    paged_kinds(cfg)  # refuse a model paged serving cannot run before building it
    model = Transformer(cfg, seed=0, device=args.device)
    eng = ServeEngine(model, cfg, DEMO_MODEL, _serve_config(args))
    rng = np.random.default_rng(args.seed)
    clock = 0.0
    for _ in range(args.requests):
        clock += float(rng.exponential(1.0 / args.rate))
        plen = int(rng.integers(4, max(5, args.max_seq // 4)))
        prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        eng.submit(prompt, 1 + int(rng.integers(1, args.gen + 1)), arrival=clock)
    done = eng.run()
    worst, p50, p99 = _lat(done)
    toks = sum(len(r.out) for r in done)
    print(
        f"served {len(done)} LM requests in {len(eng.iterations)} iterations "
        f"({eng.clock:.3f} s simulated): {toks} tokens generated"
    )
    print(f"latency p50 {p50:.3f} s, p99 {p99:.3f} s, worst {worst:.3f} s")
    print(f"goodput {toks / eng.clock:,.1f} tok/s (simulated clock)")
    print("sample generation (ids):", done[0].out[:16])
    return eng


def serve_mmdit(cfg, args) -> DiffusionServeEngine:
    serve = _serve_config(args)
    mmdit = MMDiT(cfg, seed=0, device=args.device)
    eng = DiffusionServeEngine(mmdit, cfg, DEMO_MODEL, serve)
    rng = np.random.default_rng(args.seed)
    clock = 0.0
    for _ in range(args.requests):
        clock += float(rng.exponential(1.0 / args.rate))
        s_vis = int(rng.integers(args.max_seq // 4, args.max_seq + 1))
        lat = rng.standard_normal((s_vis, cfg.in_channels * 4)).astype(np.float32)
        txt = rng.standard_normal(
            (cfg.text_len, DiffusionServeEngine.TEXT_DIM)
        ).astype(np.float32)
        eng.submit(lat, txt, args.denoise_steps, arrival=clock)
    done = eng.run()
    worst, p50, p99 = _lat(done)
    steps = sum(r.n_steps for r in done)
    print(
        f"served {len(done)} denoise requests in {len(eng.iterations)} "
        f"iterations ({eng.clock:.3f} s simulated): {steps} denoise steps"
    )
    print(f"latency p50 {p50:.3f} s, p99 {p99:.3f} s, worst {worst:.3f} s")
    print(f"sample result norm: {float(np.linalg.norm(done[0].result)):.3f}")
    return eng


def main(argv=None) -> ServeEngine | DiffusionServeEngine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without a GPU); 'cpu' runs the plain path")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=20.0, help="arrivals/s")
    ap.add_argument("--gen", type=int, default=16, help="max new tokens")
    ap.add_argument("--target-step", type=float, default=0.25)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=256)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--denoise-steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "mmdit":
        return serve_mmdit(cfg, args)
    return serve_lm(cfg, args)


if __name__ == "__main__":
    main()
