"""LM serving example: plan-driven continuous batching on the paged KV
cache, checked token for token against contiguous serving.

The port of ``examples/serve_lm.py``.  A Poisson stream of mixed-length
requests flows through :class:`repro_torch.serve.ServeEngine`
(iteration-level admission priced by the ``a + b·B·S^p`` cost model,
decode-first scheduling, fragmented paged KV pool), and every generation
must equal per-request contiguous serving (``make_prefill_step`` /
``make_decode_step``): ``token_mismatches`` is 0 or the example raises.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

On the CPU it runs the reference's smoke config (f32).  On the card it
runs the architecture at full width in that same dtype, f32: the card's
kernels take no head dim of 16, and f32 keeps the exact-token check
meaningful (in bf16 a near-tie of two logits may fall either way).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.cost_model import CostModel
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train.steps import make_decode_step, make_prefill_step

COST = CostModel(a=0.005, b=2e-7, p=2.0, r2=1.0)
SERVE = ServeConfig(target_step=0.1, page_size=8, num_pages=64, decode_slots=4, max_seq=48)


def run(arch: str = "llama3.2-1b", device=None) -> dict:
    """Serve the reference's stream of 6 requests, then decode each alone.
    Returns the counts of the run, ``token_mismatches`` among them, and the
    engine."""
    device = resolve_device(device)
    cfg = (get_smoke_config(arch) if device.type == "cpu"
           else dataclasses.replace(get_config(arch), dtype="float32"))
    model = Transformer(cfg, seed=0, device=device)
    eng = ServeEngine(model, cfg, COST, SERVE)

    rng = np.random.default_rng(0)
    specs, clock = [], 0.0
    for _ in range(6):
        clock += float(rng.exponential(0.02))
        plen = int(rng.integers(4, 20))
        prompt = rng.integers(0, cfg.vocab, size=plen).astype(np.int32)
        max_new = int(rng.integers(4, 12))
        specs.append((prompt, max_new))
        eng.submit(prompt, max_new, arrival=clock)

    t0 = time.perf_counter()
    done = eng.run()
    wall = time.perf_counter() - t0

    # parity: every generation against per-request contiguous serving
    pf = make_prefill_step(cfg, cache_cap=SERVE.max_seq)
    dc = make_decode_step(cfg)
    mismatches, refs = 0, {}
    for r in sorted(done, key=lambda r: r.rid):
        prompt, max_new = specs[r.rid]
        logits, caches = pf(model, torch.from_numpy(prompt)[None, :].to(device))
        ref, pos = [int(logits[0].argmax())], len(prompt)
        for _ in range(max_new - 1):
            tok = torch.tensor([[ref[-1]]], dtype=torch.int32, device=device)
            logits, caches = dc(model, caches, tok, pos)
            ref.append(int(logits[0].argmax()))
            pos += 1
        mismatches += sum(1 for x, y in zip(ref, r.out) if x != y) + abs(len(ref) - len(r.out))
        refs[r.rid] = ref
    return dict(arch=cfg.name, dtype=cfg.dtype, device=str(device), requests=len(done),
                iterations=len(eng.iterations), tokens=sum(len(r.out) for r in done),
                token_mismatches=mismatches, leaked_pages=eng.pool.num_allocated,
                simulated_clock_s=eng.clock, host_wall_s=wall, done=done, refs=refs, engine=eng)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without a GPU); 'cpu' runs the smoke config")
    args = ap.parse_args(argv)
    out = run(args.arch, args.device)
    lats = sorted(r.latency for r in out["done"])
    print(f"{out['arch']} ({out['dtype']}, {out['device']}): served {out['requests']} requests / "
          f"{out['tokens']} tokens in {out['iterations']} iterations "
          f"({out['simulated_clock_s']:.3f} s simulated, {out['host_wall_s']:.1f} s host)")
    print(f"latency p50 {lats[len(lats) // 2]:.3f} s, worst {lats[-1]:.3f} s; goodput "
          f"{out['tokens'] / out['simulated_clock_s']:,.1f} tok/s (simulated)")
    for rid, ref in out["refs"].items():
        print(f"  req {rid}: {ref[:8]}{'...' if len(ref) > 8 else ''}")
    print(f"parity: token_mismatches {out['token_mismatches']} over {out['requests']} requests "
          f"(contiguous prefill and decode), leaked_pages {out['leaked_pages']}")
    if out["token_mismatches"] or out["leaked_pages"]:
        raise AssertionError("paged serving diverged from contiguous serving")
    print("all generations token-identical to single-stream serving")
    return out


if __name__ == "__main__":
    main()
