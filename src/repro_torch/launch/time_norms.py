"""Time K1 (the fused AdaLN forward), the q/k K6 (the joint RMSNorm
weight gradient) and K10 (the naive-access AdaLN reduction) on the card at
the shapes of Wan-2.1 1.3B's paths and the paper's Fig. 1, with their
bounds: the quickest before / after reading of the three kernels.

    python3 src/repro_torch/launch/time_norms.py [--src DIR] [--iters N]

Run it by path, not with ``-m``: ``--src`` names the ``src`` directory whose
``repro_torch`` is imported (default: the one this file lies in), so the
same script times another checkout's kernels, e.g. a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists.
Comparing two trees: run it in one chip call for each in turn (A, B, B, A).
The wrappers' signatures are the same in both.

Shapes: K1 on x [4, 6240, 1536] (a serving wave) and [10, 1637, 1536] and
[1, 7877, 1536] (the training buckets), bf16, scale and shift strided rows
of a [B, 6, 1536] f32 modulation; K6 on q [B, S, 12, 128] and k (strided
views of a fused qkv projection) at the two training buckets, bf16, q and
k in one call; K10 on dy, x [10, 1637, 1536] (K3's shape) and [1, S, 5120]
for S 8192, 16384 and 32768 (the Fig. 1 width), bf16, with its GB/s an SM
(one block a sample: B SMs work).  Each time is device time: the median of 5 runs of CUDA
events around ``--iters`` calls enqueued behind a sleeping kernel (the
host takes longer to enqueue a call than the device to run it), the
calls cycling through copies of the inputs that together exceed the 50 MB
L2 three times over.
Bounds: each input read once and each output written once over 3.35 TB/s
(the kernels are memory-bound).  Prints one JSON object with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def _ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: the median of 5 runs of ``iters``
    calls enqueued behind a sleeping kernel, so that the events around them
    see the device's work and not the host's time to enqueue it (which
    exceeds these kernels' device time)."""
    fn()
    torch.cuda.synchronize()
    runs = []
    cycles = 40_000_000  # about 20 ms
    while len(runs) < 5:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            runs.append(ev[1].elapsed_time(ev[2]) / iters)
        else:
            cycles *= 2
    return statistics.median(runs)


def _copies(nbytes: float) -> int:
    """Input sets to cycle through so that consecutive calls touch at least
    three times the 50 MB L2: each call finds its inputs in device memory,
    as the model's calls mostly do."""
    return max(1, -(-150_000_000 // int(nbytes)))


def _row(ms: float, nbytes: float, **kw) -> dict:
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {**kw, "ms": ms, "bound_ms": bound, "share": bound / ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve().parents[2]))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_norms: no CUDA device is visible")
    sys.path.insert(0, args.src)
    from repro_torch.kernels.fused_adaln.adaln import adaln_bwd_dmod_naive, adaln_fwd
    from repro_torch.kernels.fused_rmsnorm.rmsnorm import qk_rms_bwd_dw, qk_rms_fwd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out = {"card": card, "src": args.src, "adaln_fwd": [], "qk_rms_bwd_dw": [],
           "adaln_bwd_dmod_naive": []}
    d, h, dh = 1536, 12, 128
    for b, s in ((4, 6240), (10, 1637), (1, 7877)):
        nbytes = 2 * b * s * d * 2 + 2 * b * d * 4 + 2 * b * s * 4
        sets = []
        for _ in range(_copies(nbytes)):
            mod = randn(b, 6, d, scale=0.1)
            sets.append((randn(b, s, d, dtype=torch.bfloat16, scale=2.0, shift=0.3),
                         mod[:, 1], mod[:, 0]))
        it = itertools.cycle(sets)
        ms = _ms(lambda: adaln_fwd(*next(it)), args.iters)
        out["adaln_fwd"].append(_row(ms, nbytes, shape=[b, s, d], copies=len(sets)))
        del sets, it
    for b, s in ((10, 1637), (1, 7877)):
        n = b * s * h * dh
        nbytes = 2 * 2 * n * 2 + 2 * n // dh * 4 + 2 * dh * 4
        sets = []
        for _ in range(_copies(nbytes)):
            qkv = randn(b, s, 3 * h * dh, dtype=torch.bfloat16, scale=1.5)
            q = qkv[..., : h * dh].reshape(b, s, h, dh)
            k = qkv[..., h * dh: 2 * h * dh].reshape(b, s, h, dh)
            wq, wk = randn(dh, scale=0.1, shift=1.0), randn(dh, scale=0.1, shift=1.0)
            _, _, rq, rk = qk_rms_fwd(q, k, wq, wk)
            sets.append((randn(b, s, h, dh, dtype=torch.bfloat16),
                         randn(b, s, h, dh, dtype=torch.bfloat16), q, k, rq, rk))
        it = itertools.cycle(sets)
        ms = _ms(lambda: qk_rms_bwd_dw(*next(it)), args.iters)
        out["qk_rms_bwd_dw"].append(_row(ms, nbytes, shape=[b, s, h, dh], copies=len(sets)))
        del sets, it
    for b, s, d_ in ((10, 1637, 1536), (1, 8192, 5120), (1, 16384, 5120), (1, 32768, 5120)):
        nbytes = 2 * b * s * d_ * 2 + 2 * b * s * 4 + 2 * b * d_ * 4
        sets = []
        for _ in range(_copies(nbytes)):
            mod = randn(b, 6, d_, scale=0.1)
            x = randn(b, s, d_, dtype=torch.bfloat16, scale=2.0, shift=0.3)
            _, mu, rstd = adaln_fwd(x, mod[:, 1], mod[:, 0])
            sets.append((randn(b, s, d_, dtype=torch.bfloat16), x, mu, rstd))
        it = itertools.cycle(sets)
        ms = _ms(lambda: adaln_bwd_dmod_naive(*next(it)), args.iters if b > 1 else 5)
        out["adaln_bwd_dmod_naive"].append(_row(
            ms, nbytes, shape=[b, s, d_], copies=len(sets),
            gb_s_per_sm=2 * s * d_ * 2 / (ms * 1e-3) / 1e9))
        del sets, it
    for name in ("adaln_fwd", "qk_rms_bwd_dw", "adaln_bwd_dmod_naive"):
        for r in out[name]:
            per_sm = f"  {r['gb_s_per_sm']:.1f} GB/s an SM" if "gb_s_per_sm" in r else ""
            print(f"{name:<20} {str(r['shape']):<20} {r['ms']:.4f} ms  bound {r['bound_ms']:.4f} "
                  f"({r['share']:.1%}){per_sm}  [{card}]", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
