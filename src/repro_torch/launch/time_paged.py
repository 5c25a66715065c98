"""Time K12 (paged decode attention) on the card at the LM serving shapes,
with its bound and the host's time a call: the quickest before / after
reading of the kernel.

    python3 src/repro_torch/launch/time_paged.py [--src DIR] [--pair DIR] [--iters N]

Run it by path, not with ``-m``: ``--src`` names the ``src`` directory whose
``repro_torch`` is imported (default: the one this file lies in), so the
same script times another checkout's kernel, e.g. a parent commit unpacked
with ``git archive`` into a directory that ``.gitignore`` lists.  Comparing
two trees: run it in one chip call for each in turn (A, B, B, A).  The
wrapper's signature is the same in both.

Cases, bf16, those of ``chip_smoke.py`` phase 2, which takes them from
here (``CASES``, ``case_lens``, ``paged_case``, ``paged_work``; kv_lens
drawn from seed 6), each slot's pages drawn from a shuffled free list and
its table entries past them at a scratch page: ``wave`` is a decode wave of
Llama-3.2-1B's serving (8 slots, one inactive, kv_lens 64-2112; Hq 32, Hkv
8, dh 64; pages of 16, 256 entries a table row); ``heavy`` 64 slots with
kv_lens up to 4096; ``dh128`` Qwen2.5-14B's attention (Hq 40, Hkv 8, dh
128; pages of 32, 65 entries a row), 16 slots up to 2048 tokens.  Each
time is device time: the median of 5 runs of CUDA events around
``--iters`` calls enqueued behind a sleeping kernel, the calls cycling
through page tables over disjoint pages of one pool, whose live pages
together exceed the 50 MB L2 three times over (each layer of a served
model has its own pool).  The bound: the live K and V pages (the kernel's
page skip), q, out and the live table entries read or written once over
3.35 TB/s.  The host's wall time a call at the wave, over 500 calls, three
times each: ``host_us`` with the device idle between calls (as in a decode
wave, whose device idles most of the time), ``host_busy_us`` with the
calls queued behind a sleeping kernel.  The host's time a call moves by
several microseconds between processes and minutes on a shared host, so
``--pair DIR`` also loads ``DIR``'s ``repro_torch`` (another ``src``) in
the same process and times the two wrappers at the wave in turn, ten
rounds of 500 calls each (``host_pair_us``: the medians and the median of
the rounds' differences, this tree's minus the other's).  Prints one JSON
object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM

# name: (Hq, Hkv, dh, page size, table entries a row)
CASES = {
    "wave": (32, 8, 64, 16, 256),
    "heavy": (32, 8, 64, 16, 256),
    "dh128": (40, 8, 128, 32, 65),
}


def case_lens(rng) -> dict[str, list[int]]:
    """kv_lens of the cases, drawn from ``rng`` (``chip_smoke.py`` phase 2
    and :func:`main` pass a fresh generator seeded 6)."""
    wave = [int(n) for n in rng.integers(64, 2113, size=7)] + [0]
    heavy = [int(n) for n in rng.integers(1, 4097, size=64)]
    heavy[5] = heavy[40] = 0
    dh128 = [int(n) for n in rng.integers(1, 2049, size=16)]
    dh128[3] = 0
    return {"wave": wave, "heavy": heavy, "dh128": dh128}


def paged_case(dev, g, rng, lens, hq, hkv, dh, ps, dtype, *, pages_max=None, spare=1, copies=1):
    """q [B, Hq, dh], K and V pools of random pages, ``copies`` page tables
    [B, pages_max] over disjoint pages of them, and kv_lens [B] int32 on
    ``dev``, for slots holding ``lens`` tokens: in each table a slot owns
    ceil(len / ps) pages taken from a shuffled free list, and its entries
    past them point at the scratch page (the last of the pool, after
    ``spare`` unowned pages); every slot of every page, scratch included,
    holds finite random values."""
    owned = [-(-n // ps) for n in lens]
    pages_max = pages_max or max(owned) + 1
    num_pages = copies * sum(owned) + spare
    order = rng.permutation(num_pages)
    tables, nxt = [], 0
    for _ in range(copies):
        table = np.full((len(lens), pages_max), num_pages, np.int32)
        for bi, n in enumerate(owned):
            table[bi, :n] = order[nxt: nxt + n]
            nxt += n
        tables.append(torch.from_numpy(table).to(dev))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (randn(len(lens), hq, dh), randn(num_pages + 1, ps, hkv, dh),
            randn(num_pages + 1, ps, hkv, dh), tables,
            torch.tensor(lens, dtype=torch.int32, device=dev))


def paged_work(q, k_pages, v_pages, table, lens) -> tuple[int, int]:
    """(bytes, flops) K12 must move and do for one call on these arguments
    (``paged_decode``'s): the live K and V pages (the kernel's page skip),
    q, out and the live table entries, each once; 4 flops per (q head, live
    token, dh element)."""
    from repro_torch.kernels.flash_attention.paged import live_pages

    b, hq, dh = q.shape
    _, ps, hkv, _ = k_pages.shape
    pages = live_pages(lens, ps, table.shape[1])
    tokens = int(lens.clamp(0, table.shape[1] * ps).sum())
    nbytes = (pages * (hkv * 2 * ps * dh * k_pages.element_size() + 4)
              + 2 * q.numel() * q.element_size() + b * 4)
    return nbytes, 4 * tokens * hq * dh


def _ms(fn, iters: int) -> float:
    """Device time per call: the median of 5 runs of ``iters`` calls behind
    a sleeping kernel (the host takes longer to enqueue a call than the
    device to run it)."""
    fn()
    torch.cuda.synchronize()
    runs, cycles = [], 40_000_000  # about 20 ms
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


def _host_us(fn, iters: int = 500, *, busy: bool = False) -> float:
    """Host wall time a call over ``iters`` calls; ``busy``: the calls
    queue behind a sleeping kernel that outlasts them."""
    fn()
    torch.cuda.synchronize()
    if busy:
        torch.cuda._sleep(200_000_000)  # about 100 ms
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def _load_tree(src: str, alias: str):
    """``paged_decode`` of the ``repro_torch`` under ``src``, imported as the
    package ``alias`` beside this process's own (its kernels build under its
    own tree)."""
    root = pathlib.Path(src).resolve() / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        alias, root / "__init__.py", submodule_search_locations=[str(root)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.kernels.flash_attention.paged").paged_decode


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve().parents[2]))
    ap.add_argument("--pair", default=None,
                    help="another src directory whose wrapper's host time is taken in turn")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_paged: no CUDA device is visible")
    sys.path.insert(0, args.src)
    from repro_torch.kernels.flash_attention.paged import paged_decode

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out = {"card": card, "src": args.src, "paged_decode": []}
    lens_of = case_lens(np.random.default_rng(6))
    for name, (hq, hkv, dh, ps, pages_max) in CASES.items():
        # as many tables over disjoint pages as make the live K and V pages
        # exceed the L2 three times over
        live = sum(-(-n // ps) for n in lens_of[name]) * ps * hkv * dh * 2 * 2
        q, kp, vp, tables, lens = paged_case(
            dev, g, rng, lens_of[name], hq, hkv, dh, ps, torch.bfloat16, pages_max=pages_max,
            copies=max(1, -(-150_000_000 // max(live, 1))))
        it = iter(range(1 << 62))

        def call():
            return paged_decode(q, kp, vp, tables[next(it) % len(tables)], lens)

        ms = _ms(call, args.iters)
        nbytes, _ = paged_work(q, kp, vp, tables[0], lens)
        row = {"case": name, "shape": [len(lens), hq, hkv, dh, ps, pages_max],
               "kv_lens": lens_of[name], "copies": len(tables), "ms": ms,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        row["share"] = row["bound_ms"] / ms
        if name == "wave":
            wave = (q, kp, vp, tables[0], lens)
            for key, busy in (("host_us", False), ("host_busy_us", True)):
                row[key] = [_host_us(lambda: paged_decode(*wave), busy=busy) for _ in range(3)]
            if args.pair:
                other = _load_tree(args.pair, "paired_repro_torch")
                this_us, other_us = [], []
                for _ in range(10):
                    this_us.append(_host_us(lambda: paged_decode(*wave)))
                    other_us.append(_host_us(lambda: other(*wave)))
                row["host_pair_us"] = {
                    "pair": args.pair, "this": statistics.median(this_us),
                    "other": statistics.median(other_us),
                    "difference": statistics.median(a - b for a, b in zip(this_us, other_us))}
        out["paged_decode"].append(row)
        del q, kp, vp, tables
    for r in out["paged_decode"]:
        host = (f"  host {min(r['host_us']):.1f} us a call (behind a busy device "
                f"{min(r['host_busy_us']):.1f})" if "host_us" in r else "")
        if "host_pair_us" in r:
            pr = r["host_pair_us"]
            host += (f"; in turn with {pr['pair']}: {pr['this']:.1f} against {pr['other']:.1f} "
                     f"(difference {pr['difference']:+.1f})")
        print(f"paged_decode {r['case']:<6} {r['ms']:.4f} ms  bound {r['bound_ms']:.4f} "
              f"({r['share']:.1%}){host}  [{card}]", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
