#!/usr/bin/env python3
"""On-card check of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and the repository around this file.
Phases, any failure of which exits non-zero with no result line:

1. card and toolchain: the card's name and power limit, the torch / CUDA
   versions; every kernel built from ``src/repro_torch/**/csrc/*.cu``
   (one nvcc per source, in parallel), with the build seconds;
2. each kernel against its plain PyTorch version on the card, at the
   serving shapes of Wan-2.1 1.3B (x [4, 6240, 1536]; q/k/v
   [4, 6240, 12, 128]; self-attention 6240 x 6240 and cross-attention
   6240 x 512 under packed / padded segment layouts) and at small f32
   shapes; kernel, plain and library times with CUDA events;
3. serving: Wan-2.1 1.3B at full width and depth (30 layers, random weights
   from a seed) serves 4 clips of 1-4 latent frames at 480x832 through
   ``DiffusionServeEngine``; every result finite, and every kernel's
   launch count equal to waves x its launches per wave;
4. the whole model at full width and 2 layers, kernel forward against the
   ``ops="plain"`` forward: velocity rel-L2 <= 2e-2 in bf16.

Prints the kernels' JSON record on the line before the last and, as the
last line, ``{"ok": true, "device": {...}}``.  The full record also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores

# tolerances: outputs in the working dtype (one bf16 rounding apart at
# most, as tests/test_kernels.py allows), f32 statistics summed in another
# order over up to 6240 terms
TOL = {
    "norm_bf16": 6e-2, "attn_bf16": 3e-2, "stat": 2e-4, "lse_bf16": 1e-3,
    "norm_f32": 2e-4, "attn_f32": 2e-5,
}

S_FRAME = 1560  # latent tokens per frame at 480x832 (60 x 104 latent, 1x2x2 patches)
S_MAX = 4 * S_FRAME  # 6240
TEXT_LEN = 512


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    log(f"  {name:<28} max_abs_err {err:.3e}  tol {tol:.1e}")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def segs(runs_per_row, device):
    rows = [torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in runs])
            for runs in runs_per_row]
    return torch.stack(rows).to(device)


def phase_kernels(dev) -> dict:
    """Phase 2: every kernel against its plain version; times."""
    from repro_torch.kernels.flash_attention.flash import (
        KV_TILE, Q_TILE, flash_fwd, live_tile_pairs,
    )
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.fused_adaln.adaln import adaln_fwd
    from repro_torch.kernels.fused_adaln.ref import adaln_modulate_ref
    from repro_torch.kernels.fused_rmsnorm.ref import qk_norm_ref
    from repro_torch.kernels.fused_rmsnorm.rmsnorm import qk_rms_fwd

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    out = {}
    b, s, d, h, dh = 4, S_MAX, 1536, 12, 128

    # -- K1 fused AdaLN forward ------------------------------------------
    log("K1 adaln_fwd  x [4, 6240, 1536] bf16, scale/shift rows of a [4, 6, 1536] f32 modulation")
    x = randn(b, s, d, dtype=torch.bfloat16, scale=2.0, shift=0.3)
    mod = randn(b, 6, d, scale=0.1)
    sc, sh = mod[:, 1], mod[:, 0]
    y, mu, rstd = adaln_fwd(x, sc, sh)
    yr, mur, rr = adaln_modulate_ref(x, sc, sh)
    torch.cuda.synchronize()
    check("K1 y (bf16)", max_err(y, yr), TOL["norm_bf16"])
    check("K1 mu", max_err(mu, mur), TOL["stat"])
    check("K1 rstd", max_err(rstd, rr), TOL["stat"])
    k1_err = max_err(y, yr)
    for shape in [(2, 100, 256), (3, 37, 1536)]:
        xs = randn(*shape, scale=2.0, shift=0.3)
        ms_ = randn(shape[0], 6, shape[2], scale=0.1)
        got = adaln_fwd(xs, ms_[:, 1], ms_[:, 0])
        want = adaln_modulate_ref(xs, ms_[:, 1], ms_[:, 0])
        for nm, a_, b_ in zip(("y", "mu", "rstd"), got, want):
            check(f"K1 {nm} f32 {list(shape)}", max_err(a_, b_), TOL["norm_f32"])
    t_k = cuda_ms(lambda: adaln_fwd(x, sc, sh), 20)
    t_p = cuda_ms(lambda: adaln_modulate_ref(x, sc, sh), 5)
    nbytes = 2 * x.numel() * 2 + 2 * b * d * 4 + 2 * b * s * 4
    bms, bby = bound(nbytes, 8 * x.numel(), F32_FLOPS)
    out["adaln_fwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/fused_adaln/csrc/adaln_fwd.cu",
        replaces="src/repro/kernels/fused_adaln/adaln.py:58",
        max_abs_err=k1_err, ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=bby,
        library_ms=None, shape="x [4, 6240, 1536] bf16",
    )
    log(f"  K1 ms {t_k:.4f}  plain {t_p:.4f}  bound {bms:.4f} ({bby})")
    del x, y, yr, mu, mur, rstd, rr

    # -- K4 joint q/k RMSNorm forward ------------------------------------
    log("K4 qk_rms_fwd  q, k [4, 6240, 12, 128] bf16 as views of qkv [4, 6240, 4608]")
    qkv = randn(b, s, 3 * h * dh, dtype=torch.bfloat16, scale=1.5)
    q = qkv[..., : h * dh].reshape(b, s, h, dh)
    k = qkv[..., h * dh : 2 * h * dh].reshape(b, s, h, dh)
    wq, wk = randn(dh, scale=0.1, shift=1.0), randn(dh, scale=0.1, shift=1.0)
    got = qk_rms_fwd(q, k, wq, wk)
    want = qk_norm_ref(q, k, wq, wk)
    torch.cuda.synchronize()
    k4_err = 0.0
    for nm, a_, b_ in zip(("q", "k", "rstd_q", "rstd_k"), got, want):
        tol = TOL["norm_bf16"] if nm in ("q", "k") else TOL["stat"]
        err = max_err(a_, b_)
        check(f"K4 {nm}", err, tol)
        if nm in ("q", "k"):
            k4_err = max(k4_err, err)
    for dhs in (32, 64, 128):
        qkv_s = randn(2, 50, 3 * 4 * dhs, scale=1.5)
        qs_ = qkv_s[..., : 4 * dhs].reshape(2, 50, 4, dhs)
        ks_ = qkv_s[..., 4 * dhs : 8 * dhs].reshape(2, 50, 4, dhs)
        w1, w2 = randn(dhs, shift=1.0, scale=0.1), randn(dhs, shift=1.0, scale=0.1)
        for nm, a_, b_ in zip(("q", "k", "rstd_q", "rstd_k"),
                              qk_rms_fwd(qs_, ks_, w1, w2), qk_norm_ref(qs_, ks_, w1, w2)):
            check(f"K4 {nm} f32 dh={dhs}", max_err(a_, b_), TOL["norm_f32"])
    t_k = cuda_ms(lambda: qk_rms_fwd(q, k, wq, wk), 20)
    t_p = cuda_ms(lambda: qk_norm_ref(q, k, wq, wk), 5)
    # yardstick only, never on the port's path: the library norm, once per tensor
    t_l = cuda_ms(lambda: (F.rms_norm(q, (dh,), wq.to(q.dtype), 1e-6),
                                  F.rms_norm(k, (dh,), wk.to(k.dtype), 1e-6)), 20)
    nbytes = 4 * q.numel() * 2 + 2 * dh * 4 + 2 * b * s * h * 4
    bms, bby = bound(nbytes, 2 * 4 * q.numel(), F32_FLOPS)
    out["qk_rms_fwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/fused_rmsnorm/csrc/rmsnorm_fwd.cu",
        replaces="src/repro/kernels/fused_rmsnorm/rmsnorm.py:38",
        max_abs_err=k4_err, ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=bby,
        library_ms=t_l, shape="q, k [4, 6240, 12, 128] bf16, one launch",
    )
    log(f"  K4 ms {t_k:.4f}  plain {t_p:.4f}  library(F.rms_norm x2) {t_l:.4f}  "
        f"bound {bms:.4f} ({bby})")
    del got, want

    # -- K7 segment-aware flash attention forward ------------------------
    # the serving layouts: one clip per slot padded with -1, a packed slot,
    # and a full slot; text ids 0 for a slot's prompt, -1 for padding
    seg = segs([
        [(0, 1560), (-1, 4680)],
        [(0, 3120), (-1, 3120)],
        [(0, 2000), (1, 2680), (-1, 1560)],
        [(0, 6240)],
    ], dev)
    tseg = segs([
        [(0, 512)],
        [(0, 300), (-1, 212)],
        [(0, 256), (1, 256)],
        [(0, 512)],
    ], dev)
    v = qkv[..., 2 * h * dh :].reshape(b, s, h, dh)
    kvx = randn(b, TEXT_LEN, 2 * h * dh, dtype=torch.bfloat16)
    kx = kvx[..., : h * dh].reshape(b, TEXT_LEN, h, dh)
    vx = kvx[..., h * dh :].reshape(b, TEXT_LEN, h, dh)
    qx = randn(b, s, h, dh, dtype=torch.bfloat16)
    self_args = (q, k, v, seg, seg)
    cross_args = (qx, kx, vx, seg, tseg)
    log("K7 flash_fwd  self [4, 6240, 12, 128] x 6240 and cross x 512, bf16, packed/padded segments")
    k7_err = 0.0
    for nm, args in (("self", self_args), ("cross", cross_args)):
        o, lse = flash_fwd(*args)
        o_r, lse_r = attention_ref(*args)
        torch.cuda.synchronize()
        err = max_err(o, o_r)
        k7_err = max(k7_err, err)
        check(f"K7 {nm} out", err, TOL["attn_bf16"])
        live = lse_r > -1e38
        check(f"K7 {nm} lse", max_err(lse[live], lse_r[live]), TOL["lse_bf16"])
        if not torch.equal(live, lse > -1e38):
            raise AssertionError(f"K7 {nm}: rows that see no key differ")
        dead = (~live).transpose(1, 2)  # [B, S, H]
        if dead.any() and torch.count_nonzero(o[dead]) != 0:
            raise AssertionError(f"K7 {nm}: a row that sees no key is not exact zeros")
        log(f"  K7 {nm}: {int(dead.sum())} (row, head) pairs see no key, all exact zeros")
        del o, lse, o_r, lse_r
    for dhs in (32, 64, 128):
        for causal in (False, True):
            for hq, hkv in ((4, 4), (4, 2)):
                qs_ = randn(2, 200, hq, dhs)
                ks_, vs_ = randn(2, 200, hkv, dhs), randn(2, 200, hkv, dhs)
                sg = segs([[(0, 70), (1, 100), (-1, 30)], [(5, 200)]], dev)
                sq_ = segs([[(0, 70), (1, 100), (-1, 30)], [(5, 150), (9, 50)]], dev)
                for ids in ((None, None), (sg, sg), (sq_, sg)):
                    a_ = flash_fwd(qs_, ks_, vs_, *ids, causal=causal)
                    b_ = attention_ref(qs_, ks_, vs_, *ids, causal=causal)
                    tag = f"dh={dhs} causal={causal} gqa={hq // hkv} segs={ids[0] is not None}"
                    check(f"K7 f32 {tag}", max_err(a_[0], b_[0]), TOL["attn_f32"])
                    check(f"K7 f32 lse {tag}", max_err(a_[1], b_[1]), TOL["attn_f32"])

    def pair(fn):
        return lambda: (fn(*self_args), fn(*cross_args))

    t_k = cuda_ms(pair(flash_fwd), 5)
    t_p = cuda_ms(pair(attention_ref), 2)

    # yardstick only, never on the port's path: the library's attention with
    # the segment-equality mask built beforehand
    self_mask = (seg[:, :, None] == seg[:, None, :])[:, None]
    cross_mask = (seg[:, :, None] == tseg[:, None, :])[:, None]

    def sdpa():
        return [F.scaled_dot_product_attention(
            qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=m)
            for (qq, kk, vv, _, _), m in ((self_args, self_mask), (cross_args, cross_mask))]

    t_l = cuda_ms(sdpa, 3)
    del self_mask, cross_mask
    tiles = (live_tile_pairs(s, s, seg, seg) + live_tile_pairs(s, TEXT_LEN, seg, tseg)) * h
    flops = tiles * 4 * Q_TILE * KV_TILE * dh
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, qx, kx, vx)) \
        + 2 * q.numel() * 2 + 2 * b * h * s * 4 + (2 * seg.numel() + tseg.numel()) * 4
    bms, bby = bound(nbytes, flops, BF16_FLOPS)
    out["flash_fwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_attention/flash.py:136",
        max_abs_err=k7_err, ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=bby,
        library_ms=t_l, shape="self 6240x6240 + cross 6240x512, B=4, H=12, dh=128, bf16",
        live_tile_pairs=tiles, tflops_per_s=flops / (t_k * 1e-3) / 1e12,
    )
    log(f"  K7 ms {t_k:.4f} (self + cross)  plain {t_p:.4f}  library(SDPA, bool mask) {t_l:.4f}  "
        f"bound {bms:.4f} ({bby}, {tiles} live 64x64 tiles)")
    return out


def phase_serve(K, dev) -> dict:
    """Phase 3: Wan-2.1 1.3B, 30 layers, serves 4 clips through the engine."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import DEMO_MODEL
    from repro_torch.models.mmdit import MMDiT
    from repro_torch.serve import DiffusionServeEngine, ServeConfig

    cfg = get_config("wan2.1-1.3b")
    t0 = time.perf_counter()
    mmdit = MMDiT(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in mmdit.parameters())
    log(f"model {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"params, init {time.perf_counter() - t0:.1f} s")
    # M_comp = (target - a) / b = 5e7 load units: the 1-, 2- and 3-frame
    # clips (sum S^2 = 3.4e7) share the first waves, the 4-frame clip
    # (3.9e7) waits for them
    serve = ServeConfig(target_step=10.005, page_size=16, num_pages=4 * S_MAX // 16,
                        decode_slots=4, max_seq=S_MAX)
    eng = DiffusionServeEngine(mmdit, cfg, DEMO_MODEL, serve)
    rng = np.random.default_rng(0)
    for frames in (1, 2, 3, 4):
        lat = rng.standard_normal((frames * S_FRAME, cfg.in_channels * 4)).astype(np.float32)
        txt = rng.standard_normal((TEXT_LEN, DiffusionServeEngine.TEXT_DIM)).astype(np.float32)
        eng.submit(lat, txt, n_steps=4)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    wave_ms = []
    t0 = time.perf_counter()
    while True:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        if not eng.step():
            break
        b.record()
        b.synchronize()
        wave_ms.append(a.elapsed_time(b))
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    waves = sum(1 for it in eng.iterations if it["wave"])
    for it, ms in zip(eng.iterations, wave_ms):
        log(f"  wave {it['wave']} admitted {it['admitted']}: {ms:.1f} ms "
            f"(simulated clock {it['clock']:.3f} s)")
    log(f"served {len(eng.done)} clips in {waves} waves, {wall:.2f} s wall, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launch counts {counts}")
    if len(eng.done) != 4:
        raise AssertionError("not every request finished")
    tokens = {r.rid: r.tokens for r in eng.done}
    if not any(len({tokens[rid] for rid in it["wave"]}) >= 2 for it in eng.iterations):
        raise AssertionError("no wave held two clips of different lengths")
    for r in eng.done:
        if r.result.shape != r.latents.shape or not np.isfinite(r.result).all():
            raise AssertionError(f"request {r.rid}: result not finite or misshapen")
    per_wave = {"adaln_fwd": 2 * cfg.n_layers + 1, "qk_rms_fwd": cfg.n_layers,
                "flash_fwd": 2 * cfg.n_layers}
    for name, n in per_wave.items():
        if counts[name] != waves * n:
            raise AssertionError(f"{name}: {counts[name]} launches, expected {waves} x {n}")
    return dict(waves=waves, wave_ms=wave_ms, wall_s=wall, launches=counts,
                per_wave=per_wave, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                n_params=n_params)


def phase_model(dev) -> float:
    """Phase 4: 2 layers at full width, kernel forward vs plain forward."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.mmdit import MMDiT

    cfg = dataclasses.replace(get_config("wan2.1-1.3b"), n_layers=2)
    mmdit = MMDiT(cfg, seed=1, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    b, s = 2, 2 * S_FRAME
    lat = torch.randn((b, s, cfg.in_channels * 4), generator=g, device=dev)
    txt = torch.randn((b, TEXT_LEN, 4096), generator=g, device=dev)
    t = torch.tensor([0.3, 0.8], device=dev)
    seg = segs([[(0, S_FRAME), (-1, S_FRAME)], [(0, s // 3), (1, s - s // 3)]], dev)
    tseg = segs([[(0, TEXT_LEN)], [(0, TEXT_LEN // 2), (1, TEXT_LEN // 2)]], dev)
    with torch.inference_mode():
        v_k = mmdit(lat, txt, t, segment_ids=seg, text_segment_ids=tseg)
        v_p = mmdit(lat, txt, t, segment_ids=seg, text_segment_ids=tseg, ops="plain")
    rel = float((v_k.float() - v_p.float()).norm() / v_p.float().norm())
    log(f"whole model (2 layers, full width, bf16): velocity rel-L2 kernel vs plain {rel:.3e} "
        f"(tol 2e-2)")
    if not (torch.isfinite(v_k).all() and rel <= 2e-2):
        raise AssertionError(f"whole-model check failed: rel-L2 {rel}")
    return rel


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels as K
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"built {len(reports)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    record["kernels"] = phase_kernels(dev)
    torch.cuda.empty_cache()
    record["serve"] = phase_serve(K, dev)
    torch.cuda.empty_cache()
    record["model_rel_l2"] = phase_model(dev)

    kernels = []
    for name, k in record["kernels"].items():
        kernels.append({"name": name, **{key: k[key] for key in (
            "route", "source", "replaces")}, "launches": record["serve"]["launches"][name],
            **{key: k[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
