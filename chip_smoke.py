#!/usr/bin/env python3
"""On-card check of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and the repository around this file.
Phases, any failure of which exits non-zero with no result line:

1. card and toolchain: the card's name and power limit, the torch / CUDA
   versions; every kernel built from ``src/repro_torch/**/csrc/*.cu``
   (one nvcc per source, in parallel, beside the host's one-time set-up),
   with the build seconds, each kernel's registers and spills (K1, K5/K6,
   K7, K8 and K9 by entry function, and the count of ptxas notices of
   serialised wgmmas);
2. each kernel against its plain PyTorch version on the card,
   with kernel, plain and library times from CUDA events (K1, K5 and K6
   as device times behind a sleeping kernel): the forward
   kernels at the serving shapes of Wan-2.1 1.3B (x [4, 6240, 1536]; q/k/v
   [4, 6240, 12, 128]; self-attention 6240 x 6240 and cross-attention
   6240 x 512 under packed / padded segment layouts), K7's f32-output
   mode, K1 also at the training shapes, and the backward kernels at the
   training shapes (x [10, 1637,
   1536] and [1, 7877, 1536]; q/k [10, 1637, 12, 128] and [1, 7877, 12,
   128]; attention 7877 x 7877 and 7877 x 512, packed and padded, self
   and cross timed apart), the reductions K3 and K6 and the flash
   backward K8, K9 also bitwise against a second run; all of them at small
   f32 shapes (dh 32/64/128, causal, GQA), and K7, K8 and K9 on bf16 at
   small shapes too (dh 32/64/128 x causal x GQA x three segment layouts,
   strided views; K7's f32-out mode bitwise; K8/K9 with ragged Sq 200 x
   Skv 150 and rows that see no key); K8 and K9 also at phase 9 (b)'s
   attention ([2, 8192, 32, 64], Hkv 8, causal, packed windows), timed
   beside SDPA's backward with the same mask;
3. serving: Wan-2.1 1.3B at full width and depth (30 layers, random weights
   from a seed) serves 4 clips of 1-4 latent frames at 480x832 through
   ``DiffusionServeEngine``; every result finite, and every kernel's
   launch count equal to waves x its launches per wave (0 for the
   backward kernels);
4. the whole model at full width and 2 layers, kernel forward against the
   ``ops="plain"`` forward: velocity rel-L2 <= 2e-2 in bf16;
5. training: (a) the launcher's ``main`` with ``--arch wan2.1-1.3b
   --adaptive --steps 2``; (b) Wan-2.1 1.3B at full width and 10 of its 30
   layers (the depth cut keeps the whole script within its time), bf16,
   trains 4 AdamW steps through ``Trainer`` on ``EmulatedEngine``, fed by
   ``BucketedLoader`` over the 480p image, 17- and 33-frame shapes
   (S = 1637, 4757, 7877; B = 10, 2, 1 under M_mem 16384, M_comp 6.4e7,
   p 2) in 16384-token steps: every loss and parameter finite, and every
   kernel's launch count in (a) and (b) equal to microbatches x its
   launches per microbatch; the steady step time, tokens/s and peak
   memory; (c) 2 layers at full width, kernel loss and gradients against
   the ``ops="plain"`` ones on one packed batch with the same draws: loss
   within 1e-2 and every gradient's rel-L2 within 5e-2;
6. LM serving: (a) the launcher's ``main`` with ``--arch llama3.2-1b``; (b)
   Llama-3.2-1B at full width and depth (16 layers, bf16, random weights
   from seed 0) serves 16 requests (Poisson arrivals at 20/s, prompts of
   64-2048 tokens, 16-64 new tokens) through ``ServeEngine`` over 4096
   pages of 16 tokens and 8 decode slots: every request finishes, the pool
   drains, a wave holds slots at different depths, and every kernel's
   launch count is exact (``rms_fwd`` (prefills + waves) x (2L+1),
   ``flash_fwd`` prefills x L, ``paged_decode`` waves x L, the rest 0);
   prefill ms by padded width, decode-wave ms, wall tokens/s, peak memory;
7. the LM at full width and 2 layers, kernels against ``ops="plain"``: the
   prefill logits and three decode waves' logits on the same pools, rel-L2
   <= 2e-2;
8. Mamba-2 training: (a) the launcher's ``main`` with ``--arch mamba2-2.7b
   --adaptive --steps 2 --batch 1`` (64 layers; buckets of S 272-448, none
   a multiple of the 256-token SSD chunk, so the mixer pads); (b) Mamba-2
   2.7B at full width and 16 of its 64 layers (the depth cut keeps the
   script within its time; bf16, random weights from seed 0) trains 4 AdamW
   steps of one B 4 x S 2048 microbatch through ``Trainer`` on
   ``EmulatedEngine``: every loss and parameter finite, every kernel's
   launch count in (a) and (b) equal to microbatches x its launches per
   microbatch (K4 rows 2L+1, K13 2L, K5 and K6 rows 2L+1 each, the rest
   0); the steady step time, tokens/s and peak memory; (c) 2 layers at
   full width, kernel loss and gradients against the ``ops="plain"`` ones
   at B 2 x S 2048 and B 4 x S 272: loss within 1e-2 and every gradient's
   rel-L2 within 5e-2;
9. packed dense-LM training and its sequence-parallel (SP) step: (a) K11's
   merge kernels (``ring_merge``, ``ring_finalize``) against the plain
   merge on one ring rank's state of (c) (1e-6 of the largest value); K11
   on a ``LocalRing(4)`` against its plain version at small f32 shapes
   (dh 32/64/128, k 2 and 4) and at Llama-3.2-1B's attention (Hq 32, Hkv
   8, dh 64, bf16, causal, packed ``lm_length_corpus`` documents and a -1
   tail) at S 8192, and against the whole-window K7-K9 at S 32768 (out
   3e-2, gradients rel-L2 2e-2 in bf16 and 1e-5 in f32); one layer's ring
   forward and forward + backward times, with SDPA (mask) on the gathered
   window as the library time; one f32 backward hop alone (K8 and K9 at
   [1, 8192, 32, 64], Hkv 8) against the plain backward (rel-L2 1e-5),
   timed; (b) the launcher's ``main`` with ``--arch
   llama3.2-1b --adaptive --steps 2``, then Llama-3.2-1B at full width and
   depth (16 layers, bf16, seed 0) trains 4 AdamW steps through
   ``Trainer``, each one microbatch of two packed 8192-token windows
   (``materialize_packed_windows``, a -1 tail each): every loss and
   parameter finite, every launch count exact (``per_microbatch_dense``),
   the steady step time, tokens/s and peak memory; (c)
   ``make_sp_pool_grad_step`` on a ``LocalRing(4)`` over one packed
   32768-token window (shards of 8192, a -1 tail): every launch count the
   live table's (``per_sp_step``), step ms and peak memory, and the loss
   within 1e-2 and every gradient's rel-L2 within 5e-2 of the unsplit
   ``make_pool_grad_step`` on the same window;
10. planned training on emulated ranks: (a) the launcher's ``main`` with
   ``--arch wan2.1-1.3b --adaptive --workers 4 --dispatch lpt --steps 2``
   (30 layers; ``ShardedBucketedLoader``, its ``StepPlanner`` and 4 ranks
   run serially on the card): every loss finite, every launch count the
   microbatches of all ranks x the per-microbatch table, and each step's
   records exactly the ranks and buckets of its ``StepPlan`` (less the
   first microbatch of each batch signature); (b) Wan-2.1 1.3B at full
   width and 10 of its 30 layers (bf16, seed 0) on 4 ranks over phase 5
   (b)'s 480p buckets: a warm-up step (every rank runs every bucket) whose
   CUDA-event records fit ``t = a + b·B·S^p`` (``fit_cost_model``; the
   paper's p grid [1.6, 2.4], widened down to 1 when its slope is not
   positive), then 4 steps each of independent per-rank draws and of the
   planned LPT pool (``StepPlanner`` on the fit's ``load_of``) at 16384
   tokens a rank: each rank's summed microbatch device time, their CV,
   ``CV_step`` and the predicted compute CV by step, tokens a step and
   the slowest rank (emulated ranks: summed serial device times on one
   card, not a multi-card measurement); launch counts exact, records
   matching the plans, losses and parameters finite (the CVs are findings,
   not gates); (c) the closed loop: ``AdaptiveLoadScheduler`` seeded with
   (b)'s fit, its ``make_planner`` behind ``ShardedBucketedLoader`` and
   ``Trainer(scheduler=)`` for 4 steps (refit every 2 steps from 8
   records): launch counts, records against the plans, the refit model and
   every ``PlanUpdate``.
11. kill-and-resume on emulated ranks: Wan-2.1 1.3B at full width and 2
   of its 30 layers (a checkpoint of about 1.2 GB; bf16, seed 0) on 4
   ranks over phase 10 (b)'s buckets, planned LPT at 16384 tokens a rank,
   through ``ShardedBucketedLoader(resume_state=)``, ``Trainer(ft=,
   chaos=, run_state_of=)`` with ``ft.on_resize =
   trainer.set_physical_ranks``, ``checkpoint.store.restore`` and
   ``load_run_state``: (a) 6 uninterrupted steps; (b) the churn leg
   ``kill@1:2,3;join@3:2;preempt@4``, which stops after 5 steps with the
   handoff checkpoint on disk (its events must include the kill, the join
   back to 4 ranks and the preemption); (c) a restore into a fresh state
   on the card and the last step.  The plan digests of (b) + (c) must equal
   (a)'s, and the final parameters and moments (a)'s bitwise (else the
   differing tensors are named and rel-L2 <= 1e-5 holds); launch counts of
   (b) + (c) exact; each checkpoint's save seconds, the handoff
   checkpoint's bytes and the restore seconds.
12. the Shape Benchmark and step plans across processes (see
   ``phase_shape_bench``, ``phase_mesh_nccl``, ``phase_mesh_gloo`` and
   ``phase_mesh_dispatch``).
13. contiguous LM serving: first K4 rows at d 5120 and 2304 (a 1024-token
   prefill, a decode wave of 4) and at Mamba-2's decode rows, K13 at
   Mamba-2's decode (x [4, 1, 5120], the gate a strided z slice), K7 at
   the Qwen2.5-14B (GQA 5, dh 128) and MiniCPM-2B (MHA 36 x 64) prefills
   and K12 at their decode waves, each against its plain version and
   timed; (a) Mamba-2 2.7B at full width and depth (64 layers, bf16, seed
   0) prefills 4 prompts of 2048 tokens and decodes 32 greedy steps through
   ``make_prefill_step`` / ``make_decode_step``: exact launch counts (K4
   rows L+1 and K13 L a call), prefill ms, decode ms a step (host clock,
   events, device time), tokens/s, cache bytes; the logits against the
   ``ops="plain"`` ones teacher-forced on the same tokens and against one
   chunked forward over the 2080 tokens (rel-L2 0.25, ``SERVE_TOL``), and
   the same model in f32 against the forward (1e-4); (b) Qwen2.5-14B (48 layers, bf16, seed
   0) through the launcher's paged engine (8 requests, ``--gen 32
   --max-seq 4096``), then each request through contiguous prefill and
   decode teacher-forced on the engine's tokens: logits rel-L2 a request
   (5e-2), greedy disagreements with their top-2 margins, exact launch
   counts for both, prefill and wave ms, the widest wave's device time
   against its weights bound, the contiguous step's; (c) MiniCPM-2B (40
   layers) the same with one contiguous request; (d) the ported example
   ``repro_torch.examples.serve_lm``, llama3.2-1b at full width in f32:
   0 token mismatches against contiguous serving, exact launch counts.
14. RecurrentGemma-9B (RG-LRU and local-attention blocks, bf16, seed 0):
   first K4 rows at d 4096 (training rows [8192, 4096], the prefill's [4,
   3000, 4096], the decode step's [4, 1, 4096]) and K5, K6 on rows at
   [8192, 4096] against their plain versions (K6 also bitwise against a
   second run), timed; (a) 9 of its 38 layers at full width: 4
   ``Trainer`` steps on ``EmulatedEngine``, 3 of B 2 x S 4096 unpacked
   rows and one of 2 packed windows of 4096 (documents of 300-3000 tokens,
   segment ids): exact launch counts (K4 rows 4L+1, K5 and K6 2L+1 a
   microbatch), step ms (CUDA events), tokens/s, peak memory; then at 3
   layers the kernel loss and every gradient against ``ops="plain"`` on
   both kinds of batch (loss 1e-4, gradients rel-L2 5e-2); (b) all 38
   layers prefill 4 prompts of 3000 tokens (above the window, not a
   multiple of it) and decode 64 greedy steps, so the local rings wrap:
   exact launch counts (K4 rows 2L+1 a call), the caches' bytes (exactly
   105,021,440), the rings' positions, prefill ms, decode ms a step, one
   step profiled, tokens/s; the logits against ``ops="plain"``
   teacher-forced (rel-L2 0.1) and against one forward over the 3064
   tokens (0.25); (c) 6 layers in f32, 40 decode steps against the forward (1e-4).
15. routed MoE: first K4 rows at Kimi-K2's d 7168 (a 4 x 1024 prefill, a
   decode step of 4) and at Llama-4-Scout's training rows [8192, 5120],
   K5 and K6 on those rows (K6 also bitwise against a second run), K7
   causal at Hq 64 over Hkv 8 (4 x 1024) and at Hq 40 over 8 (2 x 4096,
   dh 128), and K12 at group 8 (a wave of 4 slots) against their plain
   versions, timed;
   (a) Llama-4-Scout at full width and 2 of its 48 layers (bf16, 16
   experts top-1 and a shared one, capacity factor 1.25): 4 ``Trainer``
   steps on ``EmulatedEngine`` (3 of B 2 x S 4096, one of 2 packed
   windows): exact launch counts (the dense LM's: K4 rows 4L+1, K5 and K6
   2L+1, K7 2L, K8 and K9 L a microbatch), step ms, tokens/s, peak
   memory, the share of dropped assignments, one microbatch's gradient
   profiled; then the same depth in f32, the kernel loss and every
   gradient against ``ops="plain"`` (1e-4, 5e-2) with the share of
   (token, layer) routes that differ; (d) that f32 model without drops
   (capacity factor E / k): 32 decode steps against one forward (1e-4);
   (b) 12 of its 48 layers (bf16, capacity factor E / k: no drop) through
   the serve launcher's ``serve_lm`` on a recording engine (8 requests),
   each request through contiguous prefill and decode teacher-forced on
   the engine's tokens, two of them again with ``ops="plain"`` (logits
   rel-L2 0.25 each, route-flip shares), exact launch counts, prefill and
   wave ms, the widest wave profiled against its weights bound; (c)
   Kimi-K2 at full width and 2 of its 61 layers (the dense lead and one
   MoE layer of 384 experts top-8, bf16, capacity factor 1.25): a
   contiguous prefill of 4 x 1024 tokens (drop share) and 32 greedy decode
   steps (ms against the weights bound, one profiled), then the paged
   prefill of the same prompts and one paged wave against the contiguous
   prefill and first step (0.25), exact launch counts for both.
16. MusicGen-large (the audio family: LayerNorm, MHA 32 x 64) and
   Llama-3.2-Vision-90B (a cross-attention layer every fifth, over 4096
   image tokens): first K4 rows at d 8192 (the row kernels' largest width:
   training rows [8192, 8192], a 4 x 1024 prefill, a decode step of 4), K5
   and K6 on the training rows (K6 also bitwise against a second run), K7
   non-causal GQA 64/8 x 128 over 4096 image tokens at the training
   windows (q [2, 4096]) and the prefill (q [4, 1024]), K8 and K9 at the
   training windows, K7-K9 causal at MusicGen's [4, 2048, 32, 64], and K12
   at MusicGen's wave (group 1, dh 64) against their plain versions,
   timed; (a) MusicGen-large at full width and depth (48 layers, bf16): 4
   ``Trainer`` steps (3 of B 4 x S 2048, one of 4 packed windows): exact
   launch counts (K7 2L, K8 L, K9 L a microbatch; the LayerNorm is plain,
   so no norm kernel), step ms, tokens/s, peak memory; (e) int8
   compression with error feedback on one microbatch's gradients (every
   leaf within half its scale, the residual exact, the wire bytes),
   timed; then 8 layers in f32, the kernel loss and every gradient against
   ``ops="plain"`` on unpacked and packed rows (1e-4, 5e-2); (b) the 48
   layers serve 8 requests through a recording ``ServeEngine``, each then
   through contiguous prefill and decode teacher-forced (5e-2), and a
   contiguous prefill of 4 x 1024 and 32 greedy steps against
   ``ops="plain"`` (5e-2): exact launch counts, prefill, wave and step ms,
   one wave profiled against the weights bound; (c) Llama-3.2-Vision at
   one superblock (4 "attn" + 1 "cross" layers, every gate at 0.5): 4
   ``Trainer`` steps of B 2 x S 4096 over memory [2, 4096, 8192]: exact
   launch counts (the dense LM's; the cross layer counts as an attention
   layer), step ms, tokens/s, peak memory; then in f32 the kernel loss and
   every gradient against ``ops="plain"``; (d) 6 superblocks (30 of 100
   layers) prefill 4 x 1024 tokens over 4 x 4096 image tokens and decode
   32 greedy steps: exact launch counts, prefill ms, decode ms against the
   weights bound, one step profiled, the cross layers' decode attention
   and ``repeat_kv`` timed alone; logits against ``ops="plain"``
   teacher-forced (5e-2); then one superblock in f32, 32 decode steps
   against one forward (1e-4).
17. the dry run (``repro_torch.launch.dryrun``): (a) ``--all --force``
   in a subprocess (it runs two subprocesses a production mesh, all at
   once, with a timeout): 66 cells ``ok`` and 22 ``skipped`` with the
   reference's reasons, none ``error``; each cell's per-device operations,
   argument, temp and peak GiB, collective GiB and trace seconds printed,
   the records copied to ``chiprun_out/dryrun.json``; (b) Llama-3.2-1B at
   full width and depth (16 layers, bf16, seed 0), ``train_4k`` with its
   global batch cut from 256 to 2, dry-run on ``make_host_mesh()``, then
   ``make_train_step(cfg, opt, policy=make_policy(host_mesh, cfg))`` for
   real through the hand kernels: the predicted ``argument_bytes`` equal
   to the state's and the batch's bytes on the card, exact launch counts
   (K4 rows 4L+1, K5 and K6 rows 2L+1, K7 2L, K8 and K9 L), the predicted
   ``peak_bytes`` within 25% of the step's peak allocation above what the
   process held before the state (``max_memory_allocated`` over a steady
   step); the counted operations over the steady step's time printed as
   TFLOP/s and a share of 989; (c) ``decode_32k`` with its batch cut from
   128 to 8 (cache capacity 32768): one ``make_decode_step(cfg,
   policy=...)`` call at ``pos`` 32767 against the dry run of the cell, the
   same three gates (K4 rows 2L+1).  Both print the trace's temporaries
   beside what the same step's dispatched ops allocate on the card (the
   dry run's tracer, one more step) and what the allocator held.

Phase 2 also holds K4 on model rows (x [1, 2048, 2048] and [8, 1, 2048]
bf16) and K12 (the decode wave of phase 6; 64 slots with kv_lens up to
4096; dh 128 with 40 q heads over 8 kv heads) against their plain
versions, with shuffled page tables, inactive slots, ragged last pages and
scratch entries past each allocation (K12 also bitwise against a second
run); and the Mamba-2 kernels at phase 8's
shapes: K13 on x, g [8192, 5120] bf16 with g the strided z slice of the
in_proj output, K4 on rows of [8192, 2560] (norm1 and final_norm), K5
and K6 on rows of [8192, 2560] and [8192, 5120] against the plain rstd (K6
also bitwise against a second run), the gated norm's whole backward, and
K10 against its plain version and K3 at K3's shape (and bitwise against a
second run), timed back to back with K3 there and at the paper's Fig. 1
width (D 5120, B 1, S 8192 to 32768), with its GB/s an SM; all of them at
small f32 shapes.

Each kernel's launch counts in the record are those of the main paths,
each reset to 0 just before its run and read just after: the serving
waves of phase 3, the training steps of phase 5 (b), the LM serving of
phase 6 (b), the Mamba-2 training steps of phase 8 (b), the dense-LM
training steps of phase 9 (b), the SP step of phase 9 (c), the planned
launcher of phase 10 (a), the churn leg and resumed step of phase 11 (b),
(c), the Shape Benchmark's calls, the NCCL launcher and the gloo processes
of phase 12, and phase 13's Mamba-2 serving, Qwen2.5-14B's and
MiniCPM-2B's launchers and contiguous runs, and the example, phase
14's RecurrentGemma training steps and serving, phase 15's
Llama-4-Scout training steps, engine and contiguous runs and Kimi-K2's
contiguous and paged runs, and phase 16's MusicGen training steps, engine
and contiguous runs and Llama-3.2-Vision's training steps and contiguous
serving, and phase 17's host-mesh train step and decode step
(``launches_by_path``); ``launches`` is their sum.

Each phase's wall seconds go to the log and to the record (``phase_s``).
Prints the kernels' JSON record on the line before the last and, as the
last line, ``{"ok": true, "device": {...}}``.  The full record also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import gc
import importlib
import itertools
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
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak

# tolerances: outputs in the working dtype (one bf16 rounding apart at
# most, as tests/test_kernels.py allows), f32 statistics summed in another
# order over up to 6240 terms
TOL = {
    "norm_bf16": 6e-2, "attn_bf16": 3e-2, "stat": 2e-4, "lse_bf16": 1e-3,
    "norm_f32": 2e-4, "attn_f32": 2e-5,
    # rel-L2 of K7's f32 output from bf16 inputs: p is rounded to bf16 as an
    # mma operand, which the plain version keeps in f32
    "attn_f32_out": 1e-2,
    # rel-L2 of each slot of K12's bf16 output: p is rounded to bf16 as an
    # mma operand, and the output to bf16 (about 2^-9 each)
    "attn_bf16_slot": 1e-2,
}
# backward tolerances, relative to the reference's largest magnitude
# (max |got - want| / max |want|) or its L2 norm (rel-L2):
# - a bf16 gradient computed in f32 from the same inputs as the plain
#   version is one bf16 rounding (2^-8 relative) from it: 1e-2 of the max;
# - f32 sums over up to 2e5 rows in another order: 2e-5 of the max;
# - flash gradients in bf16 round p and ds to bf16 as mma operands, which
#   the plain version keeps in f32: rel-L2 2e-2; in f32 the products are
#   exact and only the order differs: rel-L2 1e-5 (the JAX package's own
#   f32 flash gradient gate, tests/test_flash_segment.py:84).
BWD_TOL = {"grad_bf16": 1e-2, "sum_f32": 2e-5, "flash_bf16": 2e-2, "flash_f32": 1e-5}

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


def device_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: the calls are enqueued behind a
    sleeping kernel, so the events around them see the device's work and
    not the host's time to enqueue it (which exceeds the device time of a
    small kernel).  Raises if the host did not finish enqueueing before the
    sleep ended."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # about 10 ms
    for _ in range(4):
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
            return ev[1].elapsed_time(ev[2]) / iters
        cycles *= 4
    raise RuntimeError("device_ms: the host could not enqueue ahead of the device")


def enqueue_us(fn, iters: int = 200) -> float:
    """Host wall time per call of ``fn`` over ``iters`` calls, with one
    synchronisation before and after: what the host spends to enqueue."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    log(f"  {name:<28} max_abs_err {err:.3e}  tol {tol:.1e}")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


def check_rel(name: str, got, want, tol: float) -> float:
    """max |got - want| <= tol * max |want|; returns the absolute error."""
    err = max_err(got, want)
    scale = float(want.float().abs().max())
    log(f"  {name:<28} max_abs_err {err:.3e}  (max |ref| {scale:.3e}, tol {tol:.1e} of it)")
    if not err <= tol * scale:
        raise AssertionError(f"{name}: error {err} above {tol} x {scale}")
    return err


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def check_l2(name: str, got, want, tol: float) -> float:
    """rel-L2 <= tol; returns the absolute max error."""
    rel, err = rel_l2(got, want), max_err(got, want)
    log(f"  {name:<28} rel-L2 {rel:.3e}  max_abs_err {err:.3e}  tol {tol:.1e}")
    if not rel <= tol:
        raise AssertionError(f"{name}: rel-L2 {rel} above tolerance {tol}")
    return err


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def segs(runs_per_row, device):
    rows = [torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in runs])
            for runs in runs_per_row]
    return torch.stack(rows).to(device)


def k7_small_bf16(dev, randn) -> None:
    """K7 on bf16 inputs (the warp-specialised kernel) against its plain
    version at every head width, causal or not, GQA or not, under three
    segment layouts, q, k and v strided views of one fused projection over
    S 300 (two 128-row tiles and a ragged one): out, lse, rows that see no
    key, and the f32-out mode rounded equal to the bf16 mode bitwise."""
    from repro_torch.kernels.flash_attention.flash import flash_fwd
    from repro_torch.kernels.flash_attention.ref import attention_ref

    s = 300
    sg = segs([[(0, 70), (1, 130), (-1, 100)], [(5, s)]], dev)
    sq_ = segs([[(0, 70), (1, 130), (-1, 100)], [(5, 150), (9, 150)]], dev)
    n, worst, worst_lse = 0, 0.0, 0.0
    for dhs in (32, 64, 128):
        for causal in (False, True):
            for hq, hkv in ((4, 4), (4, 2)):
                qkv = randn(2, s, (hq + 2 * hkv) * dhs, dtype=torch.bfloat16)
                qs_ = qkv[..., : hq * dhs].reshape(2, s, hq, dhs)
                ks_ = qkv[..., hq * dhs : (hq + hkv) * dhs].reshape(2, s, hkv, dhs)
                vs_ = qkv[..., (hq + hkv) * dhs :].reshape(2, s, hkv, dhs)
                for ids in ((None, None), (sg, sg), (sq_, sg)):
                    o, lse = flash_fwd(qs_, ks_, vs_, *ids, causal=causal)
                    o32, lse32 = flash_fwd(qs_, ks_, vs_, *ids, causal=causal,
                                           out_dtype=torch.float32)
                    o_r, lse_r = attention_ref(qs_, ks_, vs_, *ids, causal=causal)
                    torch.cuda.synchronize()
                    tag = f"dh={dhs} causal={causal} gqa={hq // hkv} segs={ids[0] is not None}"
                    err = max_err(o, o_r)
                    live = lse_r > -1e38
                    err_lse = max_err(lse[live], lse_r[live])
                    if not (err <= TOL["attn_bf16"] and err_lse <= TOL["lse_bf16"]):
                        check(f"K7 bf16 {tag}", err, TOL["attn_bf16"])
                        check(f"K7 bf16 lse {tag}", err_lse, TOL["lse_bf16"])
                    dead = (~live).transpose(1, 2)
                    if not torch.equal(live, lse > -1e38) or torch.count_nonzero(o[dead]):
                        raise AssertionError(f"K7 bf16 {tag}: rows that see no key differ")
                    if not (torch.equal(o32.to(o.dtype), o) and torch.equal(lse32, lse)):
                        raise AssertionError(f"K7 bf16 {tag}: the f32-out mode rounded is not "
                                             f"the bf16 mode's output and lse")
                    n, worst, worst_lse = n + 1, max(worst, err), max(worst_lse, err_lse)
    log(f"  K7 bf16 small shapes: {n} cases (dh 32/64/128 x causal x GQA x 3 segment layouts, "
        f"S {s}): max_abs_err {worst:.3e} (tol {TOL['attn_bf16']:.0e}), lse {worst_lse:.3e} "
        f"(tol {TOL['lse_bf16']:.0e}), dead rows exact zeros, f32-out mode bitwise")


def k89_small_bf16(dev, randn) -> None:
    """K8 and K9 on bf16 inputs (the warp-specialised kernels) against the
    plain backward at every head width, causal or not, GQA 1 or 4, under
    three segment layouts (none; packed with a -1 tail; rows that see no
    key), ragged Sq 200 x Skv 150, q, k and v strided views of fused
    projections: dq, dk, dv within the bf16 gate, and dq exact zeros on
    rows that see no key."""
    from repro_torch.kernels.flash_attention.flash import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_delta_ref

    sq, skv = 200, 150
    kv_ids = segs([[(0, 50), (1, 70), (-1, 30)], [(5, 100), (9, 50)]], dev)
    layouts = {
        "none": (None, None),
        "packed": (segs([[(0, 70), (1, 100), (-1, 30)], [(5, 200)]], dev), kv_ids),
        "dead rows": (segs([[(0, 60), (7, 20), (1, 90), (-1, 30)], [(5, 100), (8, 30), (9, 70)]], dev),
                      kv_ids),
    }
    n, worst, n_dead = 0, 0.0, 0
    for dhs in (32, 64, 128):
        for causal in (False, True):
            for hq, hkv in ((4, 4), (4, 1)):
                qkv = randn(2, sq, (hq + 2 * hkv) * dhs, dtype=torch.bfloat16)
                qs_ = qkv[..., : hq * dhs].reshape(2, sq, hq, dhs)
                kv = randn(2, skv, 2 * hkv * dhs, dtype=torch.bfloat16)
                ks_ = kv[..., : hkv * dhs].reshape(2, skv, hkv, dhs)
                vs_ = kv[..., hkv * dhs :].reshape(2, skv, hkv, dhs)
                do_ = randn(2, sq, hq, dhs, dtype=torch.bfloat16)
                for lay, ids in layouts.items():
                    o_, l_ = flash_fwd(qs_, ks_, vs_, *ids, causal=causal, out_dtype=torch.float32)
                    dq_, de_ = flash_bwd_dq(qs_, ks_, vs_, o_, do_, l_, *ids, causal=causal)
                    dk_, dv_ = flash_bwd_dkv(qs_, ks_, vs_, do_, l_, de_, *ids, causal=causal)
                    want = attention_bwd_ref(qs_, ks_, vs_, do_, l_, attention_delta_ref(do_, o_),
                                             *ids, causal=causal)
                    torch.cuda.synchronize()
                    tag = f"dh={dhs} causal={causal} gqa={hq // hkv} segs={lay}"
                    errs = [rel_l2(a_, b_) for a_, b_ in zip((dq_, dk_, dv_), want)]
                    if not max(errs) <= BWD_TOL["flash_bf16"]:
                        for gn, a_, b_ in zip(("dq", "dk", "dv"), (dq_, dk_, dv_), want):
                            check_l2(f"K8/K9 bf16 {gn} {tag}", a_, b_, BWD_TOL["flash_bf16"])
                    dead = (l_ < -1e38).transpose(1, 2)
                    if lay == "dead rows" and not dead.any():
                        raise AssertionError(f"K8 bf16 {tag}: the layout has no dead row")
                    if torch.count_nonzero(dq_[dead]):
                        raise AssertionError(f"K8 bf16 {tag}: a row that sees no key has a nonzero dq")
                    n, worst, n_dead = n + 1, max(worst, *errs), n_dead + int(dead.sum())
    log(f"  K8/K9 bf16 small shapes: {n} cases (dh 32/64/128 x causal x GQA 1/4 x 3 segment "
        f"layouts, Sq {sq} x Skv {skv}, strided views): worst rel-L2 {worst:.3e} (tol "
        f"{BWD_TOL['flash_bf16']:.0e}); {n_dead} (row, head) pairs see no key, dq exact zeros")


def phase_kernels(dev) -> dict:
    """Phase 2: every kernel against its plain version; times."""
    from repro_torch.kernels.flash_attention.flash import (
        BOUND_TILE, FWD_TILE, flash_fwd, live_tile_pairs,
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
    t_k = device_ms(lambda: adaln_fwd(x, sc, sh), 50)
    t_p = cuda_ms(lambda: adaln_modulate_ref(x, sc, sh), 5)
    nbytes = 2 * x.numel() * 2 + 2 * b * d * 4 + 2 * b * s * 4
    bms, bby = bound(nbytes, 8 * x.numel(), F32_FLOPS)
    log(f"  K1 ms {t_k:.4f}  plain {t_p:.4f}  bound {bms:.4f} ({bby}, {bms / t_k:.1%})")
    del x, y, yr, mu, mur, rstd, rr
    # the training buckets' shapes, where a microbatch launches K1 4L+1 times
    train = []
    for bt, st_ in ((10, 1637), (1, 7877)):
        log(f"K1 adaln_fwd  x [{bt}, {st_}, {d}] bf16")
        xt = randn(bt, st_, d, dtype=torch.bfloat16, scale=2.0, shift=0.3)
        mt = randn(bt, 6, d, scale=0.1)
        got, want = adaln_fwd(xt, mt[:, 1], mt[:, 0]), adaln_modulate_ref(xt, mt[:, 1], mt[:, 0])
        for nm, a_, b_, tol in zip(("y (bf16)", "mu", "rstd"), got, want,
                                   (TOL["norm_bf16"], TOL["stat"], TOL["stat"])):
            check(f"K1 {nm} [{bt}, {st_}]", max_err(a_, b_), tol)
        k1_err = max(k1_err, max_err(got[0], want[0]))
        # x [10, 1637] and [1, 7877] come near or under the 50 MB L2: cycle
        # through copies of the inputs that together exceed it three times
        nb = 2 * xt.numel() * 2 + 2 * bt * d * 4 + 2 * bt * st_ * 4
        sets = [(xt, mt[:, 1], mt[:, 0])] + [(xt.clone(), mt[:, 1].clone(), mt[:, 0].clone())
                                             for _ in range(-(-150_000_000 // nb) - 1)]
        cyc = itertools.cycle(sets)
        tt = device_ms(lambda: adaln_fwd(*next(cyc)), 50)
        tp = cuda_ms(lambda: adaln_modulate_ref(xt, mt[:, 1], mt[:, 0]), 5)
        tb, _ = bound(nb, 8 * xt.numel(), F32_FLOPS)
        train.append(dict(shape=[bt, st_, d], ms=tt, plain_ms=tp, bound_ms=tb))
        log(f"  K1 ms {tt:.4f}  plain {tp:.4f}  bound {tb:.4f} (bytes, {tb / tt:.1%})")
        del xt, got, want, sets, cyc
    out["adaln_fwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/fused_adaln/csrc/adaln_fwd.cu",
        replaces="src/repro/kernels/fused_adaln/adaln.py:58",
        max_abs_err=k1_err, ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=bby,
        library_ms=None, shape="x [4, 6240, 1536] bf16", train=train,
    )

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
        # the training forward's mode: the same attention written in f32,
        # held by rel-L2 against the plain f32 output, its lse against the
        # plain lse, and equal to the working-dtype mode up to the final
        # rounding (the two modes differ only in the store)
        o32, lse32 = flash_fwd(*args, out_dtype=torch.float32)
        o32_r = attention_ref(*args, out_dtype=torch.float32)[0]
        if o32.dtype != torch.float32:
            raise AssertionError("K7 f32-out mode wrote another dtype")
        check_l2(f"K7 {nm} out (f32-out mode)", o32, o32_r, TOL["attn_f32_out"])
        check(f"K7 {nm} lse (f32-out mode)", max_err(lse32[live], lse_r[live]), TOL["lse_bf16"])
        if not (torch.equal(o32.to(o.dtype), o) and torch.equal(lse32, lse)):
            raise AssertionError(f"K7 {nm}: the f32-out mode rounded is not the "
                                 f"working-dtype mode's output and lse")
        log(f"  K7 {nm}: f32-out mode rounded to {o.dtype} equals the {o.dtype} mode bitwise")
        del o, lse, o_r, lse_r, o32, lse32, o32_r
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
    k7_small_bf16(dev, randn)

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
    # the work K7 runs: its own 128 x 128 tiles, in 64 x 64 equivalents
    run = 4 * h * (live_tile_pairs(s, s, seg, seg, tile=FWD_TILE)
                   + live_tile_pairs(s, TEXT_LEN, seg, tseg, tile=FWD_TILE))
    flops = tiles * 4 * BOUND_TILE ** 2 * dh
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, qx, kx, vx)) \
        + 2 * q.numel() * 2 + 2 * b * h * s * 4 + (2 * seg.numel() + tseg.numel()) * 4
    bms, bby = bound(nbytes, flops, BF16_FLOPS)
    out["flash_fwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_attention/flash.py:136",
        max_abs_err=k7_err, ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=bby,
        library_ms=t_l, shape="self 6240x6240 + cross 6240x512, B=4, H=12, dh=128, bf16",
        live_tile_pairs=tiles, run_tile_pairs=run, tflops_per_s=flops / (t_k * 1e-3) / 1e12,
    )
    log(f"  K7 ms {t_k:.4f} (self + cross)  plain {t_p:.4f}  library(SDPA, bool mask) {t_l:.4f}  "
        f"bound {bms:.4f} ({bby}, {tiles} live 64x64 tiles; the kernel's 128x128 tiles run "
        f"{run} of them)")
    return out


def phase_kernels_bwd(dev) -> dict:
    """Phase 2, backward: K2, K3, K5, K6, K8 and K9 against their plain
    versions at the training shapes and small f32 shapes; times."""
    from repro_torch.kernels.flash_attention.flash import (
        BOUND_TILE, BWD_TILES, flash_bwd_dkv, flash_bwd_dq, flash_fwd, live_tile_pairs,
    )
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_delta_ref
    from repro_torch.kernels.fused_adaln.adaln import adaln_bwd_dmod, adaln_bwd_dx, adaln_fwd
    from repro_torch.kernels.fused_adaln.ref import adaln_bwd_dmod_ref, adaln_bwd_dx_ref
    from repro_torch.kernels.fused_rmsnorm.ref import qk_rms_bwd_ref
    from repro_torch.kernels.fused_rmsnorm.rmsnorm import (
        qk_rms_bwd_dw, qk_rms_bwd_dx, qk_rms_fwd,
    )

    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    out = {}
    d, h, dh = 1536, 12, 128
    train_shapes = ((10, 1637), (1, 7877))  # the image bucket, the 33-frame bucket

    # -- K2, K3 fused AdaLN backward -------------------------------------
    def adaln_case(b, s, d_, dtype):
        x = randn(b, s, d_, dtype=dtype, scale=2.0, shift=0.3)
        mod = randn(b, 6, d_, scale=0.1)
        _, mu, rstd = adaln_fwd(x, mod[:, 1], mod[:, 0])
        return x, mod[:, 1], mu, rstd, randn(b, s, d_, dtype=dtype)

    k2_err = k3_err = 0.0
    for b, s in train_shapes:
        log(f"K2 adaln_bwd_dx, K3 adaln_bwd_dmod  dy, x [{b}, {s}, {d}] bf16")
        x, sc, mu, rstd, dy = adaln_case(b, s, d, torch.bfloat16)
        k2_err = max(k2_err, check_rel(f"K2 dx [{b}, {s}]", adaln_bwd_dx(dy, x, mu, rstd, sc),
                                       adaln_bwd_dx_ref(dy, x, mu, rstd, sc), BWD_TOL["grad_bf16"]))
        got, want = adaln_bwd_dmod(dy, x, mu, rstd), adaln_bwd_dmod_ref(dy, x, mu, rstd)
        for nm, a_, b_ in zip(("dscale", "dshift"), got, want):
            k3_err = max(k3_err, check_rel(f"K3 {nm} [{b}, {s}]", a_, b_, BWD_TOL["sum_f32"]))
        again = adaln_bwd_dmod(dy, x, mu, rstd)
        if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
            raise AssertionError("K3 is not bitwise deterministic")
    for shape in [(2, 100, 256), (3, 37, 1536)]:
        xs, scs, mus, rs, dys = adaln_case(*shape, torch.float32)
        check_rel(f"K2 dx f32 {list(shape)}", adaln_bwd_dx(dys, xs, mus, rs, scs),
                  adaln_bwd_dx_ref(dys, xs, mus, rs, scs), BWD_TOL["sum_f32"])
        for nm, a_, b_ in zip(("dscale", "dshift"), adaln_bwd_dmod(dys, xs, mus, rs),
                              adaln_bwd_dmod_ref(dys, xs, mus, rs)):
            check_rel(f"K3 {nm} f32 {list(shape)}", a_, b_, BWD_TOL["sum_f32"])
    b, s = train_shapes[0]
    x, sc, mu, rstd, dy = adaln_case(b, s, d, torch.bfloat16)
    n = b * s
    t_k = cuda_ms(lambda: adaln_bwd_dx(dy, x, mu, rstd, sc), 20)
    t_p = cuda_ms(lambda: adaln_bwd_dx_ref(dy, x, mu, rstd, sc), 5)
    bms, bby = bound(3 * n * d * 2 + 2 * n * 4 + b * d * 4, 10 * n * d, F32_FLOPS)
    out["adaln_bwd_dx"] = dict(
        route="cuda", source="src/repro_torch/kernels/fused_adaln/csrc/adaln_bwd.cu",
        replaces="src/repro/kernels/fused_adaln/adaln.py:104",
        max_abs_err=k2_err, ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=bby,
        library_ms=None, shape=f"dy, x [{b}, {s}, {d}] bf16",
    )
    log(f"  K2 ms {t_k:.4f}  plain {t_p:.4f}  bound {bms:.4f} ({bby})")
    t_k = cuda_ms(lambda: adaln_bwd_dmod(dy, x, mu, rstd), 20)
    t_p = cuda_ms(lambda: adaln_bwd_dmod_ref(dy, x, mu, rstd), 5)
    bms, bby = bound(2 * n * d * 2 + 2 * n * 4 + 2 * b * d * 4, 4 * n * d, F32_FLOPS)
    out["adaln_bwd_dmod"] = dict(
        route="cuda", source="src/repro_torch/kernels/fused_adaln/csrc/adaln_bwd.cu",
        replaces="src/repro/kernels/fused_adaln/adaln.py:145",
        max_abs_err=k3_err, ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=bby,
        library_ms=None, shape=f"dy, x [{b}, {s}, {d}] bf16",
    )
    log(f"  K3 ms {t_k:.4f}  plain {t_p:.4f}  bound {bms:.4f} ({bby})")
    del x, dy, mu, rstd

    # -- K5, K6 joint q/k RMSNorm backward -------------------------------
    def rms_case(b, s, hh, dh_, dtype):
        qkv = randn(b, s, 3 * hh * dh_, dtype=dtype, scale=1.5)
        q = qkv[..., : hh * dh_].reshape(b, s, hh, dh_)
        k = qkv[..., hh * dh_ : 2 * hh * dh_].reshape(b, s, hh, dh_)
        wq, wk = randn(dh_, scale=0.1, shift=1.0), randn(dh_, scale=0.1, shift=1.0)
        _, _, rq, rk = qk_rms_fwd(q, k, wq, wk)
        return (randn(b, s, hh, dh_, dtype=dtype), randn(b, s, hh, dh_, dtype=dtype),
                q, k, wq, wk, rq, rk)

    k5_err = k6_err = 0.0
    for b, s in train_shapes:
        log(f"K5 qk_rms_bwd_dx, K6 qk_rms_bwd_dw  q, k [{b}, {s}, {h}, {dh}] bf16 views of qkv")
        dyq, dyk, q, k, wq, wk, rq, rk = rms_case(b, s, h, dh, torch.bfloat16)
        want = qk_rms_bwd_ref(dyq, dyk, q, k, wq, wk, rq, rk)
        for nm, a_, b_ in zip(("dq", "dk"), qk_rms_bwd_dx(dyq, dyk, q, k, wq, wk, rq, rk), want):
            k5_err = max(k5_err, check_rel(f"K5 {nm} [{b}, {s}]", a_, b_, BWD_TOL["grad_bf16"]))
        got = qk_rms_bwd_dw(dyq, dyk, q, k, rq, rk)
        for nm, a_, b_ in zip(("dwq", "dwk"), got, want[2:]):
            k6_err = max(k6_err, check_rel(f"K6 {nm} [{b}, {s}]", a_, b_, BWD_TOL["sum_f32"]))
        again = qk_rms_bwd_dw(dyq, dyk, q, k, rq, rk)
        if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
            raise AssertionError("K6 is not bitwise deterministic")
    for dhs in (32, 64, 128):
        args = rms_case(2, 50, 4, dhs, torch.float32)
        want = qk_rms_bwd_ref(*args)
        got = (*qk_rms_bwd_dx(*args), *qk_rms_bwd_dw(*args[:4], *args[6:]))
        for nm, a_, b_ in zip(("dq", "dk", "dwq", "dwk"), got, want):
            check_rel(f"K5/K6 {nm} f32 dh={dhs}", a_, b_, BWD_TOL["sum_f32"])
    b, s = train_shapes[0]
    dyq, dyk, q, k, wq, wk, rq, rk = rms_case(b, s, h, dh, torch.bfloat16)
    n = q.numel()
    t_k5 = device_ms(lambda: qk_rms_bwd_dx(dyq, dyk, q, k, wq, wk, rq, rk), 50)
    t_k6 = device_ms(lambda: qk_rms_bwd_dw(dyq, dyk, q, k, rq, rk), 50)
    t_p = cuda_ms(lambda: qk_rms_bwd_ref(dyq, dyk, q, k, wq, wk, rq, rk), 5)
    # yardstick only, never on the port's path: the library norm's backward,
    # once per tensor, for the input (K5) and for the weight (K6)
    leaves = [t.detach().requires_grad_() for t in (q, k, wq.bfloat16(), wk.bfloat16())]
    ys = (F.rms_norm(leaves[0], (dh,), leaves[2], 1e-6), F.rms_norm(leaves[1], (dh,), leaves[3], 1e-6))
    t_l5 = cuda_ms(lambda: torch.autograd.grad(ys, leaves[:2], (dyq, dyk), retain_graph=True), 10)
    t_l6 = cuda_ms(lambda: torch.autograd.grad(ys, leaves[2:], (dyq, dyk), retain_graph=True), 10)
    del ys, leaves
    bms5, bby5 = bound(2 * 3 * n * 2 + 2 * dh * 4 + 2 * n // dh * 4, 2 * 6 * n, F32_FLOPS)
    bms6, bby6 = bound(2 * 2 * n * 2 + 2 * n // dh * 4 + 2 * dh * 4, 2 * 3 * n, F32_FLOPS)
    src = "src/repro_torch/kernels/fused_rmsnorm/csrc/rmsnorm_bwd.cu"
    shape = f"dy, q, k [{b}, {s}, {h}, {dh}] bf16, one launch for q and k"
    out["qk_rms_bwd_dx"] = dict(
        route="cuda", source=src, replaces="src/repro/kernels/fused_rmsnorm/rmsnorm.py:111",
        max_abs_err=k5_err, ms=t_k5, plain_ms=t_p, bound_ms=bms5, bound_by=bby5,
        library_ms=t_l5, shape=shape)
    out["qk_rms_bwd_dw"] = dict(
        route="cuda", source=src, replaces="src/repro/kernels/fused_rmsnorm/rmsnorm.py:144",
        max_abs_err=k6_err, ms=t_k6, plain_ms=t_p, bound_ms=bms6, bound_by=bby6,
        library_ms=t_l6, shape=shape)
    log(f"  K5 ms {t_k5:.4f}  K6 ms {t_k6:.4f}  plain (dx and dw) {t_p:.4f}  library "
        f"(F.rms_norm backward x2) dx {t_l5:.4f} dw {t_l6:.4f}  bound K5 {bms5:.4f} ({bby5}, "
        f"{bms5 / t_k5:.1%}) K6 {bms6:.4f} ({bby6}, {bms6 / t_k6:.1%})")
    del dyq, dyk, q, k

    # -- K8, K9 flash-attention backward ---------------------------------
    # one packed 7877-token window: two clips and a padded tail (-1); the
    # padded rows see no text key, so their cross-attention rows are dead
    b, s = train_shapes[1]
    seg = segs([[(0, 3000), (1, 4000), (-1, s - 7000)]], dev)
    tseg = segs([[(0, 300), (1, 212)]], dev)
    qkv = randn(b, s, 3 * h * dh, dtype=torch.bfloat16)
    q = qkv[..., : h * dh].reshape(b, s, h, dh)
    k = qkv[..., h * dh : 2 * h * dh].reshape(b, s, h, dh)
    v = qkv[..., 2 * h * dh :].reshape(b, s, h, dh)
    kvx = randn(b, TEXT_LEN, 2 * h * dh, dtype=torch.bfloat16)
    kx = kvx[..., : h * dh].reshape(b, TEXT_LEN, h, dh)
    vx = kvx[..., h * dh :].reshape(b, TEXT_LEN, h, dh)
    qx = randn(b, s, h, dh, dtype=torch.bfloat16)
    cases = {"self": (q, k, v, seg, seg), "cross": (qx, kx, vx, seg, tseg)}
    res = {}
    k8_err = k9_err = 0.0
    log(f"K8 flash_bwd_dq, K9 flash_bwd_dkv  self [{b}, {s}, {h}, {dh}] x {s} and cross x "
        f"{TEXT_LEN}, bf16, packed + padded segments")
    for nm, args in cases.items():
        o32, lse = flash_fwd(*args, out_dtype=torch.float32)
        do = randn(b, s, h, dh, dtype=torch.bfloat16)
        dq, delta = flash_bwd_dq(*args[:3], o32, do, lse, *args[3:])
        dk, dv = flash_bwd_dkv(*args[:3], do, lse, delta, *args[3:])
        delta_r = attention_delta_ref(do, o32)
        dq_r, dk_r, dv_r = attention_bwd_ref(*args[:3], do, lse, delta_r, *args[3:])
        torch.cuda.synchronize()
        check_rel(f"K8 {nm} delta", delta, delta_r, BWD_TOL["sum_f32"])
        k8_err = max(k8_err, check_l2(f"K8 {nm} dq", dq, dq_r, BWD_TOL["flash_bf16"]))
        k9_err = max(k9_err, check_l2(f"K9 {nm} dk", dk, dk_r, BWD_TOL["flash_bf16"]),
                     check_l2(f"K9 {nm} dv", dv, dv_r, BWD_TOL["flash_bf16"]))
        dead = (lse < -1e38).transpose(1, 2)  # [B, S, H]
        if dead.any() and torch.count_nonzero(dq[dead]) != 0:
            raise AssertionError(f"K8 {nm}: a row that sees no key has a nonzero dq")
        log(f"  K8 {nm}: {int(dead.sum())} (row, head) pairs see no key, dq exact zeros")
        again = (*flash_bwd_dq(*args[:3], o32, do, lse, *args[3:]),
                 *flash_bwd_dkv(*args[:3], do, lse, delta, *args[3:]))
        if not all(torch.equal(a_, b_) for a_, b_ in zip(again, (dq, delta, dk, dv))):
            raise AssertionError(f"K8/K9 {nm}: a second run is not bitwise the first")
        log(f"  K8/K9 {nm}: dq, delta, dk, dv bitwise equal on a second run")
        res[nm] = (o32, lse, do, delta)
        del dq, dk, dv, dq_r, dk_r, dv_r, again
    for dhs in (32, 64, 128):
        for causal in (False, True):
            for hq, hkv in ((4, 4), (4, 2)):
                qs_ = randn(2, 200, hq, dhs)
                ks_, vs_ = randn(2, 150, hkv, dhs), randn(2, 150, hkv, dhs)
                do_ = randn(2, 200, hq, dhs)
                sg = segs([[(0, 70), (1, 100), (-1, 30)], [(5, 200)]], dev)
                sk = segs([[(0, 50), (1, 70), (-1, 30)], [(5, 100), (9, 50)]], dev)
                for ids in ((None, None), (sg, sk)):
                    o_, l_ = flash_fwd(qs_, ks_, vs_, *ids, causal=causal)
                    dq_, de_ = flash_bwd_dq(qs_, ks_, vs_, o_, do_, l_, *ids, causal=causal)
                    dk_, dv_ = flash_bwd_dkv(qs_, ks_, vs_, do_, l_, de_, *ids, causal=causal)
                    want = attention_bwd_ref(qs_, ks_, vs_, do_, l_, attention_delta_ref(do_, o_),
                                             *ids, causal=causal)
                    tag = f"dh={dhs} causal={causal} gqa={hq // hkv} segs={ids[0] is not None}"
                    for gn, a_, b_ in zip(("dq", "dk", "dv"), (dq_, dk_, dv_), want):
                        check_l2(f"K8/K9 f32 {gn} {tag}", a_, b_, BWD_TOL["flash_f32"])
    k89_small_bf16(dev, randn)

    def k8(nm):
        o32, lse, do, _ = res[nm]
        return flash_bwd_dq(*cases[nm][:3], o32, do, lse, *cases[nm][3:])

    def k9(nm):
        _, lse, do, delta = res[nm]
        return flash_bwd_dkv(*cases[nm][:3], do, lse, delta, *cases[nm][3:])

    def plain(nm):
        o32, lse, do, delta = res[nm]
        return attention_bwd_ref(*cases[nm][:3], do, lse, delta, *cases[nm][3:])

    # self and cross apart: cross-attention's kv side is 512 rows, four
    # 128-row K9 items a head
    t8 = {nm: cuda_ms(lambda nm=nm: k8(nm), 5) for nm in cases}
    t9 = {nm: cuda_ms(lambda nm=nm: k9(nm), 5) for nm in cases}
    t_k8, t_k9 = sum(t8.values()), sum(t9.values())
    t_p = cuda_ms(lambda: [plain(nm) for nm in cases], 2)
    # yardstick only, never on the port's path: the library's attention
    # backward (dq, dk, dv together) with the segment mask built beforehand
    t_l = {}
    for nm, (qq, kk, vv, s1, s2) in cases.items():
        leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (qq, kk, vv)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=(s1[:, :, None] == s2[:, None, :])[:, None])
        gg = res[nm][2].transpose(1, 2)
        t_l[nm] = cuda_ms(lambda o=o, lv=leaves, gg=gg: torch.autograd.grad(o, lv, gg, retain_graph=True), 3)
        del o, leaves
    live = {"self": live_tile_pairs(s, s, seg, seg) * h,
            "cross": live_tile_pairs(s, TEXT_LEN, seg, tseg) * h}
    tiles = sum(live.values())
    # the work each kernel runs: its own tiles (K8 128 q x 64 kv, K9 64 q x
    # 128 kv), in 64 x 64 equivalents
    run = {w: 2 * h * (live_tile_pairs(s, s, seg, seg, q_tile=qt, kv_tile=kt)
                       + live_tile_pairs(s, TEXT_LEN, seg, tseg, q_tile=qt, kv_tile=kt))
           for w, (qt, kt) in BWD_TILES.items()}
    mm = 2 * BOUND_TILE ** 2 * dh  # flops of one 64 x 64 x dh product
    rows_q = 2 * b * s * h * dh * 2  # q and qx, bf16
    rows_kv = 2 * (b * s + b * TEXT_LEN) * h * dh * 2  # k, v and kx, vx
    stats = 2 * b * h * s * 4  # one [B, Hq, Sq] f32 per case
    by8 = 2 * rows_q + rows_kv + rows_q * 2 + 2 * stats + rows_q  # q do, k v, out32, lse delta, dq
    by9 = 2 * rows_q + rows_kv + 2 * stats + rows_kv  # q do, k v, lse delta, dk dv
    bms8, bby8 = bound(by8, tiles * 3 * mm, BF16_FLOPS)
    bms9, bby9 = bound(by9, tiles * 4 * mm, BF16_FLOPS)
    src = "src/repro_torch/kernels/flash_attention/csrc/flash_bwd_{}.cu"
    shape = f"self {s}x{s} + cross {s}x{TEXT_LEN}, B={b}, H={h}, dh={dh}, bf16"
    lm = k89_lm_row(dev, g)
    out["flash_bwd_dq"] = dict(
        route="cuda", source=src.format("dq"),
        replaces="src/repro/kernels/flash_attention/flash.py:279",
        max_abs_err=k8_err, ms=t_k8, plain_ms=t_p, bound_ms=bms8, bound_by=bby8,
        library_ms=sum(t_l.values()), shape=shape, live_tile_pairs=tiles, run_tile_pairs=run["dq"],
        self_ms=t8["self"], cross_ms=t8["cross"], live_by_part=live,
        library_by_part=t_l, tflops_per_s=tiles * 3 * mm / (t_k8 * 1e-3) / 1e12, lm=lm["dq"])
    out["flash_bwd_dkv"] = dict(
        route="cuda", source=src.format("dkv"),
        replaces="src/repro/kernels/flash_attention/flash.py:375",
        max_abs_err=k9_err, ms=t_k9, plain_ms=t_p, bound_ms=bms9, bound_by=bby9,
        library_ms=sum(t_l.values()), shape=shape, live_tile_pairs=tiles, run_tile_pairs=run["dkv"],
        self_ms=t9["self"], cross_ms=t9["cross"], live_by_part=live,
        library_by_part=t_l, tflops_per_s=tiles * 4 * mm / (t_k9 * 1e-3) / 1e12, lm=lm["dkv"])
    log(f"  K8 ms {t_k8:.4f} (self {t8['self']:.4f} + cross {t8['cross']:.4f})  K9 ms {t_k9:.4f} "
        f"(self {t9['self']:.4f} + cross {t9['cross']:.4f})  plain (dq, dk, dv) {t_p:.4f}  library "
        f"(SDPA backward, bool mask) {sum(t_l.values()):.4f} (self {t_l['self']:.4f} + cross "
        f"{t_l['cross']:.4f})  bound K8 {bms8:.4f} ({bby8}, {bms8 / t_k8:.1%}) K9 {bms9:.4f} "
        f"({bby9}, {bms9 / t_k9:.1%}); {tiles} live 64x64 tiles (self {live['self']}, cross "
        f"{live['cross']}); the kernels' tiles run K8 {run['dq']}, K9 {run['dkv']} of them")
    return out


def k89_lm_row(dev, g) -> dict:
    """K8 and K9 at phase 9 (b)'s attention: Llama-3.2-1B (Hq 32, Hkv 8, dh
    64), two packed 8192-token windows (lm_length_corpus documents and a -1
    tail each), causal, bf16, q, k and v views of the fused projection;
    against the plain backward (rel-L2 2e-2), timed beside SDPA's backward
    with the same causal segment mask; bounds and tile counts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention.flash import (
        BOUND_TILE, BWD_TILES, flash_bwd_dkv, flash_bwd_dq, flash_fwd, live_tile_pairs,
    )
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_delta_ref
    from repro_torch.launch.profile_train import packed_microbatches

    b, s = DENSE_WINDOWS, DENSE_WINDOW
    hq, hkv, dh = LLAMA_ATTN["hq"], LLAMA_ATTN["hkv"], LLAMA_ATTN["dh"]
    seg = torch.from_numpy(packed_microbatches(get_config("llama3.2-1b"), s, b, 1)[0]["segment_ids"])
    seg = seg.to(dev, torch.int32).contiguous()
    qkv = (torch.randn((b, s, (hq + 2 * hkv) * dh), generator=g, device=dev)).to(torch.bfloat16)
    q = qkv[..., : hq * dh].reshape(b, s, hq, dh)
    k = qkv[..., hq * dh : (hq + hkv) * dh].reshape(b, s, hkv, dh)
    v = qkv[..., (hq + hkv) * dh :].reshape(b, s, hkv, dh)
    do = torch.randn((b, s, hq, dh), generator=g, device=dev).to(torch.bfloat16)
    log(f"K8, K9 at the packed dense-LM shape: q [{b}, {s}, {hq}, {dh}], k, v Hkv {hkv}, causal, "
        f"bf16, packed windows with a -1 tail")
    ids = (seg, seg)
    o32, lse = flash_fwd(q, k, v, *ids, causal=True, out_dtype=torch.float32)
    dq, delta = flash_bwd_dq(q, k, v, o32, do, lse, *ids, causal=True)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *ids, causal=True)
    want = attention_bwd_ref(q, k, v, do, lse, attention_delta_ref(do, o32), *ids, causal=True)
    torch.cuda.synchronize()
    errs = [check_l2(f"K8/K9 LM {nm}", a_, b_, BWD_TOL["flash_bf16"])
            for nm, a_, b_ in zip(("dq", "dk", "dv"), (dq, dk, dv), want)]
    del dq, dk, dv, want
    t8 = cuda_ms(lambda: flash_bwd_dq(q, k, v, o32, do, lse, *ids, causal=True), 5)
    t9 = cuda_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, *ids, causal=True), 5)
    t_p = cuda_ms(lambda: attention_bwd_ref(q, k, v, do, lse, delta, *ids, causal=True), 1)
    # yardstick only, never on the port's path: the library's attention
    # backward, kv heads repeated, the causal segment mask built beforehand
    mask = (seg[:, :, None] == seg[:, None, :]) & torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    leaves = [t.detach().transpose(1, 2).repeat_interleave(hq // t.shape[2], dim=1).requires_grad_()
              for t in (q, k, v)]
    o_l = F.scaled_dot_product_attention(*leaves, attn_mask=mask[:, None])
    t_l = cuda_ms(lambda: torch.autograd.grad(o_l, leaves, do.transpose(1, 2), retain_graph=True), 3)
    del o_l, leaves, mask
    tiles = live_tile_pairs(s, s, *ids, causal=True) * hq
    mm = 2 * BOUND_TILE ** 2 * dh
    rows_q, rows_kv, stats = q.numel() * 2, k.numel() * 2, b * hq * s * 4
    by8 = 2 * rows_q + 2 * rows_kv + rows_q * 2 + 2 * stats + rows_q  # q do, k v, out32, lse delta, dq
    by9 = 2 * rows_q + 2 * rows_kv + 2 * stats + 2 * rows_kv  # q do, k v, lse delta, dk dv
    shape = f"q [{b}, {s}, {hq}, {dh}], Hkv {hkv}, causal, packed windows, bf16"
    row = {}
    for w, t_k, n_mm, by in (("dq", t8, 3, by8), ("dkv", t9, 4, by9)):
        qt, kt = BWD_TILES[w]
        bms, bby = bound(by, tiles * n_mm * mm, BF16_FLOPS)
        run = live_tile_pairs(s, s, *ids, causal=True, q_tile=qt, kv_tile=kt) * hq * qt * kt // BOUND_TILE ** 2
        row[w] = dict(ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=bby, library_ms=t_l,
                      max_abs_err=max(errs), shape=shape, live_tile_pairs=tiles, run_tile_pairs=run,
                      tflops_per_s=tiles * n_mm * mm / (t_k * 1e-3) / 1e12)
        log(f"  K{8 if w == 'dq' else 9} LM ms {t_k:.4f}  bound {bms:.4f} ({bby}, {bms / t_k:.1%})  "
            f"{tiles} live 64x64 tiles, its tiles run {run}")
    log(f"  plain (dq, dk, dv) {t_p:.4f}  library (SDPA backward, causal segment mask, kv heads "
        f"repeated) {t_l:.4f}")
    return row


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
    for name, n in counts.items():
        if n != waves * per_wave.get(name, 0):
            raise AssertionError(f"{name}: {n} launches, expected {waves} x "
                                 f"{per_wave.get(name, 0)}")
    return dict(waves=waves, wave_ms=wave_ms, wall_s=wall, launches=counts,
                per_wave=per_wave, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                n_params=n_params)


def per_microbatch(n_layers: int) -> dict[str, int]:
    """Launches of one training microbatch of n_layers blocks with per-block
    recompute: each block's forward kernels run twice (forward, then again
    in the backward), the final AdaLN once; each backward kernel once per
    call of its forward (self + cross attention, both AdaLNs)."""
    L = n_layers
    return {"adaln_fwd": 4 * L + 1, "adaln_bwd_dx": 2 * L + 1, "adaln_bwd_dmod": 2 * L + 1,
            "qk_rms_fwd": 2 * L, "qk_rms_bwd_dx": L, "qk_rms_bwd_dw": L,
            "flash_fwd": 4 * L, "flash_bwd_dq": 2 * L, "flash_bwd_dkv": 2 * L}


def check_counts(counts: dict, micro: int, n_layers: int, what: str, per=per_microbatch) -> None:
    table = per(n_layers)
    for name in counts:
        if counts[name] != micro * table.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {counts[name]} times, "
                                 f"expected {micro} microbatches x {table.get(name, 0)}")
    log(f"  {what}: every launch count is {micro} microbatches x the per-microbatch table")


WAN_TRAIN_LAYERS = 10  # phase 5 (b): a third of the depth keeps the script's time


def phase_train(K, dev) -> dict:
    """Phase 5: training on the card."""
    from repro_torch.configs.registry import get_config, get_optimizer
    from repro_torch.core.bucketing import BucketingPolicy
    from repro_torch.data.pipeline import BucketedLoader
    from repro_torch.data.synthetic import make_diffusion_batch, wan_mixed_corpus
    from repro_torch.launch import train as launch_train
    from repro_torch.models.mmdit import MMDiT, rectified_flow_loss
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import init_state

    out = {}
    cfg = get_config("wan2.1-1.3b")

    # (a) the launcher's entry point, as a user runs it
    log("(a) python -m repro_torch.launch.train --arch wan2.1-1.3b --adaptive --steps 2")
    K.reset_launch_counts()
    hist = launch_train.main(["--arch", "wan2.1-1.3b", "--adaptive", "--steps", "2"])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    if not np.isfinite(hist.losses).all():
        raise AssertionError(f"launcher: a loss is not finite: {hist.losses}")
    check_counts(counts, sum(hist.microbatches), cfg.n_layers, "launcher")
    out["launcher"] = dict(losses=hist.losses, step_s=hist.step_times,
                           microbatches=hist.microbatches, launches=counts)
    del hist
    torch.cuda.empty_cache()

    # (b) Wan-2.1 1.3B at full width and WAN_TRAIN_LAYERS of its 30 layers,
    # 4 steps over the 480p buckets
    cfg = dataclasses.replace(cfg, n_layers=WAN_TRAIN_LAYERS)
    shapes, weights = wan_mixed_corpus()
    sel = [0, 2, 3]  # 480p image, 17 and 33 frames: S = 1637, 4757, 7877
    policy = BucketingPolicy(m_mem=16384, m_comp=6.4e7, p=2.0)
    buckets = policy.make_buckets([shapes[i] for i in sel])
    if [(b.seq_len, b.batch_size) for b in buckets] != [(1637, 10), (4757, 2), (7877, 1)]:
        raise AssertionError(f"unexpected buckets {buckets}")
    opt = OptimizerConfig(peak_lr=get_optimizer("wan2.1-1.3b").peak_lr, schedule="constant",
                          warmup=0, total_steps=4)
    log(f"(b) Trainer on EmulatedEngine, {cfg.name} {cfg.n_layers} of 30 layers bf16, seed 0; "
        f"buckets (S, B) {[(b.seq_len, b.batch_size) for b in buckets]}, 16384-token steps")
    state = init_state(cfg, opt, seed=0, device=dev)

    def make_batch(rng, bucket):
        return make_diffusion_batch(int(rng.integers(2**31)), bucket.batch_size,
                                    bucket.seq_len, cfg, dev)

    loader = BucketedLoader(buckets, [weights[i] for i in sel], make_batch, budget=16384.0,
                            budget_of=lambda b: float(b.tokens), seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    try:
        state, hist = Trainer(cfg, opt).run(state, iter(loader), 4, rng=1, log_every=1)
    finally:
        loader.close()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not np.isfinite(hist.losses).all():
        raise AssertionError(f"a loss is not finite: {hist.losses}")
    bad = [n for n, prm in state["model"].named_parameters() if not torch.isfinite(prm).all()]
    if bad or state["step"] != 4:
        raise AssertionError(f"parameters not finite after the updates: {bad[:5]}")
    check_counts(counts, sum(hist.microbatches), cfg.n_layers, "training")
    steady = [i for i in range(4) if i not in hist.compile_steps]
    if not steady:
        raise AssertionError("every step ran a new batch signature: no steady step")
    step_ms = [1e3 * t for t in hist.step_times]
    steady_ms = float(np.mean([step_ms[i] for i in steady]))
    for i, (ms, tok, n) in enumerate(zip(step_ms, hist.tokens, hist.microbatches)):
        log(f"  step {i}: {n} microbatches, {tok} tokens, {ms:.1f} ms, loss {hist.losses[i]:.4f}"
            f"{'  (first signature)' if i in hist.compile_steps else ''}")
    log(f"  steady step {steady_ms:.1f} ms (steps {steady}), {hist.throughput:,.0f} tokens/s, "
        f"peak memory {peak:.2f} GiB, events {hist.events}")
    out["train"] = dict(
        losses=hist.losses, step_ms=step_ms, tokens=hist.tokens,
        microbatches=hist.microbatches, events=hist.events, steady_steps=steady,
        steady_step_ms=steady_ms, tokens_per_s=hist.throughput, peak_gib=peak,
        launches=counts, per_microbatch=per_microbatch(cfg.n_layers),
        microbatch_s=[dataclasses.asdict(r) for r in hist.records],
    )
    del state, hist, loader
    torch.cuda.empty_cache()

    # (c) 2 layers at full width: kernel loss and gradients against the plain
    # versions' on one batch with injected draws and packed segment ids
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    g = torch.Generator(device=dev).manual_seed(4)
    b, s = 2, 2 * S_FRAME
    x0 = torch.randn((b, s, cfg2.in_channels * 4), generator=g, device=dev).bfloat16()
    txt = torch.randn((b, TEXT_LEN, 4096), generator=g, device=dev).bfloat16()
    t = torch.tensor([0.3, 0.8], device=dev)
    eps = torch.randn(x0.shape, generator=g, device=dev)
    seg = segs([[(0, S_FRAME), (1, S_FRAME // 2), (-1, S_FRAME // 2)], [(0, s)]], dev)
    tseg = segs([[(0, TEXT_LEN // 2), (1, TEXT_LEN // 2)], [(0, TEXT_LEN - 12), (-1, 12)]], dev)
    model = MMDiT(cfg2, seed=1, device=dev)
    res = {}
    for ops in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        loss = rectified_flow_loss(model, x0, txt, t=t, eps=eps, segment_ids=seg,
                                   text_segment_ids=tseg, ops=ops)
        loss.backward()
        res[ops] = (loss.item(), {n: prm.grad.clone() for n, prm in model.named_parameters()})
    loss_rel = abs(res["kernel"][0] - res["plain"][0]) / abs(res["plain"][0])
    rels = {n: rel_l2(res["kernel"][1][n], gp) for n, gp in res["plain"][1].items()}
    worst = max(rels, key=rels.get)
    log(f"(c) 2 layers, full width, bf16: loss {res['kernel'][0]:.6f} kernel vs "
        f"{res['plain'][0]:.6f} plain (rel {loss_rel:.2e}, tol 1e-2); largest gradient "
        f"rel-L2 {rels[worst]:.3e} ({worst}, tol 5e-2)")
    if not (loss_rel <= 1e-2 and rels[worst] <= 5e-2):
        raise AssertionError("kernel training gradients disagree with the plain versions'")
    out["grad_check"] = dict(loss_kernel=res["kernel"][0], loss_plain=res["plain"][0],
                             loss_rel=loss_rel, worst_grad=worst, worst_grad_rel_l2=rels[worst])
    return out


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

# -- the LM serving slice ------------------------------------------------------

LM_PAGE = 16  # tokens per page of the LM's paged KV pool
LM_MAX_SEQ = 4096


def phase_kernels_lm(dev) -> dict:
    """Phase 2, LM serving: K4 on model rows and K12 against their plain
    versions at the LM's shapes and small f32 shapes; times."""
    from repro_torch.kernels.flash_attention.paged import paged_decode
    from repro_torch.kernels.flash_attention.ref import paged_attention_ref
    from repro_torch.kernels.fused_rmsnorm.ref import rms_norm_ref
    from repro_torch.kernels.fused_rmsnorm.rmsnorm import rms_fwd

    g = torch.Generator(device=dev).manual_seed(6)
    rng = np.random.default_rng(6)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    out = {}
    d = 2048
    # -- K4 on model rows ----------------------------------------------------
    log("K4 rms_fwd (rows)  x [1, 2048, 2048] (a 2048-token prefill) and [8, 1, 2048] "
        "(a decode wave) bf16, w [2048] f32")
    w = randn(d, scale=0.1, shift=1.0)
    xs = {"prefill": randn(1, 2048, d, dtype=torch.bfloat16, scale=2.0, shift=0.3),
          "decode": randn(8, 1, d, dtype=torch.bfloat16, scale=2.0, shift=0.3)}
    k4_err = 0.0
    for nm, x in xs.items():
        (y, r), (yr, rr) = rms_fwd(x, w), rms_norm_ref(x, w)
        torch.cuda.synchronize()
        err = max_err(y, yr)
        k4_err = max(k4_err, err)
        check(f"K4 rows y {nm}", err, TOL["norm_bf16"])
        check(f"K4 rows rstd {nm}", max_err(r, rr), TOL["stat"])
    for shape in [(3, 5, 256), (2, 7, 8192), (4, 24), (9, 8), (2, 3, 2056)]:
        xf, wf = randn(*shape, scale=2.0, shift=0.3), randn(shape[-1], scale=0.1, shift=1.0)
        for nm, a_, b_ in zip(("y", "rstd"), rms_fwd(xf, wf), rms_norm_ref(xf, wf)):
            check(f"K4 rows {nm} f32 {list(shape)}", max_err(a_, b_), TOL["norm_f32"])
    times = {}
    for nm, x in xs.items():
        wl = w.to(x.dtype)
        times[nm] = dict(
            ms=device_ms(lambda: rms_fwd(x, w), 50),
            plain_ms=device_ms(lambda: rms_norm_ref(x, w), 10),
            # yardstick only, never on the port's path: the library norm
            library_ms=device_ms(lambda: F.rms_norm(x, (d,), wl, 1e-6), 50),
            bound=bound(2 * x.numel() * 2 + x.numel() // d * 4 + d * 4, 4 * x.numel(), F32_FLOPS),
        )
    t = times["prefill"]
    out["rms_fwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/fused_rmsnorm/csrc/rmsnorm_fwd.cu",
        replaces="src/repro/kernels/fused_rmsnorm/rmsnorm.py:38",
        max_abs_err=k4_err, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
        bound_by=t["bound"][1], library_ms=t["library_ms"],
        shape="x [1, 2048, 2048] bf16 (prefill)",
        decode=dict(shape="x [8, 1, 2048] bf16", ms=times["decode"]["ms"],
                    plain_ms=times["decode"]["plain_ms"], library_ms=times["decode"]["library_ms"],
                    bound_ms=times["decode"]["bound"][0]),
    )
    for nm, t in times.items():
        log(f"  K4 rows {nm}: ms {t['ms']:.4f}  plain {t['plain_ms']:.4f}  library(F.rms_norm) "
            f"{t['library_ms']:.4f}  bound {t['bound'][0]:.4f} ({t['bound'][1]})")
    # the host's side of a launch: wall time per call of the wrapper and of
    # the library call, enqueue only (one synchronisation after 200 calls)
    x, wl = xs["decode"], w.to(torch.bfloat16)
    host_us = {"rms_fwd": enqueue_us(lambda: rms_fwd(x, w)),
               "F.rms_norm": enqueue_us(lambda: F.rms_norm(x, (d,), wl, 1e-6))}
    log(f"  host time per call at [8, 1, 2048]: rms_fwd {host_us['rms_fwd']:.1f} us, "
        f"F.rms_norm {host_us['F.rms_norm']:.1f} us")
    out["rms_fwd"]["host_us_per_call"] = host_us

    # -- K7 at the LM's prefill: causal, GQA 4, dh 64 ------------------------------
    from repro_torch.kernels.flash_attention.flash import BOUND_TILE, FWD_TILE, flash_fwd, live_tile_pairs
    from repro_torch.kernels.flash_attention.ref import attention_ref

    log("K7 flash_fwd at the LM prefill  q [1, 2048, 32, 64], k, v [1, 2048, 8, 64] bf16 "
        "(views of qkv [1, 2048, 3072]), causal")
    qkv = randn(1, 2048, 48 * 64, dtype=torch.bfloat16)
    q = qkv[..., : 32 * 64].reshape(1, 2048, 32, 64)
    k = qkv[..., 32 * 64 : 40 * 64].reshape(1, 2048, 8, 64)
    v = qkv[..., 40 * 64 :].reshape(1, 2048, 8, 64)
    (o, lse), (o_r, lse_r) = flash_fwd(q, k, v, causal=True), attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    k7_err = max_err(o, o_r)
    check("K7 LM prefill out", k7_err, TOL["attn_bf16"])
    check("K7 LM prefill lse", max_err(lse, lse_r), TOL["lse_bf16"])
    tiles = live_tile_pairs(2048, 2048, causal=True) * 32
    run = live_tile_pairs(2048, 2048, causal=True, tile=FWD_TILE) * 32 * 4
    flops = tiles * 4 * BOUND_TILE ** 2 * 64
    t_k = device_ms(lambda: flash_fwd(q, k, v, causal=True), 20)
    t_p = device_ms(lambda: attention_ref(q, k, v, causal=True), 3)
    # yardstick only, never on the port's path: the library's causal GQA attention
    t_l = device_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
        enable_gqa=True), 20)
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + 32 * 2048 * 4
    bms, bby = bound(nbytes, flops, BF16_FLOPS)
    out["flash_fwd_lm_prefill"] = dict(max_abs_err=k7_err, ms=t_k, plain_ms=t_p, library_ms=t_l,
                                       bound_ms=bms, bound_by=bby, live_tile_pairs=tiles,
                                       run_tile_pairs=run,
                                       tflops_per_s=flops / (t_k * 1e-3) / 1e12)
    log(f"  K7 LM prefill ms {t_k:.4f}  plain {t_p:.4f}  library(SDPA causal, GQA) {t_l:.4f}  "
        f"bound {bms:.4f} ({bby}, {tiles} live 64x64 tiles; the kernel's 128x128 tiles run "
        f"{run} of them)")
    del qkv, q, k, v, o, o_r

    out["paged_decode"] = phase_paged(dev, g, rng)
    return out


def check_slots(name: str, got, want, tol: float) -> float:
    """rel-L2 of each live slot b of [B, ...] outputs (want[b] not all
    zero) <= tol; returns the worst.  A fault confined to a long context
    (a chunk or a warp's tokens dropped, a chunk weighed wrong) moves that
    slot's small outputs far more than the absolute gate sees."""
    d = (got.float() - want.float()).flatten(1).norm(dim=1)
    ref = want.float().flatten(1).norm(dim=1)
    live = ref > 0
    worst = float((d[live] / ref[live]).max()) if bool(live.any()) else 0.0
    log(f"  {name:<28} worst slot rel-L2 {worst:.3e}  tol {tol:.1e}")
    if not worst <= tol:
        raise AssertionError(f"{name}: a slot's rel-L2 {worst} above tolerance {tol}")
    return worst


def phase_paged(dev, g, rng) -> dict:
    """Phase 2, K12 against its plain version at the LM decode wave and two
    more bf16 cases (``time_paged.CASES``) and small f32 shapes; inactive
    slots exact zeros, a second run bitwise equal; times, bound and the
    host's time a call."""
    from repro_torch.kernels.flash_attention.paged import paged_decode
    from repro_torch.kernels.flash_attention.ref import paged_attention_ref
    from repro_torch.launch.time_paged import CASES, case_lens, paged_case, paged_work

    lens_of = case_lens(rng)
    wave_lens = lens_of["wave"]
    # unowned pages besides the scratch page: the wave's pool holds 4097
    # pages, as the LM engine's
    spare = {"wave": LM_MAX_SEQ - sum(-(-n // LM_PAGE) for n in wave_lens), "heavy": 64,
             "dh128": 8}
    log("K12 paged_decode  bf16: wave (8 slots, Hq 32, Hkv 8, dh 64, pages of 16, pool of 4097 "
        "pages), heavy (64 slots, kv_lens up to 4096), dh128 (16 slots, Hq 40, Hkv 8, pages "
        "of 32); shuffled tables, inactive slots, ragged last pages, scratch past each allocation")
    k12_err, args_of = 0.0, {}
    for nm, (hq, hkv, dh, ps, pmax) in CASES.items():
        q, kp, vp, tables, kv_lens = paged_case(dev, g, rng, lens_of[nm], hq, hkv, dh, ps,
                                                torch.bfloat16, pages_max=pmax, spare=spare[nm])
        args = (q, kp, vp, tables[0], kv_lens)
        o, o_r = paged_decode(*args), paged_attention_ref(*args)
        torch.cuda.synchronize()
        err = max_err(o, o_r)
        k12_err = max(k12_err, err)
        check(f"K12 {nm} out (pool {list(kp.shape)})", err, TOL["attn_bf16"])
        check_slots(f"K12 {nm} out", o, o_r, TOL["attn_bf16_slot"])
        dead = kv_lens == 0
        if torch.count_nonzero(o[dead]) != 0:
            raise AssertionError(f"K12 {nm}: an inactive slot is not exact zeros")
        # the chunks' merge reads its partials in a fixed order, whichever
        # block arrives last
        if not torch.equal(o, paged_decode(*args)):
            raise AssertionError(f"K12 {nm} is not bitwise deterministic")
        log(f"  K12 {nm}: a second run is bitwise equal")
        args_of[nm] = args
    for lens, hq, hkv, dh, ps in [((11, 0, 40), 8, 2, 64, 8), ((130, 64), 5, 1, 128, 64),
                                  ((1, 16, 17, 0), 4, 4, 64, 16), ((300, 7), 8, 8, 128, 24)]:
        q, kp, vp, tables, kv_lens = paged_case(dev, g, rng, list(lens), hq, hkv, dh, ps,
                                                torch.float32)
        args = (q, kp, vp, tables[0], kv_lens)
        check(f"K12 f32 lens={lens} g={hq // hkv} dh={dh} ps={ps}",
              max_err(paged_decode(*args), paged_attention_ref(*args)), TOL["attn_f32"])
    times = {}
    for nm, args in args_of.items():
        nbytes, flops = paged_work(*args)
        times[nm] = dict(ms=device_ms(lambda: paged_decode(*args), 50),
                         plain_ms=device_ms(lambda: paged_attention_ref(*args), 3),
                         bound=bound(nbytes, flops, F32_FLOPS), bytes=nbytes)
        t = times[nm]
        log(f"  K12 {nm}: ms {t['ms']:.4f}  plain {t['plain_ms']:.4f}  bound {t['bound'][0]:.4f} "
            f"({t['bound'][1]}, {nbytes / 1e6:.2f} MB live)  {nbytes / (t['ms'] * 1e-3) / 1e9:.0f} GB/s")
    wave = args_of["wave"]
    host_us = enqueue_us(lambda: paged_decode(*wave))
    log(f"  host time per call of paged_decode at the wave: {host_us:.1f} us")
    t = times["wave"]
    return dict(
        route="cuda", source="src/repro_torch/kernels/flash_attention/csrc/paged_decode.cu",
        replaces="src/repro/kernels/flash_attention/paged.py:102",
        max_abs_err=k12_err, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
        bound_by=t["bound"][1], library_ms=None,
        shape=f"q [8, 32, 64], pools [4097, 16, 8, 64] bf16, kv_lens {wave_lens}",
        cases={nm: dict(ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
                        bytes=t["bytes"]) for nm, t in times.items()},
        host_us_per_call=host_us,
    )


# -- the Mamba-2 training slice ------------------------------------------------

SSM_ROWS = 4 * 2048  # rows of one B 4 x S 2048 microbatch
SSM_D, SSM_DI = 2560, 5120  # d_model and d_inner of mamba2-2.7b
SSM_PROJ = 2 * SSM_DI + 2 * 128 + 80  # width of its in_proj output (z, xBC, dt)


def phase_kernels_ssm(dev) -> dict:
    """Phase 2, Mamba-2 training: K13, K4, K5 and K6 on model rows against
    their plain versions at the path's shapes and small f32 shapes, K6 bitwise
    against a second run, the gated backward through the autograd wiring;
    K10 against its plain version and K3, and K10 and K3 timed back to back
    at K3's shape and at the paper's width (D 5120, B 1, S 8192-32768)."""
    from repro_torch.kernels.fused_adaln.adaln import adaln_bwd_dmod, adaln_bwd_dmod_naive, adaln_fwd
    from repro_torch.kernels.fused_adaln.ref import adaln_bwd_dmod_ref
    from repro_torch.kernels.fused_rmsnorm.ops import gated_rms_norm
    from repro_torch.kernels.fused_rmsnorm.ref import (
        gated_rms_bwd_ref, gated_rms_norm_ref, rms_bwd_ref, rms_norm_ref,
    )
    from repro_torch.kernels.fused_rmsnorm.rmsnorm import (
        gated_rms_fwd, rms_bwd_dw, rms_bwd_dx, rms_fwd,
    )

    g = torch.Generator(device=dev).manual_seed(9)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    out = {}
    n, di = SSM_ROWS, SSM_DI

    # -- K13 gated RMSNorm forward ------------------------------------------------
    log(f"K13 gated_rms_fwd  x [{n}, {di}] bf16, g the z slice of an in_proj output "
        f"[{n}, {SSM_PROJ}] bf16, w [{di}] f32")
    x = randn(n, di, dtype=torch.bfloat16)
    zx = randn(n, SSM_PROJ, dtype=torch.bfloat16)
    gz = zx[:, :di]
    w = randn(di, scale=0.1, shift=1.0)
    (y, r), (yr, rr) = gated_rms_fwd(x, w, gz), gated_rms_norm_ref(x, w, gz)
    torch.cuda.synchronize()
    # y is rounded once to bf16 from f32 values that agree to a few ulps
    k13_err = check_rel("K13 y (bf16)", y, yr, BWD_TOL["grad_bf16"])
    check("K13 rstd", max_err(r, rr), TOL["stat"])
    for shape in [(3, 5, 256), (2, 7, 8192), (9, 8), (2, 3, 2056)]:
        wide = randn(*shape[:-1], 3 * shape[-1], scale=1.5)
        xf, gf = wide[..., : shape[-1]], wide[..., shape[-1] : 2 * shape[-1]]
        wf = randn(shape[-1], scale=0.1, shift=1.0)
        for nm, a_, b_ in zip(("y", "rstd"), gated_rms_fwd(xf, wf, gf), gated_rms_norm_ref(xf, wf, gf)):
            check(f"K13 {nm} f32 {list(shape)} (strided x, g)", max_err(a_, b_), TOL["norm_f32"])
    t_k = cuda_ms(lambda: gated_rms_fwd(x, w, gz), 20)
    t_p = cuda_ms(lambda: gated_rms_norm_ref(x, w, gz), 5)
    bms, bby = bound(3 * n * di * 2 + n * 4 + di * 4, 10 * n * di, F32_FLOPS)
    out["gated_rms_fwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/fused_rmsnorm/csrc/rmsnorm_fwd.cu",
        replaces="src/repro/kernels/fused_rmsnorm/rmsnorm.py:73",
        max_abs_err=k13_err, ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=bby, library_ms=None,
        shape=f"x, g [{n}, {di}] bf16 (g strided)",
    )
    log(f"  K13 ms {t_k:.4f}  plain {t_p:.4f}  bound {bms:.4f} ({bby})")

    # -- the gated backward through its autograd wiring ------------------------------
    log(f"K13 + K5/K6 rows: the gated norm's backward at [{n}, {di}] bf16 (dy_eff rounded "
        f"to bf16 on the card, not in the plain version)")
    dy = randn(n, di, dtype=torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in (x, w, gz)]
    got = torch.autograd.grad(gated_rms_norm(*leaves), leaves, dy)
    want = gated_rms_bwd_ref(dy, x, w, gz, r)
    for nm, a_, b_ in zip(("dx", "dw", "dg"), got, want):
        check_rel(f"gated backward {nm}", a_, b_, BWD_TOL["grad_bf16"])
    del leaves, got, want, zx, gz

    # -- K4 on model rows at the path's width, then K5, K6 on model rows ------------
    k5_err = k6_err = 0.0
    times = {}
    for d_ in (SSM_D, SSM_DI):
        xs = randn(n, d_, dtype=torch.bfloat16, scale=2.0, shift=0.3)
        ws = randn(d_, scale=0.1, shift=1.0)
        yr, rs = rms_norm_ref(xs, ws)
        if d_ == SSM_D:
            # at d 2560 a thread of K4 holds one or two 16-byte vectors
            log(f"K4 rms_fwd (rows)  x [{n}, {d_}] bf16, w [{d_}] f32 (norm1, final_norm)")
            y, r = rms_fwd(xs, ws)
            torch.cuda.synchronize()
            k4_err = max_err(y, yr)
            check(f"K4 rows y [{n}, {d_}]", k4_err, TOL["norm_bf16"])
            check(f"K4 rows rstd [{n}, {d_}]", max_err(r, rs), TOL["stat"])
            wl = ws.bfloat16()
            b4 = bound(2 * xs.numel() * 2 + n * 4 + d_ * 4, 4 * xs.numel(), F32_FLOPS)
            out["rms_fwd_mamba2"] = dict(
                shape=f"x [{n}, {d_}] bf16 (norm1, final_norm)", max_abs_err=k4_err,
                ms=cuda_ms(lambda: rms_fwd(xs, ws), 20),
                plain_ms=cuda_ms(lambda: rms_norm_ref(xs, ws), 5),
                # yardstick only, never on the port's path: the library norm
                library_ms=cuda_ms(lambda: F.rms_norm(xs, (d_,), wl, 1e-6), 20),
                bound_ms=b4[0], bound_by=b4[1],
            )
            t = out["rms_fwd_mamba2"]
            log(f"  K4 rows ms {t['ms']:.4f}  plain {t['plain_ms']:.4f}  library(F.rms_norm) "
                f"{t['library_ms']:.4f}  bound {b4[0]:.4f} ({b4[1]})")
            del y, r
        log(f"K5 rms_bwd_dx, K6 rms_bwd_dw (rows)  dy, x [{n}, {d_}] bf16, w [{d_}] f32, "
            f"rstd of the plain forward")
        dys = randn(n, d_, dtype=torch.bfloat16)
        dxr, dwr = rms_bwd_ref(dys, xs, ws, rs)
        k5_err = max(k5_err, check_rel(f"K5 rows dx [{n}, {d_}]", rms_bwd_dx(dys, xs, ws, rs), dxr,
                                       BWD_TOL["grad_bf16"]))
        dw = rms_bwd_dw(dys, xs, rs)
        k6_err = max(k6_err, check_rel(f"K6 rows dw [{n}, {d_}]", dw, dwr, BWD_TOL["sum_f32"]))
        if not torch.equal(dw, rms_bwd_dw(dys, xs, rs)):
            raise AssertionError("K6 on rows is not bitwise deterministic")
        log("  K6 rows: a second run is bitwise equal")
        nb = n * d_
        wl = ws.bfloat16()
        # yardstick only, never on the port's path: the library norm's
        # backward, for the input (K5) and for the weight (K6)
        leaves = [xs.detach().requires_grad_(), wl.detach().requires_grad_()]
        yl = F.rms_norm(leaves[0], (d_,), leaves[1], 1e-6)
        times[d_] = dict(
            k5=cuda_ms(lambda: rms_bwd_dx(dys, xs, ws, rs), 20),
            k6=cuda_ms(lambda: rms_bwd_dw(dys, xs, rs), 20),
            plain=cuda_ms(lambda: rms_bwd_ref(dys, xs, ws, rs), 5),
            lib5=cuda_ms(lambda: torch.autograd.grad(yl, leaves[:1], dys, retain_graph=True), 10),
            lib6=cuda_ms(lambda: torch.autograd.grad(yl, leaves[1:], dys, retain_graph=True), 10),
            bound5=bound(3 * nb * 2 + n * 4 + d_ * 4, 6 * nb, F32_FLOPS),
            bound6=bound(2 * nb * 2 + n * 4 + d_ * 4, 3 * nb, F32_FLOPS),
        )
        t = times[d_]
        log(f"  K5 rows ms {t['k5']:.4f}  K6 rows ms {t['k6']:.4f}  plain (dx and dw) "
            f"{t['plain']:.4f}  library (F.rms_norm backward) dx {t['lib5']:.4f} dw "
            f"{t['lib6']:.4f}  bound K5 {t['bound5'][0]:.4f} K6 {t['bound6'][0]:.4f} (bytes)")
        del xs, yr, dys, leaves, yl
    for shape in [(3, 5, 256), (2, 7, 8192), (9, 8), (2, 3, 2056), (70, 5120)]:
        xf, wf = randn(*shape, scale=2.0, shift=0.3), randn(shape[-1], scale=0.1, shift=1.0)
        rf, dyf = rms_norm_ref(xf, wf)[1], randn(*shape)
        dxr, dwr = rms_bwd_ref(dyf, xf, wf, rf)
        check_rel(f"K5 rows dx f32 {list(shape)}", rms_bwd_dx(dyf, xf, wf, rf), dxr, BWD_TOL["sum_f32"])
        check_rel(f"K6 rows dw f32 {list(shape)}", rms_bwd_dw(dyf, xf, rf), dwr, BWD_TOL["sum_f32"])
    src = "src/repro_torch/kernels/fused_rmsnorm/csrc/rmsnorm_bwd.cu"
    for name, key, err, line in (("rms_bwd_dx", "5", k5_err, 111), ("rms_bwd_dw", "6", k6_err, 144)):
        t, t2 = times[SSM_D], times[SSM_DI]
        out[name] = dict(
            route="cuda", source=src, replaces=f"src/repro/kernels/fused_rmsnorm/rmsnorm.py:{line}",
            max_abs_err=err, ms=t["k" + key], plain_ms=t["plain"], bound_ms=t["bound" + key][0],
            bound_by=t["bound" + key][1], library_ms=t["lib" + key],
            shape=f"dy, x [{n}, {SSM_D}] bf16 (norm1, final_norm)",
            gated=dict(shape=f"dy_eff, x [{n}, {SSM_DI}] bf16", ms=t2["k" + key],
                       plain_ms=t2["plain"], library_ms=t2["lib" + key],
                       bound_ms=t2["bound" + key][0]),
        )

    # -- K10 naive-access AdaLN d scale / d shift -------------------------------------
    def adaln_case(b, s, d_, dtype):
        xa = randn(b, s, d_, dtype=dtype, scale=2.0, shift=0.3)
        mod = randn(b, 6, d_, scale=0.1)
        _, mu, rstd = adaln_fwd(xa, mod[:, 1], mod[:, 0])
        return randn(b, s, d_, dtype=dtype), xa, mu, rstd

    b, s, d = 10, 1637, 1536
    log(f"K10 adaln_bwd_dmod_naive  dy, x [{b}, {s}, {d}] bf16 (K3's shape), against the "
        f"plain version and K3")
    args = adaln_case(b, s, d, torch.bfloat16)
    got = adaln_bwd_dmod_naive(*args)
    if not all(torch.equal(a_, b_) for a_, b_ in zip(got, adaln_bwd_dmod_naive(*args))):
        raise AssertionError("K10 is not bitwise deterministic")
    log("  K10: a second run is bitwise equal")
    k10_err = 0.0
    for nm, a_, b_, c_ in zip(("dscale", "dshift"), got, adaln_bwd_dmod_ref(*args),
                              adaln_bwd_dmod(*args)):
        k10_err = max(k10_err, check_rel(f"K10 {nm}", a_, b_, BWD_TOL["sum_f32"]))
        check_rel(f"K10 {nm} against K3", a_, c_, BWD_TOL["sum_f32"])
    for shape in [(2, 100, 256), (3, 37, 1536), (1, 300, 4096)]:
        argf = adaln_case(*shape, torch.float32)
        for nm, a_, b_ in zip(("dscale", "dshift"), adaln_bwd_dmod_naive(*argf),
                              adaln_bwd_dmod_ref(*argf)):
            check_rel(f"K10 {nm} f32 {list(shape)}", a_, b_, BWD_TOL["sum_f32"])
    t_k = device_ms(lambda: adaln_bwd_dmod_naive(*args), 20)
    t_3 = cuda_ms(lambda: adaln_bwd_dmod(*args), 20)
    t_p = cuda_ms(lambda: adaln_bwd_dmod_ref(*args), 5)
    nb = b * s * d
    bms, bby = bound(2 * nb * 2 + 2 * b * s * 4 + 2 * b * d * 4, 4 * nb, F32_FLOPS)
    # one block a sample: the naive access's rate is one SM's
    fig1 = [dict(shape=[b, s, d], naive_ms=t_k, k3_ms=t_3, bound_ms=bms,
                 gb_s_per_sm=2 * nb * 2 / b / (t_k * 1e-3) / 1e9)]
    log(f"  K10 ms {t_k:.4f} ({fig1[0]['gb_s_per_sm']:.1f} GB/s an SM)  K3 ms {t_3:.4f}  "
        f"plain {t_p:.4f}  bound {bms:.4f} ({bby})")
    del args
    for s_ in (8192, 16384, 32768):  # the paper's Fig. 1 width, Wan-14B's D 5120
        argw = adaln_case(1, s_, 5120, torch.bfloat16)
        nb_ = s_ * 5120
        t3a = cuda_ms(lambda: adaln_bwd_dmod(*argw), 5)
        tna = cuda_ms(lambda: adaln_bwd_dmod_naive(*argw), 2)
        tnb = cuda_ms(lambda: adaln_bwd_dmod_naive(*argw), 2)
        t3b = cuda_ms(lambda: adaln_bwd_dmod(*argw), 5)
        bw = bound(2 * nb_ * 2 + 2 * s_ * 4 + 2 * 5120 * 4, 4 * nb_, F32_FLOPS)[0]
        fig1.append(dict(shape=[1, s_, 5120], naive_ms=[tna, tnb], k3_ms=[t3a, t3b], bound_ms=bw,
                         gb_s_per_sm=2 * nb_ * 2 / (min(tna, tnb) * 1e-3) / 1e9))
        log(f"  Fig. 1 [1, {s_}, 5120]: K3 {t3a:.4f}, {t3b:.4f} ms; K10 {tna:.4f}, {tnb:.4f} ms "
            f"({fig1[-1]['gb_s_per_sm']:.1f} GB/s an SM); bound {bw:.4f} ms")
        del argw
    out["adaln_bwd_dmod_naive"] = dict(
        route="cuda", source="src/repro_torch/kernels/fused_adaln/csrc/adaln_bwd.cu",
        replaces="src/repro/kernels/fused_adaln/adaln.py:189",
        max_abs_err=k10_err, ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=bby, library_ms=None,
        shape=f"dy, x [{b}, {s}, {d}] bf16", k3_ms=t_3, fig1=fig1,
    )
    return out


def per_microbatch_ssm(n_layers: int) -> dict[str, int]:
    """Launches of one LM training microbatch of n_layers Mamba-2 blocks
    with per-block recompute: each block's norm1 (K4 on rows) and gated norm
    (K13) run twice (forward, then again in the backward), the final norm
    once; K5 and K6 on rows once per norm (norm1 and the gated norm of each
    block, and the final norm)."""
    L = n_layers
    return {"rms_fwd": 2 * L + 1, "gated_rms_fwd": 2 * L, "rms_bwd_dx": 2 * L + 1,
            "rms_bwd_dw": 2 * L + 1}


SSM_BATCH, SSM_SEQ = 4, 2048  # phase 8 (b): 8,192-token steps
SSM_TRAIN_LAYERS = 16  # phase 8 (b): a quarter of the depth keeps the script's time


def phase_train_ssm(K, dev) -> dict:
    """Phase 8: Mamba-2 2.7B training on the card."""
    import types

    from repro_torch.configs.registry import get_config, get_optimizer
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import Transformer, lm_loss
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import init_state

    out = {}
    cfg = get_config("mamba2-2.7b")

    # (a) the launcher's entry point, as a user runs it
    log("(a) python -m repro_torch.launch.train --arch mamba2-2.7b --adaptive --steps 2 --batch 1")
    K.reset_launch_counts()
    hist = launch_train.main(["--arch", "mamba2-2.7b", "--adaptive", "--steps", "2", "--batch", "1"])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    if not np.isfinite(hist.losses).all():
        raise AssertionError(f"launcher: a loss is not finite: {hist.losses}")
    check_counts(counts, sum(hist.microbatches), cfg.n_layers, "launcher", per_microbatch_ssm)
    out["launcher"] = dict(losses=hist.losses, step_s=hist.step_times,
                           microbatches=hist.microbatches, launches=counts)
    del hist
    torch.cuda.empty_cache()

    # (b) full width and SSM_TRAIN_LAYERS of the 64 layers, 4 steps of one
    # B 4 x S 2048 microbatch each
    cfg = dataclasses.replace(cfg, n_layers=SSM_TRAIN_LAYERS)
    opt = OptimizerConfig(peak_lr=get_optimizer("mamba2-2.7b").peak_lr, schedule="constant",
                          warmup=0, total_steps=4)
    t0 = time.perf_counter()
    state = init_state(cfg, opt, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["model"].parameters())
    log(f"(b) Trainer on EmulatedEngine, {cfg.name}: {cfg.n_layers} of 64 layers, d {cfg.d_model}, "
        f"d_inner {cfg.d_inner}, {cfg.ssm_heads} heads, vocab {cfg.vocab}, bf16, "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s; "
        f"B {SSM_BATCH} x S {SSM_SEQ} per step")
    bucket = types.SimpleNamespace(batch_size=SSM_BATCH, seq_len=SSM_SEQ, tokens=SSM_BATCH * SSM_SEQ)
    rng = np.random.default_rng(0)
    stream = ([(bucket, make_lm_batch(int(rng.integers(2**31)), SSM_BATCH, SSM_SEQ, cfg.vocab,
                                      cfg, dev))] for _ in range(4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    state, hist = Trainer(cfg, opt).run(state, stream, 4, rng=1, log_every=1)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not np.isfinite(hist.losses).all():
        raise AssertionError(f"a loss is not finite: {hist.losses}")
    bad = [n for n, prm in state["model"].named_parameters() if not torch.isfinite(prm).all()]
    if bad or state["step"] != 4:
        raise AssertionError(f"parameters not finite after the updates: {bad[:5]}")
    check_counts(counts, sum(hist.microbatches), cfg.n_layers, "training", per_microbatch_ssm)
    steady = [i for i in range(4) if i not in hist.compile_steps]
    if not steady:
        raise AssertionError("every step ran a new batch signature: no steady step")
    step_ms = [1e3 * t for t in hist.step_times]
    steady_ms = float(np.mean([step_ms[i] for i in steady]))
    for i, (ms, tok) in enumerate(zip(step_ms, hist.tokens)):
        log(f"  step {i}: {tok} tokens, {ms:.1f} ms, loss {hist.losses[i]:.4f}"
            f"{'  (first signature)' if i in hist.compile_steps else ''}")
    log(f"  steady step {steady_ms:.1f} ms (steps {steady}), {hist.throughput:,.0f} tokens/s, "
        f"peak memory {peak:.2f} GiB, events {hist.events}")
    out["train"] = dict(
        n_params=n_params, losses=hist.losses, step_ms=step_ms, tokens=hist.tokens,
        events=hist.events, steady_steps=steady, steady_step_ms=steady_ms,
        tokens_per_s=hist.throughput, peak_gib=peak, launches=counts,
        per_microbatch=per_microbatch_ssm(cfg.n_layers),
    )
    del state, hist, stream
    torch.cuda.empty_cache()

    # (c) 2 layers at full width: kernel loss and gradients against the plain
    # versions', at S 2048 (8 SSD chunks) and S 272 (padded to 512)
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    model = Transformer(cfg2, seed=1, device=dev)
    out["grad_check"] = []
    for b, s in ((2, 2048), (4, 272)):
        batch = make_lm_batch(5, b, s, cfg2.vocab, cfg2, dev)
        res = {}
        for ops in ("kernel", "plain"):
            model.zero_grad(set_to_none=True)
            loss = lm_loss(model, batch["tokens"], batch["labels"], ops=ops)
            loss.backward()
            res[ops] = (loss.item(), {n: prm.grad.clone() for n, prm in model.named_parameters()})
        loss_rel = abs(res["kernel"][0] - res["plain"][0]) / abs(res["plain"][0])
        rels = {n: rel_l2(res["kernel"][1][n], gp) for n, gp in res["plain"][1].items()}
        worst = max(rels, key=rels.get)
        log(f"(c) 2 layers, full width, bf16, B {b} x S {s}: loss {res['kernel'][0]:.6f} kernel "
            f"vs {res['plain'][0]:.6f} plain (rel {loss_rel:.2e}, tol 1e-2); largest gradient "
            f"rel-L2 {rels[worst]:.3e} ({worst}, tol 5e-2)")
        if not (np.isfinite(res["kernel"][0]) and loss_rel <= 1e-2 and rels[worst] <= 5e-2):
            raise AssertionError("kernel training gradients disagree with the plain versions'")
        out["grad_check"].append(dict(shape=[b, s], loss_kernel=res["kernel"][0],
                                      loss_plain=res["plain"][0], loss_rel=loss_rel,
                                      worst_grad=worst, worst_grad_rel_l2=rels[worst]))
        del res
    del model
    torch.cuda.empty_cache()
    return out


LM_PER_CALL = {  # launches of one prefill and one decode wave, per layer L
    "prefill": lambda L: {"rms_fwd": 2 * L + 1, "flash_fwd": L},
    "wave": lambda L: {"rms_fwd": 2 * L + 1, "paged_decode": L},
}


def check_lm_counts(counts: dict, eng, n_layers: int, what: str,
                    extra: dict | None = None, per_call=LM_PER_CALL) -> tuple[int, int]:
    """Each kernel's count against the engine's prefills and waves (plus
    ``extra`` launches expected besides), ``per_call`` the launches of one
    prefill and one wave."""
    prefills = sum(len(it["prefills"]) for it in eng.iterations)
    waves = sum(1 for it in eng.iterations if it["decodes"])
    want = dict(extra or {})
    for kind, n in (("prefill", prefills), ("wave", waves)):
        for name, per in per_call[kind](n_layers).items():
            want[name] = want.get(name, 0) + n * per
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {n} times, expected "
                                 f"{want.get(name, 0)} ({prefills} prefills, {waves} waves)")
    log(f"  {what}: every launch count exact for {prefills} prefills and {waves} waves")
    return prefills, waves


def phase_serve_lm(K, dev) -> dict:
    """Phase 6: Llama-3.2-1B, 16 layers, serves 16 requests through the engine."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.serve import DEMO_MODEL
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import ServeConfig, ServeEngine

    out = {}
    cfg = get_config("llama3.2-1b")
    L = cfg.n_layers

    # (a) the launcher's entry point, as a user runs it
    log("(a) python -m repro_torch.launch.serve --arch llama3.2-1b --requests 4 --gen 8")
    K.reset_launch_counts()
    eng = launch_serve.main(["--arch", "llama3.2-1b", "--requests", "4", "--gen", "8"])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    if len(eng.done) != 4:
        raise AssertionError("launcher: not every request finished")
    check_lm_counts(counts, eng, L, "launcher")
    out["launcher"] = dict(iterations=len(eng.iterations), launches=counts,
                           tokens=[len(r.out) for r in eng.done])
    del eng
    torch.cuda.empty_cache()

    # (b) 16 requests at full width and depth
    t0 = time.perf_counter()
    model = Transformer(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"(b) model {cfg.name}: {L} layers, d {cfg.d_model}, {n_params / 1e9:.3f} B params, "
        f"bf16, init {time.perf_counter() - t0:.1f} s")
    serve = ServeConfig(target_step=1.0, page_size=LM_PAGE, num_pages=4096, decode_slots=8,
                        max_seq=LM_MAX_SEQ)
    eng = ServeEngine(model, cfg, DEMO_MODEL, serve)
    rng = np.random.default_rng(0)
    clock = 0.0
    for _ in range(16):
        clock += float(rng.exponential(1.0 / 20.0))
        plen = int(rng.integers(64, 2049))
        max_new = int(rng.integers(16, 65))
        eng.submit(rng.integers(0, cfg.vocab, size=plen).astype(np.int32), max_new, arrival=clock)
    log(f"  prompts {[r.prompt_len for r in eng.waiting]}, max_new "
        f"{[r.max_new for r in eng.waiting]}")

    # CUDA events around each prefill and decode call of the engine
    calls = {"prefill": [], "decode": []}
    finite = []

    def timed(fn, kind):
        def run(*args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if kind == "prefill":
                what = int(args[1].shape[1])  # padded width
            else:
                what = sorted(int(n) for n in eng.kv_lens if n > 0)  # depths in the wave
            a.record()
            logits, pools = fn(*args)
            b.record()
            finite.append(torch.isfinite(logits).all())
            calls[kind].append((what, a, b))
            return logits, pools
        return run

    eng._prefill = timed(eng._prefill, "prefill")
    eng._decode = timed(eng._decode, "decode")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()  # asserts the page pool drained
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(done) != 16 or any(len(r.out) != r.max_new for r in done):
        raise AssertionError("not every request finished with its max_new tokens")
    if not all(bool(f) for f in finite):
        raise AssertionError("a prefill or decode wave gave non-finite logits")
    if any(not 0 <= t < cfg.vocab for r in done for t in r.out):
        raise AssertionError("a generated id is outside the vocabulary")
    prefills, waves = check_lm_counts(counts, eng, L, "LM serving")
    if not any(len(set(depths)) >= 2 for depths, _, _ in calls["decode"]):
        raise AssertionError("no wave held slots at different depths")
    prefill_ms: dict = {}
    for width, a, b in calls["prefill"]:
        prefill_ms.setdefault(width, []).append(a.elapsed_time(b))
    wave_ms = [a.elapsed_time(b) for _, a, b in calls["decode"]]
    wave_slots = [len(depths) for depths, _, _ in calls["decode"]]
    gen = sum(len(r.out) for r in done)
    prompt_toks = sum(r.prompt_len for r in done)
    full = [ms for ms, n in zip(wave_ms, wave_slots) if n == 8]
    for width in sorted(prefill_ms):
        ms = prefill_ms[width]
        log(f"  prefill width {width}: {len(ms)} calls, {np.mean(ms):.2f} ms mean "
            f"({', '.join(f'{m:.2f}' for m in ms)})")
    log(f"  decode waves: {waves}, {np.median(wave_ms):.2f} ms median, "
        f"{np.min(wave_ms):.2f}-{np.max(wave_ms):.2f} ms; waves with all 8 slots: {len(full)}"
        f"{f', {np.median(full):.2f} ms median' if full else ''}")
    lat = sorted(r.latency for r in done)
    log(f"  served 16 requests in {len(eng.iterations)} iterations ({prefills} prefills, "
        f"{waves} waves), {wall:.2f} s wall: {gen} tokens generated, {gen / wall:.1f} "
        f"generated tokens/s, {(gen + prompt_toks) / wall:.1f} tokens/s with the {prompt_toks} "
        f"prompt tokens; simulated clock {eng.clock:.3f} s, latency p50 {lat[8]:.3f} s; "
        f"peak memory {peak:.2f} GiB")
    log(f"  launch counts {counts}")
    out["serve"] = dict(
        n_params=n_params, iterations=len(eng.iterations), prefills=prefills, waves=waves,
        wall_s=wall, generated_tokens=gen, prompt_tokens=prompt_toks,
        generated_tokens_per_s=gen / wall, tokens_per_s=(gen + prompt_toks) / wall,
        peak_gib=peak, launches=counts,
        prefill_ms_by_width={str(k): v for k, v in sorted(prefill_ms.items())},
        wave_ms=wave_ms, wave_slots=wave_slots, wave_ms_median=float(np.median(wave_ms)),
        full_wave_ms_median=float(np.median(full)) if full else None,
        simulated_clock_s=eng.clock, latencies_s=lat,
    )
    del eng, model, done
    torch.cuda.empty_cache()
    return out


def phase_model_lm(dev) -> dict:
    """Phase 7: the LM at full width and 2 layers, kernels vs plain: the
    prefill logits and three decode waves' logits on the same pools."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2)
    model = T.Transformer(cfg, seed=1, device=dev)
    rng = np.random.default_rng(7)
    ps, num_pages, s_pad = LM_PAGE, 256, 1024
    true_len = np.array([1000, 517], np.int32)
    tokens = np.zeros((2, s_pad), np.int32)
    for bi, n in enumerate(true_len):
        tokens[bi, :n] = rng.integers(0, cfg.vocab, n)
    order = rng.permutation(num_pages)
    table = np.full((3, s_pad // ps + 1), num_pages, np.int32)  # slot 2 stays inactive
    table[0, :63] = order[:63]  # 1000 + 3 tokens
    table[1, :33] = order[63:96]  # 517 + 3 tokens
    dv = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for k, a in
          (("tokens", tokens), ("true_len", true_len), ("table", table),
           ("prefill_table", table[:2, : s_pad // ps]))}
    logits, pools = {}, {}
    with torch.inference_mode():
        for ops in ("kernel", "plain"):
            pools[ops] = T.init_paged_pools(cfg, num_pages, ps, device=dev)
            lg, pools[ops] = T.paged_prefill(model, dv["tokens"], dv["true_len"],
                                             dv["prefill_table"], pools[ops], ops=ops)
            logits[ops] = [lg]
        kv_lens = np.array([1000, 517, 0], np.int32)
        last = np.zeros((3, 1), np.int32)
        last[:2, 0] = logits["kernel"][0].argmax(dim=-1).cpu().numpy()
        for _ in range(3):
            lens_d, last_d = torch.from_numpy(kv_lens).to(dev), torch.from_numpy(last).to(dev)
            for ops in ("kernel", "plain"):
                lg, pools[ops] = T.paged_decode_step(model, pools[ops], dv["table"], lens_d,
                                                     last_d, ops=ops)
                logits[ops].append(lg[:2])
            last[:2, 0] = logits["kernel"][-1].argmax(dim=-1).cpu().numpy()
            kv_lens[:2] += 1
    rels = [rel_l2(a, b) for a, b in zip(logits["kernel"], logits["plain"])]
    log(f"LM, 2 layers, full width, bf16: logits rel-L2 kernel vs plain, prefill "
        f"{rels[0]:.3e}, decode waves {', '.join(f'{r:.3e}' for r in rels[1:])} (tol 2e-2)")
    if not (all(torch.isfinite(lg).all() for lg in logits["kernel"]) and max(rels) <= 2e-2):
        raise AssertionError(f"LM whole-model check failed: rel-L2 {rels}")
    return dict(prefill_rel_l2=rels[0], decode_rel_l2=rels[1:])


# -- the packed dense-LM training slice and its sequence-parallel step ------------

RING_K = 4  # phase 9: ring ranks
RING_S = 32768  # phase 9 (c): the SP window (shards of 8192)
RING_S_SMALL = 8192  # phase 9 (a): K11 against its plain version
LLAMA_ATTN = dict(hq=32, hkv=8, dh=64)  # llama3.2-1b's attention


def ring_inputs(dev, g, s: int, *, hq=32, hkv=8, dh=64, dtype=torch.bfloat16, seed=0):
    """One packed window of ``s`` tokens at an attention's shapes: q, k, v
    views of a fused projection [1, s, (hq + 2 hkv) dh], the output
    gradient, and the segment ids of ``lm_length_corpus`` documents packed
    first-fit-decreasing with a -1 tail (``profile_train
    .packed_microbatches``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.profile_train import packed_microbatches

    seg = packed_microbatches(get_config("llama3.2-1b"), s, 1, 1, seed=seed)[0]["segment_ids"]
    qkv = torch.randn((1, s, (hq + 2 * hkv) * dh), generator=g, device=dev).to(dtype)
    q = qkv[..., : hq * dh].reshape(1, s, hq, dh)
    k = qkv[..., hq * dh : (hq + hkv) * dh].reshape(1, s, hkv, dh)
    v = qkv[..., (hq + hkv) * dh :].reshape(1, s, hkv, dh)
    dy = torch.randn((1, s, hq, dh), generator=g, device=dev).to(dtype)
    return q, k, v, dy, torch.from_numpy(seg).to(dev)


def stack_shards(x, k: int):
    """[B, S, ...] -> the k contiguous shards stacked rank-major [k B, S/k, ...]."""
    return torch.cat(x.chunk(k, dim=1), dim=0)


def ring_run(q, k, v, dy, seg, kranks: int, *, plain: bool = False, grads: bool = True):
    """K11 (or its plain version) on a LocalRing over the gathered window:
    (out, dq, dk, dv) in the stacked layout, and the ring's live table."""
    from repro_torch.kernels.flash_attention.ring import LocalRing, ring_attention

    group = LocalRing(kranks)
    leaves = [stack_shards(t, kranks).detach().requires_grad_(grads) for t in (q, k, v)]
    ids = stack_shards(seg, kranks)
    out = ring_attention(*leaves, ids, ids, group=group, causal=True, plain=plain)
    res = [out.detach()]
    if grads:
        res += list(torch.autograd.grad(out, leaves, stack_shards(dy, kranks)))
    return res, group.table(ids, ids, True)


def ring_live_tiles(seg, kranks: int, table) -> int:
    """(q tile, kv tile) pairs the ring's live hops run, one head."""
    from repro_torch.kernels.flash_attention.flash import live_tile_pairs

    shards = seg.chunk(kranks, dim=1)
    n = 0
    for t in range(kranks):
        for r in range(kranks):
            if table[t, r]:
                sq = shards[r].shape[1]
                n += live_tile_pairs(sq, sq, shards[r], shards[(r - t) % kranks], causal=t == 0)
    return n


def phase_kernels_ring(dev) -> dict:
    """Phase 9 (a): the merge kernels against the plain merge, K11 against
    its plain version and against the whole-window K7-K9; times."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.flash import BOUND_TILE
    from repro_torch.kernels.flash_attention.ref import NEG_INF
    from repro_torch.kernels.flash_attention.ring import (
        finalize_ref, merge_ref, ring_finalize, ring_merge,
    )

    g = torch.Generator(device=dev).manual_seed(9)
    out = {}
    hq, hkv, dh = LLAMA_ATTN["hq"], LLAMA_ATTN["hkv"], LLAMA_ATTN["dh"]
    sl = RING_S // RING_K

    # -- ring_merge, ring_finalize: one rank's state at phase (c) ---------------------
    log(f"K11 ring_merge, ring_finalize  state m, s [1, {hq}, {sl}], num [1, {sl}, {hq}, {dh}] "
        f"f32; a quarter of the rows masked in the hop (o 0, lse -2e38), a quarter masked in "
        f"every hop so far (m -2e38)")

    def state(dead_hop=0.25, dead_rows=0.25):
        m = torch.randn((1, hq, sl), generator=g, device=dev) * 3
        s = torch.rand((1, hq, sl), generator=g, device=dev) * 3 + 0.5
        num = torch.randn((1, sl, hq, dh), generator=g, device=dev)
        o = torch.randn((1, sl, hq, dh), generator=g, device=dev)
        lse = torch.randn((1, hq, sl), generator=g, device=dev) * 3
        hop = torch.rand((1, hq, sl), generator=g, device=dev) < dead_hop
        lse[hop] = NEG_INF
        o.transpose(1, 2)[hop] = 0.0
        rows = torch.rand((1, hq, sl), generator=g, device=dev) < dead_rows
        m[rows] = NEG_INF
        num.transpose(1, 2)[rows] = 0.0
        return m, s, num, o, lse

    m, s, num, o, lse = state()
    want = merge_ref(m, s, num, o, lse)
    got = [t.clone() for t in (m, s, num)]
    ring_merge(*got, o, lse)
    torch.cuda.synchronize()
    # the same operations, each rounded once; the card's expf and logf and
    # torch's may differ in the last bit: 1e-6 of the largest value
    merge_err = max(check_rel(f"ring_merge {nm}", a, b, 1e-6)
                    for nm, a, b in zip(("m", "s", "num"), got, want))
    fin_want = finalize_ref(*want)
    fin_got = ring_finalize(*[t.clone() for t in want])
    torch.cuda.synchronize()
    fin_err = max(check_rel(f"ring_finalize {nm}", a, b, 1e-6)
                  for nm, a, b in zip(("out", "lse"), fin_got, fin_want))
    dead = want[0] == NEG_INF
    if not (fin_got[1][dead] == NEG_INF).all() or torch.count_nonzero(
            fin_got[0].transpose(1, 2)[dead]) != 0:
        raise AssertionError("ring_finalize: a row masked in every hop is not (0, -2e38)")
    for d_ in (32, 128):  # the other head widths the kernels take
        st = [torch.randn((2, 3, 200), generator=g, device=dev),
              torch.rand((2, 3, 200), generator=g, device=dev) + 0.5,
              torch.randn((2, 200, 3, d_), generator=g, device=dev),
              torch.randn((2, 200, 3, d_), generator=g, device=dev),
              torch.randn((2, 3, 200), generator=g, device=dev)]
        got = [t.clone() for t in st[:3]]
        ring_merge(*got, *st[3:])
        for nm, a, b in zip(("m", "s", "num"), got, merge_ref(*st)):
            check_rel(f"ring_merge dh={d_} {nm}", a, b, 1e-6)
        for nm, a, b in zip(("out", "lse"), ring_finalize(*got), finalize_ref(*merge_ref(*st))):
            check_rel(f"ring_finalize dh={d_} {nm}", a, b, 1e-6)
    rows = hq * sl
    copies = [t.clone() for t in (m, s, num)]
    t_merge = device_ms(lambda: ring_merge(*copies, o, lse), 50)
    t_merge_p = device_ms(lambda: merge_ref(m, s, num, o, lse), 10)
    t_fin = device_ms(lambda: ring_finalize(*copies), 50)
    t_fin_p = device_ms(lambda: finalize_ref(m, s, num), 10)
    merge_bytes = rows * (5 * 4 + 3 * dh * 4)  # m s lse in, m s out; num o in, num out
    fin_bytes = rows * (3 * 4 + 2 * dh * 4)  # m s in, m out; num in, num out
    bm = bound(merge_bytes, rows * (3 * dh + 6), F32_FLOPS)
    bf = bound(fin_bytes, rows * (dh + 3), F32_FLOPS)
    src = "src/repro_torch/kernels/flash_attention/csrc/ring_merge.cu"
    shape = f"m, s [1, {hq}, {sl}], num, o [1, {sl}, {hq}, {dh}] f32"
    out["ring_merge"] = dict(
        route="cuda", source=src, replaces="src/repro/kernels/flash_attention/ring.py:90",
        max_abs_err=merge_err, ms=t_merge, plain_ms=t_merge_p, bound_ms=bm[0], bound_by=bm[1],
        library_ms=None, shape=shape)
    out["ring_finalize"] = dict(
        route="cuda", source=src, replaces="src/repro/kernels/flash_attention/ring.py:195",
        max_abs_err=fin_err, ms=t_fin, plain_ms=t_fin_p, bound_ms=bf[0], bound_by=bf[1],
        library_ms=None, shape=shape)
    log(f"  ring_merge ms {t_merge:.4f}  plain {t_merge_p:.4f}  bound {bm[0]:.4f} ({bm[1]}); "
        f"ring_finalize ms {t_fin:.4f}  plain {t_fin_p:.4f}  bound {bf[0]:.4f} ({bf[1]})")
    del m, s, num, o, lse, want, got, fin_want, fin_got, copies

    # -- K11 against its plain version, small f32 shapes ------------------------------
    for d_ in (32, 64, 128):
        for kranks in (2, 4):
            args = ring_inputs(dev, g, 1024, hq=4, hkv=2, dh=d_, dtype=torch.float32,
                               seed=d_ + kranks)
            # a 1024-token window holds one document: give it four and a tail
            args = (*args[:4], segs([[(0, 300), (1, 200), (2, 250), (3, 150), (-1, 124)]], dev))
            got, _ = ring_run(*args, kranks)
            want, _ = ring_run(*args, kranks, plain=True)
            torch.cuda.synchronize()
            tag = f"dh={d_} k={kranks}"
            check(f"K11 f32 out {tag}", max_err(got[0], want[0]), TOL["attn_f32"])
            for nm, a_, b_ in zip(("dq", "dk", "dv"), got[1:], want[1:]):
                check_l2(f"K11 f32 {nm} {tag}", a_, b_, BWD_TOL["flash_f32"])

    # -- K11 against its plain version at the Llama shapes, S 8192 ----------------------
    log(f"K11 ring_attention  q [1, {RING_S_SMALL}, {hq}, {dh}], k, v [1, {RING_S_SMALL}, {hkv}, "
        f"{dh}] bf16 (views of qkv), causal, packed documents + a -1 tail, LocalRing({RING_K})")
    args = ring_inputs(dev, g, RING_S_SMALL, **LLAMA_ATTN, seed=2)
    got, table = ring_run(*args, RING_K)
    want, _ = ring_run(*args, RING_K, plain=True)
    torch.cuda.synchronize()
    log(f"  live table (hop x rank) {table.astype(int).tolist()}")
    k11_err = max_err(got[0], want[0])
    check("K11 out (S 8192)", k11_err, TOL["attn_bf16"])
    for nm, a_, b_ in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        check_l2(f"K11 {nm} (S 8192)", a_, b_, BWD_TOL["flash_bf16"])
    del got, want, args

    # -- K11 against the whole-window K7-K9 at the SP window, S 32768 ---------------------
    log(f"K11 against flash_fwd/flash_bwd_dq/flash_bwd_dkv on the gathered window, S {RING_S}, "
        f"LocalRing({RING_K})")
    q, k, v, dy, seg = ring_inputs(dev, g, RING_S, **LLAMA_ATTN, seed=1)
    got, table = ring_run(q, k, v, dy, seg, RING_K)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o_w = flash_ops.attention(*leaves, causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    grads_w = torch.autograd.grad(o_w, leaves, dy)
    torch.cuda.synchronize()
    log(f"  live table (hop x rank) {table.astype(int).tolist()}")
    err = max_err(got[0], stack_shards(o_w, RING_K))
    check("K11 out vs window", err, TOL["attn_bf16"])
    k11_err = max(k11_err, err)
    for nm, a_, b_ in zip(("dq", "dk", "dv"), got[1:], grads_w):
        check_l2(f"K11 {nm} vs window", a_, stack_shards(b_, RING_K), BWD_TOL["flash_bf16"])
    del got, o_w, grads_w, leaves

    # per layer: one forward pass of the ring, and one forward + backward
    stacked = [stack_shards(t, RING_K).detach().requires_grad_() for t in (q, k, v)]
    ids, dys = stack_shards(seg, RING_K), stack_shards(dy, RING_K)
    from repro_torch.kernels.flash_attention.ring import LocalRing, ring_attention

    def fwd(plain=False):
        with torch.no_grad():
            return ring_attention(*stacked, ids, ids, group=LocalRing(RING_K), causal=True,
                                  plain=plain)

    def fwd_bwd(plain=False):
        o_ = ring_attention(*stacked, ids, ids, group=LocalRing(RING_K), causal=True, plain=plain)
        return torch.autograd.grad(o_, stacked, dys)

    t_f, t_fb = cuda_ms(fwd, 3), cuda_ms(fwd_bwd, 2)
    # the plain ring takes 1.1 s a pass here: one pass, not warmed up (the
    # S 8192 comparison above ran its operations already)
    t_pfb = cuda_ms(lambda: fwd_bwd(True), 1, warmup=0)
    t_pf = cuda_ms(lambda: fwd(True), 1, warmup=0)
    # yardstick only, never on the port's path: the library's attention on
    # the gathered window, kv heads repeated, the causal segment mask built
    # beforehand (forward and forward + backward)
    mask = (seg[0][:, None] == seg[0][None, :]).tril_()[None, None]
    lib = [t.detach().transpose(1, 2).repeat_interleave(hq // t.shape[2], dim=1).requires_grad_()
           for t in (q, k, v)]
    dyt = dy.transpose(1, 2)

    def lib_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(*lib, attn_mask=mask)

    def lib_fwd_bwd():
        return torch.autograd.grad(F.scaled_dot_product_attention(*lib, attn_mask=mask), lib, dyt)

    t_lf, t_lfb = cuda_ms(lib_fwd, 2), cuda_ms(lib_fwd_bwd, 1)
    del mask, lib
    tiles = ring_live_tiles(seg, RING_K, table) * hq
    mm = 2 * BOUND_TILE ** 2 * dh  # flops of one 64 x 64 x dh product
    live = int(table.sum())
    # each input read once, each output written once (the merged state is
    # the ring's own traffic): q k v and dy in, out, dq dk dv out, bf16.
    # The function needs 7 products per live tile: q k^T and p v forward;
    # q k^T once more, then dO v^T, p^T dO, dS k and dS^T q backward (K8 and
    # K9 each form s and dP themselves: the split costs 9, not 7)
    io_fwd = (2 * q.numel() + 2 * k.numel()) * 2
    bms, bby = bound(2 * io_fwd, tiles * 7 * mm, BF16_FLOPS)
    bms_f, bby_f = bound(io_fwd, tiles * 2 * mm, BF16_FLOPS)
    out["ring_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/flash_attention/ring.py",
        replaces="src/repro/kernels/flash_attention/ring.py:300",
        max_abs_err=k11_err, ms=t_fb, plain_ms=t_pfb, bound_ms=bms, bound_by=bby,
        library_ms=t_lfb,
        shape=f"one layer's ring forward + backward, S {RING_S} over LocalRing({RING_K}), "
              f"Hq {hq}, Hkv {hkv}, dh {dh}, bf16 in, f32 backward hops",
        forward=dict(ms=t_f, plain_ms=t_pf, library_ms=t_lf, bound_ms=bms_f, bound_by=bby_f),
        live_table=table.astype(int).tolist(), live_hops=live, live_tile_pairs=tiles,
        tflops_per_s=tiles * 7 * mm / (t_fb * 1e-3) / 1e12)
    log(f"  K11 per layer: forward {t_f:.3f} ms (plain {t_pf:.1f}, SDPA+mask {t_lf:.3f}, "
        f"bound {bms_f:.4f} {bby_f}); forward + backward {t_fb:.3f} ms (plain {t_pfb:.1f}, "
        f"SDPA+mask {t_lfb:.3f}, bound {bms:.4f} {bby}); {live} live hops, {tiles} live 64x64 tiles")
    out.update(ring_hop_f32(q, k, v, dy, seg))
    return out


def ring_hop_f32(q, k, v, dy, seg) -> dict:
    """One backward hop of the ring alone: K8 and K9 in f32 (3xTF32
    products) on q shard 1 against kv shard 0 of the SP window (hop 1 of
    rank 1, no causal cut), with K7's f32 out and lse of the same hop;
    against the plain backward, with times and bounds."""
    from repro_torch.kernels.flash_attention.flash import (
        BOUND_TILE, flash_bwd_dkv, flash_bwd_dq, flash_fwd, live_tile_pairs,
    )
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    hq, hkv, dh = q.shape[2], k.shape[2], q.shape[3]
    qh = q.chunk(RING_K, dim=1)[1].float()
    kh, vh = (t.chunk(RING_K, dim=1)[0].float() for t in (k, v))
    do = dy.chunk(RING_K, dim=1)[1].float()
    ids = (seg.chunk(RING_K, dim=1)[1].contiguous(), seg.chunk(RING_K, dim=1)[0].contiguous())
    sl = qh.shape[1]
    log(f"K8, K9 f32: one ring hop, q [1, {sl}, {hq}, {dh}] (shard 1) against k, v [1, {sl}, "
        f"{hkv}, {dh}] (shard 0), f32, packed documents")
    o32, lse = flash_fwd(qh, kh, vh, *ids)
    dq, delta = flash_bwd_dq(qh, kh, vh, o32, do, lse, *ids)
    dk, dv = flash_bwd_dkv(qh, kh, vh, do, lse, delta, *ids)
    want = attention_bwd_ref(qh, kh, vh, do, lse, delta, *ids)
    torch.cuda.synchronize()
    errs = [check_l2(f"K8/K9 f32 hop {nm}", a_, b_, BWD_TOL["flash_f32"])
            for nm, a_, b_ in zip(("dq", "dk", "dv"), (dq, dk, dv), want)]
    del dq, dk, dv, want
    t8 = cuda_ms(lambda: flash_bwd_dq(qh, kh, vh, o32, do, lse, *ids), 5)
    t9 = cuda_ms(lambda: flash_bwd_dkv(qh, kh, vh, do, lse, delta, *ids), 5)
    t_p = cuda_ms(lambda: attention_bwd_ref(qh, kh, vh, do, lse, delta, *ids), 1, warmup=0)
    # yardstick only, never on the port's path: the library's f32 attention
    # backward (dq, dk, dv together), kv heads repeated, the mask built beforehand
    leaves = [t.transpose(1, 2).repeat_interleave(hq // t.shape[2], dim=1).requires_grad_()
              for t in (qh, kh, vh)]
    o_l = F.scaled_dot_product_attention(*leaves, attn_mask=(ids[0][0][:, None] == ids[1][0][None, :])[None, None])
    t_l = cuda_ms(lambda: torch.autograd.grad(o_l, leaves, do.transpose(1, 2), retain_graph=True), 2)
    del o_l, leaves
    tiles = live_tile_pairs(sl, sl, *ids) * hq
    mm = 2 * BOUND_TILE ** 2 * dh
    rows_q, rows_kv, stat = qh.numel() * 4, kh.numel() * 4, hq * sl * 4
    by8 = 2 * rows_q + 2 * rows_kv + rows_q + 2 * stat + rows_q  # q do, k v, out, lse delta, dq
    by9 = 2 * rows_q + 2 * rows_kv + 2 * stat + 2 * rows_kv  # q do, k v, lse delta, dk dv
    # f32 inputs: the least time is one pass of each product at the TF32 rate
    b8, b9 = bound(by8, tiles * 3 * mm, TF32_FLOPS), bound(by9, tiles * 4 * mm, TF32_FLOPS)
    shape = f"one ring hop, q [1, {sl}, {hq}, {dh}] x kv [1, {sl}, {hkv}, {dh}] f32, packed ids"
    res = {}
    for nm, t_k, (bms, bby), n in (("flash_bwd_dq_f32_hop", t8, b8, 3), ("flash_bwd_dkv_f32_hop", t9, b9, 4)):
        res[nm] = dict(max_abs_err=max(errs), ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=bby,
                       library_ms=t_l, shape=shape, live_tile_pairs=tiles,
                       tflops_per_s=tiles * n * mm / (t_k * 1e-3) / 1e12)
    log(f"  f32 hop: K8 ms {t8:.4f} (bound {b8[0]:.4f} {b8[1]}), K9 ms {t9:.4f} (bound "
        f"{b9[0]:.4f} {b9[1]}); plain (dq, dk, dv) {t_p:.2f}, library (SDPA f32 backward, "
        f"bool mask) {t_l:.4f}; {tiles} live 64x64 tiles")
    return res


def per_microbatch_dense(n_layers: int) -> dict[str, int]:
    """Launches of one dense LM training microbatch of n_layers attention
    blocks with per-block recompute: each block's norm1 and norm2 (K4 on
    rows) and its attention forward (K7) run twice (forward, then again in
    the backward), the final norm once; K5 and K6 on rows once per norm,
    K8 and K9 once per attention."""
    L = n_layers
    return {"rms_fwd": 4 * L + 1, "rms_bwd_dx": 2 * L + 1, "rms_bwd_dw": 2 * L + 1,
            "flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}


def per_sp_step(n_layers: int, live: int) -> dict[str, int]:
    """Launches of one SP step on a LocalRing whose live table has ``live``
    entries: the norms as a dense microbatch (the shards are stacked along
    the batch, so one launch covers the ring); per block, the ring's
    forward pass twice (forward and recompute: K7 and ring_merge once per
    live hop, ring_finalize once) and its backward pass once (K8 and K9 once
    per live hop); ring_attention counts the 3 passes."""
    L = n_layers
    return {"rms_fwd": 4 * L + 1, "rms_bwd_dx": 2 * L + 1, "rms_bwd_dw": 2 * L + 1,
            "flash_fwd": 2 * L * live, "ring_merge": 2 * L * live, "ring_finalize": 2 * L,
            "flash_bwd_dq": L * live, "flash_bwd_dkv": L * live, "ring_attention": 3 * L}


DENSE_WINDOW, DENSE_WINDOWS = 8192, 2  # phase 9 (b): 16,384-slot steps


def phase_train_dense(K, dev) -> dict:
    """Phase 9 (b), (c): packed dense-LM training of Llama-3.2-1B and its
    sequence-parallel step."""
    import types

    from repro_torch.configs.registry import get_config, get_optimizer
    from repro_torch.data.packing import split_packed_batch
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels.flash_attention.ring import LocalRing
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.profile_train import packed_microbatches
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import init_state, make_pool_grad_step, make_sp_pool_grad_step, sp_batch

    out = {}
    cfg = get_config("llama3.2-1b")

    # (a) the launcher's entry point, as a user runs it
    log("(b) python -m repro_torch.launch.train --arch llama3.2-1b --adaptive --steps 2")
    K.reset_launch_counts()
    hist = launch_train.main(["--arch", "llama3.2-1b", "--adaptive", "--steps", "2"])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    if not np.isfinite(hist.losses).all():
        raise AssertionError(f"launcher: a loss is not finite: {hist.losses}")
    check_counts(counts, sum(hist.microbatches), cfg.n_layers, "launcher", per_microbatch_dense)
    out["launcher"] = dict(losses=hist.losses, step_s=hist.step_times,
                           microbatches=hist.microbatches, launches=counts)
    del hist
    torch.cuda.empty_cache()

    # (b) 16 layers, 4 steps of one microbatch of two packed 8192-token windows
    opt = OptimizerConfig(peak_lr=get_optimizer("llama3.2-1b").peak_lr, schedule="constant",
                          warmup=0, total_steps=4)
    t0 = time.perf_counter()
    state = init_state(cfg, opt, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["model"].parameters())
    mbs = packed_microbatches(cfg, DENSE_WINDOW, DENSE_WINDOWS, 4)
    docs = [int(mb["segment_ids"].max(axis=1).sum()) + DENSE_WINDOWS for mb in mbs]
    log(f"(b) Trainer on EmulatedEngine, {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads}, vocab {cfg.vocab}, bf16, "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s; each step one "
        f"microbatch of {DENSE_WINDOWS} packed {DENSE_WINDOW}-token windows ({docs} documents)")
    bucket = types.SimpleNamespace(batch_size=DENSE_WINDOWS, seq_len=DENSE_WINDOW,
                                   tokens=DENSE_WINDOWS * DENSE_WINDOW)
    stream = iter([[(bucket, to_device(mb, dev))] for mb in mbs])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    state, hist = Trainer(cfg, opt).run(state, stream, 4, rng=1, log_every=1)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not np.isfinite(hist.losses).all():
        raise AssertionError(f"a loss is not finite: {hist.losses}")
    model = state["model"]
    bad = [n for n, prm in model.named_parameters() if not torch.isfinite(prm).all()]
    if bad or state["step"] != 4:
        raise AssertionError(f"parameters not finite after the updates: {bad[:5]}")
    check_counts(counts, sum(hist.microbatches), cfg.n_layers, "training", per_microbatch_dense)
    steady = [i for i in range(4) if i not in hist.compile_steps]
    if not steady:
        raise AssertionError("every step ran a new batch signature: no steady step")
    step_ms = [1e3 * t for t in hist.step_times]
    steady_ms = float(np.mean([step_ms[i] for i in steady]))
    for i, (ms, tok) in enumerate(zip(step_ms, hist.tokens)):
        log(f"  step {i}: {tok} tokens, {ms:.1f} ms, loss {hist.losses[i]:.4f}"
            f"{'  (first signature)' if i in hist.compile_steps else ''}")
    log(f"  steady step {steady_ms:.1f} ms (steps {steady}), {hist.throughput:,.0f} tokens/s, "
        f"peak memory {peak:.2f} GiB, events {hist.events}")
    out["train"] = dict(
        n_params=n_params, documents=docs, losses=hist.losses, step_ms=step_ms,
        tokens=hist.tokens, events=hist.events, steady_steps=steady, steady_step_ms=steady_ms,
        tokens_per_s=hist.throughput, peak_gib=peak, launches=counts,
        per_microbatch=per_microbatch_dense(cfg.n_layers),
    )
    state["opt"] = None
    del state, hist, stream, mbs
    torch.cuda.empty_cache()

    # (c) the SP step: one packed 32768-token window over a LocalRing of 4
    window = packed_microbatches(cfg, RING_S, 1, 1, seed=1)[0]
    group = LocalRing(RING_K)
    batch = sp_batch(split_packed_batch(window, RING_K), group, dev)
    table = group.table(batch["segment_ids"], batch["segment_ids"], True)
    live = int(table.sum())
    log(f"(c) make_sp_pool_grad_step on LocalRing({RING_K}), {cfg.name} {cfg.n_layers} layers "
        f"bf16: one packed window of {RING_S} tokens ({int(window['segment_ids'].max()) + 1} "
        f"documents, a -1 tail), shards of {RING_S // RING_K}; live table "
        f"{table.astype(int).tolist()} ({live} live hops)")
    sp = make_sp_pool_grad_step(cfg, group)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    loss, grads = sp(model, batch, 0, 0)
    ev[1].record()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak_sp = torch.cuda.max_memory_allocated() / 2**30
    sp_ms = ev[0].elapsed_time(ev[1])
    want = per_sp_step(cfg.n_layers, live)
    for name in counts:
        if counts[name] != want.get(name, 0):
            raise AssertionError(f"SP step: {name} launched {counts[name]} times, expected "
                                 f"{want.get(name, 0)} from the live table")
    log("  SP step: every launch count is the live table's")
    # the unsplit step on the merged window, with the kernels
    ev[0].record()
    uloss, ugrads = make_pool_grad_step(cfg)(model, to_device(window, dev), 0, 0)
    ev[1].record()
    torch.cuda.synchronize()
    unsplit_ms = ev[0].elapsed_time(ev[1])
    if not (torch.isfinite(loss) and all(torch.isfinite(t).all() for t in grads.values())):
        raise AssertionError("SP step: a loss or gradient is not finite")
    loss_rel = abs(loss.item() - uloss.item()) / abs(uloss.item())
    rels = {n: rel_l2(grads[n], gu) for n, gu in ugrads.items()}
    worst = max(rels, key=rels.get)
    log(f"  SP step {sp_ms:.1f} ms (its first call); peak memory {peak_sp:.2f} GiB; "
        f"unsplit step on the window {unsplit_ms:.1f} ms")
    log(f"  loss {loss.item():.6f} SP vs {uloss.item():.6f} unsplit (rel {loss_rel:.2e}, tol "
        f"1e-2); largest gradient rel-L2 {rels[worst]:.3e} ({worst}, tol 5e-2)")
    if not (loss_rel <= 1e-2 and rels[worst] <= 5e-2):
        raise AssertionError("the SP step disagrees with the unsplit step")
    out["sp"] = dict(window=RING_S, ranks=RING_K, live_table=table.astype(int).tolist(),
                     step_ms=sp_ms, unsplit_step_ms=unsplit_ms, peak_gib=peak_sp,
                     loss_sp=loss.item(), loss_unsplit=uloss.item(), loss_rel=loss_rel,
                     worst_grad=worst, worst_grad_rel_l2=rels[worst], launches=counts,
                     per_step=want)
    del model, grads, ugrads, batch
    torch.cuda.empty_cache()
    return out


PLANNED_RANKS = 4  # phase 10: emulated data-parallel ranks
PLANNED_TOKENS = 16384  # phase 10 (b): the token budget a rank, both regimes
PLANNED_STEPS = 4  # phase 10 (b), (c): steps a regime


def planned_records(records, plans, seen: set) -> list:
    """The (step, rank, B, S) records a run of ``plans`` must give: every
    planned microbatch in rank-major order, less the first of each batch
    signature (``seen`` carries the signatures met before; an MMDiT
    batch's signature is its (B, S))."""
    want = []
    for step, plan in enumerate(plans):
        for w in range(plan.n_workers):
            for b in plan.worker_microbatches(w):
                key = (b.batch_size, b.seq_len)
                if key in seen:
                    want.append((step, w, b.batch_size, b.seq_len))
                seen.add(key)
    got = [(r.step, r.worker, r.batch_size, r.seq_len) for r in records]
    if got != want:
        raise AssertionError(f"records {got} do not name the planned ranks and buckets {want}")
    return want


def rank_times(records, step: int, n_ranks: int) -> list[float]:
    """Each rank's summed microbatch device time (s) in ``step``."""
    t = [0.0] * n_ranks
    for r in records:
        if r.step == step:
            t[r.worker] += r.compute_time
    return t


def phase_train_planned(K, dev) -> dict:
    """Phase 10: planned training of Wan-2.1 1.3B on emulated ranks."""
    from repro_torch.configs.registry import get_config, get_optimizer
    from repro_torch.core.balancer import step_metrics
    from repro_torch.core.bucketing import BucketingPolicy
    from repro_torch.core.cost_model import BenchSample, fit_cost_model
    from repro_torch.core.dispatch import StepPlanner
    from repro_torch.core.scheduler import AdaptiveLoadScheduler, SchedulerConfig
    from repro_torch.core.simulator import CorpusSampler
    from repro_torch.data.pipeline import ShardedBucketedLoader, on_side_stream
    from repro_torch.data.synthetic import make_diffusion_batch, wan_mixed_corpus
    from repro_torch.launch import train as launch_train
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.engine import EmulatedEngine
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import init_state

    out = {}
    cfg = get_config("wan2.1-1.3b")
    n = PLANNED_RANKS

    # (a) the launcher's entry point on 4 ranks, as a user runs it
    log("(a) python -m repro_torch.launch.train --arch wan2.1-1.3b --adaptive --workers 4 "
        "--dispatch lpt --steps 2")
    K.reset_launch_counts()
    hist = launch_train.main(["--arch", "wan2.1-1.3b", "--adaptive", "--workers", str(n),
                              "--dispatch", "lpt", "--steps", "2"])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    if not np.isfinite(hist.losses).all():
        raise AssertionError(f"planned launcher: a loss is not finite: {hist.losses}")
    if len(hist.plans) != 2 or any(p.n_workers != n for p in hist.plans):
        raise AssertionError(f"planned launcher: plans {hist.plans}")
    check_counts(counts, sum(hist.microbatches), cfg.n_layers, "planned launcher")
    want = planned_records(hist.records, hist.plans, set())
    log(f"  {len(want)} records name exactly the planned ranks and buckets of "
        f"{sum(hist.microbatches)} microbatches (the rest met their signature first)")
    out["launcher"] = dict(
        losses=hist.losses, step_s=hist.step_times, microbatches=hist.microbatches,
        launches=counts, plans=[[[(b.batch_size, b.seq_len) for b in p.worker_microbatches(w)]
                                 for w in range(n)] for p in hist.plans],
        records=[dataclasses.asdict(r) for r in hist.records])
    del hist
    torch.cuda.empty_cache()

    # (b) the paper's comparison: independent draws against the planned LPT
    # pool, 4 emulated ranks at 16384 tokens a rank, 10 of the 30 layers
    cfg = dataclasses.replace(cfg, n_layers=WAN_TRAIN_LAYERS)
    shapes, weights = wan_mixed_corpus()
    sel = [0, 2, 3]  # 480p image, 17 and 33 frames: S = 1637, 4757, 7877
    buckets = BucketingPolicy(m_mem=16384, m_comp=6.4e7, p=2.0).make_buckets(
        [shapes[i] for i in sel])
    weights = [weights[i] for i in sel]
    if [(b.seq_len, b.batch_size) for b in buckets] != [(1637, 10), (4757, 2), (7877, 1)]:
        raise AssertionError(f"unexpected buckets {buckets}")
    opt = OptimizerConfig(peak_lr=get_optimizer("wan2.1-1.3b").peak_lr, schedule="constant",
                          warmup=0, total_steps=1 + 3 * PLANNED_STEPS)
    state = init_state(cfg, opt, seed=0, device=dev)
    engine = EmulatedEngine(cfg, opt)
    trainer = Trainer(cfg, opt, engine=engine)
    rng = np.random.default_rng(0)

    def batch(b):
        return make_diffusion_batch(int(rng.integers(2**31)), b.batch_size, b.seq_len, cfg, dev)

    def items(shares_of_steps):
        # drawn in the trainer's thread between steps, off every event pair
        for shares in shares_of_steps:
            yield [[(b, batch(b)) for b in share] for share in shares]

    log(f"(b) {cfg.name} {cfg.n_layers} of 30 layers bf16, seed 0, {n} emulated ranks (run "
        f"serially on this card), buckets (S, B) {[(b.seq_len, b.batch_size) for b in buckets]}")
    K.reset_launch_counts()
    micro = 0
    # one warm-up step: every rank runs every bucket, rank 0 meets each first
    warm = [list(buckets)] * n
    state, h = trainer.run(state, items([warm]), 1, rng=1, log_every=0)
    micro += sum(h.microbatches)
    planned_records(h.records, [_fixed_plan(warm)], set())
    samples = [BenchSample(r.batch_size, r.seq_len, r.compute_time) for r in h.records]
    paper = fit_cost_model(samples)  # the paper's grid: p in [1.6, 2.4]
    fit = paper
    if paper.b <= 0:
        # the dual-constraint buckets' time falls as B·S^p rises at every p
        # of the grid: the grid widened down to p = 1 gives the planner and
        # the scheduler a slope (a finding, recorded beside the paper's fit)
        fit = fit_cost_model(samples, p_lo=1.0)
        if fit.b <= 0:
            raise AssertionError(f"no exponent in [1, 2.4] fits a positive slope: {fit}")
    for name, m in (("the paper's grid", paper), ("the fit used", fit)):
        log(f"  warm-up: t = a + b·B·S^p on {m.n_samples} CUDA-event records, {name}: a "
            f"{m.a * 1e3:.3f} ms, b {m.b:.4e}, p {m.p:.2f}, R² {m.r2:.4f}")
    out["fit_paper_grid"] = dataclasses.asdict(paper)
    out["fit"] = dataclasses.asdict(fit)

    sampler = CorpusSampler(buckets, weights)
    ind_rng = np.random.default_rng(1)
    independent = []
    for _ in range(PLANNED_STEPS):  # each rank draws to its own token budget
        shares = []
        for _w in range(n):
            share, acc = [], 0.0
            while acc < PLANNED_TOKENS:
                b = sampler.draw(ind_rng, 1)[0]
                share.append(b)
                acc += b.tokens
            shares.append(share)
        independent.append(_fixed_plan(shares))
    planner = StepPlanner(buckets, weights, n_workers=n, budget=float(PLANNED_TOKENS),
                          budget_of=lambda b: float(b.tokens), load_of=fit.load_of,
                          strategy="lpt", seed=1)
    planned = [planner.plan() for _ in range(PLANNED_STEPS)]
    seen = {(b.batch_size, b.seq_len) for b in buckets}
    regimes = {}
    for name, plans in (("independent", independent), ("planned/lpt", planned)):
        shares = [[p.worker_microbatches(w) for w in range(n)] for p in plans]
        t0 = time.perf_counter()
        state, h = trainer.run(state, items(shares), PLANNED_STEPS, rng=2, log_every=0)
        wall = time.perf_counter() - t0
        micro += sum(h.microbatches)
        planned_records(h.records, plans, set(seen))
        steps = []
        for i, plan in enumerate(plans):
            times = rank_times(h.records, i, n)
            loads = [sum(fit.load_of(b) for b in plan.worker_microbatches(w)) for w in range(n)]
            m = step_metrics(times, loads, plan.tokens)
            t = np.asarray(times)
            steps.append(dict(rank_s=times, cv=float(t.std() / t.mean()), cv_step=m.cv_step,
                              predicted_cv=m.compute_cv, tokens=plan.tokens,
                              slowest_s=m.step_time, step_s=h.step_times[i],
                              loss=h.losses[i]))
        summary = {key: float(np.mean([s[key] for s in steps])) for key in (
            "cv", "cv_step", "predicted_cv", "tokens", "slowest_s", "step_s")}
        regimes[name] = dict(summary, steps=steps, wall_s=wall)
        if not np.isfinite(h.losses).all():
            raise AssertionError(f"{name}: a loss is not finite: {h.losses}")
        log(f"  {name}: rank-time CV {summary['cv']:.3f}, CV_step {summary['cv_step']:.3f}, "
            f"predicted compute CV {summary['predicted_cv']:.3f}, {summary['tokens']:,.0f} "
            f"tokens a step, slowest rank {summary['slowest_s'] * 1e3:.1f} ms (summed serial "
            f"device times of emulated ranks, not a multi-card measurement)")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check_counts(counts, micro, cfg.n_layers, "planned comparison")
    bad = [nm for nm, prm in state["model"].named_parameters() if not torch.isfinite(prm).all()]
    if bad:
        raise AssertionError(f"parameters not finite after the updates: {bad[:5]}")
    out["comparison"] = dict(regimes=regimes, ranks=n, tokens_a_rank=PLANNED_TOKENS,
                             steps=PLANNED_STEPS, launches=counts, microbatches=micro,
                             emulated="ranks run serially on one card; rank times are summed "
                                      "CUDA-event microbatch times")

    # (c) the closed loop: the scheduler seeded with (b)'s fit, its planner
    # behind the sharded loader, the trainer feeding it every step's records
    sconf = SchedulerConfig(target_sync=fit.predict(buckets[0].batch_size, buckets[0].seq_len),
                            m_mem=16384, refit_interval=2, min_samples=8, dispatch="lpt")
    sched = AdaptiveLoadScheduler(sconf, [shapes[i] for i in sel], initial_model=fit,
                                  n_workers=n)
    planner = sched.make_planner(seed=0)
    log(f"(c) closed loop: M_comp {sched.policy.m_comp:.4e} from the fit, buckets (S, B) "
        f"{[(b.seq_len, b.batch_size) for b in sched.buckets]}")

    def make_batch(rng_np, b):
        return make_diffusion_batch(int(rng_np.integers(2**31)), b.batch_size, b.seq_len, cfg,
                                    dev)

    loader = ShardedBucketedLoader(sched.buckets, None, on_side_stream(make_batch, dev),
                                   n_workers=n, planner=planner, seed=0)
    K.reset_launch_counts()
    try:
        state, h = Trainer(cfg, opt, scheduler=sched, engine=engine).run(
            state, iter(loader), PLANNED_STEPS, rng=3, log_every=0)
        plans = loader.plans[:PLANNED_STEPS]
    finally:
        loader.close()
        sched.close()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check_counts(counts, sum(h.microbatches), cfg.n_layers, "closed loop")
    planned_records(h.records, plans, seen)
    if not np.isfinite(h.losses).all():
        raise AssertionError(f"closed loop: a loss is not finite: {h.losses}")
    samples = sched.telemetry.bench_samples()
    refit = fit_cost_model(samples) if len(samples) >= 3 else None
    updates = [dict(step=u.step, reason=u.reason, m_comp=u.m_comp,
                    buckets=[(b.seq_len, b.batch_size) for b in u.buckets]) for u in sched.updates]
    for u in updates:
        log(f"  PlanUpdate at step {u['step']}: {u['reason']}; M_comp {u['m_comp']:.4e}, "
            f"buckets {u['buckets']}")
    if refit is not None:
        log(f"  refit on {refit.n_samples} records: a {refit.a * 1e3:.3f} ms, b "
            f"{refit.b:.4e}, p {refit.p:.2f}, R² {refit.r2:.4f}; {len(updates)} plan updates; "
            f"the scheduler's model p {sched.model.p:.2f}")
    out["closed_loop"] = dict(
        losses=h.losses, step_s=h.step_times, microbatches=h.microbatches, launches=counts,
        updates=updates, refit=dataclasses.asdict(refit) if refit else None,
        model=dataclasses.asdict(sched.model), records=len(h.records),
        plans=[[[(b.batch_size, b.seq_len) for b in p.worker_microbatches(w)]
                for w in range(n)] for p in plans])
    del state, engine, trainer
    torch.cuda.empty_cache()
    return out


RESUME_LAYERS = 2  # phase 11: a checkpoint of ~1.2 GB (30 layers would write ~14 GB a save)
RESUME_STEPS = 6  # phase 11 (a): the uninterrupted run
RESUME_CHURN = "kill@1:2,3;join@3:2;preempt@4"  # phase 11 (b): stops after 5 steps


def phase_train_resume(K, dev) -> dict:
    """Phase 11: kill-and-resume and a churn cycle of Wan-2.1 training on
    emulated ranks, through the checkpoint store and the fault-tolerance
    runner."""
    import shutil

    from repro_torch.checkpoint import store
    from repro_torch.configs.registry import get_config, get_optimizer
    from repro_torch.core.bucketing import BucketingPolicy
    from repro_torch.data.pipeline import ShardedBucketedLoader, on_side_stream
    from repro_torch.data.synthetic import make_diffusion_batch, wan_mixed_corpus
    from repro_torch.distributed.chaos import ChaosSchedule
    from repro_torch.distributed.fault_tolerance import (
        CheckpointCadence,
        FaultTolerantRunner,
        HeartbeatMonitor,
        PreemptionNotice,
    )
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.loop import Trainer, deserialize_rng_key
    from repro_torch.train.steps import init_state

    n = PLANNED_RANKS
    cfg = dataclasses.replace(get_config("wan2.1-1.3b"), n_layers=RESUME_LAYERS)
    shapes, weights = wan_mixed_corpus()
    sel = [0, 2, 3]  # phase 10 (b)'s buckets: S = 1637, 4757, 7877
    buckets = BucketingPolicy(m_mem=16384, m_comp=6.4e7, p=2.0).make_buckets(
        [shapes[i] for i in sel])
    weights = [weights[i] for i in sel]
    opt = OptimizerConfig(peak_lr=get_optimizer("wan2.1-1.3b").peak_lr, schedule="constant",
                          warmup=0, total_steps=RESUME_STEPS)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"  # gitignored; removed below
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def make_batch(rng_np, b):
        return make_diffusion_batch(int(rng_np.integers(2**31)), b.batch_size, b.seq_len, cfg,
                                    dev)

    def loader_of(resume_state=None):
        return ShardedBucketedLoader(
            buckets, weights, on_side_stream(make_batch, dev), n_workers=n,
            budget=float(PLANNED_TOKENS), budget_of=lambda b: float(b.tokens),
            load_of=lambda b: b.load(2.0), strategy="lpt", seed=0, resume_state=resume_state)

    def train(state, loader, steps, *, rng, start_step=0, **kw):
        trainer = Trainer(cfg, opt, run_state_of=lambda held: {
            "loader": loader.state_dict(rewind=held)}, **kw)
        if trainer.ft is not None:
            trainer.ft.on_resize = trainer.set_physical_ranks  # --elastic remap
        try:
            state, hist = trainer.run(state, iter(loader), steps, rng=rng,
                                      start_step=start_step, log_every=0)
            digests = [p.digest().hex() for p in loader.plans[:len(hist.losses)]]
        finally:
            loader.close()
        return state, hist, digests

    saves = []

    class TimedRunner(FaultTolerantRunner):
        """The runner, with each checkpoint's wall seconds recorded."""

        def _save(self, state, step, run_state):
            t = time.perf_counter()
            super()._save(state, step, run_state)
            saves.append((step, time.perf_counter() - t))

    log(f"{cfg.name} {cfg.n_layers} of 30 layers {cfg.dtype}, seed 0, {n} emulated ranks on planned "
        f"LPT, buckets (S, B) {[(b.seq_len, b.batch_size) for b in buckets]}, "
        f"{PLANNED_TOKENS} tokens a rank")
    try:
        # (a) the uninterrupted run
        state_a, hist_a, digests_a = train(init_state(cfg, opt, seed=0, device=dev),
                                           loader_of(), RESUME_STEPS, rng=1)
        log(f"(a) uninterrupted: {RESUME_STEPS} steps, {sum(hist_a.microbatches)} "
            f"microbatches, losses {[round(x, 5) for x in hist_a.losses]}")

        # (b) the churn leg: kill 2 ranks after step 1, 2 join after step 3,
        # preempted after step 4 with the handoff checkpoint on disk
        ft = TimedRunner(ckpt_dir=str(ckpt_dir),
                         cadence=CheckpointCadence(1.0, 1.0, min_interval_steps=100),
                         monitor=HeartbeatMonitor(n, timeout_s=1e9), keep=1,
                         preemption=PreemptionNotice())
        K.reset_launch_counts()
        state_b, hist_b, digests_b = train(init_state(cfg, opt, seed=0, device=dev),
                                           loader_of(), RESUME_STEPS, rng=1, ft=ft,
                                           chaos=ChaosSchedule.from_spec(RESUME_CHURN))
        del state_b
        log(f"(b) {RESUME_CHURN}: {len(hist_b.losses)} steps, events {hist_b.events}")
        for want in ("chaos:kill:2,3@1", "join@3:2->4", "preempt@4"):
            if want not in hist_b.events:
                raise AssertionError(f"churn leg: no {want!r} in {hist_b.events}")
        if not hist_b.preempted or len(hist_b.losses) != 5:
            raise AssertionError(f"churn leg: {len(hist_b.losses)} steps, preempted "
                                 f"{hist_b.preempted}")
        step_dir = ckpt_dir / f"step-{5:09d}"
        ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())

        # (c) restore into a fresh state on the card, train the last step
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_state = store.load_run_state(ckpt_dir)
        state_c = store.restore(ckpt_dir, init_state(cfg, opt, seed=1, device=dev))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        if not state_c["step"] == run_state["step"] == 5:
            raise AssertionError(f"restored step {state_c['step']}, run state {run_state}")
        state_c, hist_c, digests_c = train(
            state_c, loader_of(run_state["loader"]), RESUME_STEPS - 5,
            rng=deserialize_rng_key(run_state["trainer"]["rng"]), start_step=5)
        torch.cuda.synchronize()
        counts = K.launch_counts()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    micro = sum(hist_b.microbatches) + sum(hist_c.microbatches)
    check_counts(counts, micro, cfg.n_layers, "train_resume (b) + (c)")
    if digests_b + digests_c != digests_a:
        raise AssertionError("the resumed plan digests differ from the uninterrupted run's")
    log(f"  plan digests of (b) + (c) equal (a)'s ({len(digests_a)} steps)")
    pairs = [(f"params/{nm}", p.detach(), state_a["model"].get_parameter(nm).detach())
             for nm, p in state_c["model"].named_parameters()]
    pairs += [(f"opt/{k}/{nm}", t, state_a["opt"][k][nm])
              for k in ("m", "v") for nm, t in state_c["opt"][k].items()]
    differ = [name for name, got, want in pairs if not torch.equal(got, want)]
    num = sum(float((got.double() - want.double()).square().sum()) for _, got, want in pairs)
    den = sum(float(want.double().square().sum()) for _, _, want in pairs)
    rel = (num / den) ** 0.5
    if differ:
        log(f"  NOT bitwise: {len(differ)} of {len(pairs)} tensors differ (first "
            f"{differ[:5]}), rel-L2 {rel:.3e}")
        if rel > 1e-5:
            raise AssertionError(f"resumed state rel-L2 {rel:.3e} > 1e-5 (the oracle gate)")
    else:
        log(f"  parameters and moments of (c) equal (a)'s bitwise ({len(pairs)} tensors)")
    if hist_b.losses + hist_c.losses != hist_a.losses:
        log(f"  losses differ: {hist_b.losses + hist_c.losses} vs {hist_a.losses}")
    for step, sec in saves:
        log(f"  checkpoint at step {step}: {sec:.3f} s")
    log(f"  handoff checkpoint: {ckpt_bytes:,} bytes ({ckpt_bytes / 2**30:.3f} GiB), restore "
        f"{restore_s:.3f} s (manifest, read, copy to the card)")
    del state_a, state_c
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, ranks=n, churn=RESUME_CHURN, events=hist_b.events,
                losses=dict(a=hist_a.losses, b=hist_b.losses, c=hist_c.losses),
                digests_equal=True, bitwise=not differ, differ=differ, rel_l2=rel,
                ckpt_bytes=ckpt_bytes, save_s=saves, restore_s=restore_s,
                microbatches=micro, launches=counts)


# -- phase 12: the Shape Benchmark and step plans across processes -------------

SHAPE_LAYERS = 2  # phase 12 (a): Wan-2.1 1.3B at full width, 2 of its 30 layers
SHAPE_S = (1637, 3677, 4757, 7877, 17237, 18077, 39677, 46877)  # wan_mixed_corpus's S
SHAPE_MAX_BATCH, SHAPE_M_MEM = 16, 196_608
MESH_WORLD, MESH_LAYERS, MESH_STEPS = 2, 2, 3  # phase 12 (c)
MESH_WAIT_S = 300  # phase 12 (c): the longest the parent waits for a process
DISPATCH_STEPS, DISPATCH_BLOCKS = 8, 3  # phase 12 (d): steps a run; blocks of 4 runs


def phase_shape_bench(K, dev) -> dict:
    """Phase 12 (a): the Shape Benchmark of Wan-2.1 1.3B on the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cost_model import fit_cost_model
    from repro_torch.core.shape_bench import (
        AnalyticDeviceModel,
        ModelDims,
        run_measured_benchmark,
        sweep_grid,
    )
    from repro_torch.data.synthetic import make_diffusion_batch
    from repro_torch.models.mmdit import MMDiT
    from repro_torch.train.steps import make_pool_grad_step

    cfg = dataclasses.replace(get_config("wan2.1-1.3b"), n_layers=SHAPE_LAYERS)
    model = MMDiT(cfg, seed=0, device=dev)
    grad_step = make_pool_grad_step(cfg)
    cells = sweep_grid(SHAPE_S, max_batch=SHAPE_MAX_BATCH, m_mem=SHAPE_M_MEM)
    warmup, iters = 1, 2
    log(f"(a) run_measured_benchmark: {cfg.name} {cfg.n_layers} of 30 layers {cfg.dtype}, seed "
        f"0, make_pool_grad_step; sweep_grid over S {list(SHAPE_S)}, max_batch "
        f"{SHAPE_MAX_BATCH}, m_mem {SHAPE_M_MEM}: {len(cells)} cells, warmup {warmup}, iters "
        f"{iters}")

    def args_factory(b, s):
        return (model, make_diffusion_batch(s * 7 + b, b, s, cfg, dev), 0, 0)

    def step(*args):
        grad_step(*args)

    K.reset_launch_counts()
    samples = run_measured_benchmark(step, args_factory, cells, warmup=warmup, iters=iters,
                                     device=dev)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    calls = len(cells) * (warmup + iters)
    check_counts(counts, calls, cfg.n_layers, "shape benchmark")
    t = np.array([x.step_time for x in samples])
    if not (np.isfinite(t).all() and (t > 0).all()):
        raise AssertionError(f"a cell's time is not finite and positive: {t}")
    paper = fit_cost_model(samples)
    wide = fit_cost_model(samples, p_lo=1.0)
    for name, m in (("paper's grid p in [1.6, 2.4]", paper), ("p_lo 1.0", wide)):
        log(f"  fit_cost_model, {name}: a {m.a * 1e3:.3f} ms, b {m.b:.4e}, p {m.p:.2f}, "
            f"R² {m.r2:.4f}")
    # the H100 model's three free constants by least squares on the relative
    # error (cells span 20 ms to 1.5 s): where compute exceeds memory,
    # step_time = overhead + (M / peak) / efficiency + (A / peak) /
    # attn_efficiency, linear in (overhead, 1/eff, 1/attn_eff)
    dims = ModelDims(cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim)
    base = AnalyticDeviceModel(dims)
    rows = np.array([[1.0, base.matmul_flops(x.batch_size, x.seq_len) / base.peak_flops,
                      base.attention_flops(x.batch_size, x.seq_len) / base.peak_flops]
                     for x in samples])
    (overhead, inv_eff, inv_attn), *_ = np.linalg.lstsq(rows / t[:, None], np.ones_like(t),
                                                        rcond=None)
    # for comparison: plain least squares on the absolute error, which the
    # long cells' seconds dominate
    plain_fit, *_ = np.linalg.lstsq(rows, t, rcond=None)
    rel_p = np.abs(rows @ plain_fit - t) / t
    log(f"  plain least squares (absolute error): overhead {plain_fit[0] * 1e3:.3f} ms, "
        f"efficiency {1 / plain_fit[1]:.4f}, attn_efficiency {1 / plain_fit[2]:.4f}; relative "
        f"error median {np.median(rel_p):.4f}, worst {rel_p.max():.4f}")
    model_h100 = AnalyticDeviceModel(dims, overhead=float(overhead), efficiency=1 / inv_eff,
                                     attn_efficiency=1 / inv_attn)
    pred = np.array([model_h100.step_time(x.batch_size, x.seq_len) for x in samples])
    defaults = AnalyticDeviceModel(dims)
    pred_d = np.array([defaults.step_time(x.batch_size, x.seq_len) for x in samples])
    rel = np.abs(pred - t) / t
    rel_d = np.abs(pred_d - t) / t
    memory_bound = [x for x in samples
                    if model_h100.bytes_moved(x.batch_size, x.seq_len) / model_h100.hbm_bw
                    >= model_h100.step_time(x.batch_size, x.seq_len) - model_h100.overhead]
    for x, p_ in zip(samples, pred):
        pf = paper.predict(x.batch_size, x.seq_len)
        log(f"  B {x.batch_size:2d} x S {x.seq_len:5d}: {x.step_time * 1e3:9.3f} ms; H100 model "
            f"{p_ * 1e3:9.3f} ms; a + b·B·S^p {pf * 1e3:9.3f} ms")
    log(f"  H100 model fit: overhead {overhead * 1e3:.3f} ms, efficiency {1 / inv_eff:.4f}, "
        f"attn_efficiency {1 / inv_attn:.4f}; relative error median {np.median(rel):.4f}, worst "
        f"{rel.max():.4f} ({len(memory_bound)} cells memory-bound); with the module's defaults "
        f"median {np.median(rel_d):.4f}, worst {rel_d.max():.4f}")
    del model
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, cells=[dict(batch=x.batch_size, seq=x.seq_len,
                                                 ms=x.step_time * 1e3, model_ms=p_ * 1e3)
                                            for x, p_ in zip(samples, pred)],
                fit_paper_grid=dataclasses.asdict(paper), fit_p_lo_1=dataclasses.asdict(wide),
                h100=dict(overhead_s=float(overhead), efficiency=float(1 / inv_eff),
                          attn_efficiency=float(1 / inv_attn), median_rel=float(np.median(rel)),
                          worst_rel=float(rel.max()), defaults_median_rel=float(np.median(rel_d)),
                          plain_lstsq=[float(x) for x in plain_fit],
                          plain_median_rel=float(np.median(rel_p)),
                          plain_worst_rel=float(rel_p.max()),
                          defaults_worst_rel=float(rel_d.max())),
                calls=calls, launches=counts)


def phase_mesh_nccl(K, dev) -> dict:
    """Phase 12 (b): the launcher's --mesh route at world 1 over NCCL."""
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as launch_train

    cfg = get_config("wan2.1-1.3b")
    store = tempfile.mktemp(prefix="mesh_store_", dir=ROOT / "build")
    # 4 steps: the launcher's one-microbatch steps over its 3 buckets meet a
    # signature again at the latest in the fourth, so the records are tested
    argv = ["--arch", "wan2.1-1.3b", "--adaptive", "--mesh", "--workers", "1", "--rank", "0",
            "--backend", "nccl", "--dist-store", store, "--steps", "4"]
    log(f"(b) python -m repro_torch.launch.train {' '.join(argv)}")
    K.reset_launch_counts()
    try:
        hist = launch_train.main(argv)
    finally:
        pathlib.Path(store).unlink(missing_ok=True)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    if not np.isfinite(hist.losses).all():
        raise AssertionError(f"mesh launcher: a loss is not finite: {hist.losses}")
    check_counts(counts, sum(hist.microbatches), cfg.n_layers, "mesh launcher (nccl, world 1)")
    want = planned_records(hist.records, hist.plans, set())
    if not want:
        raise AssertionError("mesh launcher: no step met a signature again: no record to check")
    log(f"  {len(want)} records name exactly the planned buckets of {sum(hist.microbatches)} "
        f"microbatches; losses {hist.losses}, step s {hist.step_times}")
    return dict(losses=hist.losses, step_s=hist.step_times, microbatches=hist.microbatches,
                launches=counts, records=len(want))


def _mesh_setup(dev, world: int = MESH_WORLD):
    """Phase 12 (c)'s configuration, loader, optimizer and initial state,
    the same in each process and in the parent's replay (phase 12 (d):
    the same at ``world`` 1)."""
    from repro_torch.configs.registry import get_config, get_optimizer
    from repro_torch.core.bucketing import BucketingPolicy
    from repro_torch.data.pipeline import ShardedBucketedLoader
    from repro_torch.data.synthetic import make_diffusion_batch, wan_mixed_corpus
    from repro_torch.distributed.plan_exec import DeferredBatch
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.steps import init_state

    cfg = dataclasses.replace(get_config("wan2.1-1.3b"), n_layers=MESH_LAYERS)
    shapes, weights = wan_mixed_corpus()
    sel = [0, 2, 3]  # phase 10 (b)'s buckets: S = 1637, 4757, 7877
    buckets = BucketingPolicy(m_mem=16384, m_comp=6.4e7, p=2.0).make_buckets(
        [shapes[i] for i in sel])
    if [(b.seq_len, b.batch_size) for b in buckets] != [(1637, 10), (4757, 2), (7877, 1)]:
        raise AssertionError(f"unexpected buckets {buckets}")
    opt = OptimizerConfig(peak_lr=get_optimizer("wan2.1-1.3b").peak_lr, schedule="constant",
                          warmup=0, total_steps=MESH_STEPS + 1)

    def make_batch(rng_np, b):
        return DeferredBatch(make_diffusion_batch,
                             (int(rng_np.integers(2**31)), b.batch_size, b.seq_len, cfg))

    loader = ShardedBucketedLoader(
        buckets, [weights[i] for i in sel], make_batch, n_workers=world,
        budget=float(PLANNED_TOKENS), budget_of=lambda b: float(b.tokens),
        load_of=lambda b: b.load(2.0), strategy="lpt", seed=0, prefetch=0)
    return cfg, opt, loader, init_state(cfg, opt, seed=0, device=dev)


def phase_mesh_dispatch(dev) -> dict:
    """Phase 12 (d): serial against async dispatch of ``Trainer(mesh=)`` at
    world 1 over NCCL, in ``DISPATCH_BLOCKS`` blocks of serial, async,
    async, serial (each block two pairs).  Each run starts from the same
    state and plan stream, so the losses must agree bitwise; the host's
    wall time a step (between the ends of consecutive steps, after the
    last step that met a batch signature first) is compared pair by
    pair."""
    import tempfile

    from repro_torch.launch.mesh import make_data_group
    from repro_torch.train.loop import Trainer

    order = ("serial", "async", "async", "serial") * DISPATCH_BLOCKS
    log(f"(d) Trainer(mesh=) at world 1 over NCCL, measure_ranks 'serial' (a synchronisation "
        f"after each microbatch, the next step fetched after this one) against 'async' (the "
        f"next step fetched and staged while the device computes): Wan-2.1 1.3B at "
        f"{MESH_LAYERS} layers, phase 10 (b)'s buckets, {PLANNED_TOKENS} tokens a step, "
        f"{DISPATCH_STEPS} steps a run, {DISPATCH_BLOCKS} blocks of serial async async serial")
    store = tempfile.mktemp(prefix="mesh_store_", dir=ROOT / "build")
    grp = make_data_group(rank=0, world_size=1, store=store, backend="nccl", device=dev)
    runs = []
    try:
        for mode in order:
            cfg, opt, loader, state = _mesh_setup(dev, world=1)
            trainer = Trainer(cfg, opt, mesh=grp, measure_ranks=mode)
            torch.cuda.synchronize()
            marks = [time.perf_counter()]
            try:
                state, hist = trainer.run(state, iter(loader), DISPATCH_STEPS, rng=1,
                                          log_every=0,
                                          on_metrics=lambda i, m: marks.append(
                                              time.perf_counter()))
            finally:
                loader.close()
            # steady state: the steps after the last that met a signature first
            first = max(max(hist.compile_steps, default=-1) + 1, 1)
            wall = np.diff(marks)[first:]
            step = np.array(hist.step_times[first:])
            runs.append(dict(mode=mode, losses=hist.losses, compile_steps=hist.compile_steps,
                             wall_ms=(wall * 1e3).tolist(), step_ms=(step * 1e3).tolist(),
                             median_wall_ms=float(np.median(wall) * 1e3)))
            log(f"  {mode:6s}: host wall a step, median {np.median(wall) * 1e3:.3f} ms over "
                f"{len(wall)} steps; the trainer's step time, median "
                f"{np.median(step) * 1e3:.3f} ms; compile steps {hist.compile_steps}")
            del state, trainer
            torch.cuda.empty_cache()
    finally:
        grp.close()
        pathlib.Path(store).unlink(missing_ok=True)
    for r in runs:
        if not np.isfinite(r["losses"]).all():
            raise AssertionError(f"dispatch {r['mode']}: a loss is not finite: {r['losses']}")
        if r["losses"] != runs[0]["losses"]:
            raise AssertionError(f"dispatch {r['mode']}: losses {r['losses']} differ from "
                                 f"serial's {runs[0]['losses']}")
    by = {m: np.array([r["median_wall_ms"] for r in runs if r["mode"] == m])
          for m in ("serial", "async")}
    wins = int((by["async"] < by["serial"]).sum())  # pairs in block order
    q1, q3 = np.percentile(by["serial"], [25, 75])
    med = {m: float(np.median(v)) for m, v in by.items()}
    log(f"  equal losses in all {len(runs)} runs; host wall a step, median of the runs' medians: "
        f"serial {med['serial']:.3f} ms, async {med['async']:.3f} ms, async/serial "
        f"{med['async'] / med['serial']:.4f}; async faster in {wins} of {len(by['async'])} "
        f"pairs; serial runs' quartiles {q1:.3f}-{q3:.3f} ms")
    return dict(layers=MESH_LAYERS, steps=DISPATCH_STEPS, runs=runs, wall_ms=med,
                async_over_serial=med["async"] / med["serial"], async_wins=wins,
                pairs=len(by["async"]), serial_quartiles_ms=[float(q1), float(q3)])


def mesh_child(rank: int, store: str, out: str) -> int:
    """One process of phase 12 (c): ``Trainer(mesh=)`` over gloo on the
    card, then a step whose digest process 1 perturbs."""
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import kernels as K
    from repro_torch.distributed.plan_exec import (
        PlanAgreementError,
        state_fingerprint,
        worker_steps_digest,
    )
    from repro_torch.launch.mesh import make_data_group
    from repro_torch.train.loop import Trainer

    dev = torch.device("cuda")
    grp = make_data_group(rank=rank, world_size=MESH_WORLD, store=store, backend="gloo",
                          device=dev, timeout_s=MESH_WAIT_S)
    res = {"rank": rank}
    try:
        cfg, opt, loader, state = _mesh_setup(dev)
        sums = []
        trainer = Trainer(cfg, opt, mesh=grp, measure_ranks="async")
        K.reset_launch_counts()
        try:
            state, hist = trainer.run(state, iter(loader), MESH_STEPS, rng=1, log_every=0,
                                      on_metrics=lambda i, m: sums.append(
                                          state_fingerprint(state).tolist()))
            extra = next(loader)
            plans = loader.plans[:MESH_STEPS]
        finally:
            loader.close()
        torch.cuda.synchronize()
        res["launches"] = K.launch_counts()
        res["losses"] = hist.losses
        res["step_s"] = hist.step_times
        res["records"] = [dataclasses.astuple(r) for r in hist.records]
        res["digests"] = [p.digest().hex() for p in plans]
        res["sums"] = sums
        res["microbatches"] = [len(p.worker_microbatches(rank)) for p in plans]
        # the rank times of the last step, from the engine
        res["rank_s"] = trainer.engine.rank_times
        ws = [list(share) for share in extra]
        digest = bytes(32) if rank == 1 else worker_steps_digest(ws)
        try:
            trainer.engine.executor.execute(state, ws, step_key=99, step=MESH_STEPS,
                                            digest=digest)
            res["agreement"] = "no error"
        except PlanAgreementError as e:
            res["agreement"] = f"PlanAgreementError: {e}"
        torch.save({"params": {n: p.detach() for n, p in state["model"].named_parameters()},
                    "m": state["opt"]["m"], "v": state["opt"]["v"]}, out + ".pt")
        pathlib.Path(out).write_text(json.dumps(res))
    finally:
        grp.close()
    return 0


def phase_mesh_gloo(K, dev) -> dict:
    """Phase 12 (c): 2 processes on the one card over gloo, held bitwise
    to a single-process replay of the same sums."""
    from repro_torch.distributed.plan_exec import oracle_step, place_batch, rel_l2
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.train.loop import split_key
    from repro_torch.train.steps import decay_rule, init_state, make_pool_grad_step

    import shutil

    work = ROOT / "build" / "chip_smoke_mesh"  # gitignored; removed below
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    log_dir = ROOT / "chiprun_out"
    log_dir.mkdir(exist_ok=True)
    log(f"(c) Trainer(mesh=) on {MESH_WORLD} processes over gloo on this one card: Wan-2.1 1.3B "
        f"at full width and {MESH_LAYERS} of 30 layers, bf16, seed 0, phase 10 (b)'s buckets, "
        f"LPT at {PLANNED_TOKENS} tokens a rank, {MESH_STEPS} steps")
    t0 = time.perf_counter()
    procs = []
    try:
        for r in range(MESH_WORLD):
            with open(log_dir / f"chip_smoke_mesh_rank{r}.log", "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(pathlib.Path(__file__).resolve()), "--mesh-rank",
                     str(r), "--store", str(work / "store"), "--out", str(work / f"rank{r}.json")],
                    cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
        codes = [p.wait(timeout=MESH_WAIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    spawn_s = time.perf_counter() - t0
    if any(codes):
        tails = [(log_dir / f"chip_smoke_mesh_rank{r}.log").read_text()[-3000:]
                 for r in range(MESH_WORLD)]
        raise AssertionError(f"a mesh process failed: exit codes {codes}\n" + "\n".join(tails))
    res = [json.loads((work / f"rank{r}.json").read_text()) for r in range(MESH_WORLD)]
    finals = [torch.load(work / f"rank{r}.json.pt", map_location=dev) for r in range(MESH_WORLD)]
    log(f"  both processes exited 0 after {spawn_s:.1f} s (start-up, kernels loaded from the "
        f"build, {MESH_STEPS} steps, the agreement step)")
    for r in res:
        if not r["agreement"].startswith("PlanAgreementError"):
            raise AssertionError(f"process {r['rank']}: the perturbed digest gave {r['agreement']}")
    log(f"  the perturbed digest of process 1: {res[0]['agreement'][:80]}... on both processes")
    if res[0]["digests"] != res[1]["digests"]:
        raise AssertionError("the processes' plan digests differ")
    if res[0]["sums"] != res[1]["sums"]:
        bad = [i for i, (a, b) in enumerate(zip(res[0]["sums"], res[1]["sums"])) if a != b]
        raise AssertionError(f"parameters or moments differ between the processes after steps {bad}")
    if res[0]["records"] != res[1]["records"]:
        raise AssertionError("the processes hold different records")
    if res[0]["losses"] != res[1]["losses"]:
        raise AssertionError(f"losses differ: {res[0]['losses']} vs {res[1]['losses']}")
    for r in res:
        check_counts(r["launches"], sum(r["microbatches"]), MESH_LAYERS,
                     f"process {r['rank']} ({sum(r['microbatches'])} microbatches of its shares)")
    for name in ("params", "m", "v"):
        for n, t in finals[0][name].items():
            if not torch.equal(t, finals[1][name][n]):
                raise AssertionError(f"final {name}/{n} differs between the processes")
    log(f"  after every step both processes' parameters and moments agree (bit sums of "
        f"{len(res[0]['sums'][0]) - 1} tensors and the step), the final states bitwise, the "
        f"records and losses equal")

    # the single-process replay: each rank's share summed in the
    # parameters' dtype, lifted to f32, the two rank sums added, AdamW
    cfg, opt, loader, state = _mesh_setup(dev)
    _, _, loader_o, state_o = _mesh_setup(dev)
    grad_step = make_pool_grad_step(cfg)
    decay = decay_rule(cfg)
    rng = 1
    try:
        for step in range(MESH_STEPS):
            ws = next(loader)
            ws_o = next(loader_o)
            rng, sub = split_key(rng)
            model = state["model"]
            sums, index = [], 0
            for share in ws:
                acc = None
                for _bucket, batch in share:
                    _, grads = grad_step(model, place_batch(batch, dev), sub, index)
                    index += 1
                    if acc is None:
                        acc = grads
                    else:
                        for n, g in grads.items():
                            acc[n].add_(g)
                sums.append(acc)
            grads = {n: (sums[0][n].float() + sums[1][n].float()) / index for n in sums[0]}
            adamw_update(dict(model.named_parameters()), grads, state["opt"], state["step"],
                         opt, decay=decay)
            state["step"] += 1
            del sums, grads
            state_o, _ = oracle_step(cfg, opt, state_o, ws_o, step_key=sub)
    finally:
        loader.close()
        loader_o.close()
    replay = {"params": dict(state["model"].named_parameters()), "m": state["opt"]["m"],
              "v": state["opt"]["v"]}
    differ = [f"{k}/{n}" for k in ("params", "m", "v") for n, t in replay[k].items()
              if not torch.equal(t.detach(), finals[0][k][n])]
    if differ:
        rel = rel_l2({k: {n: finals[0][k][n] for n in replay[k]} for k in replay},
                     {k: {n: t.detach() for n, t in replay[k].items()} for k in replay})
        raise AssertionError(f"not bitwise the single-process replay: {len(differ)} tensors "
                             f"differ (first {differ[:5]}), rel-L2 {rel:.3e}")
    oracle = {"params": {n: p.detach() for n, p in state_o["model"].named_parameters()},
              "m": state_o["opt"]["m"], "v": state_o["opt"]["v"]}
    rel_o = {k: rel_l2({n: finals[0][k][n] for n in oracle[k]}, oracle[k]) for k in oracle}
    log(f"  bitwise the single-process replay ({3 * len(replay['params'])} tensors); rel-L2 to "
        f"oracle_step (the whole pool summed in bf16 in one order): params "
        f"{rel_o['params']:.3e}, m {rel_o['m']:.3e}, v {rel_o['v']:.3e}")
    for r in res:
        log(f"  process {r['rank']}: microbatches {r['microbatches']}, step s "
            f"{[round(x, 4) for x in r['step_s']]}, last step's rank times "
            f"{[round(x, 4) for x in r['rank_s']]} (two processes contending for one card: "
            f"not a balance measurement)")
    flat_bytes = 4 * sum(-(-t.numel() // 64) * 64 for t in replay["params"].values())
    log(f"  the all_reduce buffer: {flat_bytes:,} bytes of f32 a step")
    shutil.rmtree(work, ignore_errors=True)
    del state, state_o, finals
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in res) for k in res[0]["launches"]}
    return dict(world=MESH_WORLD, layers=MESH_LAYERS, steps=MESH_STEPS, spawn_s=spawn_s,
                losses=res[0]["losses"], digests=res[0]["digests"],
                step_s=[r["step_s"] for r in res], rank_s=[r["rank_s"] for r in res],
                microbatches=[r["microbatches"] for r in res], bitwise_replay=True,
                rel_l2_oracle=rel_o, allreduce_bytes=flat_bytes, agreement=res[0]["agreement"],
                launches=launches, launches_by_process=[r["launches"] for r in res])


def _fixed_plan(shares):
    """A ``StepPlan`` that deals ``shares`` (bucket lists, one a rank) as
    they stand: the independent regime's and the warm-up's dispatch."""
    from repro_torch.core.dispatch import StepPlan

    pool, groups = [], []
    for share in shares:
        groups.append(tuple(range(len(pool), len(pool) + len(share))))
        pool.extend(share)
    return StepPlan(microbatches=tuple(pool), assignments=tuple(groups),
                    loads=tuple(0.0 for _ in pool), strategy="independent")


# -- phase 13: contiguous LM serving, Mamba-2's recurrent decode, two dense configs --

SSM_SERVE_B, SSM_SERVE_S, SSM_SERVE_NEW = 4, 2048, 32  # phase 13 (a): prompts, decode steps
SSM_F32_NEW = 8  # phase 13 (a): decode steps of the f32 check at full depth
# rel-L2 of the logits of two computations of one model that round
# different values: the kernels against their plain versions (another
# order of f32 sums), the recurrent decode against the chunked scan (the
# forward's conv sums in bf16, the decode's in f32), K12's bf16 p against
# the plain f32 softmax.  In bf16 each layer's roundings (2^-9 relative)
# then differ and the layers amplify the differences.  Unrelated logits (a
# lost cache, a wrong position, a k not written) give about sqrt(2).
# - dense_bf16: Qwen2.5-14B and MiniCPM-2B, 40-48 layers: about 1e-2;
# - ssm_bf16: Mamba-2 2.7B, 64 layers, amplifies them most: the prefill's
#   kernels against plain (one computation, the f32 sums of the norms in
#   another order) differ by 5e-2 and the decode against the forward by up
#   to 1.2e-1 after 32 steps (the state carries them; PERF.md); 0.25 is
#   twice that;
# - hybrid_bf16: RecurrentGemma-9B, 38 layers (phase 14), the decode
#   against the forward: the prefill's RG-LRU conv sums its 4 taps in bf16
#   and the decode's in f32, and the recurrent layers carry the differences
#   as Mamba-2's do; read 6.7e-2 after 64 steps (PERF.md), so Mamba-2's
#   0.25;
# - hybrid_kernels_bf16: the same model, the kernels against their plain
#   versions on the same tokens (only the norms' f32 sums differ): read
#   3.5e-2 (prefill) and 4.2e-2 (decode) (PERF.md), so 0.1;
# - f32, the whole 64-layer Mamba-2 again: only the order of f32 sums
#   differs (2^-24 amplified as above gives about 1e-6), so 1e-4 holds the
#   decode to the forward tightly, and bf16 anywhere would fail it.
SERVE_TOL = {"dense_bf16": 5e-2, "ssm_bf16": 0.25, "hybrid_bf16": 0.25,
             "hybrid_kernels_bf16": 0.1, "f32": 1e-4}
CONTIG_PER_CALL = {  # launches of one contiguous prefill and one decode step, per layer L
    "attn": {"prefill": lambda L: {"rms_fwd": 2 * L + 1, "flash_fwd": L},
             "step": lambda L: {"rms_fwd": 2 * L + 1}},
    "ssm": {"prefill": lambda L: {"rms_fwd": L + 1, "gated_rms_fwd": L},
            "step": lambda L: {"rms_fwd": L + 1, "gated_rms_fwd": L}},
    # RG-LRU and local blocks: norm1 and norm2 a layer, the final norm
    "hybrid": {"prefill": lambda L: {"rms_fwd": 2 * L + 1},
               "step": lambda L: {"rms_fwd": 2 * L + 1}},
    # MusicGen's attention blocks: the LayerNorm is plain, the decode
    # attention too
    "layernorm": {"prefill": lambda L: {"flash_fwd": L}, "step": lambda L: {}},
}


def contig_want(kind: str, n_layers: int, prefills: int, steps: int) -> dict[str, int]:
    want: dict[str, int] = {}
    for call, n in (("prefill", prefills), ("step", steps)):
        for name, per in CONTIG_PER_CALL[kind][call](n_layers).items():
            want[name] = want.get(name, 0) + n * per
    return want


def check_exact(counts: dict, want: dict, what: str) -> None:
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {n} times, expected {want.get(name, 0)}")
    log(f"  {what}: every launch count exact ({ {k: v for k, v in want.items() if v} })")


def device_busy(fn) -> dict:
    """The device's busy time over one call of ``fn`` (a whole decode step,
    whose launches outnumber what the device's queue holds behind a
    sleeping kernel) and the idle share of the window from its first kernel
    to its last, from ``torch.profiler`` (``profile_serve.profile``; its
    CPU tracing slows the host a little, so the idle share is an upper
    estimate)."""
    from repro_torch.launch.profile_serve import profile

    fn()
    torch.cuda.synchronize()
    b = profile(fn)
    return {k: b[k] for k in ("busy_ms", "window_ms", "idle_share", "device_ms_by_family")}


def phase_kernels_serve(dev) -> dict:
    """Phase 13, the kernels at the new serving shapes against their plain
    versions, timed: K4 rows at Qwen2.5-14B's d 5120 and MiniCPM-2B's 2304
    (a 1024-token prefill and a decode wave of 4) and at Mamba-2's decode
    rows, K13 at Mamba-2's decode (x [4, 1, 5120], the gate strided), K7 at
    the two prefills (GQA 5 at dh 128; MHA 36 x 64) and K12 at their decode
    waves (4 slots up to 1056 tokens, pages of 16)."""
    from repro_torch.kernels.flash_attention.flash import BOUND_TILE, flash_fwd, live_tile_pairs
    from repro_torch.kernels.flash_attention.paged import paged_decode
    from repro_torch.kernels.flash_attention.ref import attention_ref, paged_attention_ref
    from repro_torch.kernels.fused_rmsnorm.ref import gated_rms_norm_ref, rms_norm_ref
    from repro_torch.kernels.fused_rmsnorm.rmsnorm import gated_rms_fwd, rms_fwd
    from repro_torch.launch.time_paged import paged_case, paged_work

    g = torch.Generator(device=dev).manual_seed(13)
    rng = np.random.default_rng(13)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    def report(name, t):
        log(f"  {name}: ms {t['ms']:.4f}  plain {t['plain_ms']:.4f}  library "
            f"{'none' if t['library_ms'] is None else format(t['library_ms'], '.4f')}  bound "
            f"{t['bound_ms']:.4f} ({t['bound_by']}, {t['bytes'] / 1e6:.3f} MB, "
            f"{t['flops'] / 1e9:.3f} GFLOP)  share {t['bound_ms'] / t['ms']:.1%}")

    out = {"rms_fwd": {}, "flash_fwd": {}, "paged_decode": {}}
    log("K4 rms_fwd (rows) bf16 at the new widths: qwen [1, 1024, 5120] and [4, 1, 5120], "
        "minicpm [1, 1024, 2304] and [4, 1, 2304], mamba2 decode [4, 1, 2560]")
    for nm, shape in (("qwen_prefill", (1, 1024, 5120)), ("qwen_decode", (4, 1, 5120)),
                      ("minicpm_prefill", (1, 1024, 2304)), ("minicpm_decode", (4, 1, 2304)),
                      ("mamba2_decode", (4, 1, 2560))):
        d = shape[-1]
        x, w = randn(*shape, dtype=torch.bfloat16, scale=2.0, shift=0.3), randn(d, scale=0.1, shift=1.0)
        (y, r), (yr, rr) = rms_fwd(x, w), rms_norm_ref(x, w)
        torch.cuda.synchronize()
        err = max_err(y, yr)
        check(f"K4 rows y {nm}", err, TOL["norm_bf16"])
        check(f"K4 rows rstd {nm}", max_err(r, rr), TOL["stat"])
        wl = w.to(x.dtype)
        t = dict(shape=list(shape), max_abs_err=err, ms=device_ms(lambda: rms_fwd(x, w), 50),
                 plain_ms=device_ms(lambda: rms_norm_ref(x, w), 10),
                 # yardstick only, never on the port's path: the library norm
                 library_ms=device_ms(lambda: F.rms_norm(x, (d,), wl, 1e-6), 50),
                 bytes=2 * x.numel() * 2 + x.numel() // d * 4 + d * 4, flops=4 * x.numel())
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"], F32_FLOPS)
        out["rms_fwd"][nm] = t
        report(f"K4 rows {nm}", t)

    n, di = SSM_SERVE_B, SSM_DI
    log(f"K13 gated_rms_fwd at Mamba-2's decode: x [{n}, 1, {di}] bf16, g the z slice of an "
        f"in_proj output [{n}, 1, {SSM_PROJ}] (row stride {SSM_PROJ}), w [{di}] f32")
    x = randn(n, 1, di, dtype=torch.bfloat16)
    gz = randn(n, 1, SSM_PROJ, dtype=torch.bfloat16)[:, 0, :di][:, None, :]
    w = randn(di, scale=0.1, shift=1.0)
    (y, r), (yr, rr) = gated_rms_fwd(x, w, gz), gated_rms_norm_ref(x, w, gz)
    torch.cuda.synchronize()
    err = check_rel("K13 y decode (bf16)", y, yr, BWD_TOL["grad_bf16"])
    check("K13 rstd decode", max_err(r, rr), TOL["stat"])
    t = dict(shape=[n, 1, di], max_abs_err=err, ms=device_ms(lambda: gated_rms_fwd(x, w, gz), 50),
             plain_ms=device_ms(lambda: gated_rms_norm_ref(x, w, gz), 10), library_ms=None,
             bytes=3 * n * di * 2 + n * 4 + di * 4, flops=10 * n * di)
    t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"], F32_FLOPS)
    out["gated_rms_fwd"] = {"mamba2_decode": t}
    report("K13 mamba2_decode", t)

    for nm, hq, hkv, dh in (("qwen", 40, 8, 128), ("minicpm", 36, 36, 64)):
        s = 1024
        log(f"K7 flash_fwd at the {nm} prefill: q [1, {s}, {hq}, {dh}], k, v [1, {s}, {hkv}, "
            f"{dh}] bf16 (views of qkv [1, {s}, {(hq + 2 * hkv) * dh}]), causal")
        qkv = randn(1, s, (hq + 2 * hkv) * dh, dtype=torch.bfloat16)
        q = qkv[..., : hq * dh].reshape(1, s, hq, dh)
        k = qkv[..., hq * dh : (hq + hkv) * dh].reshape(1, s, hkv, dh)
        v = qkv[..., (hq + hkv) * dh :].reshape(1, s, hkv, dh)
        (o, lse), (o_r, lse_r) = flash_fwd(q, k, v, causal=True), attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_err(o, o_r)
        check(f"K7 {nm} prefill out", err, TOL["attn_bf16"])
        check(f"K7 {nm} prefill lse", max_err(lse, lse_r), TOL["lse_bf16"])
        tiles = live_tile_pairs(s, s, causal=True) * hq
        t = dict(shape=f"q [1, {s}, {hq}, {dh}], kv heads {hkv}", max_abs_err=err,
                 ms=device_ms(lambda: flash_fwd(q, k, v, causal=True), 20),
                 plain_ms=device_ms(lambda: attention_ref(q, k, v, causal=True), 3),
                 # yardstick only, never on the port's path: the library's causal attention
                 library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                     q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                     enable_gqa=hq != hkv), 20),
                 bytes=2 * q.numel() * 2 + 2 * k.numel() * 2 + hq * s * 4,
                 flops=tiles * 4 * BOUND_TILE ** 2 * dh, live_tile_pairs=tiles)
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"], BF16_FLOPS)
        out["flash_fwd"][f"{nm}_prefill"] = t
        report(f"K7 {nm}_prefill", t)
        del qkv, q, k, v, o, o_r

        lens = [int(x) for x in rng.integers(64, 1057, size=4)]
        log(f"K12 paged_decode at the {nm} wave: q [4, {hq}, {dh}], pages of 16 [.., 16, {hkv}, "
            f"{dh}] bf16, 256 entries a table row, kv_lens {lens}")
        q, kp, vp, tables, kv_lens = paged_case(dev, g, rng, lens, hq, hkv, dh, LM_PAGE,
                                                torch.bfloat16, pages_max=256, spare=64)
        args = (q, kp, vp, tables[0], kv_lens)
        o, o_r = paged_decode(*args), paged_attention_ref(*args)
        torch.cuda.synchronize()
        err = max_err(o, o_r)
        check(f"K12 {nm} wave out", err, TOL["attn_bf16"])
        check_slots(f"K12 {nm} wave out", o, o_r, TOL["attn_bf16_slot"])
        nbytes, flops = paged_work(*args)
        t = dict(shape=f"q [4, {hq}, {dh}], pool {list(kp.shape)}, kv_lens {lens}",
                 max_abs_err=err, ms=device_ms(lambda: paged_decode(*args), 50),
                 plain_ms=device_ms(lambda: paged_attention_ref(*args), 3), library_ms=None,
                 bytes=nbytes, flops=flops)
        t["bound_ms"], t["bound_by"] = bound(nbytes, flops, F32_FLOPS)
        out["paged_decode"][f"{nm}_wave"] = t
        report(f"K12 {nm}_wave", t)
    return out


def phase_serve_ssm(K, dev) -> dict:
    """Phase 13 (a): Mamba-2 2.7B at full width and depth serves 4 prompts
    of 2048 tokens and 32 greedy decode steps through ``make_prefill_step``
    / ``make_decode_step``; kernels against ``ops="plain"`` teacher-forced
    on the same tokens, the recurrent decode against one chunked forward
    over the extended sequence, and the same model in f32 against the
    forward."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = get_config("mamba2-2.7b")
    L, b, s, new = cfg.n_layers, SSM_SERVE_B, SSM_SERVE_S, SSM_SERVE_NEW
    t0 = time.perf_counter()
    model = T.Transformer(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"(a) {cfg.name}: {L} layers, d {cfg.d_model}, {cfg.dtype}, seed 0 (init "
        f"{time.perf_counter() - t0:.1f} s); {b} prompts of {s} tokens, {new} greedy decode steps")
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
    prefill, decode = make_prefill_step(cfg, s + new), make_decode_step(cfg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(new + 2)]
    ev[0].record()
    logits, caches = prefill(model, tokens)
    ev[1].record()
    torch.cuda.synchronize()  # the first tokens are ready before decoding starts
    caches0 = caches
    got = [logits]
    t0 = time.perf_counter()
    for i in range(new):
        logits, caches = decode(model, caches, got[-1].argmax(dim=-1, keepdim=True).int(), s + i)
        ev[i + 2].record()
        got.append(logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_exact(counts, contig_want("ssm", L, 1, new), f"prefill + {new} decode steps")
    if not all(bool(torch.isfinite(lg).all()) for lg in got):
        raise AssertionError("Mamba-2 serving gave non-finite logits")
    prefill_ms = ev[0].elapsed_time(ev[1])
    step_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(new)]
    cache_bytes = sum(t.numel() * t.element_size() for c in caches for t in c.values())
    first = got[0].argmax(dim=-1, keepdim=True).int()
    busy = device_busy(lambda: decode(model, caches0, first, s))
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    state_bytes = sum(c["state"].numel() * 4 for c in caches)
    bound_ms = (weight_bytes + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"  prefill {prefill_ms:.1f} ms ({b * s / prefill_ms * 1e3:.0f} tokens/s); decode "
        f"{wall / new * 1e3:.2f} ms a step on the host's clock ({b * new / wall:.1f} tokens/s), "
        f"{np.median(step_ms):.2f} ms median between events; one step profiled: device busy "
        f"{busy['busy_ms']:.3f} ms of {busy['window_ms']:.3f} (idle {busy['idle_share']:.1%}); "
        f"bound {bound_ms:.3f} ms (weights {weight_bytes / 1e9:.3f} GB, state "
        f"{state_bytes / 1e6:.1f} MB read and written); caches {cache_bytes / 1e6:.1f} MB; "
        f"peak {peak:.2f} GiB")

    # the kernels against their plain versions, teacher-forced on the same tokens
    forced = [lg.argmax(dim=-1, keepdim=True).int() for lg in got[:new]]
    with torch.inference_mode():
        lg, pc = T.prefill(model, tokens, s + new, ops="plain")
        plain = [lg]
        for i in range(new):
            lg, pc = T.decode_step(model, pc, forced[i], s + i, ops="plain")
            plain.append(lg)
        del pc
        # the reference's oracle: one chunked forward over the extended sequence
        h, _ = model(torch.cat([tokens, *forced], dim=1))
        oracle = (h[:, s - 1 :] @ model.embed.T).float()  # [B, new + 1, V]
    rel_plain = [rel_l2(a, p_) for a, p_ in zip(got, plain)]
    rel_fwd = [rel_l2(a, oracle[:, i]) for i, a in enumerate(got)]
    log(f"  logits rel-L2, kernels vs plain: prefill {rel_plain[0]:.3e}, decode max "
        f"{max(rel_plain[1:]):.3e} (tol {SERVE_TOL['ssm_bf16']})")
    log(f"  logits rel-L2, decode vs the chunked forward over {s + new} tokens: prefill "
        f"{rel_fwd[0]:.3e}, decode max {max(rel_fwd[1:]):.3e}, median "
        f"{float(np.median(rel_fwd[1:])):.3e} (tol {SERVE_TOL['ssm_bf16']})")
    if max(rel_plain) > SERVE_TOL["ssm_bf16"] or max(rel_fwd) > SERVE_TOL["ssm_bf16"]:
        raise AssertionError(f"Mamba-2 serving disagrees: {rel_plain} {rel_fwd}")
    del model, caches, caches0, got, plain, h, oracle
    torch.cuda.empty_cache()

    # the same model in f32: decode against the chunked forward
    m2 = T.Transformer(dataclasses.replace(cfg, dtype="float32"), seed=0, device=dev)
    with torch.inference_mode():
        lg, c2 = T.prefill(m2, tokens, s + SSM_F32_NEW)
        got2 = [lg]
        for i in range(SSM_F32_NEW):
            lg, c2 = T.decode_step(m2, c2, got2[-1].argmax(dim=-1, keepdim=True).int(), s + i)
            got2.append(lg)
        ext = torch.cat([tokens, *[x.argmax(dim=-1, keepdim=True).int()
                                   for x in got2[:SSM_F32_NEW]]], dim=1)
        h2, _ = m2(ext)
        oracle2 = (h2[:, s - 1 :] @ m2.embed.T).float()
    rel_f32 = [rel_l2(a, oracle2[:, i]) for i, a in enumerate(got2)]
    log(f"  f32, {L} layers: decode vs the chunked forward over {s + SSM_F32_NEW} tokens, "
        f"rel-L2 prefill {rel_f32[0]:.3e}, decode max {max(rel_f32[1:]):.3e} "
        f"(tol {SERVE_TOL['f32']:.0e})")
    if max(rel_f32) > SERVE_TOL["f32"]:
        raise AssertionError(f"Mamba-2 f32 decode disagrees with the forward: {rel_f32}")
    del m2, c2, h2, oracle2
    torch.cuda.empty_cache()
    return dict(launches=counts, prefill_ms=prefill_ms, decode_ms_wall=wall / new * 1e3,
                decode_ms_events=step_ms, decode_step_profile=busy,
                tokens_per_s=b * new / wall, decode_bound_ms=bound_ms, weight_bytes=weight_bytes,
                cache_bytes=cache_bytes, state_bytes=state_bytes, peak_gib=peak,
                rel_l2_plain=rel_plain, rel_l2_forward=rel_fwd, rel_l2_f32_forward=rel_f32)


def _recording_engine():
    """The LM engine as it is, keeping each request's logits (its prefill's,
    then its row of each decode wave it advances in), CUDA events around
    each call, and the arguments of the widest wave."""
    from repro_torch.serve import ServeEngine

    class RecordingEngine(ServeEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.logits_of, self.calls, self.widest = {}, {"prefill": [], "decode": []}, None
            prefill, decode = self._prefill, self._decode
            self.raw_decode = decode

            def run(kind, fn, args, rows):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                logits, pools = fn(*args)
                b.record()
                self.calls[kind].append((len(rows), args[1].shape[1] if kind == "prefill" else
                                         None, a, b))
                for row, rid in rows:
                    self.logits_of.setdefault(rid, []).append(logits[row])
                return logits, pools

            def rec_prefill(*args):
                return run("prefill", prefill, args, [(0, self._admitting.rid)])

            def rec_decode(*args):
                rows = [(r.slot, r.rid) for r in self._running]
                if self.widest is None or len(rows) > len(self.widest[1]):
                    self.widest = (args, rows)
                return run("decode", decode, args, rows)

            self._prefill, self._decode = rec_prefill, rec_decode

        def _start(self, r):
            self._admitting = r
            super()._start(r)

        def step(self):
            # the slots a wave advances: those running before this step's
            # admissions (a fresh prefill joins the next wave)
            self._running = [r for r in self.slot_req if r is not None]
            return super().step()

    return RecordingEngine


def phase_serve_dense(K, dev, arch: str, n_contig: int) -> dict:
    """Phase 13 (b), (c): the launcher serves 8 requests of ``arch`` at full
    width and depth (bf16, seed 0) on the paged engine, then the first
    ``n_contig`` requests run through contiguous prefill and decode,
    teacher-forced on the engine's tokens: logits rel-L2 a request, greedy
    disagreements with their top-2 margins, exact launch counts; prefill
    and wave ms, a wave's device time, the contiguous step's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = get_config(arch)
    L = cfg.n_layers
    argv = ["--arch", arch, "--requests", "8", "--gen", "32", "--max-seq", "4096"]
    log(f"python -m repro_torch.launch.serve {' '.join(argv)}  ({L} layers, d {cfg.d_model}, "
        f"Hq {cfg.n_heads}, Hkv {cfg.n_kv_heads}, dh {cfg.head_dim}, vocab {cfg.vocab}, {cfg.dtype})")
    engine = launch_serve.ServeEngine
    launch_serve.ServeEngine = _recording_engine()
    try:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        eng = launch_serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        launch_serve.ServeEngine = engine
    counts = K.launch_counts()
    done = sorted(eng.done, key=lambda r: r.rid)
    if len(done) != 8 or any(len(r.out) != r.max_new for r in done):
        raise AssertionError(f"{arch}: not every request finished with its max_new tokens")
    prefills, waves = check_lm_counts(counts, eng, L, "launcher")
    model = eng.model
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prefill_ms = {}
    for _, width, a, b in eng.calls["prefill"]:
        prefill_ms.setdefault(width, []).append(a.elapsed_time(b))
    wave_ms = [a.elapsed_time(b) for _, _, a, b in eng.calls["decode"]]
    wave_slots = [n for n, _, _, _ in eng.calls["decode"]]
    args, rows = eng.widest
    wave_busy = device_busy(lambda: eng.raw_decode(*args))
    widest_ms = float(np.median([ms for ms, n in zip(wave_ms, wave_slots) if n == len(rows)]))
    log(f"  {n_params / 1e9:.3f} B params ({weight_bytes / 1e9:.2f} GB); prompts "
        f"{[r.prompt_len for r in done]}, new tokens {[r.max_new for r in done]}; {prefills} "
        f"prefills, {waves} waves in {wall:.2f} s wall (model init included)")
    for width in sorted(prefill_ms):
        log(f"  prefill width {width}: {', '.join(f'{m:.2f}' for m in prefill_ms[width])} ms")
    log(f"  waves: median {np.median(wave_ms):.2f} ms; the widest ({len(rows)} slots) median "
        f"{widest_ms:.2f} ms; one such wave profiled: device busy {wave_busy['busy_ms']:.3f} ms "
        f"of {wave_busy['window_ms']:.3f} (idle {wave_busy['idle_share']:.1%}); the weights alone "
        f"bound a wave at "
        f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms")

    # contiguous prefill and decode of each request, teacher-forced on the engine's tokens
    decode = make_decode_step(cfg)
    reqs = done[:n_contig]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    per_req, step_s, steps = [], 0.0, 0
    for r in reqs:
        prompt = torch.from_numpy(r.prompt[None]).to(dev)
        forced = torch.tensor(r.out, dtype=torch.int32, device=dev)[:, None, None]
        logits, caches = make_prefill_step(cfg, r.prompt_len + r.max_new)(model, prompt)
        got = [logits[0]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(r.max_new - 1):
            logits, caches = decode(model, caches, forced[i], r.prompt_len + i)
            got.append(logits[0])
        torch.cuda.synchronize()
        step_s += time.perf_counter() - t0
        steps += r.max_new - 1
        got, ref = torch.stack(got), torch.stack(eng.logits_of[r.rid])
        arg = got.argmax(dim=-1).cpu().tolist()  # the first maximum, as the engine's
        top2 = got.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).cpu().tolist()
        ref_top2 = ref.topk(2, dim=-1).values
        ref_margin = (ref_top2[:, 0] - ref_top2[:, 1]).cpu().tolist()
        dis = [dict(index=i, contiguous=arg[i], engine=r.out[i], margin=margin[i],
                    engine_margin=ref_margin[i]) for i in range(len(arg)) if arg[i] != r.out[i]]
        per_req.append(dict(rid=r.rid, prompt_len=r.prompt_len, max_new=r.max_new,
                            rel_l2=rel_l2(got, ref),
                            rel_l2_prefill=rel_l2(got[0], ref[0]),
                            finite=bool(torch.isfinite(got).all()), disagreements=dis))
    last = (caches, forced[r.max_new - 2], r.prompt_len + r.max_new - 2)
    torch.cuda.synchronize()
    ccounts = K.launch_counts()
    check_exact(ccounts, contig_want("attn", L, len(reqs), steps),
                 f"contiguous: {len(reqs)} prefills, {steps} decode steps")
    step_busy = device_busy(lambda: decode(model, *last))
    for q in per_req:
        log(f"  request {q['rid']} (prompt {q['prompt_len']}, {q['max_new']} tokens): logits "
            f"rel-L2 {q['rel_l2']:.3e} (prefill {q['rel_l2_prefill']:.3e}), "
            f"{len(q['disagreements'])} greedy disagreements"
            + "".join(f"; at {d['index']}: {d['contiguous']} vs {d['engine']}, top-2 margins "
                      f"{d['margin']:.4f} (contiguous) {d['engine_margin']:.4f} (engine)"
                      for d in q["disagreements"]))
    log(f"  contiguous decode: {step_s / steps * 1e3:.2f} ms a step on the host's clock, "
        f"one step profiled: device busy {step_busy['busy_ms']:.3f} ms of "
        f"{step_busy['window_ms']:.3f} (idle {step_busy['idle_share']:.1%}; the plain decode "
        f"attention over {last[0][0]['k'].shape[1]}-slot caches)")
    worst = max(q["rel_l2"] for q in per_req)
    if worst > SERVE_TOL["dense_bf16"] or not all(q["finite"] for q in per_req):
        raise AssertionError(f"{arch}: contiguous decoding disagrees with the engine: {per_req}")
    out = dict(
        n_params=n_params, weight_bytes=weight_bytes,
        launcher=dict(launches=counts, prefills=prefills, waves=waves, wall_s=wall,
                      prompts=[r.prompt_len for r in done], max_new=[r.max_new for r in done],
                      prefill_ms_by_width={str(k): v for k, v in sorted(prefill_ms.items())},
                      wave_ms=wave_ms, wave_slots=wave_slots, widest_wave_ms=widest_ms,
                      widest_wave_profile=wave_busy,
                      weights_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3),
        contiguous=dict(launches=ccounts, requests=per_req, decode_ms_wall=step_s / steps * 1e3,
                        decode_step_profile=step_busy, worst_rel_l2=worst,
                        disagreements=sum(len(q["disagreements"]) for q in per_req),
                        tokens=steps + len(reqs)),
    )
    del eng, model, caches, last, got, ref
    torch.cuda.empty_cache()
    return out


def phase_example(K, dev) -> dict:
    """Phase 13 (d): the ported example, llama3.2-1b at full width in f32:
    the paged engine's tokens against contiguous serving (0 mismatches)."""
    from repro_torch.examples import serve_lm

    log("python -m repro_torch.examples.serve_lm  (llama3.2-1b, full width, f32)")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    res = serve_lm.main([])  # raises on a token mismatch
    torch.cuda.synchronize()
    counts = K.launch_counts()
    eng = res["engine"]
    L = eng.cfg.n_layers
    steps = sum(len(ref) - 1 for ref in res["refs"].values())
    check_lm_counts(counts, eng, L, "example: engine + contiguous",
                    extra=contig_want("attn", L, len(res["refs"]), steps))
    if res["token_mismatches"] != 0 or eng.cfg.dtype != "float32":
        raise AssertionError(f"example: {res['token_mismatches']} token mismatches")
    out = {k: res[k] for k in ("arch", "dtype", "requests", "iterations", "tokens",
                               "token_mismatches", "leaked_pages", "host_wall_s")}
    out["launches"] = counts
    del res, eng
    torch.cuda.empty_cache()
    return out


# -- phase 14: RecurrentGemma-9B (RG-LRU and local attention), trained and served -------

HYB_ARCH = "recurrentgemma-9b"
HYB_TRAIN_LAYERS = 9  # phase 14 (a): 3 of the 12 superblocks (3.02 B parameters)
HYB_B, HYB_S = 2, 4096  # phase 14 (a): two windows of 2048, so the chunked branch runs
HYB_STEPS = 4  # phase 14 (a): 3 unpacked steps, then one packed microbatch
HYB_SERVE_B, HYB_SERVE_S, HYB_SERVE_NEW = 4, 3000, 64  # phase 14 (b): prompts, decode steps
HYB_F32_LAYERS, HYB_F32_NEW = 6, 40  # phase 14 (c): 2 superblocks in f32
# phase 14 (a)'s 3-layer check, kernels against plain: the loss (read
# 3.0e-7 and 0; only the norms' f32 sums differ) and every gradient's
# rel-L2 (read 9.6e-3, the embedding's) (PERF.md)
HYB_LOSS_TOL, HYB_GRAD_TOL = 1e-4, 5e-2
HYB_CACHE_BYTES = 105_021_440  # 26 RG-LRU layers x 163,840 + 12 local rings x 8,396,800 (B 4)


def per_microbatch_hybrid(n_layers: int) -> dict[str, int]:
    """Launches of one RecurrentGemma training microbatch of n_layers
    blocks with per-block recompute: each block's norm1 and norm2 (K4 on
    rows) run twice (forward, then again in the backward), the final norm
    once; K5 and K6 on rows once per norm.  The RG-LRU and local attention
    are plain PyTorch (the reference runs them outside Pallas)."""
    L = n_layers
    return {"rms_fwd": 4 * L + 1, "rms_bwd_dx": 2 * L + 1, "rms_bwd_dw": 2 * L + 1}


def phase_kernels_hybrid(dev) -> dict:
    """Phase 14, K4, K5 and K6 on rows at RecurrentGemma's d 4096 against
    their plain versions, timed: the training rows (B 2 x S 4096), the
    prefill's (4 x 3000) and the decode step's (4 rows)."""
    from repro_torch.kernels.fused_rmsnorm.ref import rms_bwd_ref, rms_norm_ref
    from repro_torch.kernels.fused_rmsnorm.rmsnorm import rms_bwd_dw, rms_bwd_dx, rms_fwd

    g = torch.Generator(device=dev).manual_seed(14)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    def report(name, t):
        log(f"  {name}: ms {t['ms']:.4f}  plain {t['plain_ms']:.4f}  library {t['library_ms']:.4f}"
            f"  bound {t['bound_ms']:.4f} ({t['bound_by']}, {t['bytes'] / 1e6:.3f} MB)  share "
            f"{t['bound_ms'] / t['ms']:.1%}")

    d = 4096
    out = {"rms_fwd": {}, "rms_bwd_dx": {}, "rms_bwd_dw": {}}
    log(f"K4 rms_fwd (rows) bf16 at d {d}: training [{HYB_B * HYB_S}, {d}], prefill "
        f"[{HYB_SERVE_B}, {HYB_SERVE_S}, {d}], decode [{HYB_SERVE_B}, 1, {d}]")
    for nm, shape in (("train", (HYB_B * HYB_S, d)), ("prefill", (HYB_SERVE_B, HYB_SERVE_S, d)),
                      ("decode", (HYB_SERVE_B, 1, d))):
        x, w = randn(*shape, dtype=torch.bfloat16, scale=2.0, shift=0.3), randn(d, scale=0.1, shift=1.0)
        (y, r), (yr, rr) = rms_fwd(x, w), rms_norm_ref(x, w)
        torch.cuda.synchronize()
        err = max_err(y, yr)
        check(f"K4 rows y {nm}", err, TOL["norm_bf16"])
        check(f"K4 rows rstd {nm}", max_err(r, rr), TOL["stat"])
        wl = w.to(x.dtype)
        t = dict(shape=list(shape), max_abs_err=err, ms=device_ms(lambda: rms_fwd(x, w), 20),
                 plain_ms=device_ms(lambda: rms_norm_ref(x, w), 5),
                 # yardstick only, never on the port's path: the library norm
                 library_ms=device_ms(lambda: F.rms_norm(x, (d,), wl, 1e-6), 20),
                 bytes=2 * x.numel() * 2 + x.numel() // d * 4 + d * 4, flops=4 * x.numel())
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"], F32_FLOPS)
        out["rms_fwd"][nm] = t
        report(f"K4 rows {nm}", t)
        del x, y, yr

    n = HYB_B * HYB_S
    log(f"K5 rms_bwd_dx, K6 rms_bwd_dw (rows)  dy, x [{n}, {d}] bf16, w [{d}] f32, rstd of the "
        f"plain forward")
    xs, ws = randn(n, d, dtype=torch.bfloat16, scale=2.0, shift=0.3), randn(d, scale=0.1, shift=1.0)
    rs = rms_norm_ref(xs, ws)[1]
    dys = randn(n, d, dtype=torch.bfloat16)
    dxr, dwr = rms_bwd_ref(dys, xs, ws, rs)
    k5_err = check_rel(f"K5 rows dx [{n}, {d}]", rms_bwd_dx(dys, xs, ws, rs), dxr,
                       BWD_TOL["grad_bf16"])
    dw = rms_bwd_dw(dys, xs, rs)
    k6_err = check_rel(f"K6 rows dw [{n}, {d}]", dw, dwr, BWD_TOL["sum_f32"])
    if not torch.equal(dw, rms_bwd_dw(dys, xs, rs)):
        raise AssertionError("K6 on rows is not bitwise deterministic at d 4096")
    log("  K6 rows: a second run is bitwise equal")
    # yardstick only, never on the port's path: the library norm's backward
    leaves = [xs.detach().requires_grad_(), ws.bfloat16().detach().requires_grad_()]
    yl = F.rms_norm(leaves[0], (d,), leaves[1], 1e-6)
    plain_ms = device_ms(lambda: rms_bwd_ref(dys, xs, ws, rs), 5)
    for name, fn, err, lib, nbytes, flops in (
            ("rms_bwd_dx", lambda: rms_bwd_dx(dys, xs, ws, rs), k5_err, leaves[:1],
             3 * n * d * 2 + n * 4 + d * 4, 6 * n * d),
            ("rms_bwd_dw", lambda: rms_bwd_dw(dys, xs, rs), k6_err, leaves[1:],
             2 * n * d * 2 + n * 4 + d * 4, 3 * n * d)):
        t = dict(shape=[n, d], max_abs_err=err, ms=device_ms(fn, 20), plain_ms=plain_ms,
                 library_ms=cuda_ms(lambda: torch.autograd.grad(yl, lib, dys, retain_graph=True),
                                    10),
                 bytes=nbytes, flops=flops)
        t["bound_ms"], t["bound_by"] = bound(nbytes, flops, F32_FLOPS)
        out[name]["train"] = t
        report(f"{'K5' if name == 'rms_bwd_dx' else 'K6'} rows train", t)
    del xs, dys, leaves, yl, dxr, dwr
    return out


def hybrid_packed_batch(cfg, dev, seed: int = 14, *, windows: int = HYB_B,
                        window: int = HYB_S) -> dict:
    """One microbatch of ``windows`` packed windows of ``window`` tokens
    (HYB_B of HYB_S by default) holding documents of 300 to min(3000,
    window) tokens (segment ids, -1 on any padding)."""
    from repro_torch.data.pipeline import materialize_packed_windows, to_device

    lengths = np.random.default_rng(seed).integers(300, min(3000, window) + 1, size=16)
    mbs = materialize_packed_windows(lengths, window=window, vocab=cfg.vocab,
                                     batch_windows=windows, seed=seed)
    if mbs[0]["tokens"].shape[0] != windows:
        raise AssertionError("the documents packed into fewer windows than a microbatch holds")
    return to_device({k: mbs[0][k] for k in ("tokens", "labels", "segment_ids")}, dev)


def lm_train_run(K, cfg, opt, state, batches, per, what: str) -> dict:
    """``len(batches)`` ``Trainer`` steps on ``EmulatedEngine``, one
    microbatch each, launch counts reset just before and checked exactly
    after (``per``): losses, step ms (CUDA events), tokens/s, peak memory."""
    import types

    from repro_torch.train.engine import EmulatedEngine
    from repro_torch.train.loop import Trainer

    b, s = batches[0]["tokens"].shape
    bucket = types.SimpleNamespace(batch_size=b, seq_len=s, tokens=b * s)
    stream = iter([[(bucket, x)] for x in batches])
    n = len(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    state, hist = Trainer(cfg, opt, engine=EmulatedEngine(cfg, opt)).run(
        state, stream, n, rng=1, log_every=1)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not np.isfinite(hist.losses).all():
        raise AssertionError(f"{what}: a loss is not finite: {hist.losses}")
    bad = [nm for nm, prm in state["model"].named_parameters() if not torch.isfinite(prm).all()]
    if bad or state["step"] != n:
        raise AssertionError(f"{what}: parameters not finite after the updates: {bad[:5]}")
    check_counts(counts, sum(hist.microbatches), cfg.n_layers, what, per)
    steady = [i for i in range(n) if i not in hist.compile_steps]
    if not steady:
        raise AssertionError(f"{what}: every step ran a new batch signature: no steady step")
    step_ms = [1e3 * t for t in hist.step_times]
    steady_ms = float(np.mean([step_ms[i] for i in steady]))
    for i, (ms, tok) in enumerate(zip(step_ms, hist.tokens)):
        log(f"  step {i}: {tok} tokens, {ms:.1f} ms, loss {hist.losses[i]:.4f}"
            f"{'  (first signature)' if i in hist.compile_steps else ''}")
    log(f"  steady step {steady_ms:.1f} ms (steps {steady}), {hist.throughput:,.0f} tokens/s, "
        f"peak memory {peak:.2f} GiB, events {hist.events}")
    return dict(losses=hist.losses, step_ms=step_ms, tokens=hist.tokens, events=hist.events,
                steady_steps=steady, steady_step_ms=steady_ms, tokens_per_s=hist.throughput,
                peak_gib=peak, launches=counts, per_microbatch=per(cfg.n_layers))


def grad_check(model, batch, what: str) -> dict:
    """The kernel loss and every gradient against ``ops="plain"`` on one
    batch (its memory too): loss within HYB_LOSS_TOL, every gradient's rel-L2
    within HYB_GRAD_TOL (phase 14's gates)."""
    from repro_torch.models.transformer import lm_loss

    res = {}
    for ops in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        loss = lm_loss(model, batch["tokens"], batch["labels"], memory=batch.get("memory"),
                       ops=ops, segment_ids=batch.get("segment_ids"))
        loss.backward()
        res[ops] = (loss.item(), {n: prm.grad for n, prm in model.named_parameters()})
        for prm in model.parameters():
            prm.grad = None
    loss_rel = abs(res["kernel"][0] - res["plain"][0]) / abs(res["plain"][0])
    rels = {n: rel_l2(res["kernel"][1][n], gp) for n, gp in res["plain"][1].items()}
    worst = max(rels, key=rels.get)
    log(f"  {what}: loss {res['kernel'][0]:.6f} kernel vs {res['plain'][0]:.6f} plain (rel "
        f"{loss_rel:.2e}, tol {HYB_LOSS_TOL}); largest gradient rel-L2 {rels[worst]:.3e} "
        f"({worst}, tol {HYB_GRAD_TOL})")
    if not (np.isfinite(res["kernel"][0]) and loss_rel <= HYB_LOSS_TOL
            and rels[worst] <= HYB_GRAD_TOL):
        raise AssertionError(f"{what}: kernel training gradients disagree with the plain versions'")
    return dict(what=what, loss_kernel=res["kernel"][0], loss_plain=res["plain"][0],
                loss_rel=loss_rel, worst_grad=worst, worst_grad_rel_l2=rels[worst])


def phase_train_hybrid(K, dev) -> dict:
    """Phase 14 (a): RecurrentGemma-9B training at full width and 9 of its
    38 layers (3 superblocks): 4 ``Trainer`` steps on ``EmulatedEngine``
    (3 of B 2 x S 4096 unpacked rows, one of 2 packed windows of 4096), exact
    launch counts, step time, tokens/s and peak memory; then at 3 layers the
    kernel loss and every gradient against ``ops="plain"`` on both kinds of
    batch."""
    from repro_torch.configs.registry import get_config, get_optimizer
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.steps import init_state

    full = get_config(HYB_ARCH)
    cfg = dataclasses.replace(full, n_layers=HYB_TRAIN_LAYERS)
    opt = OptimizerConfig(peak_lr=get_optimizer(HYB_ARCH).peak_lr, schedule="constant",
                          warmup=0, total_steps=HYB_STEPS)
    t0 = time.perf_counter()
    state = init_state(cfg, opt, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["model"].parameters())
    rng = np.random.default_rng(0)
    packed = hybrid_packed_batch(cfg, dev)
    docs = int((packed["segment_ids"].max(dim=1).values + 1).sum())
    pad = int((packed["segment_ids"] < 0).sum())
    log(f"(a) Trainer on EmulatedEngine, {cfg.name}: {cfg.n_layers} of {full.n_layers} layers "
        f"({cfg.layer_kinds()}), d {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} over "
        f"{cfg.n_kv_heads}, window {cfg.local_window}, vocab {cfg.vocab}, bf16, "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s; steps 0-2 B "
        f"{HYB_B} x S {HYB_S} unpacked, step 3 {HYB_B} packed windows of {HYB_S} ({docs} "
        f"documents of 300-3000 tokens, {pad} padding slots)")
    batches = [make_lm_batch(int(rng.integers(2**31)), HYB_B, HYB_S, cfg.vocab, cfg, dev)
               for _ in range(HYB_STEPS - 1)] + [packed]
    out = {"train": lm_train_run(K, cfg, opt, state, batches, per_microbatch_hybrid, "training")}
    out["train"].update(n_params=n_params, documents=docs, padding=pad)
    state["opt"] = None
    del state, batches
    torch.cuda.empty_cache()

    # one superblock at full width: kernel loss and gradients against the
    # plain versions', unpacked rows and the packed windows
    cfg3 = dataclasses.replace(full, n_layers=3)
    model = Transformer(cfg3, seed=1, device=dev)
    out["grad_check"] = [
        grad_check(model, make_lm_batch(5, 1, HYB_S, cfg3.vocab, cfg3, dev),
                   "3 layers, full width, bf16, unpacked B 1 x S 4096"),
        grad_check(model, packed, f"3 layers, full width, bf16, packed {HYB_B} x {HYB_S}")]
    del model, packed
    torch.cuda.empty_cache()
    return out


def _ring_positions(caches, kinds) -> list[int]:
    """The positions the first local layer's ring holds, sorted."""
    ring = caches[kinds.index("local")]["pos"]
    return sorted(int(p) for p in ring.tolist() if p >= 0)


def phase_serve_hybrid(K, dev) -> dict:
    """Phase 14 (b), (c): RecurrentGemma-9B at full width and depth serves
    4 prompts of 3000 tokens (above the window and not a multiple of it)
    and 64 greedy decode steps through ``make_prefill_step`` /
    ``make_decode_step``; kernels against ``ops="plain"`` teacher-forced,
    each step's logits against one forward over the extended sequence, the
    caches' bytes; then 6 layers in f32, decode against the forward."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = get_config(HYB_ARCH)
    L, b, s, new, w = cfg.n_layers, HYB_SERVE_B, HYB_SERVE_S, HYB_SERVE_NEW, cfg.local_window
    t0 = time.perf_counter()
    model = T.Transformer(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    log(f"(b) {cfg.name}: {L} layers, d {cfg.d_model}, {cfg.dtype}, seed 0, "
        f"{n_params / 1e9:.3f} B params (init {time.perf_counter() - t0:.1f} s); {b} prompts "
        f"of {s} tokens, {new} greedy decode steps from position {s} (window {w})")
    tokens = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
    prefill, decode = make_prefill_step(cfg, s + new), make_decode_step(cfg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(new + 2)]
    ev[0].record()
    logits, caches = prefill(model, tokens)
    ev[1].record()
    torch.cuda.synchronize()  # the first tokens are ready before decoding starts
    rings0 = _ring_positions(caches, model.kinds)
    got = [logits]
    t0 = time.perf_counter()
    for i in range(new):
        logits, caches = decode(model, caches, got[-1].argmax(dim=-1, keepdim=True).int(), s + i)
        ev[i + 2].record()
        got.append(logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_exact(counts, contig_want("hybrid", L, 1, new), f"prefill + {new} decode steps")
    if not all(bool(torch.isfinite(lg).all()) and lg.shape == (b, cfg.vocab) for lg in got):
        raise AssertionError("RecurrentGemma serving gave non-finite or misshapen logits")
    cache_bytes = sum(t.numel() * t.element_size() for c in caches for t in c.values())
    rings = _ring_positions(caches, model.kinds)
    log(f"  caches {cache_bytes:,} bytes (expected {HYB_CACHE_BYTES:,}); the ring held "
        f"{rings0[0]}..{rings0[-1]} after the prefill, {rings[0]}..{rings[-1]} after decoding")
    if cache_bytes != HYB_CACHE_BYTES:
        raise AssertionError(f"cache bytes {cache_bytes} != {HYB_CACHE_BYTES}")
    if rings0 != list(range(s - w, s)) or rings != list(range(s + new - w, s + new)):
        raise AssertionError("a local ring does not hold the last window of positions")
    prefill_ms = ev[0].elapsed_time(ev[1])
    step_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(new)]
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    first = got[0].argmax(dim=-1, keepdim=True).int()
    # one more step at position s for the profile: it rewrites the ring slot
    # of position s with the same k and v (the correctness checks are done)
    busy = device_busy(lambda: decode(model, caches, first, s))
    log(f"  prefill {prefill_ms:.1f} ms ({b * s / prefill_ms * 1e3:.0f} tokens/s); decode "
        f"{wall / new * 1e3:.2f} ms a step on the host's clock ({b * new / wall:.1f} tokens/s), "
        f"{np.median(step_ms):.2f} ms median between events; one step profiled: device busy "
        f"{busy['busy_ms']:.3f} ms of {busy['window_ms']:.3f} (idle {busy['idle_share']:.1%}); "
        f"weights bound {bound_ms:.3f} ms ({weight_bytes / 1e9:.3f} GB); peak {peak:.2f} GiB")
    del caches

    # the kernels against their plain versions, teacher-forced on the same tokens
    forced = [lg.argmax(dim=-1, keepdim=True).int() for lg in got[:new]]
    with torch.inference_mode():
        lg, pc = T.prefill(model, tokens, s + new, ops="plain")
        plain = [lg]
        for i in range(new):
            lg, pc = T.decode_step(model, pc, forced[i], s + i, ops="plain")
            plain.append(lg)
        del pc
        # the oracle: one forward over the extended sequence (the chunked
        # local attention, the RG-LRU's prefix scan)
        h, _ = model(torch.cat([tokens, *forced], dim=1))
        oracle = (h[:, s - 1 :] @ model.embed.T).float()  # [B, new + 1, V]
    tol_plain, tol = SERVE_TOL["hybrid_kernels_bf16"], SERVE_TOL["hybrid_bf16"]
    rel_plain = [rel_l2(a, p_) for a, p_ in zip(got, plain)]
    rel_fwd = [rel_l2(a, oracle[:, i]) for i, a in enumerate(got)]
    log(f"  logits rel-L2, kernels vs plain: prefill {rel_plain[0]:.3e}, decode max "
        f"{max(rel_plain[1:]):.3e} (tol {tol_plain})")
    log(f"  logits rel-L2, decode vs the forward over {s + new} tokens: prefill "
        f"{rel_fwd[0]:.3e}, decode max {max(rel_fwd[1:]):.3e}, median "
        f"{float(np.median(rel_fwd[1:])):.3e} (tol {tol})")
    if max(rel_plain) > tol_plain or max(rel_fwd) > tol:
        raise AssertionError(f"RecurrentGemma serving disagrees: {rel_plain} {rel_fwd}")
    out = dict(launches=counts, prefill_ms=prefill_ms, decode_ms_wall=wall / new * 1e3,
               decode_ms_events=step_ms, decode_step_profile=busy,
               prefill_tokens_per_s=b * s / prefill_ms * 1e3, tokens_per_s=b * new / wall,
               decode_bound_ms=bound_ms, n_params=n_params, weight_bytes=weight_bytes,
               cache_bytes=cache_bytes,
               peak_gib=peak, rel_l2_plain=rel_plain, rel_l2_forward=rel_fwd)
    del model, got, plain, h, oracle
    torch.cuda.empty_cache()

    # (c) f32 at reduced depth: decode against the forward, tightly
    cfg32 = dataclasses.replace(cfg, n_layers=HYB_F32_LAYERS, dtype="float32")
    n32 = HYB_F32_NEW
    m2 = T.Transformer(cfg32, seed=0, device=dev)
    with torch.inference_mode():
        lg, c2 = T.prefill(m2, tokens, s + n32)
        got2 = [lg]
        for i in range(n32):
            lg, c2 = T.decode_step(m2, c2, got2[-1].argmax(dim=-1, keepdim=True).int(), s + i)
            got2.append(lg)
        ext = torch.cat([tokens, *[x.argmax(dim=-1, keepdim=True).int() for x in got2[:n32]]],
                        dim=1)
        h2, _ = m2(ext)
        oracle2 = (h2[:, s - 1 :] @ m2.embed.T).float()
    rel_f32 = [rel_l2(a, oracle2[:, i]) for i, a in enumerate(got2)]
    log(f"(c) f32, {HYB_F32_LAYERS} layers ({cfg32.layer_kinds()}): decode vs the forward over "
        f"{s + n32} tokens, rel-L2 prefill {rel_f32[0]:.3e}, decode max {max(rel_f32[1:]):.3e} "
        f"(tol {SERVE_TOL['f32']:.0e})")
    if max(rel_f32) > SERVE_TOL["f32"]:
        raise AssertionError(f"RecurrentGemma f32 decode disagrees with the forward: {rel_f32}")
    out["f32"] = dict(layers=HYB_F32_LAYERS, decode_steps=n32, rel_l2_forward=rel_f32)
    del m2, c2, h2, oracle2
    torch.cuda.empty_cache()
    return out


MOE_LLAMA, MOE_KIMI = "llama4-scout-17b-a16e", "kimi-k2-1t-a32b"
MOE_TRAIN_LAYERS = 2  # phase 15 (a): 2 of Llama-4-Scout's 48 layers (65.3 GB of state)
MOE_STEPS = 4  # phase 15 (a): 3 unpacked steps of B 2 x S 4096, then one packed microbatch
MOE_SERVE_LAYERS = 12  # phase 15 (b): 12 of 48 layers, 54.9 GB of bf16 weights
MOE_KIMI_B, MOE_KIMI_S, MOE_KIMI_NEW = 4, 1024, 32  # phase 15 (c): prompts, decode steps
MOE_F32_B, MOE_F32_S, MOE_F32_NEW = 2, 1024, 32  # phase 15 (d)
# phase 15 (a)'s f32 check at 2 layers, kernels against plain: phase 14's
# gates (the loss 1e-4, every gradient's rel-L2 5e-2)
MOE_LOSS_TOL, MOE_GRAD_TOL = 1e-4, 5e-2
# phase 15, bf16: a token whose route differs at one layer (a near tie of
# router probabilities, moved by one bf16 rounding of a norm's output, an
# attention's, or a matrix product's whose tiling follows its row count)
# takes another expert's whole output.  So bf16 logits are held to the
# dense gate (SERVE_TOL "dense_bf16") only where every route of the two
# runs agrees, and otherwise printed beside the share of (token, layer)
# routes that differ; the engine against contiguous serving, whose routes
# cannot be paired (other batches), is printed in bf16 and gated in f32
# (15 (d), SERVE_TOL "f32").
MOE_ENGINE_REQUESTS = 8  # 15 (b) and (d)


class MoERoutes:
    """Records every call of ``models.moe.route`` while active: the keep mask,
    the top-k experts and whether the call routed without drops (capacity
    ``T k``).  References only: no copy, no read-back while recording."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.route, self.calls = moe, moe.route, []

    def __enter__(self):
        def recording(logits, cfg, cap):
            out = self.route(logits, cfg, cap)
            self.calls.append((out[1], out[4], cap >= logits.shape[1] * cfg.top_k))
            return out

        self.moe.route = recording
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def drop_share(self) -> float:
        """Dropped assignments over all assignments of the capacity-routed
        calls (0.0 if there were none)."""
        kept = [k for k, _, no_drop in self.calls if not no_drop]
        n = sum(k.numel() for k in kept)
        return float(sum(int((~k).sum()) for k in kept)) / n if n else 0.0

    def flip_share(self, other_calls: list) -> float:
        """(token, layer) routes whose top-k set differs from those of
        ``other_calls``, another run's record of the same calls."""
        if len(self.calls) != len(other_calls):
            raise AssertionError(f"{len(self.calls)} routing calls against {len(other_calls)}")
        flips = total = 0
        for (_, a, _), (_, b, _) in zip(self.calls, other_calls):
            flips += int((a.sort(dim=-1).values != b.sort(dim=-1).values).any(dim=-1).sum())
            total += a.shape[0] * a.shape[1]
        return flips / total


def moe_no_drop(cfg):
    """``cfg`` with the capacity factor E / k: every expert has room for every
    token of its group, so nothing drops."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def phase_kernels_moe(dev) -> dict:
    """Phase 15, the kernels at the MoE models' new widths against their
    plain versions, timed: K4 rows at Kimi-K2's d 7168 (a 4 x 1024 prefill,
    a decode step of 4) and at Llama-4-Scout's training rows [8192, 5120],
    K5 and K6 on those rows, K7 causal at Hq 64 over Hkv 8 (Kimi's prefill)
    and at Hq 40 over 8 (Llama-4's training windows, B 2 x S 4096), and K12
    at group 8 (a Kimi decode wave of 4 slots)."""
    from repro_torch.kernels.flash_attention.flash import BOUND_TILE, flash_fwd, live_tile_pairs
    from repro_torch.kernels.flash_attention.paged import paged_decode
    from repro_torch.kernels.flash_attention.ref import attention_ref, paged_attention_ref
    from repro_torch.kernels.fused_rmsnorm.ref import rms_bwd_ref, rms_norm_ref
    from repro_torch.kernels.fused_rmsnorm.rmsnorm import rms_bwd_dw, rms_bwd_dx, rms_fwd
    from repro_torch.launch.time_paged import paged_case, paged_work

    g = torch.Generator(device=dev).manual_seed(15)
    rng = np.random.default_rng(15)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    def report(name, t):
        log(f"  {name}: ms {t['ms']:.4f}  plain {t['plain_ms']:.4f}  library "
            f"{'none' if t['library_ms'] is None else format(t['library_ms'], '.4f')}  bound "
            f"{t['bound_ms']:.4f} ({t['bound_by']}, {t['bytes'] / 1e6:.3f} MB, "
            f"{t['flops'] / 1e9:.3f} GFLOP)  share {t['bound_ms'] / t['ms']:.1%}")

    b, s, hq, hkv, dh = MOE_KIMI_B, MOE_KIMI_S, 64, 8, 128
    rows = HYB_B * HYB_S  # Llama-4-Scout's training rows (B 2 x S 4096)
    out = {"rms_fwd": {}, "rms_bwd_dx": {}, "rms_bwd_dw": {}, "flash_fwd": {},
           "paged_decode": {}}
    log(f"K4 rms_fwd (rows) bf16: Kimi-K2's prefill [{b}, {s}, 7168] and decode [{b}, 1, 7168], "
        f"Llama-4-Scout's training rows [{rows}, 5120]")
    for nm, shape in (("kimi_prefill", (b, s, 7168)), ("kimi_decode", (b, 1, 7168)),
                      ("llama4_train", (rows, 5120))):
        d = shape[-1]
        x, w = randn(*shape, dtype=torch.bfloat16, scale=2.0, shift=0.3), randn(d, scale=0.1, shift=1.0)
        (y, r), (yr, rr) = rms_fwd(x, w), rms_norm_ref(x, w)
        torch.cuda.synchronize()
        err = max_err(y, yr)
        check(f"K4 rows y {nm}", err, TOL["norm_bf16"])
        check(f"K4 rows rstd {nm}", max_err(r, rr), TOL["stat"])
        wl = w.to(x.dtype)
        t = dict(shape=list(shape), max_abs_err=err, ms=device_ms(lambda: rms_fwd(x, w), 50),
                 plain_ms=device_ms(lambda: rms_norm_ref(x, w), 10),
                 # yardstick only, never on the port's path: the library norm
                 library_ms=device_ms(lambda: F.rms_norm(x, (d,), wl, 1e-6), 50),
                 bytes=2 * x.numel() * 2 + x.numel() // d * 4 + d * 4, flops=4 * x.numel())
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"], F32_FLOPS)
        out["rms_fwd"][nm] = t
        report(f"K4 rows {nm}", t)
        del x, y, yr

    d = 5120
    log(f"K5 rms_bwd_dx, K6 rms_bwd_dw (rows)  dy, x [{rows}, {d}] bf16, w [{d}] f32, rstd of the "
        f"plain forward")
    xs, ws = randn(rows, d, dtype=torch.bfloat16, scale=2.0, shift=0.3), randn(d, scale=0.1, shift=1.0)
    rs = rms_norm_ref(xs, ws)[1]
    dys = randn(rows, d, dtype=torch.bfloat16)
    dxr, dwr = rms_bwd_ref(dys, xs, ws, rs)
    k5_err = check_rel(f"K5 rows dx [{rows}, {d}]", rms_bwd_dx(dys, xs, ws, rs), dxr,
                       BWD_TOL["grad_bf16"])
    dw = rms_bwd_dw(dys, xs, rs)
    k6_err = check_rel(f"K6 rows dw [{rows}, {d}]", dw, dwr, BWD_TOL["sum_f32"])
    if not torch.equal(dw, rms_bwd_dw(dys, xs, rs)):
        raise AssertionError(f"K6 on rows is not bitwise deterministic at d {d}")
    # yardstick only, never on the port's path: the library norm's backward
    leaves = [xs.detach().requires_grad_(), ws.bfloat16().detach().requires_grad_()]
    yl = F.rms_norm(leaves[0], (d,), leaves[1], 1e-6)
    plain_ms = device_ms(lambda: rms_bwd_ref(dys, xs, ws, rs), 5)
    for name, fn, err, lib, nbytes, flops in (
            ("rms_bwd_dx", lambda: rms_bwd_dx(dys, xs, ws, rs), k5_err, leaves[:1],
             3 * rows * d * 2 + rows * 4 + d * 4, 6 * rows * d),
            ("rms_bwd_dw", lambda: rms_bwd_dw(dys, xs, rs), k6_err, leaves[1:],
             2 * rows * d * 2 + rows * 4 + d * 4, 3 * rows * d)):
        t = dict(shape=[rows, d], max_abs_err=err, ms=device_ms(fn, 20), plain_ms=plain_ms,
                 library_ms=cuda_ms(lambda: torch.autograd.grad(yl, lib, dys, retain_graph=True),
                                    10),
                 bytes=nbytes, flops=flops)
        t["bound_ms"], t["bound_by"] = bound(nbytes, flops, F32_FLOPS)
        out[name]["llama4_train"] = t
        report(f"{'K5' if name == 'rms_bwd_dx' else 'K6'} rows llama4_train", t)
    del xs, dys, leaves, yl, dxr, dwr

    for nm, bb, ss, hh in (("kimi_prefill", b, s, hq), ("llama4_train", HYB_B, HYB_S, 40)):
        log(f"K7 flash_fwd, {nm}: q [{bb}, {ss}, {hh}, {dh}], k, v [{bb}, {ss}, {hkv}, {dh}] bf16 "
            f"(views of qkv [{bb}, {ss}, {(hh + 2 * hkv) * dh}]), causal")
        qkv = randn(bb, ss, (hh + 2 * hkv) * dh, dtype=torch.bfloat16)
        q = qkv[..., : hh * dh].reshape(bb, ss, hh, dh)
        k = qkv[..., hh * dh : (hh + hkv) * dh].reshape(bb, ss, hkv, dh)
        v = qkv[..., (hh + hkv) * dh :].reshape(bb, ss, hkv, dh)
        (o, lse), (o_r, lse_r) = flash_fwd(q, k, v, causal=True), attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_err(o, o_r)
        check(f"K7 {nm} out", err, TOL["attn_bf16"])
        check(f"K7 {nm} lse", max_err(lse, lse_r), TOL["lse_bf16"])
        tiles = live_tile_pairs(ss, ss, causal=True) * hh * bb
        t = dict(shape=f"q [{bb}, {ss}, {hh}, {dh}], kv heads {hkv}", max_abs_err=err,
                 ms=device_ms(lambda: flash_fwd(q, k, v, causal=True), 20),
                 plain_ms=device_ms(lambda: attention_ref(q, k, v, causal=True), 3),
                 # yardstick only, never on the port's path: the library's causal attention
                 library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                     q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                     enable_gqa=True), 20),
                 bytes=2 * q.numel() * 2 + 2 * k.numel() * 2 + bb * hh * ss * 4,
                 flops=tiles * 4 * BOUND_TILE ** 2 * dh, live_tile_pairs=tiles)
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"], BF16_FLOPS)
        out["flash_fwd"][nm] = t
        report(f"K7 {nm}", t)
        del qkv, q, k, v, o, o_r

    lens = [int(x) for x in rng.integers(s, s + MOE_KIMI_NEW + 1, size=b)]
    log(f"K12 paged_decode at the Kimi-K2 wave: q [{b}, {hq}, {dh}] (group {hq // hkv}), pages "
        f"of 16 [.., 16, {hkv}, {dh}] bf16, 256 entries a table row, kv_lens {lens}")
    q, kp, vp, tables, kv_lens = paged_case(dev, g, rng, lens, hq, hkv, dh, LM_PAGE,
                                            torch.bfloat16, pages_max=256, spare=64)
    args = (q, kp, vp, tables[0], kv_lens)
    o, o_r = paged_decode(*args), paged_attention_ref(*args)
    torch.cuda.synchronize()
    err = max_err(o, o_r)
    check("K12 kimi wave out", err, TOL["attn_bf16"])
    check_slots("K12 kimi wave out", o, o_r, TOL["attn_bf16_slot"])
    nbytes, flops = paged_work(*args)
    t = dict(shape=f"q [{b}, {hq}, {dh}], pool {list(kp.shape)}, kv_lens {lens}",
             max_abs_err=err, ms=device_ms(lambda: paged_decode(*args), 50),
             plain_ms=device_ms(lambda: paged_attention_ref(*args), 3), library_ms=None,
             bytes=nbytes, flops=flops)
    t["bound_ms"], t["bound_by"] = bound(nbytes, flops, F32_FLOPS)
    out["paged_decode"]["kimi_wave"] = t
    report("K12 kimi_wave", t)
    return out


def phase_train_moe(K, dev) -> dict:
    """Phase 15 (a): Llama-4-Scout training at full width and 2 of its 48
    layers (bf16, f32 AdamW moments): 4 ``Trainer`` steps on
    ``EmulatedEngine`` (3 of B 2 x S 4096 unpacked rows, one of 2 packed
    windows), exact launch counts, step ms, tokens/s, peak memory and the
    drop share; one step's gradient profiled; then the same 2 layers in f32,
    the kernel loss and every gradient against ``ops="plain"`` with the
    route-flip share; (d) the f32 model without drops, 32 decode steps
    against one forward."""
    import types

    from repro_torch.configs.registry import get_config, get_optimizer
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.engine import EmulatedEngine
    from repro_torch.train.loop import Trainer
    from repro_torch.train.steps import init_state, make_pool_grad_step

    out = {}
    full = get_config(MOE_LLAMA)
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    B, S, L = HYB_B, HYB_S, cfg.n_layers
    opt = OptimizerConfig(peak_lr=get_optimizer(MOE_LLAMA).peak_lr, schedule="constant",
                          warmup=0, total_steps=MOE_STEPS)
    t0 = time.perf_counter()
    state = init_state(cfg, opt, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["model"].parameters())
    rng = np.random.default_rng(0)
    packed = hybrid_packed_batch(cfg, dev, seed=15)
    docs = int((packed["segment_ids"].max(dim=1).values + 1).sum())
    log(f"(a) Trainer on EmulatedEngine, {cfg.name}: {L} of {full.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} over {cfg.n_kv_heads}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of {cfg.moe.d_expert} and a shared "
        f"one, capacity factor {cfg.moe.capacity_factor}, vocab {cfg.vocab}, bf16, "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s; steps 0-2 B {B} x "
        f"S {S} unpacked, step 3 {B} packed windows of {S} ({docs} documents)")
    bucket = types.SimpleNamespace(batch_size=B, seq_len=S, tokens=B * S)
    batches = [make_lm_batch(int(rng.integers(2**31)), B, S, cfg.vocab, cfg, dev)
               for _ in range(MOE_STEPS - 1)] + [packed]
    stream = iter([[(bucket, b)] for b in batches])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with MoERoutes() as routes:
        state, hist = Trainer(cfg, opt, engine=EmulatedEngine(cfg, opt)).run(
            state, stream, MOE_STEPS, rng=1, log_every=1)
        torch.cuda.synchronize()
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not np.isfinite(hist.losses).all():
        raise AssertionError(f"a loss is not finite: {hist.losses}")
    bad = [n for n, prm in state["model"].named_parameters() if not torch.isfinite(prm).all()]
    if bad or state["step"] != MOE_STEPS:
        raise AssertionError(f"parameters not finite after the updates: {bad[:5]}")
    check_counts(counts, sum(hist.microbatches), L, "training", per_microbatch_dense)
    steady = [i for i in range(MOE_STEPS) if i not in hist.compile_steps]
    if not steady:
        raise AssertionError("every step ran a new batch signature: no steady step")
    step_ms = [1e3 * t for t in hist.step_times]
    steady_ms = float(np.mean([step_ms[i] for i in steady]))
    drop = routes.drop_share()
    for i, (ms, tok) in enumerate(zip(step_ms, hist.tokens)):
        log(f"  step {i}: {tok} tokens, {ms:.1f} ms, loss {hist.losses[i]:.4f}"
            f"{'  (first signature)' if i in hist.compile_steps else ''}")
    log(f"  steady step {steady_ms:.1f} ms (steps {steady}), {hist.throughput:,.0f} tokens/s, "
        f"peak memory {peak:.2f} GiB, dropped assignments {drop:.2%} of {len(routes.calls)} "
        f"capacity-routed calls, events {hist.events}")
    grad_step = make_pool_grad_step(cfg)
    busy = device_busy(lambda: grad_step(state["model"], batches[0], 0, 0))
    log(f"  one microbatch's gradient (B {B} x S {S}) profiled: device busy "
        f"{busy['busy_ms']:.1f} ms of {busy['window_ms']:.1f} (idle {busy['idle_share']:.1%}); by "
        f"family {json.dumps({k: round(v, 2) for k, v in busy['device_ms_by_family'].items()})}")
    out["train"] = dict(
        n_params=n_params, documents=docs, losses=hist.losses, step_ms=step_ms,
        tokens=hist.tokens, events=hist.events, steady_steps=steady, steady_step_ms=steady_ms,
        tokens_per_s=hist.throughput, peak_gib=peak, launches=counts, drop_share=drop,
        per_microbatch=per_microbatch_dense(L), grad_profile=busy)
    state["opt"] = None
    del state, hist, stream, batches, routes, grad_step
    gc.collect()
    torch.cuda.empty_cache()

    # the same depth in f32: the kernels against their plain versions
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = T.Transformer(cfg32, seed=1, device=dev)
    batch = make_lm_batch(5, 1, S, cfg32.vocab, cfg32, dev)
    res, runs = {}, {}
    for ops in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        with MoERoutes() as runs[ops]:
            loss = T.lm_loss(model, batch["tokens"], batch["labels"], ops=ops)
            loss.backward()
        res[ops] = (loss.item(), {n: prm.grad for n, prm in model.named_parameters()})
        for prm in model.parameters():
            prm.grad = None
    loss_rel = abs(res["kernel"][0] - res["plain"][0]) / abs(res["plain"][0])
    rels = {n: rel_l2(res["kernel"][1][n], gp) for n, gp in res["plain"][1].items()}
    worst = max(rels, key=rels.get)
    flips = runs["kernel"].flip_share(runs["plain"].calls)
    log(f"  {L} layers, full width, f32, B 1 x S {S}: loss {res['kernel'][0]:.6f} kernel vs "
        f"{res['plain'][0]:.6f} plain (rel {loss_rel:.2e}, tol {MOE_LOSS_TOL}); largest gradient "
        f"rel-L2 {rels[worst]:.3e} ({worst}, tol {MOE_GRAD_TOL}); routes that differ "
        f"{flips:.3%}; dropped {runs['kernel'].drop_share():.2%} (kernel), "
        f"{runs['plain'].drop_share():.2%} (plain)")
    if not (np.isfinite(res["kernel"][0]) and loss_rel <= MOE_LOSS_TOL
            and rels[worst] <= MOE_GRAD_TOL):
        raise AssertionError("kernel training gradients disagree with the plain versions'")
    out["grad_check"] = dict(dtype="float32", loss_kernel=res["kernel"][0],
                             loss_plain=res["plain"][0], loss_rel=loss_rel, worst_grad=worst,
                             worst_grad_rel_l2=rels[worst], route_flip_share=flips)
    del res, runs, batch

    # (d) no drops (capacity factor E / k): decoding against the forward
    model.cfg = moe_no_drop(cfg32)
    b, s, new = MOE_F32_B, MOE_F32_S, MOE_F32_NEW
    tokens = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        lg, caches = T.prefill(model, tokens, s + new)
        got = [lg]
        for i in range(new):
            lg, caches = T.decode_step(model, caches, got[-1].argmax(dim=-1, keepdim=True).int(),
                                       s + i)
            got.append(lg)
        ext = torch.cat([tokens, *[x.argmax(dim=-1, keepdim=True).int() for x in got[:new]]],
                        dim=1)
        h, _ = model(ext)
        oracle = (h[:, s - 1 :] @ model.embed.T).float()
    rel = [rel_l2(a, oracle[:, i]) for i, a in enumerate(got)]
    log(f"(d) f32, {L} layers, capacity factor {model.cfg.moe.capacity_factor} (no drop): "
        f"{new} decode steps from {b} prompts of {s} against the forward over {s + new} tokens, "
        f"rel-L2 prefill {rel[0]:.3e}, decode max {max(rel[1:]):.3e} (tol {SERVE_TOL['f32']:.0e})")
    if max(rel) > SERVE_TOL["f32"]:
        raise AssertionError(f"Llama-4-Scout f32 decode disagrees with the forward: {rel}")
    del caches, h, oracle, got
    # the paged engine against contiguous serving, in f32
    eng, wall = moe_engine(K, model, MOE_ENGINE_REQUESTS, max_seq=1024)
    check_lm_counts(K.launch_counts(), eng, L, "f32 engine")
    contig = engine_vs_contiguous(K, eng, L)
    worst = max(q["rel_l2"] for q in contig["requests"])
    rels = ", ".join(format(q["rel_l2"], ".2e") for q in contig["requests"])
    log(f"  f32 engine ({len(eng.done)} requests, {wall:.2f} s) against contiguous serving "
        f"teacher-forced: logits rel-L2 [{rels}] (tol {SERVE_TOL['f32']:.0e}), greedy "
        f"disagreements {[q['disagreements'] for q in contig['requests']]}")
    if worst > SERVE_TOL["f32"]:
        raise AssertionError(f"the f32 engine disagrees with contiguous serving: {contig}")
    out["f32_decode"] = dict(layers=L, decode_steps=new, rel_l2_forward=rel,
                             engine_rel_l2=[q["rel_l2"] for q in contig["requests"]])
    del model, eng
    torch.cuda.empty_cache()
    return out


def moe_engine(K, model, n_requests: int, *, max_seq: int):
    """``n_requests`` requests through a recording ``ServeEngine`` on
    ``model`` (the serve launcher's stream: Poisson arrivals at 20/s,
    prompts of 4 to max_seq / 4 tokens, 2 to 32 new tokens; 4 slots, 256
    pages of 16), launch counts reset just before.  Returns ``(engine, wall
    s)``."""
    from repro_torch.launch.serve import DEMO_MODEL
    from repro_torch.serve import ServeConfig

    eng = _recording_engine()(model, model.cfg, DEMO_MODEL, ServeConfig(
        target_step=0.25, page_size=LM_PAGE, num_pages=256, decode_slots=4, max_seq=max_seq))
    rng = np.random.default_rng(0)
    clock = 0.0
    for _ in range(n_requests):
        clock += float(rng.exponential(1.0 / 20.0))
        plen = int(rng.integers(4, max(5, max_seq // 4)))
        eng.submit(rng.integers(0, model.cfg.vocab, size=plen).astype(np.int32),
                   1 + int(rng.integers(1, 33)), arrival=clock)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(eng.done) != n_requests or any(len(r.out) != r.max_new for r in eng.done):
        raise AssertionError("not every request finished with its max_new tokens")
    return eng, wall


def engine_vs_contiguous(K, eng, n_layers: int, kind: str = "attn") -> dict:
    """Each of the engine's requests through contiguous prefill and decode,
    teacher-forced on the engine's tokens: the logits' rel-L2 against the
    engine's and the greedy disagreements a request, exact launch counts
    (``CONTIG_PER_CALL[kind]``), the host's ms a decode step, one step
    profiled."""
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    model, cfg = eng.model, eng.cfg
    decode = make_decode_step(cfg)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    per_req, step_s, steps = [], 0.0, 0
    for r in sorted(eng.done, key=lambda r: r.rid):
        prompt = torch.from_numpy(r.prompt[None]).to(model.device)
        forced = torch.tensor(r.out, dtype=torch.int32, device=model.device)[:, None, None]
        logits, caches = make_prefill_step(cfg, r.prompt_len + r.max_new)(model, prompt)
        got = [logits[0]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(r.max_new - 1):
            logits, caches = decode(model, caches, forced[i], r.prompt_len + i)
            got.append(logits[0])
        torch.cuda.synchronize()
        step_s += time.perf_counter() - t0
        steps += r.max_new - 1
        got, ref = torch.stack(got), torch.stack(eng.logits_of[r.rid])
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"request {r.rid}: non-finite contiguous logits")
        arg = got.argmax(dim=-1).cpu().tolist()
        per_req.append(dict(rid=r.rid, prompt_len=r.prompt_len, max_new=r.max_new,
                            rel_l2=rel_l2(got, ref),
                            disagreements=sum(a != o for a, o in zip(arg, r.out))))
    last = (caches, forced[r.max_new - 2], r.prompt_len + r.max_new - 2)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check_exact(counts, contig_want(kind, n_layers, len(per_req), steps),
                f"contiguous: {len(per_req)} prefills, {steps} decode steps")
    busy = device_busy(lambda: decode(model, *last))
    return dict(launches=counts, requests=per_req, decode_ms_wall=step_s / steps * 1e3,
                decode_step_profile=busy)


def phase_serve_moe(K, dev) -> dict:
    """Phase 15 (b): Llama-4-Scout at 12 of its 48 layers (bf16, seed 0,
    capacity factor E / k so that no route drops) serves 8 requests on a
    recording ``ServeEngine`` (the serve launcher's stream), then each
    request through contiguous prefill and decode teacher-forced on the
    engine's tokens, and two of them again with ``ops="plain"``: exact
    launch counts, prefill and wave ms, the widest wave's device time
    against its weights bound, the logits' rel-L2 and the route-flip
    shares (bf16: gated only where every route agrees)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    cfg = moe_no_drop(dataclasses.replace(get_config(MOE_LLAMA), n_layers=MOE_SERVE_LAYERS))
    L = cfg.n_layers
    t0 = time.perf_counter()
    model = T.Transformer(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"(b) {cfg.name} at {L} of 48 layers, bf16, capacity factor "
        f"{cfg.moe.capacity_factor} (no drop), init {time.perf_counter() - t0:.1f} s; "
        f"{MOE_ENGINE_REQUESTS} requests through ServeEngine (max_seq 4096, 4 slots)")
    torch.cuda.reset_peak_memory_stats()
    eng, wall = moe_engine(K, model, MOE_ENGINE_REQUESTS, max_seq=4096)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    done = sorted(eng.done, key=lambda r: r.rid)
    prefills, waves = check_lm_counts(counts, eng, L, "engine")
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prefill_ms = {}
    for _, width, a, b in eng.calls["prefill"]:
        prefill_ms.setdefault(width, []).append(a.elapsed_time(b))
    wave_ms = [a.elapsed_time(b) for _, _, a, b in eng.calls["decode"]]
    wave_slots = [n for n, _, _, _ in eng.calls["decode"]]
    wargs, rows = eng.widest
    wave_busy = device_busy(lambda: eng.raw_decode(*wargs))
    widest_ms = float(np.median([ms for ms, n in zip(wave_ms, wave_slots) if n == len(rows)]))
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  {weight_bytes / 1e9:.2f} GB of weights; prompts {[r.prompt_len for r in done]}, new "
        f"tokens {[r.max_new for r in done]}; {prefills} prefills, {waves} waves in {wall:.2f} s, "
        f"peak {peak:.2f} GiB")
    for width in sorted(prefill_ms):
        log(f"  prefill width {width}: {', '.join(f'{m:.2f}' for m in prefill_ms[width])} ms")
    log(f"  waves: median {np.median(wave_ms):.2f} ms; the widest ({len(rows)} slots) median "
        f"{widest_ms:.2f} ms; one profiled: device busy {wave_busy['busy_ms']:.3f} ms of "
        f"{wave_busy['window_ms']:.3f} (idle {wave_busy['idle_share']:.1%}); the weights bound a "
        f"wave at {bound_ms:.2f} ms; by family "
        f"{json.dumps({k: round(v, 3) for k, v in wave_busy['device_ms_by_family'].items()})}")
    contig = engine_vs_contiguous(K, eng, L)
    busy = contig["decode_step_profile"]
    log(f"  contiguous against the engine, bf16 (printed; gated in f32 in (d)): logits rel-L2 a "
        f"request {[round(q['rel_l2'], 4) for q in contig['requests']]}, greedy disagreements "
        f"{[q['disagreements'] for q in contig['requests']]}; decode "
        f"{contig['decode_ms_wall']:.2f} ms a step (host clock), one step profiled: device busy "
        f"{busy['busy_ms']:.3f} ms of {busy['window_ms']:.3f} (idle {busy['idle_share']:.1%})")

    # the kernels against their plain versions, teacher-forced, two requests
    plain_check = []
    for r in done[:2]:
        prompt = torch.from_numpy(r.prompt[None]).to(dev)
        forced = torch.tensor(r.out, dtype=torch.int32, device=dev)[:, None, None]
        lgs, runs = {}, {}
        for ops in ("kernel", "plain"):
            with torch.inference_mode(), MoERoutes() as runs[ops]:
                lg, c = T.prefill(model, prompt, r.prompt_len + r.max_new, ops=ops)
                lgs[ops] = [lg[0]]
                for i in range(r.max_new - 1):
                    lg, c = T.decode_step(model, c, forced[i], r.prompt_len + i, ops=ops)
                    lgs[ops].append(lg[0])
        rel = rel_l2(torch.stack(lgs["kernel"]), torch.stack(lgs["plain"]))
        flips = runs["kernel"].flip_share(runs["plain"].calls)
        gated = flips == 0.0
        plain_check.append(dict(rid=r.rid, rel_l2=rel, route_flip_share=flips, gated=gated))
        log(f"  request {r.rid}, kernels against plain teacher-forced: logits rel-L2 {rel:.3e}, "
            f"routes that differ {flips:.3%} of (token, layer)"
            + (f" (tol {SERVE_TOL['dense_bf16']})" if gated else " (printed: a route differs)"))
        if gated and rel > SERVE_TOL["dense_bf16"]:
            raise AssertionError(f"kernel serving disagrees with the plain versions: {rel}")
    out = dict(
        layers=L, weight_bytes=weight_bytes, peak_gib=peak,
        engine=dict(launches=counts, prefills=prefills, waves=waves, wall_s=wall,
                    prompts=[r.prompt_len for r in done], max_new=[r.max_new for r in done],
                    prefill_ms_by_width={str(k): v for k, v in sorted(prefill_ms.items())},
                    wave_ms=wave_ms, wave_slots=wave_slots, widest_wave_ms=widest_ms,
                    widest_wave_profile=wave_busy, weights_bound_ms=bound_ms),
        contiguous=contig, plain_check=plain_check)
    del eng, model
    torch.cuda.empty_cache()
    return out


def phase_serve_kimi(K, dev) -> dict:
    """Phase 15 (c): Kimi-K2 at full width and 2 of its 61 layers (the dense
    lead layer and one MoE layer of 384 experts, bf16, seed 0, the published
    capacity factor): a contiguous prefill of 4 x 1024 tokens, 32 greedy
    decode steps, then the same prompts through the paged prefill and one
    paged decode wave against the first contiguous step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import (
        make_decode_step,
        make_paged_decode_step,
        make_paged_prefill_step,
        make_prefill_step,
    )

    cfg = dataclasses.replace(get_config(MOE_KIMI), n_layers=2)
    L, b, s, new = cfg.n_layers, MOE_KIMI_B, MOE_KIMI_S, MOE_KIMI_NEW
    t0 = time.perf_counter()
    model = T.Transformer(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    expert_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                       if n.split(".")[-1] in ("w1", "w2", "w3") and ".moe." in n
                       and ".shared." not in n)
    log(f"(c) {cfg.name}: {L} of 61 layers ({cfg.layer_kinds()}), d {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads}, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k} of {cfg.moe.d_expert}, capacity factor {cfg.moe.capacity_factor}, "
        f"{weight_bytes / 1e9:.2f} GB of weights ({expert_bytes / 1e9:.2f} GB of routed experts, "
        f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at the memory rate), "
        f"init {time.perf_counter() - t0:.1f} s; {b} prompts of {s}, {new} decode steps")
    tokens = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
    prefill, decode = make_prefill_step(cfg, s + new), make_decode_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(new + 2)]
    with MoERoutes() as routes:
        ev[0].record()
        logits, caches = prefill(model, tokens)
        ev[1].record()
        got = [logits]
        t0 = time.perf_counter()
        for i in range(new):
            logits, caches = decode(model, caches, got[-1].argmax(dim=-1, keepdim=True).int(),
                                    s + i)
            ev[i + 2].record()
            got.append(logits)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_exact(counts, contig_want("attn", L, 1, new), f"prefill + {new} decode steps")
    if not all(bool(torch.isfinite(lg).all()) and lg.shape == (b, cfg.vocab) for lg in got):
        raise AssertionError("Kimi-K2 serving gave non-finite or misshapen logits")
    prefill_ms = ev[0].elapsed_time(ev[1])
    step_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(new)]
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    first = got[0].argmax(dim=-1, keepdim=True).int()
    busy = device_busy(lambda: decode(model, caches, first, s))
    drop = routes.drop_share()
    log(f"  prefill {prefill_ms:.1f} ms ({b * s / prefill_ms * 1e3:.0f} tokens/s), dropped "
        f"assignments {drop:.2%}; decode {wall / new * 1e3:.2f} ms a step on the host's clock "
        f"({b * new / wall:.1f} tokens/s), {np.median(step_ms):.2f} ms median between events; "
        f"one step profiled: device busy {busy['busy_ms']:.3f} ms of {busy['window_ms']:.3f} "
        f"(idle {busy['idle_share']:.1%}); weights bound {bound_ms:.2f} ms; peak {peak:.2f} GiB; "
        f"by family {json.dumps({k: round(v, 3) for k, v in busy['device_ms_by_family'].items()})}")
    del caches

    # the same prompts through the paged path, and one wave against step 0
    ps = LM_PAGE
    per = -(-(s + new) // ps)
    pools = T.init_paged_pools(cfg, b * per, ps, device=dev)
    table = torch.arange(b * per, dtype=torch.int32, device=dev).reshape(b, per)
    K.reset_launch_counts()
    with MoERoutes() as paged_routes:
        plg, pools = make_paged_prefill_step(cfg)(
            model, tokens, torch.full((b,), s, dtype=torch.int32, device=dev), table[:, : s // ps],
            pools)
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        wlg, pools = make_paged_decode_step(cfg)(
            model, pools, table, torch.full((b,), s, dtype=torch.int32, device=dev), first)
        e.record()
        torch.cuda.synchronize()
    pcounts = K.launch_counts()
    want = {}
    for kind in ("prefill", "wave"):
        for name, n in LM_PER_CALL[kind](L).items():
            want[name] = want.get(name, 0) + n
    check_exact(pcounts, want, "paged prefill + one wave")
    rel_prefill, rel_wave = rel_l2(plg, got[0]), rel_l2(wlg, got[1])
    # against the contiguous prefill's and first decode step's calls
    flips = paged_routes.flip_share(routes.calls[: len(paged_routes.calls)])
    tol = SERVE_TOL["dense_bf16"]
    log(f"  paged: prefill logits against the contiguous prefill's rel-L2 {rel_prefill:.3e}, "
        f"the wave's against decode step 0 {rel_wave:.3e}, wave {a.elapsed_time(e):.2f} ms, "
        f"routes that differ {flips:.3%}"
        + (f" (tol {tol})" if flips == 0.0 else " (printed: a route differs)"))
    if flips == 0.0 and max(rel_prefill, rel_wave) > tol:
        raise AssertionError(f"paged Kimi-K2 serving disagrees: {rel_prefill} {rel_wave}")
    out = dict(layers=L, weight_bytes=weight_bytes, expert_bytes=expert_bytes,
               launches=counts, paged_launches=pcounts, prefill_ms=prefill_ms,
               decode_ms_wall=wall / new * 1e3, decode_ms_events=step_ms,
               decode_step_profile=busy, decode_bound_ms=bound_ms, peak_gib=peak,
               drop_share=drop, paged_rel_l2=[rel_prefill, rel_wave],
               paged_wave_ms=a.elapsed_time(e), paged_route_flip_share=flips)
    del model, pools, got
    torch.cuda.empty_cache()
    return out


MG_ARCH, VLM_ARCH = "musicgen-large", "llama-3.2-vision-90b"
MG_B, MG_S, MG_STEPS = 4, 2048, 4  # phase 16 (a): 3 unpacked steps at 48 layers, then one packed
MG_F32_LAYERS = 8  # phase 16 (a): the f32 check, kernels against plain
MG_ENGINE_REQUESTS = 8  # phase 16 (b)
MG_SERVE_B, MG_SERVE_S, MG_SERVE_NEW = 4, 1024, 32  # phase 16 (b): contiguous prompts, steps
VLM_TRAIN_LAYERS = 5  # phase 16 (c): one superblock, 4 "attn" + 1 "cross" (5.33 B parameters)
VLM_B, VLM_S, VLM_STEPS = 2, 4096, 4  # phase 16 (c): B 2 x S 4096 over 4096 image tokens
VLM_GATE = 0.5  # every cross layer's gate: at init (0) the cross path adds nothing
VLM_SERVE_LAYERS = 30  # phase 16 (d): 6 of the 20 superblocks, 53.4 GB of bf16 weights
VLM_SERVE_B, VLM_SERVE_S, VLM_SERVE_NEW = 4, 1024, 32  # phase 16 (d): prompts, decode steps
VLM_F32_B, VLM_F32_S, VLM_F32_NEW = 2, 1024, 32  # phase 16 (d): f32 at one superblock
MG_PER_CALL = {  # MusicGen's paged prefill and wave, per layer L: its LayerNorm is plain
    "prefill": lambda L: {"flash_fwd": L},
    "wave": lambda L: {"paged_decode": L},
}


def per_microbatch_audio(n_layers: int) -> dict[str, int]:
    """Launches of one MusicGen training microbatch of n_layers attention
    blocks with per-block recompute: K7 twice a block (forward, then again
    in the backward), K8 and K9 once.  Its LayerNorms are plain PyTorch, as
    the reference's are jnp: no norm kernel runs."""
    L = n_layers
    return {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}


def set_gates(model, value: float) -> int:
    """Every cross layer's gate to ``value``; returns the number of cross
    layers."""
    n = 0
    with torch.no_grad():
        for bp, kind in zip(model.blocks, model.kinds):
            if kind == "cross":
                bp.attn.gate.fill_(value)
                n += 1
    return n


def phase_kernels_vlm(dev) -> dict:
    """Phase 16, the kernels at the new shapes against their plain versions,
    timed: K4 rows at Llama-3.2-Vision's d 8192 (the row kernels' largest
    width: training rows [8192, 8192], a 4 x 1024 prefill, a decode step of
    4), K5 and K6 on the training rows (K6 also bitwise against a second
    run); K7 non-causal GQA 64/8 x 128 over 4096 image tokens at the
    training windows (q [2, 4096]) and the prefill (q [4, 1024]), K8 and K9
    at the training windows; K7, K8 and K9 causal at MusicGen's [4, 2048,
    32, 64]; K12 at MusicGen's wave (group 1, dh 64, 32 kv heads)."""
    from repro_torch.kernels.flash_attention.flash import (
        BOUND_TILE, BWD_TILES, flash_bwd_dkv, flash_bwd_dq, flash_fwd, live_tile_pairs,
    )
    from repro_torch.kernels.flash_attention.paged import paged_decode
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_delta_ref, attention_ref, paged_attention_ref,
    )
    from repro_torch.kernels.fused_rmsnorm.ref import rms_bwd_ref, rms_norm_ref
    from repro_torch.kernels.fused_rmsnorm.rmsnorm import rms_bwd_dw, rms_bwd_dx, rms_fwd
    from repro_torch.launch.time_paged import paged_case, paged_work

    g = torch.Generator(device=dev).manual_seed(16)
    rng = np.random.default_rng(16)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    def report(name, t):
        log(f"  {name}: ms {t['ms']:.4f}  plain {t['plain_ms']:.4f}  library "
            f"{'none' if t['library_ms'] is None else format(t['library_ms'], '.4f')}  bound "
            f"{t['bound_ms']:.4f} ({t['bound_by']}, {t['bytes'] / 1e6:.3f} MB, "
            f"{t['flops'] / 1e9:.3f} GFLOP)  share {t['bound_ms'] / t['ms']:.1%}")

    d, rows = 8192, VLM_B * VLM_S
    out = {"rms_fwd": {}, "rms_bwd_dx": {}, "rms_bwd_dw": {}, "flash_fwd": {},
           "flash_bwd_dq": {}, "flash_bwd_dkv": {}, "paged_decode": {}}
    log(f"K4 rms_fwd (rows) bf16 at d {d}: training rows [{rows}, {d}], prefill [4, 1024, {d}], "
        f"decode [4, 1, {d}]")
    for nm, shape in (("vlm_train", (rows, d)), ("vlm_prefill", (4, 1024, d)),
                      ("vlm_decode", (4, 1, d))):
        x, w = randn(*shape, dtype=torch.bfloat16, scale=2.0, shift=0.3), randn(d, scale=0.1, shift=1.0)
        (y, r), (yr, rr) = rms_fwd(x, w), rms_norm_ref(x, w)
        torch.cuda.synchronize()
        err = max_err(y, yr)
        check(f"K4 rows y {nm}", err, TOL["norm_bf16"])
        check(f"K4 rows rstd {nm}", max_err(r, rr), TOL["stat"])
        wl = w.to(x.dtype)
        t = dict(shape=list(shape), max_abs_err=err, ms=device_ms(lambda: rms_fwd(x, w), 50),
                 plain_ms=device_ms(lambda: rms_norm_ref(x, w), 10),
                 # yardstick only, never on the port's path: the library norm
                 library_ms=device_ms(lambda: F.rms_norm(x, (d,), wl, 1e-6), 50),
                 bytes=2 * x.numel() * 2 + x.numel() // d * 4 + d * 4, flops=4 * x.numel())
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"], F32_FLOPS)
        out["rms_fwd"][nm] = t
        report(f"K4 rows {nm}", t)
        del x, y, yr

    log(f"K5 rms_bwd_dx, K6 rms_bwd_dw (rows)  dy, x [{rows}, {d}] bf16, w [{d}] f32, rstd of the "
        f"plain forward")
    xs, ws = randn(rows, d, dtype=torch.bfloat16, scale=2.0, shift=0.3), randn(d, scale=0.1, shift=1.0)
    rs = rms_norm_ref(xs, ws)[1]
    dys = randn(rows, d, dtype=torch.bfloat16)
    dxr, dwr = rms_bwd_ref(dys, xs, ws, rs)
    k5_err = check_rel(f"K5 rows dx [{rows}, {d}]", rms_bwd_dx(dys, xs, ws, rs), dxr,
                       BWD_TOL["grad_bf16"])
    dw = rms_bwd_dw(dys, xs, rs)
    k6_err = check_rel(f"K6 rows dw [{rows}, {d}]", dw, dwr, BWD_TOL["sum_f32"])
    if not torch.equal(dw, rms_bwd_dw(dys, xs, rs)):
        raise AssertionError(f"K6 on rows is not bitwise deterministic at d {d}")
    # yardstick only, never on the port's path: the library norm's backward
    leaves = [xs.detach().requires_grad_(), ws.bfloat16().detach().requires_grad_()]
    yl = F.rms_norm(leaves[0], (d,), leaves[1], 1e-6)
    plain_ms = device_ms(lambda: rms_bwd_ref(dys, xs, ws, rs), 5)
    for name, fn, err, lib, nbytes, flops in (
            ("rms_bwd_dx", lambda: rms_bwd_dx(dys, xs, ws, rs), k5_err, leaves[:1],
             3 * rows * d * 2 + rows * 4 + d * 4, 6 * rows * d),
            ("rms_bwd_dw", lambda: rms_bwd_dw(dys, xs, rs), k6_err, leaves[1:],
             2 * rows * d * 2 + rows * 4 + d * 4, 3 * rows * d)):
        t = dict(shape=[rows, d], max_abs_err=err, ms=device_ms(fn, 20), plain_ms=plain_ms,
                 library_ms=cuda_ms(lambda: torch.autograd.grad(yl, lib, dys, retain_graph=True),
                                    10),
                 bytes=nbytes, flops=flops)
        t["bound_ms"], t["bound_by"] = bound(nbytes, flops, F32_FLOPS)
        out[name]["vlm_train"] = t
        report(f"{'K5' if name == 'rms_bwd_dx' else 'K6'} rows vlm_train", t)
    del xs, dys, leaves, yl, dxr, dwr

    def attn_case(nm, b, sq, skv, hq, hkv, dh, causal, bwd):
        """K7 (and with ``bwd`` K8, K9) at one shape; q, k, v views of a
        fused projection (self-attention) or of q and kv projections
        (cross-attention, ``sq != skv`` or not causal), bf16."""
        if causal:
            qkv = randn(b, sq, (hq + 2 * hkv) * dh, dtype=torch.bfloat16)
            q = qkv[..., : hq * dh].reshape(b, sq, hq, dh)
            kv = qkv[..., hq * dh :]
        else:
            q = randn(b, sq, hq * dh, dtype=torch.bfloat16).reshape(b, sq, hq, dh)
            kv = randn(b, skv, 2 * hkv * dh, dtype=torch.bfloat16)
        k = kv[..., : hkv * dh].reshape(b, skv, hkv, dh)
        v = kv[..., hkv * dh :].reshape(b, skv, hkv, dh)
        shape = (f"q [{b}, {sq}, {hq}, {dh}], k, v [{b}, {skv}, {hkv}, {dh}], "
                 f"{'causal' if causal else 'non-causal'}, bf16")
        log(f"K7 flash_fwd {nm}: {shape}")
        (o, lse), (o_r, lse_r) = flash_fwd(q, k, v, causal=causal), attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = max_err(o, o_r)
        check(f"K7 {nm} out", err, TOL["attn_bf16"])
        check(f"K7 {nm} lse", max_err(lse, lse_r), TOL["lse_bf16"])
        del o, o_r
        tiles = live_tile_pairs(sq, skv, causal=causal) * hq * b
        mm = 2 * BOUND_TILE ** 2 * dh
        tq = [t_.detach().transpose(1, 2) for t_ in (q, k, v)]
        t = dict(shape=shape, max_abs_err=err, ms=device_ms(lambda: flash_fwd(q, k, v, causal=causal), 20),
                 plain_ms=device_ms(lambda: attention_ref(q, k, v, causal=causal), 3),
                 # yardstick only, never on the port's path: the library's attention
                 library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                     *tq, is_causal=causal, enable_gqa=hq != hkv), 20),
                 bytes=2 * q.numel() * 2 + 2 * k.numel() * 2 + b * hq * sq * 4,
                 flops=tiles * 2 * mm, live_tile_pairs=tiles)
        t["bound_ms"], t["bound_by"] = bound(t["bytes"], t["flops"], BF16_FLOPS)
        out["flash_fwd"][nm] = t
        report(f"K7 {nm}", t)
        if not bwd:
            return
        do = randn(b, sq, hq, dh, dtype=torch.bfloat16)
        o32, lse = flash_fwd(q, k, v, causal=causal, out_dtype=torch.float32)
        dq, delta = flash_bwd_dq(q, k, v, o32, do, lse, causal=causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
        want = attention_bwd_ref(q, k, v, do, lse, attention_delta_ref(do, o32), causal=causal)
        torch.cuda.synchronize()
        errs = [check_l2(f"K8/K9 {nm} {w}", a_, b_, BWD_TOL["flash_bf16"])
                for w, a_, b_ in zip(("dq", "dk", "dv"), (dq, dk, dv), want)]
        del dq, dk, dv, want
        t8 = cuda_ms(lambda: flash_bwd_dq(q, k, v, o32, do, lse, causal=causal), 5)
        t9 = cuda_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal), 5)
        t_p = cuda_ms(lambda: attention_bwd_ref(q, k, v, do, lse, delta, causal=causal), 1)
        # yardstick only, never on the port's path: the library's attention backward
        lv = [t_.requires_grad_() for t_ in tq]
        o_l = F.scaled_dot_product_attention(*lv, is_causal=causal, enable_gqa=hq != hkv)
        t_l = cuda_ms(lambda: torch.autograd.grad(o_l, lv, do.transpose(1, 2), retain_graph=True), 3)
        del o_l, lv
        rows_q, rows_kv, stats = q.numel() * 2, k.numel() * 2, b * hq * sq * 4
        by8 = 2 * rows_q + 2 * rows_kv + rows_q * 2 + 2 * stats + rows_q  # q do, k v, out32, lse delta, dq
        by9 = 2 * rows_q + 2 * rows_kv + 2 * stats + 2 * rows_kv  # q do, k v, lse delta, dk dv
        for w, t_k, n_mm, by in (("dq", t8, 3, by8), ("dkv", t9, 4, by9)):
            qt, kt = BWD_TILES[w]
            bms, bby = bound(by, tiles * n_mm * mm, BF16_FLOPS)
            run = live_tile_pairs(sq, skv, causal=causal, q_tile=qt, kv_tile=kt) * b * hq * qt * kt \
                // BOUND_TILE ** 2
            out[f"flash_bwd_{w}"][nm] = dict(
                ms=t_k, plain_ms=t_p, bound_ms=bms, bound_by=bby, library_ms=t_l,
                max_abs_err=max(errs), shape=shape, live_tile_pairs=tiles, run_tile_pairs=run,
                bytes=by, flops=tiles * n_mm * mm, tflops_per_s=tiles * n_mm * mm / (t_k * 1e-3) / 1e12)
            log(f"  K{8 if w == 'dq' else 9} {nm} ms {t_k:.4f}  bound {bms:.4f} ({bby}, "
                f"{bms / t_k:.1%})  {tiles} live 64x64 tiles, its tiles run {run}")
        log(f"  plain (dq, dk, dv) {t_p:.4f}  library (SDPA backward) {t_l:.4f}")

    attn_case("vlm_cross_train", VLM_B, VLM_S, 4096, 64, 8, 128, False, True)
    attn_case("vlm_cross_prefill", VLM_SERVE_B, VLM_SERVE_S, 4096, 64, 8, 128, False, False)
    attn_case("musicgen_train", MG_B, MG_S, MG_S, 32, 32, 64, True, True)

    hq = hkv = 32
    lens = [int(x) for x in rng.integers(64, MG_SERVE_S + MG_SERVE_NEW + 1, size=4)]
    log(f"K12 paged_decode at the MusicGen wave: q [4, {hq}, 64] (group 1), pages of 16 "
        f"[.., 16, {hkv}, 64] bf16, 256 entries a table row, kv_lens {lens}")
    q, kp, vp, tables, kv_lens = paged_case(dev, g, rng, lens, hq, hkv, 64, LM_PAGE,
                                            torch.bfloat16, pages_max=256, spare=64)
    args = (q, kp, vp, tables[0], kv_lens)
    o, o_r = paged_decode(*args), paged_attention_ref(*args)
    torch.cuda.synchronize()
    err = max_err(o, o_r)
    check("K12 musicgen wave out", err, TOL["attn_bf16"])
    check_slots("K12 musicgen wave out", o, o_r, TOL["attn_bf16_slot"])
    nbytes, flops = paged_work(*args)
    t = dict(shape=f"q [4, {hq}, 64], pool {list(kp.shape)}, kv_lens {lens}",
             max_abs_err=err, ms=device_ms(lambda: paged_decode(*args), 50),
             plain_ms=device_ms(lambda: paged_attention_ref(*args), 3), library_ms=None,
             bytes=nbytes, flops=flops)
    t["bound_ms"], t["bound_by"] = bound(nbytes, flops, F32_FLOPS)
    out["paged_decode"]["musicgen_wave"] = t
    report("K12 musicgen_wave", t)
    return out


def compression_check(grads: dict) -> dict:
    """Phase 16 (e): ``compress_int8`` with error feedback on one gradient
    dict on the card: a first step (the residual from 0) and its
    decompression, then a second step and its decompression, timed, whose
    every leaf is checked: the int8 values times their scale
    within half a scale of the gradient plus the carried residual (and the
    f32 rounding of the quotient and the product, 2^-22 of the leaf's
    largest magnitude), and the new residual exactly what they miss; the
    wire bytes of each format."""
    from repro_torch.distributed.compression import (
        WIRE_BYTES, compress_int8, decompress_int8, init_error_feedback, wire_bytes,
    )

    n = sum(t.numel() for t in grads.values())
    ef = init_error_feedback(grads)
    q, s, ef = compress_int8(grads, ef)
    # untimed, as the first step: the allocator's first blocks of each size
    decompress_int8(q, s, torch.float32)
    torch.cuda.synchronize()
    a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    a.record()
    q, s, ef2 = compress_int8(grads, ef)
    b.record()
    deq = decompress_int8(q, s, torch.float32)
    c.record()
    c.synchronize()
    ms, dec_ms = a.elapsed_time(b), b.elapsed_time(c)
    worst = 0.0
    for name, gr in grads.items():
        gf = gr.float() + ef[name]
        err = float((deq[name] - gf).abs().max())
        worst = max(worst, err / float(s[name]))
        lim = 0.5 * float(s[name]) + float(gf.abs().max()) * 2.0**-22
        if err > lim:
            raise AssertionError(f"compression: {name} is off by {err}, above half its scale "
                                 f"{float(s[name])} and f32 rounding ({lim})")
        if not torch.equal(ef2[name], gf - q[name].float() * s[name]):
            raise AssertionError(f"compression: {name}'s residual is not what the int8 misses")
        if q[name].dtype != torch.int8 or int(q[name].abs().max()) > 127:
            raise AssertionError(f"compression: {name} is not int8 within +-127")
    sizes = {m: wire_bytes(grads, m) for m in WIRE_BYTES}
    if sizes != {m: n * per for m, per in WIRE_BYTES.items()}:
        raise AssertionError(f"compression: wire bytes {sizes} for {n} values")
    # each value: the bf16 gradient and the f32 residual read, the int8 value
    # and the new residual written; the scales are one f32 a leaf
    nbytes = n * (2 + 4 + 1 + 4)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"(e) compress_int8 with error feedback on {len(grads)} gradients of {n / 1e9:.3f} B "
        f"values: {ms:.2f} ms ({nbytes / ms / 1e6:.0f} GB/s; the bytes it must move bound it at "
        f"{bound_ms:.2f} ms), decompress {dec_ms:.2f} ms; the largest error {worst:.4f} of its "
        f"leaf's scale (bound 0.5); wire bytes {sizes}")
    return dict(values=n, leaves=len(grads), ms=ms, decompress_ms=dec_ms, bound_ms=bound_ms,
                worst_err_of_scale=worst, wire_bytes=sizes)


def phase_train_musicgen(K, dev) -> dict:
    """Phase 16 (a), (e): MusicGen-large training at full width and depth
    (48 layers, bf16, f32 AdamW moments): 4 ``Trainer`` steps on
    ``EmulatedEngine`` (3 of B 4 x S 2048 unpacked rows, one of 4 packed
    windows), exact launch counts (K7 2L, K8 L, K9 L, no norm kernel), step
    ms, tokens/s, peak memory, one microbatch's gradient profiled; (e) int8
    compression with error feedback on that microbatch's gradients; then 8
    layers in f32, the kernel loss and every gradient against
    ``ops="plain"``."""
    from repro_torch.configs.registry import get_config, get_optimizer
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.steps import init_state, make_pool_grad_step

    cfg = get_config(MG_ARCH)
    opt = OptimizerConfig(peak_lr=get_optimizer(MG_ARCH).peak_lr, schedule="constant",
                          warmup=0, total_steps=MG_STEPS)
    t0 = time.perf_counter()
    state = init_state(cfg, opt, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["model"].parameters())
    rng = np.random.default_rng(16)
    packed = hybrid_packed_batch(cfg, dev, seed=16, windows=MG_B, window=MG_S)
    docs = int((packed["segment_ids"].max(dim=1).values + 1).sum())
    log(f"(a) Trainer on EmulatedEngine, {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim} (MHA), d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.norm}, bf16, {n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s; "
        f"steps 0-2 B {MG_B} x S {MG_S} unpacked, step 3 {MG_B} packed windows of {MG_S} "
        f"({docs} documents)")
    batches = [make_lm_batch(int(rng.integers(2**31)), MG_B, MG_S, cfg.vocab, cfg, dev)
               for _ in range(MG_STEPS - 1)] + [packed]
    out = {"train": lm_train_run(K, cfg, opt, state, batches, per_microbatch_audio, "training")}
    out["train"].update(n_params=n_params, documents=docs)
    state["opt"] = None
    gc.collect()
    torch.cuda.empty_cache()
    grad_step = make_pool_grad_step(cfg)
    busy = device_busy(lambda: grad_step(state["model"], batches[0], 0, 0))
    log(f"  one microbatch's gradient (B {MG_B} x S {MG_S}) profiled: device busy "
        f"{busy['busy_ms']:.1f} ms of {busy['window_ms']:.1f} (idle {busy['idle_share']:.1%}); by "
        f"family {json.dumps({k: round(v, 2) for k, v in busy['device_ms_by_family'].items()})}")
    out["train"]["grad_profile"] = busy
    _, grads = grad_step(state["model"], batches[0], 0, 0)
    out["compression"] = compression_check(grads)
    del state, batches, grads
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, n_layers=MG_F32_LAYERS, dtype="float32")
    model = Transformer(cfg32, seed=1, device=dev)
    out["grad_check"] = [grad_check(model, make_lm_batch(5, 1, MG_S, cfg.vocab, cfg32, dev),
                                    f"{MG_F32_LAYERS} layers, full width, f32, B 1 x S {MG_S}"),
                         grad_check(model, packed, f"{MG_F32_LAYERS} layers, f32, packed "
                                                   f"{MG_B} x {MG_S}")]
    del model, packed
    torch.cuda.empty_cache()
    return out


def contiguous_run(K, model, tokens, new: int, want: dict, what: str, memory=None) -> dict:
    """One contiguous prefill of ``tokens`` (the cross layers over
    ``memory``; after an untimed first one) and ``new`` greedy decode
    steps, launch counts reset just before and checked exactly (``want``):
    the logits of every step, the prefill's ms, each step's ms between
    events and on the host's clock, one step profiled, peak memory.
    Returns the record, the logits and the last caches."""
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = model.cfg
    b, s = tokens.shape
    prefill, decode = make_prefill_step(cfg, s + new), make_decode_step(cfg)
    # a first prefill at these shapes, untimed: the first call of a shape
    # pays the library's one-time set-up (on an H100, MusicGen's first
    # 1024-wide engine prefill took 201 ms, the next ones 40)
    prefill(model, tokens, memory)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(new + 2)]
    ev[0].record()
    logits, caches = prefill(model, tokens, memory)
    ev[1].record()
    got = [logits]
    t0 = time.perf_counter()
    for i in range(new):
        logits, caches = decode(model, caches, got[-1].argmax(dim=-1, keepdim=True).int(), s + i)
        ev[i + 2].record()
        got.append(logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_exact(counts, want, f"{what}: prefill + {new} decode steps")
    if not all(bool(torch.isfinite(lg).all()) and lg.shape == (b, cfg.vocab) for lg in got):
        raise AssertionError(f"{what}: non-finite or misshapen logits")
    prefill_ms = ev[0].elapsed_time(ev[1])
    step_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(new)]
    first = got[0].argmax(dim=-1, keepdim=True).int()
    # one more step at position s for the profile: it rewrites the cache
    # row of position s with the same k and v (the logits are kept)
    busy = device_busy(lambda: decode(model, caches, first, s))
    log(f"  {what}: prefill {prefill_ms:.1f} ms ({b * s / prefill_ms * 1e3:.0f} tokens/s); decode "
        f"{wall / new * 1e3:.2f} ms a step on the host's clock ({b * new / wall:.1f} tokens/s), "
        f"{np.median(step_ms):.2f} ms median between events; one step profiled: device busy "
        f"{busy['busy_ms']:.3f} ms of {busy['window_ms']:.3f} (idle {busy['idle_share']:.1%}); "
        f"peak {peak:.2f} GiB; by family "
        f"{json.dumps({k: round(v, 3) for k, v in busy['device_ms_by_family'].items()})}")
    rec = dict(launches=counts, prefill_ms=prefill_ms, decode_ms_wall=wall / new * 1e3,
               decode_ms_events=step_ms, decode_step_profile=busy, peak_gib=peak,
               prefill_tokens_per_s=b * s / prefill_ms * 1e3, tokens_per_s=b * new / wall)
    return rec, got, caches


def teacher_forced_plain(model, tokens, got, memory=None) -> list:
    """The logits of ``ops="plain"`` prefill and decode, fed the kernel run's
    greedy tokens (``got``: its logits a step)."""
    from repro_torch.models import transformer as T

    s, new = tokens.shape[1], len(got) - 1
    with torch.inference_mode():
        lg, c = T.prefill(model, tokens, s + new, memory=memory, ops="plain")
        plain = [lg]
        for i in range(new):
            lg, c = T.decode_step(model, c, got[i].argmax(dim=-1, keepdim=True).int(), s + i,
                                  ops="plain")
            plain.append(lg)
    return [rel_l2(a, p_) for a, p_ in zip(got, plain)]


def phase_serve_musicgen(K, dev) -> dict:
    """Phase 16 (b): MusicGen-large at full width and depth (48 layers,
    bf16, seed 0) serves 8 requests on a recording ``ServeEngine`` (the
    serve launcher's stream), each request then through contiguous prefill
    and decode teacher-forced on the engine's tokens; then a contiguous
    prefill of 4 x 1024 and 32 greedy decode steps, against ``ops="plain"``
    teacher-forced: exact launch counts (no norm kernel: the LayerNorm is
    plain), prefill and wave ms, one wave profiled against the weights
    bound."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(MG_ARCH)
    L = cfg.n_layers
    t0 = time.perf_counter()
    model = T.Transformer(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"(b) {cfg.name}: {L} layers, bf16, {weight_bytes / 1e9:.2f} GB of weights, init "
        f"{time.perf_counter() - t0:.1f} s; {MG_ENGINE_REQUESTS} requests through ServeEngine "
        f"(max_seq 4096, 4 slots)")
    torch.cuda.reset_peak_memory_stats()
    eng, wall = moe_engine(K, model, MG_ENGINE_REQUESTS, max_seq=4096)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    done = sorted(eng.done, key=lambda r: r.rid)
    prefills, waves = check_lm_counts(counts, eng, L, "engine", per_call=MG_PER_CALL)
    prefill_ms = {}
    for _, width, a, b in eng.calls["prefill"]:
        prefill_ms.setdefault(width, []).append(a.elapsed_time(b))
    wave_ms = [a.elapsed_time(b) for _, _, a, b in eng.calls["decode"]]
    wave_slots = [n for n, _, _, _ in eng.calls["decode"]]
    wargs, rows = eng.widest
    wave_busy = device_busy(lambda: eng.raw_decode(*wargs))
    widest_ms = float(np.median([ms for ms, n in zip(wave_ms, wave_slots) if n == len(rows)]))
    log(f"  prompts {[r.prompt_len for r in done]}, new tokens {[r.max_new for r in done]}; "
        f"{prefills} prefills, {waves} waves in {wall:.2f} s, peak {peak:.2f} GiB")
    for width in sorted(prefill_ms):
        log(f"  prefill width {width}: {', '.join(f'{m:.2f}' for m in prefill_ms[width])} ms")
    log(f"  waves: median {np.median(wave_ms):.2f} ms; the widest ({len(rows)} slots) median "
        f"{widest_ms:.2f} ms; one profiled: device busy {wave_busy['busy_ms']:.3f} ms of "
        f"{wave_busy['window_ms']:.3f} (idle {wave_busy['idle_share']:.1%}); the weights bound a "
        f"wave at {bound_ms:.2f} ms; by family "
        f"{json.dumps({k: round(v, 3) for k, v in wave_busy['device_ms_by_family'].items()})}")
    contig = engine_vs_contiguous(K, eng, L, kind="layernorm")
    worst = max(q["rel_l2"] for q in contig["requests"])
    log(f"  contiguous against the engine, teacher-forced: logits rel-L2 a request "
        f"{[round(q['rel_l2'], 4) for q in contig['requests']]} (tol {SERVE_TOL['dense_bf16']}), "
        f"greedy disagreements {[q['disagreements'] for q in contig['requests']]}")
    if worst > SERVE_TOL["dense_bf16"]:
        raise AssertionError(f"MusicGen contiguous serving disagrees with the engine: {worst}")
    del eng
    b, s, new = MG_SERVE_B, MG_SERVE_S, MG_SERVE_NEW
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
    rec, got, caches = contiguous_run(K, model, tokens, new, contig_want("layernorm", L, 1, new),
                                      f"contiguous {b} x {s}")
    del caches
    rel = teacher_forced_plain(model, tokens, got)
    log(f"  logits rel-L2, kernels vs plain teacher-forced: prefill {rel[0]:.3e}, decode max "
        f"{max(rel[1:]):.3e} (tol {SERVE_TOL['dense_bf16']})")
    if max(rel) > SERVE_TOL["dense_bf16"]:
        raise AssertionError(f"MusicGen kernel serving disagrees with the plain versions: {rel}")
    rec.update(rel_l2_plain=rel, decode_bound_ms=bound_ms)
    out = dict(layers=L, weight_bytes=weight_bytes,
               engine=dict(launches=counts, prefills=prefills, waves=waves, wall_s=wall,
                           peak_gib=peak, prompts=[r.prompt_len for r in done],
                           max_new=[r.max_new for r in done],
                           prefill_ms_by_width={str(k): v for k, v in sorted(prefill_ms.items())},
                           wave_ms=wave_ms, wave_slots=wave_slots, widest_wave_ms=widest_ms,
                           widest_wave_profile=wave_busy, weights_bound_ms=bound_ms),
               contiguous=contig, prefill_decode=rec)
    del model, got
    torch.cuda.empty_cache()
    return out


def phase_train_vlm(K, dev) -> dict:
    """Phase 16 (c): Llama-3.2-Vision-90B training at full width and one
    superblock (4 "attn" layers and 1 "cross", bf16, f32 AdamW moments,
    every gate at 0.5): 4 ``Trainer`` steps of B 2 x S 4096 over 4096 image
    tokens of memory, exact launch counts (the dense LM's: the cross layer
    counts as an attention layer), step ms, tokens/s, peak memory; then the
    same depth in f32, the kernel loss and every gradient against
    ``ops="plain"``."""
    from repro_torch.configs.registry import get_config, get_optimizer
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train.steps import init_state

    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_TRAIN_LAYERS)
    opt = OptimizerConfig(peak_lr=get_optimizer(VLM_ARCH).peak_lr, schedule="constant",
                          warmup=0, total_steps=VLM_STEPS)
    t0 = time.perf_counter()
    state = init_state(cfg, opt, seed=0, device=dev)
    n_cross = set_gates(state["model"], VLM_GATE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["model"].parameters())
    rng = np.random.default_rng(16)
    log(f"(c) Trainer on EmulatedEngine, {cfg.name}: {cfg.n_layers} of {full.n_layers} layers "
        f"({cfg.layer_kinds()}), d {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} over "
        f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16, {n_params / 1e9:.3f} B params, "
        f"{n_cross} gate(s) at {VLM_GATE}, init {time.perf_counter() - t0:.1f} s; 4 steps of B "
        f"{VLM_B} x S {VLM_S}, memory [{VLM_B}, {cfg.n_image_tokens}, {cfg.d_model}] bf16")
    batches = [make_lm_batch(int(rng.integers(2**31)), VLM_B, VLM_S, cfg.vocab, cfg, dev)
               for _ in range(VLM_STEPS)]
    out = {"train": lm_train_run(K, cfg, opt, state, batches, per_microbatch_dense, "training")}
    out["train"].update(n_params=n_params, gates=[bp.attn.gate.item() for bp, k in zip(
        state["model"].blocks, state["model"].kinds) if k == "cross"])
    state["opt"] = None
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = Transformer(cfg32, seed=1, device=dev)
    set_gates(model, VLM_GATE)
    batch = make_lm_batch(5, 1, 1024, cfg.vocab, cfg32, dev)
    out["grad_check"] = grad_check(model, batch, f"{cfg.n_layers} layers, full width, f32, B 1 x "
                                                 f"S 1024 over {cfg.n_image_tokens} image tokens")
    del model, batch
    torch.cuda.empty_cache()
    return out


def phase_serve_vlm(K, dev) -> dict:
    """Phase 16 (d): Llama-3.2-Vision-90B at full width and 6 of its 20
    superblocks (30 of 100 layers, bf16, seed 0, every gate at 0.5) prefills
    4 prompts of 1024 tokens over 4 x 4096 image tokens and decodes 32
    greedy steps contiguously: exact launch counts (K4 rows 2L+1 a call, K7
    L a prefill), prefill ms, decode ms a step against the weights bound,
    one step profiled, the cross layers' repeat_kv and decode attention
    timed alone; the logits against ``ops="plain"`` teacher-forced; then
    one superblock in f32, 32 decode steps against one forward."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import decode_attention, repeat_kv

    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_SERVE_LAYERS)
    L, b, s, new = cfg.n_layers, VLM_SERVE_B, VLM_SERVE_S, VLM_SERVE_NEW
    t0 = time.perf_counter()
    model = T.Transformer(cfg, seed=0, device=dev)
    n_cross = set_gates(model, VLM_GATE)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"(d) {cfg.name}: {L} of {full.n_layers} layers ({n_cross} cross), bf16, "
        f"{weight_bytes / 1e9:.2f} GB of weights (the decode step's bound {bound_ms:.2f} ms), "
        f"init {time.perf_counter() - t0:.1f} s; {b} prompts of {s} over {cfg.n_image_tokens} "
        f"image tokens each, {new} decode steps")
    gen = torch.Generator(device=dev).manual_seed(16)
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
    memory = torch.randn((b, cfg.n_image_tokens, cfg.d_model), generator=gen, device=dev,
                         dtype=torch.float32).to(model.embed.dtype)
    rec, got, caches = contiguous_run(K, model, tokens, new, contig_want("attn", L, 1, new),
                                      f"contiguous {b} x {s}", memory=memory)
    cache_bytes = sum(t.numel() * t.element_size() for c in caches for t in c.values())

    # the cross layers' decode attention, and its repeat_kv alone, on a
    # cross layer's cache: the reference's repeat_kv of every step
    i = model.kinds.index("cross")
    kc, vc = caches[i]["k"], caches[i]["v"]
    g = cfg.n_heads // cfg.n_kv_heads
    q = torch.randn((b, 1, cfg.n_heads, cfg.head_dim), generator=gen, device=dev).to(kc.dtype)
    valid = torch.ones(kc.shape[1], dtype=torch.bool, device=dev)
    rep_ms = cuda_ms(lambda: (repeat_kv(kc, g), repeat_kv(vc, g)), 10)
    attn_ms = cuda_ms(lambda: decode_attention(q, repeat_kv(kc, g), repeat_kv(vc, g), valid), 10)
    step_ms = float(np.median(rec["decode_ms_events"]))
    log(f"  caches {cache_bytes / 1e9:.3f} GB; a cross layer's decode attention over "
        f"{kc.shape[1]} image tokens {attn_ms:.3f} ms, its repeat_kv of k and v to {cfg.n_heads} "
        f"heads ([{b}, {kc.shape[1]}, {cfg.n_heads}, {cfg.head_dim}] each) {rep_ms:.3f} ms; "
        f"{n_cross} cross layers: {n_cross * attn_ms:.2f} ms ({n_cross * rep_ms:.2f} ms repeat_kv) "
        f"of a {step_ms:.2f} ms step ({n_cross * attn_ms / step_ms:.1%}, repeat_kv "
        f"{n_cross * rep_ms / step_ms:.1%})")
    del caches, kc, vc
    rel = teacher_forced_plain(model, tokens, got, memory)
    log(f"  logits rel-L2, kernels vs plain teacher-forced: prefill {rel[0]:.3e}, decode max "
        f"{max(rel[1:]):.3e} (tol {SERVE_TOL['dense_bf16']})")
    if max(rel) > SERVE_TOL["dense_bf16"]:
        raise AssertionError(f"Llama-3.2-Vision kernel serving disagrees with plain: {rel}")
    rec.update(layers=L, weight_bytes=weight_bytes, decode_bound_ms=bound_ms,
               cache_bytes=cache_bytes, rel_l2_plain=rel, cross_layers=n_cross,
               cross_decode_attention_ms=attn_ms, cross_repeat_kv_ms=rep_ms,
               cross_share=n_cross * attn_ms / step_ms, repeat_kv_share=n_cross * rep_ms / step_ms)
    del model, got, memory
    gc.collect()
    torch.cuda.empty_cache()

    # f32 at one superblock: decoding against the forward
    cfg32 = dataclasses.replace(full, n_layers=VLM_TRAIN_LAYERS, dtype="float32")
    b, s, new = VLM_F32_B, VLM_F32_S, VLM_F32_NEW
    m2 = T.Transformer(cfg32, seed=0, device=dev)
    set_gates(m2, VLM_GATE)
    mem32 = torch.randn((b, cfg.n_image_tokens, cfg.d_model), generator=gen, device=dev)
    with torch.inference_mode():
        lg, c2 = T.prefill(m2, tokens[:b], s + new, memory=mem32)
        got2 = [lg]
        for j in range(new):
            lg, c2 = T.decode_step(m2, c2, got2[-1].argmax(dim=-1, keepdim=True).int(), s + j)
            got2.append(lg)
        ext = torch.cat([tokens[:b], *[x.argmax(dim=-1, keepdim=True).int() for x in got2[:new]]],
                        dim=1)
        h2, _ = m2(ext, memory=mem32)
        oracle = (h2[:, s - 1 :] @ m2.embed.T).float()
    rel32 = [rel_l2(a, oracle[:, j]) for j, a in enumerate(got2)]
    log(f"  f32, {cfg32.n_layers} layers: {new} decode steps from {b} prompts of {s} against the "
        f"forward over {s + new} tokens, rel-L2 prefill {rel32[0]:.3e}, decode max "
        f"{max(rel32[1:]):.3e} (tol {SERVE_TOL['f32']:.0e})")
    if max(rel32) > SERVE_TOL["f32"]:
        raise AssertionError(f"Llama-3.2-Vision f32 decode disagrees with the forward: {rel32}")
    rec["f32"] = dict(layers=cfg32.n_layers, decode_steps=new, rel_l2_forward=rel32)
    del m2, c2, h2, oracle, got2, mem32
    torch.cuda.empty_cache()
    return rec


DRYRUN_TIMEOUT_S = 600  # phase 17 (a): the --all subprocesses together
DRY_ARCH = "llama3.2-1b"
DRY_TRAIN_BATCH = 2  # phase 17 (b): train_4k's global batch of 256, cut
DRY_DECODE_BATCH = 8  # phase 17 (c): decode_32k's global batch of 128, cut
DRY_PEAK_BAND = 0.25  # predicted peak_bytes against the card's (PERF.md, phase 17)


def phase_dryrun_all() -> dict:
    """Phase 17 (a): every cell of the dry run on both production meshes,
    in a subprocess of its own (``--all`` spawns the mesh processes); the
    records checked against the registry's catalogue."""
    from repro_torch.configs.registry import SHAPES, arch_ids, cell_supported, get_config
    from repro_torch.launch import dryrun

    argv = ["--all", "--force", "--timeout", str(DRYRUN_TIMEOUT_S)]
    code = (f"import sys; sys.path.insert(0, {str(SRC)!r}); "
            f"from repro_torch.launch.dryrun import main; sys.exit(main({argv!r}))")
    log_dir = ROOT / "chiprun_out"
    log_dir.mkdir(exist_ok=True)
    log(f"(a) python -m repro_torch.launch.dryrun {' '.join(argv)}")
    t0 = time.perf_counter()
    with open(log_dir / "dryrun.log", "w") as f:
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, stdout=f,
                              stderr=subprocess.STDOUT, timeout=DRYRUN_TIMEOUT_S + 60)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the dry run exited {proc.returncode}: "
                             f"{(log_dir / 'dryrun.log').read_text()[-3000:]}")
    res = json.loads(dryrun.RESULTS.read_text())
    (log_dir / "dryrun.json").write_text(json.dumps(res, indent=1))
    tally, gib, cells = {"ok": 0, "skipped": 0, "error": 0}, 2**30, {}
    for mesh in dryrun.MESHES:
        for arch in arch_ids():
            for name, shape in SHAPES.items():
                key = dryrun.cell_key(arch, name, mesh)
                rec = res[key]
                tally[rec["status"]] = tally.get(rec["status"], 0) + 1
                ok, why = cell_supported(get_config(arch), shape)
                if rec["status"] != ("ok" if ok else "skipped") or rec.get("reason", "") != why:
                    raise AssertionError(f"dry run {key}: {rec['status']} "
                                         f"{rec.get('reason') or rec.get('error')}, expected "
                                         f"{'ok' if ok else 'skipped: ' + why}")
                if not ok:
                    continue
                mem = rec["memory"]
                cells[key] = dict(flops=rec["flops"], arg_gib=mem["argument_bytes"] / gib,
                                  temp_gib=mem["temp_bytes"] / gib,
                                  peak_gib=mem["peak_bytes"] / gib,
                                  coll_gib=rec["collectives"]["total_bytes"] / gib,
                                  trace_s=rec["trace_s"])
                log(f"  {key}: flops/dev {rec['flops']:.4e}  arg {cells[key]['arg_gib']:.3f} "
                    f"temp {cells[key]['temp_gib']:.3f} peak {cells[key]['peak_gib']:.3f} GiB  "
                    f"coll {cells[key]['coll_gib']:.3f} GiB  trace {rec['trace_s']} s")
    if tally != {"ok": 66, "skipped": 22, "error": 0}:
        raise AssertionError(f"dry run: {tally}, expected 66 ok, 22 skipped, 0 error")
    log(f"  {tally['ok']} ok, {tally['skipped']} skipped (the reference's reasons), "
        f"{tally['error']} error in {wall:.1f} s")
    return {"wall_s": wall, "tally": tally, "cells": cells}


def _state_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _dispatched_peak(fn) -> int:
    """The peak bytes the ops dispatched by one call of ``fn`` allocate,
    by the dry run's tracer (``dryrun.LiveBytes``), on whatever device
    they run: on the card, what the meta trace would see if it ran there."""
    from repro_torch.launch.dryrun import LiveBytes

    tracer = LiveBytes()
    with tracer:
        fn()
    torch.cuda.synchronize()
    return tracer.peak


def _peak_gate(what: str, rec: dict, measured: int) -> dict:
    pred = rec["memory"]["peak_bytes"]
    ratio = pred / measured
    log(f"  {what}: predicted peak {pred / 2**30:.3f} GiB (arguments "
        f"{rec['memory']['argument_bytes'] / 2**30:.3f} + temp "
        f"{rec['memory']['temp_bytes'] / 2**30:.3f}), the card's {measured / 2**30:.3f} GiB: "
        f"ratio {ratio:.4f}")
    if abs(ratio - 1) > DRY_PEAK_BAND:
        raise AssertionError(f"{what}: predicted peak {pred} bytes is not within "
                             f"{DRY_PEAK_BAND:.0%} of the card's {measured}")
    return {"predicted_peak_bytes": pred, "card_peak_bytes": measured, "ratio": ratio}


def phase_dryrun_host(K, dev) -> dict:
    """Phase 17 (b), (c): two host-mesh cells of Llama-3.2-1B dry-run, then
    run for real on the card under the host mesh's policy."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config, get_optimizer
    from repro_torch.distributed.sharding import make_policy
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import init_state, make_decode_step, make_train_step

    cfg, opt = get_config(DRY_ARCH), get_optimizer(DRY_ARCH)
    L = cfg.n_layers
    mesh = make_host_mesh()
    out = {}
    try:
        policy = make_policy(mesh, cfg)
        rng = np.random.default_rng(17)

        # (b) train_4k at batch 2
        rec = dryrun.run_cell(DRY_ARCH, "train_4k", "host", global_batch=DRY_TRAIN_BATCH,
                              mesh=mesh)
        log(f"(b) {DRY_ARCH} train_4k on the host mesh, global batch {DRY_TRAIN_BATCH} "
            f"(256 cut): dry run in {rec['cell_s']} s (trace {rec['trace_s']} s)")
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        state = init_state(cfg, opt, seed=0, device=dev)
        tok = rng.integers(0, cfg.vocab, (DRY_TRAIN_BATCH, 4096)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(tok).to(dev),
                 "labels": torch.from_numpy(np.roll(tok, -1, axis=1)).to(dev)}
        held = _state_bytes(list(state["model"].parameters()) + list(state["opt"]["m"].values())
                            + list(state["opt"]["v"].values()) + list(batch.values()))
        log(f"  argument_bytes: predicted {rec['memory']['argument_bytes']:,}, on the card "
            f"{held:,}")
        if held != rec["memory"]["argument_bytes"]:
            raise AssertionError("(b) argument_bytes differ from the card's")
        step = make_train_step(cfg, opt, policy=policy)
        state, m0 = step(state, batch, None)  # warm-up: the first signature
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m1 = step(state, batch, None)
        e1.record()
        torch.cuda.synchronize()
        counts = K.launch_counts()
        ms = e0.elapsed_time(e1)
        raw = torch.cuda.max_memory_allocated()
        for m in (m0, m1):
            if not torch.isfinite(m["loss"]):
                raise AssertionError(f"(b) the loss is not finite: {m}")
        check_counts(counts, 1, L, "(b) host-mesh train step", per_microbatch_dense)
        gate = _peak_gate("(b)", rec, raw - base)
        disp = _dispatched_peak(lambda: step(state, batch, None))
        log(f"  (b) temporaries: the meta trace's {rec['memory']['temp_bytes'] / 2**30:.3f} GiB, "
            f"the ops dispatched on the card {disp / 2**30:.3f}, the allocator's "
            f"{(raw - base - held) / 2**30:.3f}")
        tflops = rec["flops"] / (ms * 1e-3) / 1e12
        log(f"  steady step {ms:.1f} ms, loss {float(m0['loss']):.4f} -> {float(m1['loss']):.4f};"
            f" counted {rec['flops']:.4e} operations: {tflops:.1f} TFLOP/s, "
            f"{tflops / (BF16_FLOPS / 1e12):.1%} of 989 (max_memory_allocated "
            f"{raw / 2**30:.3f} GiB, {base / 2**30:.3f} of it held before the state)")
        out["train"] = dict(record=rec, card_argument_bytes=held, step_ms=ms, launches=counts,
                            tflops_per_s=tflops, peak_share=tflops / (BF16_FLOPS / 1e12),
                            max_memory_allocated=raw, held_before=base,
                            card_dispatched_temp=disp, **gate)
        del state, batch, step, m0, m1
        gc.collect()
        torch.cuda.empty_cache()

        # (c) decode_32k at batch 8, pos the cache's last slot
        cap = 32768
        rec = dryrun.run_cell(DRY_ARCH, "decode_32k", "host", global_batch=DRY_DECODE_BATCH,
                              mesh=mesh)
        log(f"(c) {DRY_ARCH} decode_32k on the host mesh, batch {DRY_DECODE_BATCH} (128 cut), "
            f"capacity {cap}: dry run in {rec['cell_s']} s")
        base = torch.cuda.memory_allocated()
        model = T.Transformer(cfg, seed=0, device=dev)
        caches = T.init_cache(cfg, DRY_DECODE_BATCH, cap, device=dev)
        token = torch.from_numpy(rng.integers(0, cfg.vocab, (DRY_DECODE_BATCH, 1)).astype(
            np.int32)).to(dev)
        held = _state_bytes(list(model.parameters()) + [t for c in caches for t in c.values()]
                            + [token])
        log(f"  argument_bytes: predicted {rec['memory']['argument_bytes']:,}, on the card "
            f"{held:,}")
        if held != rec["memory"]["argument_bytes"]:
            raise AssertionError("(c) argument_bytes differ from the card's")
        decode = make_decode_step(cfg, policy=policy)
        decode(model, caches, token, cap - 1)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        e0.record()
        logits, caches = decode(model, caches, token, cap - 1)
        e1.record()
        torch.cuda.synchronize()
        counts = K.launch_counts()
        raw = torch.cuda.max_memory_allocated()
        if logits.shape != (DRY_DECODE_BATCH, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"(c) logits {tuple(logits.shape)} not finite or misshapen")
        check_exact(counts, contig_want("attn", L, 0, 1), "(c) host-mesh decode step")
        gate = _peak_gate("(c)", rec, raw - base)
        log(f"  decode step {e0.elapsed_time(e1):.2f} ms (max_memory_allocated "
            f"{raw / 2**30:.3f} GiB, {base / 2**30:.3f} of it held before the model)")
        disp = _dispatched_peak(lambda: decode(model, caches, token, cap - 1))
        log(f"  (c) temporaries: the meta trace's {rec['memory']['temp_bytes'] / 2**30:.3f} GiB, "
            f"the ops dispatched on the card {disp / 2**30:.3f}, the allocator's "
            f"{(raw - base - held) / 2**30:.3f}")
        out["decode"] = dict(record=rec, card_argument_bytes=held, step_ms=e0.elapsed_time(e1),
                             launches=counts, max_memory_allocated=raw, held_before=base,
                             card_dispatched_temp=disp, **gate)
        del model, caches, token, logits
    finally:
        dist.destroy_process_group()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels as K
    from repro_torch.kernels import _build

    # one nvcc per source, in the background; meanwhile the host does the
    # process's one-time set-up that needs no kernel of ours: the CUDA
    # context, and torch._dynamo, which torch.utils.checkpoint imports at
    # its first call (seconds of Python imports, on the first training step)
    t0 = time.perf_counter()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    building = pool.submit(_build.build_all)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(card)
    gpus = subprocess.run(["nvidia-smi", "-L"], check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()
    log(f"nvidia-smi -L: {len(gpus)} GPU(s) on this host: {gpus}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.zeros(1, device=dev)
    importlib.import_module("torch._dynamo")

    t_host = time.perf_counter() - t0
    reports = building.result()
    pool.shutdown()
    log(f"built {len(reports)} kernels in {time.perf_counter() - t0:.1f} s (the host's set-up "
        f"beside it {t_host:.1f} s)")
    notices = 0
    for name, rep in reports.items():
        for line in rep.splitlines():
            # each flash instantiation (K7, K8, K9), and ptxas's wgmma notes
            if name.startswith(("flash_fwd", "flash_bwd", "adaln_fwd", "rmsnorm_bwd")) and (
                    "Compiling entry" in line or "wgmma" in line or "setmaxnreg" in line):
                log(f"  {name}: {line.strip()}")
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
            notices += "instructions are serialized" in line
    log(f"  ptxas notices of serialised wgmmas (C7511, C7514, C7520, ...): {notices}")

    record = {"card": card, "gpus": gpus, "torch": torch.__version__, "cuda": torch.version.cuda}
    record["phase_s"] = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        # a phase's objects in reference cycles (trainers, engines, loaders)
        # would keep their device memory until the collector's next pass
        gc.collect()
        torch.cuda.empty_cache()
        record["phase_s"][name] = time.perf_counter() - t
        held = torch.cuda.memory_allocated() / 2**30
        record.setdefault("held_gib", {})[name] = held
        log(f"[{name}: {record['phase_s'][name]:.1f} s, {held:.2f} GiB still allocated]")
        return res

    record["kernels"] = timed("1 kernels", phase_kernels, dev)
    record["kernels"].update(timed("2 kernels_bwd", phase_kernels_bwd, dev))
    record["kernels"].update(timed("2 kernels_ssm", phase_kernels_ssm, dev))
    record["serve"] = timed("3 serve", phase_serve, K, dev)
    record["model_rel_l2"] = timed("4 model", phase_model, dev)
    record["train"] = timed("5 train", phase_train, K, dev)
    lm = timed("2 kernels_lm", phase_kernels_lm, dev)
    record["kernels"]["flash_fwd"]["lm_prefill"] = lm.pop("flash_fwd_lm_prefill")
    record["kernels"].update(lm)
    record["kernels"]["rms_fwd"]["mamba2"] = record["kernels"].pop("rms_fwd_mamba2")
    record["serve_lm"] = timed("6 serve_lm", phase_serve_lm, K, dev)
    record["model_lm"] = timed("7 model_lm", phase_model_lm, dev)
    record["train_ssm"] = timed("8 train_ssm", phase_train_ssm, K, dev)
    record["kernels"].update(timed("9a kernels_ring", phase_kernels_ring, dev))
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        record["kernels"][name]["f32_hop"] = record["kernels"].pop(f"{name}_f32_hop")
    record["train_dense"] = timed("9bc train_dense", phase_train_dense, K, dev)
    record["train_planned"] = timed("10 train_planned", phase_train_planned, K, dev)
    record["train_resume"] = timed("11 train_resume", phase_train_resume, K, dev)
    record["shape_bench"] = timed("12a shape_bench", phase_shape_bench, K, dev)
    record["mesh_nccl"] = timed("12b mesh_nccl", phase_mesh_nccl, K, dev)
    record["mesh_gloo"] = timed("12c mesh_gloo", phase_mesh_gloo, K, dev)
    record["mesh_dispatch"] = timed("12d mesh_dispatch", phase_mesh_dispatch, dev)
    for name, cases in timed("13 kernels_serve", phase_kernels_serve, dev).items():
        record["kernels"][name]["serve13"] = cases
    record["serve13"] = {
        "mamba2": timed("13a serve_mamba2", phase_serve_ssm, K, dev),
        "qwen": timed("13b serve_qwen", phase_serve_dense, K, dev, "qwen2.5-14b", 8),
        "minicpm": timed("13c serve_minicpm", phase_serve_dense, K, dev, "minicpm-2b", 1),
        "example": timed("13d example", phase_example, K, dev),
    }
    for name, cases in timed("14 kernels_hybrid", phase_kernels_hybrid, dev).items():
        record["kernels"][name]["hybrid14"] = cases
    record["hybrid14"] = {
        "train": timed("14a train_hybrid", phase_train_hybrid, K, dev),
        "serve": timed("14bc serve_hybrid", phase_serve_hybrid, K, dev),
    }
    for name, cases in timed("15 kernels_moe", phase_kernels_moe, dev).items():
        record["kernels"][name]["moe15"] = cases
    record["moe15"] = {
        "train": timed("15ad train_moe", phase_train_moe, K, dev),
        "serve": timed("15b serve_moe", phase_serve_moe, K, dev),
        "kimi": timed("15c serve_kimi", phase_serve_kimi, K, dev),
    }
    for name, cases in timed("16 kernels_vlm", phase_kernels_vlm, dev).items():
        record["kernels"][name]["vlm16"] = cases
    record["vlm16"] = {
        "train_musicgen": timed("16ae train_musicgen", phase_train_musicgen, K, dev),
        "serve_musicgen": timed("16b serve_musicgen", phase_serve_musicgen, K, dev),
        "train_vlm": timed("16c train_vlm", phase_train_vlm, K, dev),
        "serve_vlm": timed("16d serve_vlm", phase_serve_vlm, K, dev),
    }
    record["dryrun17"] = {
        "all": timed("17a dryrun_all", phase_dryrun_all),
        **timed("17bc dryrun_host", phase_dryrun_host, K, dev),
    }

    # launches: each main path's own count, reset to 0 just before that run
    # and read just after (the serving waves of phase 3, the 4 training steps
    # of phase 5 (b), the LM serving of phase 6 (b), the 4 Mamba-2 training
    # steps of phase 8 (b), the 4 dense-LM training steps of phase 9 (b), the
    # SP step of phase 9 (c), the planned launcher of phase 10 (a), the
    # churn leg and resumed step of phase 11 (b), (c), the Shape Benchmark's
    # calls of phase 12 (a), the NCCL launcher of phase 12 (b), both
    # processes of phase 12 (c), phase 13's Mamba-2 serving, the Qwen and
    # MiniCPM launchers and contiguous runs, and the example, phase 14's
    # RecurrentGemma training steps and serving, phase 15's Llama-4-Scout
    # training steps, engine and contiguous runs and Kimi-K2's contiguous
    # and paged runs, and phase 16's MusicGen training steps, engine and
    # contiguous runs and Llama-3.2-Vision's training steps and contiguous
    # serving, and phase 17's host-mesh train and decode steps); "launches"
    # is their sum
    kernels = []
    vlm16 = record["vlm16"]
    for name, k in record["kernels"].items():
        by_path = {"serve": record["serve"]["launches"][name],
                   "train": record["train"]["train"]["launches"][name],
                   "serve_lm": record["serve_lm"]["serve"]["launches"][name],
                   "train_lm": record["train_ssm"]["train"]["launches"][name],
                   "train_dense": record["train_dense"]["train"]["launches"][name],
                   "train_sp": record["train_dense"]["sp"]["launches"][name],
                   "train_planned": record["train_planned"]["launcher"]["launches"][name],
                   "train_resume": record["train_resume"]["launches"][name],
                   "shape_bench": record["shape_bench"]["launches"][name],
                   "train_mesh_nccl": record["mesh_nccl"]["launches"][name],
                   "train_mesh_gloo": record["mesh_gloo"]["launches"][name],
                   "serve_mamba2": record["serve13"]["mamba2"]["launches"][name],
                   "serve_qwen": record["serve13"]["qwen"]["launcher"]["launches"][name],
                   "contig_qwen": record["serve13"]["qwen"]["contiguous"]["launches"][name],
                   "serve_minicpm": record["serve13"]["minicpm"]["launcher"]["launches"][name],
                   "contig_minicpm": record["serve13"]["minicpm"]["contiguous"]["launches"][name],
                   "example_llama_f32": record["serve13"]["example"]["launches"][name],
                   "train_hybrid": record["hybrid14"]["train"]["train"]["launches"][name],
                   "serve_hybrid": record["hybrid14"]["serve"]["launches"][name],
                   "train_moe": record["moe15"]["train"]["train"]["launches"][name],
                   "serve_moe": record["moe15"]["serve"]["engine"]["launches"][name],
                   "contig_moe": record["moe15"]["serve"]["contiguous"]["launches"][name],
                   "contig_kimi": record["moe15"]["kimi"]["launches"][name],
                   "paged_kimi": record["moe15"]["kimi"]["paged_launches"][name],
                   "train_musicgen": vlm16["train_musicgen"]["train"]["launches"][name],
                   "serve_musicgen": vlm16["serve_musicgen"]["engine"]["launches"][name],
                   "contig_musicgen_engine":
                       vlm16["serve_musicgen"]["contiguous"]["launches"][name],
                   "contig_musicgen": vlm16["serve_musicgen"]["prefill_decode"]["launches"][name],
                   "train_vlm": vlm16["train_vlm"]["train"]["launches"][name],
                   "contig_vlm": vlm16["serve_vlm"]["launches"][name],
                   "dry_train_host": record["dryrun17"]["train"]["launches"][name],
                   "dry_decode_host": record["dryrun17"]["decode"]["launches"][name]}
        kernels.append({"name": name, **{key: k[key] for key in (
            "route", "source", "replaces")}, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **{key: k[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}})
    record["wall_s"] = time.perf_counter() - t_start
    log(f"chip_smoke: every phase passed in {record['wall_s']:.1f} s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # one process of phase 12 (c)
        ap = argparse.ArgumentParser(description="one process of chip_smoke.py phase 12 (c)")
        ap.add_argument("--mesh-rank", type=int, required=True)
        ap.add_argument("--store", required=True)
        ap.add_argument("--out", required=True)
        a = ap.parse_args()
        sys.exit(mesh_child(a.mesh_rank, a.store, a.out))
    sys.exit(main())
