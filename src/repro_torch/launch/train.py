"""Training launcher of the port (the mmdit and LM routes of
``repro.launch.train`` on emulated ranks):

    PYTHONPATH=src python -m repro_torch.launch.train --adaptive --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --adaptive --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch wan2.1-1.3b \\
        --adaptive --workers 4 --dispatch lpt --steps 2

runs on CUDA; ``--device cpu --smoke`` trains the smoke configuration on
the plain PyTorch path.  ``--adaptive`` feeds dual-constraint buckets
(``B = min(M_mem / S, M_comp / S^p)``) with the reference launcher's
shapes, budgets and seeds: through ``BucketedLoader`` at one rank, and with
``--workers N > 1`` through ``ShardedBucketedLoader``, whose ``StepPlanner``
draws one global pool a step and packs it across the N ranks by ``B·S^p``
(``--dispatch``; ``--overlap`` refines knapsack plans on a background
thread, ``--deterministic-refine`` in fixed rounds; ``--sp-max-ranks``
lets it split packed windows).  The N ranks run serially on one device
(``EmulatedEngine``: the pool-mean gradient, one AdamW update a step), or,
with ``--mesh``, one process a rank: start N processes with ``--rank
0..N-1``, the same ``--dist-store`` (a file path or ``tcp://host:port``)
and ``--backend`` (``nccl``, one card a rank, or ``gloo``).  Each process
draws the whole plan stream (every microbatch's seed from the loader's
generator, so plans and draws are the emulated route's), makes only its
own rank's batches on its device, and ``PlanExecutor`` sums the ranks'
gradients in one ``all_reduce`` a step (``MeshEngine``).
Without ``--adaptive`` every step is one fixed ``--batch`` x ``--seq``
microbatch.  The mmdit trains on diffusion latents, the LMs (the dense
``tinyllama-1.1b``, the default as in the reference launcher, and
``llama3.2-1b``; the ssm ``mamba2-2.7b``; the MoE ``llama4-scout-17b-a16e``
and ``kimi-k2-1t-a32b``; the audio ``musicgen-large``; the vlm
``llama-3.2-vision-90b``, whose batches carry the stub frontend's image
``memory``) on unpacked synthetic token streams (``make_lm_batch``) of the
same shapes.  On the card the loader's
thread draws batches on a side stream (``on_side_stream``), off the stream
the engine times.  It prints the final loss and tokens/s.

**Checkpoints and resume.**  ``--steps`` is the TOTAL step count of the
run.  With ``--ckpt-dir`` a ``FaultTolerantRunner`` saves on its cadence
(``--ckpt-every``, newest ``--keep`` kept), on failures, joins and a
graceful preemption (``--preempt-flag`` or SIGTERM), and once at the end;
``--resume`` restores the latest checkpoint there, weights AND run state
(trainer key, loader and planner streams, next step), and trains the
remaining steps, so a killed-and-resumed run gives byte-identical plan
digests (``--digest-log`` writes one hex digest a consumed plan) and the
same parameters as the uninterrupted run.  ``--chaos`` injects faults
(``repro_torch.distributed.chaos``) on ``--workers N > 1``; ``--elastic``
says how a rank-count change lands (``remap``: the plan stream keeps its
width, shares regroup onto the physical ranks; ``replan``: the loader is
resized).  Checkpoints use the JAX package's format, so either launcher
resumes the other's.  Without ``--ckpt-dir`` nothing is saved.

    PYTHONPATH=src python -m repro_torch.launch.train --arch wan2.1-1.3b \\
        --adaptive --workers 4 --steps 6 --ckpt-dir CKPT --digest-log D \\
        --chaos 'kill@1:2,3;join@3:2;preempt@4'
    PYTHONPATH=src python -m repro_torch.launch.train --arch wan2.1-1.3b \\
        --adaptive --workers 4 --steps 6 --ckpt-dir CKPT --digest-log D --resume

On a mesh, rank 0 alone writes checkpoints and the digest log, every rank
restores, and every rank waits at a barrier after each save:

    T=$(mktemp -d); for r in 0 1; do PYTHONPATH=src python -m \\
        repro_torch.launch.train --arch wan2.1-1.3b --adaptive --mesh \\
        --workers 2 --rank $r --backend gloo --dist-store $T/store \\
        --steps 2 & done; wait
"""

from __future__ import annotations

import argparse
import functools
import signal

import numpy as np
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import store
from repro_torch.configs.registry import ARCHS, get_config, get_optimizer, get_smoke_config
from repro_torch.core.bucketing import BucketingPolicy, DataShape
from repro_torch.core.dispatch import DISPATCH_STRATEGIES
from repro_torch.data.pipeline import BucketedLoader, ShardedBucketedLoader, on_side_stream
from repro_torch.data.synthetic import make_diffusion_batch, make_lm_batch
from repro_torch.distributed.chaos import ChaosSchedule
from repro_torch.distributed.fault_tolerance import (
    CheckpointCadence,
    FaultTolerantRunner,
    HeartbeatMonitor,
    PreemptionNotice,
    RankZeroRunner,
)
from repro_torch.distributed.plan_exec import DeferredBatch
from repro_torch.launch.mesh import make_data_group
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.loop import Trainer, TrainHistory, deserialize_rng_key
from repro_torch.train.steps import init_state

EPILOG = (
    "Differences from repro.launch.train: checkpoints are written only with "
    "--ckpt-dir (the reference defaults to /tmp/repro_ckpt and always saves at the "
    "end), so --resume, --chaos and --preempt-flag need it; the SIGTERM handler "
    "(graceful preemption) is installed for the duration of main only.  --mesh runs "
    "one process a rank (--rank, --dist-store, --backend; --workers is the world "
    "size): plan agreement is checked every step, --overlap needs "
    "--deterministic-refine when --workers > 1, and with --ckpt-dir rank 0 alone "
    "writes.  --workers without --mesh runs its ranks serially on one device; a "
    "split window merges back whole there."
)


class _Fixed:
    """Fixed-shape stream: one ``batch`` x ``seq`` microbatch per step."""

    class _Bucket:
        def __init__(self, batch: int, seq: int):
            self.batch_size, self.seq_len, self.tokens = batch, seq, batch * seq

    def __init__(self, make_batch, rng, batch: int, seq: int):
        self._make_batch, self._rng = make_batch, rng
        self._bucket = self._Bucket(batch, seq)

    def __iter__(self):
        return self

    def __next__(self):
        return [(self._bucket, self._make_batch(self._rng, self._bucket))]

    def close(self) -> None:
        pass


def main(argv=None) -> TrainHistory:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], epilog=EPILOG)
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=30,
                    help="TOTAL steps for the run (a resumed run trains steps..--steps "
                         "from the checkpoint)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; without it nothing is saved")
    ap.add_argument("--resume", action="store_true",
                    help="restore weights + full run state (plan stream, keys) from the "
                         "latest checkpoint under --ckpt-dir")
    ap.add_argument("--keep", type=int, default=3,
                    help="checkpoint retention: newest K survive")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="min steps between periodic checkpoints")
    ap.add_argument("--digest-log", default=None, metavar="PATH",
                    help="write each consumed plan's sha256 digest (one hex line per "
                         "step; appended on a resumed run)")
    ap.add_argument("--adaptive", action="store_true",
                    help="bucketed AdaptiveLoad data (variable shapes)")
    ap.add_argument("--workers", type=int, default=1,
                    help="DP ranks fed from one global step plan (run serially; with "
                         "--mesh the world size, one process a rank)")
    ap.add_argument("--mesh", action="store_true",
                    help="execute the step plan with one process a rank over "
                         "torch.distributed (PlanExecutor) instead of emulating ranks")
    ap.add_argument("--rank", type=int, default=0, help="this process's rank (--mesh)")
    ap.add_argument("--dist-store", default=None, metavar="PATH|tcp://HOST:PORT",
                    help="the process group's rendezvous: a FileStore path every rank "
                         "names, or rank 0's TCP address (--mesh)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the process group's backend (--mesh): nccl, one card a rank; "
                         "gloo")
    ap.add_argument("--dispatch", default="lpt", choices=DISPATCH_STRATEGIES,
                    help="step-level microbatch dispatch strategy (§4.5)")
    ap.add_argument("--overlap", action="store_true",
                    help="overlapped execution: knapsack-swap plan refinement runs "
                         "behind the previous step's compute (requires --dispatch "
                         "knapsack)")
    ap.add_argument("--deterministic-refine", action="store_true",
                    help="fixed-round digest-seeded refinement: adoption is a pure "
                         "function of the plan (requires --overlap)")
    ap.add_argument("--refine-rounds", type=int, default=16,
                    help="exchange rounds for --deterministic-refine")
    ap.add_argument("--sp-max-ranks", type=int, default=1,
                    help="sequence parallelism: let the planner split one long packed "
                         "window across up to K contiguous ranks; 1 = never split.  "
                         "Only packed variable-length microbatches are eligible")
    ap.add_argument("--elastic", default="remap", choices=("remap", "replan"),
                    help="how rank-count changes (failures, joins) land: 'remap' keeps "
                         "the plan stream at its logical width and regroups shares onto "
                         "the physical ranks (digest-stable under churn); 'replan' "
                         "resizes the loader itself")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="deterministic fault injection, e.g. "
                         "'kill@4:2,3;join@8:2;preempt@12' (repro_torch.distributed.chaos)")
    ap.add_argument("--preempt-flag", default=None, metavar="PATH",
                    help="poll this path each step; its appearance (or SIGTERM) triggers "
                         "a graceful preemption: full run-state save, then clean exit")
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without a GPU); 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    # the reference launcher's checks, where they apply
    if args.workers > 1 and not args.adaptive:
        ap.error("--workers > 1 requires --adaptive (the fixed-shape stream "
                 "has no planner to shard)")
    if args.overlap and args.dispatch != "knapsack":
        ap.error("--overlap refines knapsack plans; pass --dispatch knapsack")
    if args.mesh and not args.adaptive:
        ap.error("--mesh requires --adaptive (mesh execution consumes the "
                 "planner's per-rank streams)")
    if args.mesh and (args.dist_store is None or args.backend is None):
        ap.error("--mesh needs --dist-store and --backend")
    if not args.mesh and (args.rank != 0 or args.dist_store or args.backend):
        ap.error("--rank, --dist-store and --backend configure --mesh")
    if args.overlap and not (args.mesh or args.workers > 1):
        ap.error("--overlap requires the planner-driven stream "
                 "(--workers > 1 or --mesh)")
    if args.mesh and args.workers > 1 and args.overlap and not args.deterministic_refine:
        ap.error("--mesh --overlap needs --deterministic-refine: wall-clock adoption "
                 "differs between processes, and their plans would part")
    if args.deterministic_refine and not args.overlap:
        ap.error("--deterministic-refine configures the overlapped refiner; "
                 "pass --overlap (the synchronous knapsack pass is already "
                 "deterministic)")
    if args.resume and args.overlap and not args.deterministic_refine:
        ap.error("--resume with --overlap needs --deterministic-refine: "
                 "wall-clock adoption makes the plan stream unreplayable")
    if args.chaos and not (args.adaptive and args.workers > 1):
        ap.error("--chaos injects rank-level faults; pass --adaptive "
                 "--workers N (N > 1)")
    if args.sp_max_ranks < 1:
        ap.error("--sp-max-ranks must be >= 1")
    if args.sp_max_ranks > 1 and not (args.mesh or args.workers > 1):
        ap.error("--sp-max-ranks > 1 needs the planner-driven multi-rank "
                 "stream (--workers N > 1, usually with --mesh)")
    for flag, value in (("--resume", args.resume), ("--chaos", args.chaos),
                        ("--preempt-flag", args.preempt_flag)):
        if value and args.ckpt_dir is None:
            ap.error(f"{flag} needs --ckpt-dir (without it nothing is saved)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt = get_optimizer(args.arch)
    opt = OptimizerConfig(
        peak_lr=opt.peak_lr, schedule="constant", warmup=0,
        total_steps=args.steps, state_dtype=cfg.opt_state_dtype,
    )
    group = None
    if args.mesh:
        group = make_data_group(rank=args.rank, world_size=args.workers, store=args.dist_store,
                                backend=args.backend, device=args.device)
        device = group.device
    else:
        device = resolve_device(args.device)
    try:
        return _train(args, cfg, opt, device, group)
    finally:
        if group is not None:
            group.close()


def _train(args, cfg, opt, device, group) -> TrainHistory:
    rank0 = group is None or group.rank == 0
    state = init_state(cfg, opt, seed=0, device=device)
    start = 0
    run_state = None
    if args.resume:
        latest = store.latest_step(args.ckpt_dir)
        if latest is not None:
            state = store.restore(args.ckpt_dir, state)
            run_state = store.load_run_state(args.ckpt_dir)
            start = run_state["step"] if run_state is not None else latest
            print(f"resumed from step {start}"
                  + ("" if run_state else " (weights-only checkpoint: fresh run state)"))
    n_run = args.steps - start
    if n_run <= 0:
        print(f"nothing to do: checkpoint already at step {start} >= --steps {args.steps}")
        return TrainHistory()

    def make_batch(rng_np, bucket):
        # exactly one draw from the loader's generator per microbatch, as
        # the reference launcher takes one for its PRNGKey
        seed = int(rng_np.integers(2**31))
        if group is not None:
            # every process draws the whole pool; each makes only its own
            # rank's batches, on its device, when the executor takes them
            if cfg.family == "mmdit":
                return DeferredBatch(make_diffusion_batch,
                                     (seed, bucket.batch_size, bucket.seq_len, cfg))
            return DeferredBatch(make_lm_batch,
                                 (seed, bucket.batch_size, bucket.seq_len, cfg.vocab, cfg))
        if cfg.family == "mmdit":
            return make_diffusion_batch(seed, bucket.batch_size, bucket.seq_len, cfg, device)
        return make_lm_batch(seed, bucket.batch_size, bucket.seq_len, cfg.vocab, cfg, device)

    if args.adaptive:
        # variable-shape bucketed stream with the dual constraint (the
        # reference launcher's shapes and budgets; seq lens stay <= 512, so
        # an LM's loss is a single softmax-xent chunk)
        shapes = [DataShape(1, 256, 256, 16), DataShape(9, 192, 192, 16),
                  DataShape(17, 192, 192, 16)]
        policy = BucketingPolicy(m_mem=args.batch * 1024, m_comp=2.0e7, p=2.0)
        buckets = policy.make_buckets(shapes)
        if group is not None or args.workers > 1:
            # global step plan: one pool per step, packed across ranks by
            # quadratic load, instead of independent per-rank draws
            loader = ShardedBucketedLoader(
                buckets, None,
                make_batch if group is not None else on_side_stream(make_batch, device),
                n_workers=args.workers,
                budget=float(args.batch * args.seq),
                budget_of=lambda b: float(b.tokens),
                load_of=lambda b: b.load(policy.p),
                strategy=args.dispatch,
                overlap=args.overlap,
                deterministic_refine=args.deterministic_refine,
                refine_rounds=args.refine_rounds,
                sp_max_ranks=args.sp_max_ranks if args.sp_max_ranks > 1 else None,
                resume_state=(run_state or {}).get("loader"),
                # on a mesh each process draws the stream itself: no lead,
                # so a resize lands at the same plan on every process
                **({"prefetch": 0} if group is not None else {}),
            )
        else:
            loader = BucketedLoader(
                buckets, None, on_side_stream(make_batch, device),
                budget=float(args.batch * args.seq), budget_of=lambda b: float(b.tokens),
            )
    else:
        loader = _Fixed(make_batch, np.random.default_rng(0), args.batch, args.seq)
    sharded = isinstance(loader, ShardedBucketedLoader)

    def run_state_of(held: int) -> dict:
        return {"loader": loader.state_dict(rewind=held)} if sharded else {}

    ft = None
    installed = False
    try:
        if args.ckpt_dir is not None:
            preemption = PreemptionNotice(flag_file=args.preempt_flag)
            # put back in ``finally``: the caller's own SIGTERM handling
            # (a test runner, a parent script) must survive this call
            previous_sigterm = preemption.install_signal_handler()
            installed = True
            runner = (FaultTolerantRunner if group is None
                      else functools.partial(RankZeroRunner, group=group.group))
            ft = runner(
                ckpt_dir=args.ckpt_dir,
                cadence=CheckpointCadence(ckpt_cost_s=0.5, mtbf_s=3600.0,
                                          min_interval_steps=args.ckpt_every),
                monitor=HeartbeatMonitor(n_workers=args.workers, timeout_s=1e9),
                keep=args.keep,
                preemption=preemption,
            )
        chaos = ChaosSchedule.from_spec(args.chaos) if args.chaos else None
        # the mesh route measures every rank (CUDA events, gathered), so its
        # records are the emulated route's
        trainer = Trainer(cfg, opt, ft=ft, run_state_of=run_state_of, chaos=chaos, mesh=group,
                          measure_ranks="async" if group is not None else None)
        if ft is not None and args.elastic == "remap":
            # the plan stream stays at logical width --workers; rank changes
            # only regroup shares onto the surviving/grown physical fleet, so
            # the consumed digest stream is byte-identical under churn
            ft.on_resize = trainer.set_physical_ranks
        elif ft is not None and sharded:
            ft.on_resize = loader.resize
        trainer_rng = (deserialize_rng_key(run_state["trainer"]["rng"])
                       if run_state is not None else 1)
        try:
            state, hist = trainer.run(state, iter(loader), n_run, rng=trainer_rng,
                                      start_step=start, log_every=10)
        finally:
            loader.close()
        n_done = len(hist.losses)  # < n_run when a preemption broke the loop
        if sharded:
            # the producer runs ahead by its prefetch depth: the consumed prefix
            hist.plans = loader.plans[:n_done]
            if args.digest_log and rank0:
                # appended only when the run resumed mid-stream: a --resume
                # that found no checkpoint starts at step 0 and truncates
                with open(args.digest_log, "a" if start > 0 else "w") as f:
                    for p in hist.plans:
                        f.write(p.digest().hex() + "\n")
                print(f"plan digests for steps {start}..{start + n_done - 1} -> "
                      f"{args.digest_log}")
        if hist.preempted:
            # the runner already saved weights + run state inside the grace
            # window; a second save here would advance past the handoff point
            print(f"preempted after step {start + n_done - 1}: run state saved, resume "
                  f"with --resume to train the remaining {args.steps - start - n_done} steps")
            return hist
        print(
            f"done: {n_run} steps ({start}..{args.steps - 1}), final loss "
            f"{hist.losses[-1]:.4f}, throughput {hist.throughput:,.0f} tok/s, "
            f"events={hist.events}"
        )
        if ft is not None:
            if rank0:
                store.save(state, args.steps, args.ckpt_dir, keep=args.keep,
                           run_state=trainer.last_run_state)
                print(f"checkpoint (weights + run state) at step {args.steps} -> "
                      f"{args.ckpt_dir}")
            if group is not None:
                dist.barrier()
        return hist
    finally:
        if installed:  # None: a handler not set from Python, put back as the default
            signal.signal(signal.SIGTERM,
                          signal.SIG_DFL if previous_sigterm is None else previous_sigterm)


if __name__ == "__main__":
    main()
