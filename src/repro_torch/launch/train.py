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
(``EmulatedEngine``: the pool-mean gradient, one AdamW update a step).
Without ``--adaptive`` every step is one fixed ``--batch`` x ``--seq``
microbatch.  The mmdit trains on diffusion latents, the LMs (the dense
``tinyllama-1.1b``, the default as in the reference launcher, and
``llama3.2-1b``; the ssm ``mamba2-2.7b``) on unpacked synthetic token
streams (``make_lm_batch``) of the same shapes.  On the card the loader's
thread draws batches on a side stream (``on_side_stream``), off the stream
the engine times.  It prints the final loss and tokens/s.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCHS, get_config, get_optimizer, get_smoke_config
from repro_torch.core.bucketing import BucketingPolicy, DataShape
from repro_torch.core.dispatch import DISPATCH_STRATEGIES
from repro_torch.data.pipeline import BucketedLoader, ShardedBucketedLoader, on_side_stream
from repro_torch.data.synthetic import make_diffusion_batch, make_lm_batch
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.loop import Trainer, TrainHistory
from repro_torch.train.steps import init_state

EPILOG = (
    "Not yet in the port (each comes with its slice, and its flag is an error "
    "here): the final checkpoint save and --ckpt-dir/--resume/--keep/--ckpt-every/"
    "--digest-log and --chaos/--preempt-flag (checkpoints and fault tolerance, "
    "ROADMAP Queue 1 item 3); --mesh and --elastic (one rank a GPU, the multi-GPU "
    "plan executor, item 4).  --workers runs its ranks serially on one device; "
    "a split window merges back whole there (the ring step itself is "
    "repro_torch.train.steps.make_sp_pool_grad_step)."
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
    ap.add_argument("--steps", type=int, default=30, help="optimizer steps")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--adaptive", action="store_true",
                    help="bucketed AdaptiveLoad data (variable shapes)")
    ap.add_argument("--workers", type=int, default=1,
                    help="DP ranks fed from one global step plan (run serially)")
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
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without a GPU); 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    # the reference launcher's checks, where they apply
    if args.workers > 1 and not args.adaptive:
        ap.error("--workers > 1 requires --adaptive (the fixed-shape stream "
                 "has no planner to shard)")
    if args.overlap and args.dispatch != "knapsack":
        ap.error("--overlap refines knapsack plans; pass --dispatch knapsack")
    if args.overlap and not args.workers > 1:
        ap.error("--overlap requires the planner-driven stream (--workers > 1)")
    if args.deterministic_refine and not args.overlap:
        ap.error("--deterministic-refine configures the overlapped refiner; "
                 "pass --overlap (the synchronous knapsack pass is already "
                 "deterministic)")
    if args.sp_max_ranks < 1:
        ap.error("--sp-max-ranks must be >= 1")
    if args.sp_max_ranks > 1 and not args.workers > 1:
        ap.error("--sp-max-ranks > 1 needs the planner-driven multi-rank "
                 "stream (--workers N > 1)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt = get_optimizer(args.arch)
    opt = OptimizerConfig(
        peak_lr=opt.peak_lr, schedule="constant", warmup=0,
        total_steps=args.steps, state_dtype=cfg.opt_state_dtype,
    )
    device = resolve_device(args.device)
    state = init_state(cfg, opt, seed=0, device=device)

    def make_batch(rng_np, bucket):
        # exactly one draw from the loader's generator per microbatch, as
        # the reference launcher takes one for its PRNGKey
        seed = int(rng_np.integers(2**31))
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
        if args.workers > 1:
            # global step plan: one pool per step, packed across ranks by
            # quadratic load, instead of independent per-rank draws
            loader = ShardedBucketedLoader(
                buckets, None, on_side_stream(make_batch, device),
                n_workers=args.workers,
                budget=float(args.batch * args.seq),
                budget_of=lambda b: float(b.tokens),
                load_of=lambda b: b.load(policy.p),
                strategy=args.dispatch,
                overlap=args.overlap,
                deterministic_refine=args.deterministic_refine,
                refine_rounds=args.refine_rounds,
                sp_max_ranks=args.sp_max_ranks if args.sp_max_ranks > 1 else None,
            )
        else:
            loader = BucketedLoader(
                buckets, None, on_side_stream(make_batch, device),
                budget=float(args.batch * args.seq), budget_of=lambda b: float(b.tokens),
            )
    else:
        loader = _Fixed(make_batch, np.random.default_rng(0), args.batch, args.seq)
    try:
        state, hist = Trainer(cfg, opt).run(state, iter(loader), args.steps, rng=1,
                                            log_every=10)
    finally:
        loader.close()
    if isinstance(loader, ShardedBucketedLoader):
        # the producer runs ahead by its prefetch depth: the consumed prefix
        hist.plans = loader.plans[:len(hist.losses)]
    print(
        f"done: {args.steps} steps, final loss {hist.losses[-1]:.4f}, "
        f"throughput {hist.throughput:,.0f} tok/s, events={hist.events}"
    )
    return hist


if __name__ == "__main__":
    main()
