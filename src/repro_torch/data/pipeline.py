"""Bucketed data pipeline: the paper's Fig. 2 dataloader, the port's copy of
``repro.data.pipeline`` (the loaders are framework-free: ``make_batch``
decides where batches live; packed microbatches are numpy arrays, as the
reference's, and :func:`to_device` moves them).

``BucketedLoader`` drives ONE data-parallel worker's stream:

  shape corpus -> bucket draw -> (B_shape, S) microbatch -> accumulate to the
  step budget (tokens for the baseline, fitted B*S^p load for AdaptiveLoad)

``ShardedBucketedLoader`` drives ALL workers from one global dispatch
decision: a single prefetch thread asks a ``StepPlanner`` for each step's
cluster-wide plan (§4.5 intra-step re-alignment), materializes the plan's
microbatches once, and fans them out to per-rank queues — so rank streams
are never independent draws and step-level load balance survives all the
way to the devices.

A background prefetch thread keeps ``prefetch`` steps of synthetic batches
ready so device steps never wait on the host (the paper's shape benchmark
explicitly excludes data-loading jitter; this is how the real loop does
too).  ``plan_update()`` lets the closed-loop scheduler swap bucket tables
mid-training without draining the pipeline.
"""

from __future__ import annotations

import copy
import queue
import threading
from collections import deque
from typing import Callable, Deque, Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.bucketing import Bucket
from repro_torch.core.cost_model import CostModel
from repro_torch.core.dispatch import (
    SplitShard,
    StepPlan,
    StepPlanner,
    assign_pool,
    merge_split_worker_steps,
    normalized_weights,
)
from repro_torch.data.packing import (
    PackedBucket,
    PackedWindow,
    pack_documents,
    segment_id_batch,
    split_packed_batch,
)


class SnapshotUnavailable(RuntimeError):
    """``state_dict`` cannot produce a replayable snapshot *right now*
    (the boundary plan was re-emitted by an elastic resize, or the rewind
    outran the retained window).  Transient by construction: the next
    producer-drawn plan boundary is snapshotted again, so callers defer
    the checkpoint one boundary instead of dying."""


class BucketedLoader:
    def __init__(
        self,
        buckets: Sequence[Bucket],
        weights: Sequence[float] | None,
        make_batch: Callable[[np.random.Generator, Bucket], dict],
        *,
        budget: float,
        budget_of: Callable[[Bucket], float],
        seed: int = 0,
        prefetch: int = 2,
    ):
        self._lock = threading.Lock()
        self._buckets = list(buckets)
        self._probs = normalized_weights(self._buckets, weights)
        self._make_batch = make_batch
        self.budget = budget
        self.budget_of = budget_of
        self._rng = np.random.default_rng(seed)
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._error: Exception | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- plan updates from the closed-loop scheduler -------------------------

    def plan_update(
        self,
        buckets: Sequence[Bucket],
        budget: float,
        weights: Sequence[float] | None = None,
    ) -> None:
        probs = normalized_weights(list(buckets), weights)
        with self._lock:
            self._buckets = list(buckets)
            self._probs = probs
            self.budget = budget

    # -- producer -------------------------------------------------------------

    def _draw_step(self) -> list[tuple[Bucket, dict]]:
        with self._lock:
            buckets, probs, budget = self._buckets, self._probs, self.budget
        out = []
        acc = 0.0
        while acc < budget:
            b = buckets[int(self._rng.choice(len(buckets), p=probs))]
            out.append((b, self._make_batch(self._rng, b)))
            acc += self.budget_of(b)
        return out

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                step = self._draw_step()
                while not self._stop.is_set():
                    try:
                        self._q.put(step, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # noqa: BLE001 — surface to the consumer
            self._error = e

    # -- consumer ---------------------------------------------------------------

    def __iter__(self) -> Iterator[list[tuple[Bucket, dict]]]:
        return self

    def __next__(self) -> list[tuple[Bucket, dict]]:
        while True:
            if self._error is not None:
                raise RuntimeError("loader producer failed") from self._error
            try:
                return self._q.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():  # closed: end the stream
                    raise StopIteration
                continue

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def materialize_packed_windows(
    lengths: Sequence[int],
    *,
    window: int,
    p: float | None = None,
    load_budget: float | None = None,
    vocab: int = 32_000,
    batch_windows: int = 1,
    seed: int = 0,
    cost_model: CostModel | None = None,
) -> list[dict]:
    """Pack documents and materialize model-ready packed microbatches.

    Each microbatch dict carries ``batch_windows`` windows:

    * ``tokens`` / ``labels`` — ``[Bw, window]`` int32 synthetic streams
      (padding slots and document-final positions carry label 0: the loss
      has no ignore-index, so boundary/padding targets are neutralized to a
      constant class rather than predicting across documents),
    * ``segment_ids`` — ``[Bw, window]`` int32 per-window segment-id rows
      (document j -> id j, padding -> -1), exactly what
      ``models.transformer.lm_loss(..., segment_ids=...)`` and the
      segment-aware flash kernel consume,
    * ``windows`` — the ``PackedWindow`` records, and
    * ``load`` — the microbatch's per-segment load Σ len_i^p (via
      ``cost_model.predict_packed`` when a fitted model is passed, else the
      raw window loads), the ``load_of`` the StepPlanner should dispatch on.
    """
    windows = pack_documents(lengths, window=window, p=p, load_budget=load_budget)
    rng = np.random.default_rng(seed)
    out: list[dict] = []
    for i in range(0, len(windows), batch_windows):
        group: list[PackedWindow] = windows[i : i + batch_windows]
        arrays = _packed_arrays(rng, group, window, vocab)
        if cost_model is not None:
            # one fitted intercept per microbatch (matching predict(B, S) for
            # ordinary buckets), not one per window
            all_lengths = [n for w in group for n in w.lengths]
            load = cost_model.predict_packed(1, all_lengths)
        else:
            load = sum(w.load for w in group)
            if load == 0.0:  # p=None packing records no loads; token count
                load = float(sum(w.tokens for w in group))  # keeps LPT usable
        out.append({**arrays, "windows": group, "load": float(load)})
    return out


def _packed_arrays(
    rng: np.random.Generator,
    group: Sequence[PackedWindow],
    window: int,
    vocab: int,
) -> dict:
    """Model-ready arrays for one group of packed windows.

    Padding slots and document-final positions carry label 0 (the loss has
    no ignore-index, so boundary/padding targets are neutralized to a
    constant class rather than predicting across documents)."""
    seg = segment_id_batch(group, window)
    tokens = rng.integers(1, vocab, size=seg.shape, dtype=np.int64)
    tokens[seg < 0] = 0
    labels = np.roll(tokens, -1, axis=1)
    labels[seg < 0] = 0
    labels[:, -1] = 0
    # a document's last token must not predict the next document's first
    labels[:, :-1][seg[:, :-1] != seg[:, 1:]] = 0
    return {
        "tokens": tokens.astype(np.int32),
        "labels": labels.astype(np.int32),
        "segment_ids": seg,
    }


def make_packed_batch(
    rng: np.random.Generator, bucket: PackedBucket, *, vocab: int = 32_000
) -> dict:
    """``make_batch`` for planner-dispatched ``PackedBucket`` microbatches.

    Returns arrays only (``tokens``/``labels``/``segment_ids``) so the
    engine's batch-signature check keys cleanly on the batch dict."""
    return _packed_arrays(rng, bucket.windows, bucket.window, vocab)


def on_side_stream(make_batch: Callable, device) -> Callable:
    """``make_batch`` run on a CUDA stream of its own, for a loader whose
    prefetch thread makes batches on the card: each batch is drawn on the
    side stream, marked as used by the default stream (so the caching
    allocator never hands its memory back to the side stream while the
    training kernels still read it), and waited for by the producer thread
    before the loader queues it.  The draws then never enter the default
    stream, where the engine's CUDA events time each microbatch.  Off the
    card ``make_batch`` is returned as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return make_batch
    side = torch.cuda.Stream(device)
    main = torch.cuda.default_stream(device)

    def made(rng: np.random.Generator, bucket) -> dict:
        with torch.cuda.stream(side):
            batch = make_batch(rng, bucket)
        for v in batch.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                v.record_stream(main)
        side.synchronize()
        return batch

    return made


def to_device(batch: dict, device) -> dict:
    """The numpy arrays of a batch as tensors on ``device`` (other entries,
    such as ``windows`` and ``load``, are dropped)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


WorkerStep = list[tuple[Bucket, dict]]  # one rank's microbatches for one step


class ShardedBucketedLoader:
    """Planner-driven multi-rank loader: one global dispatch decision per
    optimizer step, materialized into per-rank streams.

    A single prefetch thread calls ``StepPlanner.plan()``, builds every
    microbatch in the plan once, and pushes each rank's share onto that
    rank's queue.  Two consumption modes (pick one per loader):

    * ``next(loader)`` — the whole step, ``list[WorkerStep]`` indexed by
      rank; used by the host-side ``Trainer`` that emulates all DP ranks.
    * ``worker_iter(w)`` — rank ``w``'s stream only; what a real per-host
      data service would expose.  Ranks stay in lockstep because the
      producer always pushes complete plans — so EVERY rank needs a
      concurrent consumer.  Draining one rank's queue alone stalls after
      ``prefetch`` steps: the other ranks' queues fill, the producer
      blocks, and no further plans are emitted until they're drained or
      the loader is closed.

    ``plan_update()`` mirrors ``BucketedLoader`` so the closed-loop
    scheduler can swap bucket tables/budgets mid-training; alternatively,
    pass the scheduler's own planner (``planner=sched.make_planner()``) and
    every scheduler replan reaches dispatch with no manual plumbing.

    **Overlapped refinement.** With ``overlap=True`` (and the ``knapsack``
    strategy) the producer dispatches each plan's cheap LPT seed and lets
    a background ``PlanRefiner`` run the swap passes during the
    materialize + backpressure window (i.e. behind the previous steps'
    compute); at the push boundary the refined assignment is adopted iff
    it strictly lowers the predicted max-rank load.  Refinement only
    regroups the pool, so materialized batches are reused either way;
    ``refined_adopted`` counts adoptions.

    **Elastic resize.** ``resize(n)`` rebuilds the queue fan-out in place
    on rank join/leave: every already-queued microbatch is redistributed
    across the new rank count exactly once (per original plan boundary, so
    step alignment survives), and the planner is retargeted so subsequent
    plans are drawn for ``n`` ranks.  The same rebuild happens automatically
    when a *shared* planner is resized by the scheduler (the producer adopts
    the planner's worker count instead of mis-sharding or crashing).
    ``close()`` and ``resize()`` are mutually exclusive — a close during an
    in-flight resize can never observe a partially rebuilt fan-out.

    **No lead** (``prefetch=0``).  The producer draws a plan only when a
    consumer finds none pending (``next``, ``worker_iter``, ``state_dict``).
    A replan or a resize then lands at a plan index fixed by the order of
    the consumer's own calls, not by how far the thread ran ahead: what
    processes that each draw the same plan stream need (``Trainer(mesh=)``
    refuses a leading loader at world > 1).

    **Resumable stream.** The producer snapshots its replayable state
    (planner RNG + both loader RNG bit-generator states) *before* drawing
    each plan, keyed by the plan's emitted sequence number.
    :meth:`state_dict` returns the snapshot belonging to the next
    *unconsumed* plan — so a loader rebuilt from it (``resume_state=`` or
    :meth:`load_state_dict`) regenerates plan-for-plan and batch-for-batch
    the exact stream the checkpointed run would have consumed next.
    ``rewind=`` compensates for steps the trainer popped but had not yet
    executed at checkpoint time (the H2D double-buffer).  Steps re-emitted
    by an elastic resize carry no snapshot (they are merges of partially
    delivered plans, not planner draws); checkpointing while those drain
    raises, and becomes possible again at the next producer-drawn plan.
    """

    _REWIND_MARGIN = 8  # consumed-plan snapshots retained for rewind

    def __init__(
        self,
        buckets: Sequence[Bucket],
        weights: Sequence[float] | None,
        make_batch: Callable[[np.random.Generator, Bucket], dict],
        *,
        n_workers: int,
        budget: float | None = None,
        budget_of: Callable[[Bucket], float] | None = None,
        load_of: Callable[[Bucket], float] | None = None,
        strategy: str | None = None,
        seed: int = 0,
        prefetch: int = 2,
        planner: StepPlanner | None = None,
        overlap: bool = False,
        deterministic_refine: bool = False,
        refine_rounds: int | None = None,
        capacities: Sequence[float] | None = None,
        sp_max_ranks: int | None = None,
        split_load_of: Callable | None = None,
        resume_state: dict | None = None,
    ):
        self.n_workers = n_workers
        self._owns_planner = planner is None
        if planner is not None:
            # the planner already defines the plan; conflicting args would
            # silently lose, so refuse them outright
            if (weights is not None or budget is not None
                    or budget_of is not None or load_of is not None
                    or strategy is not None or overlap
                    or deterministic_refine or refine_rounds is not None
                    or capacities is not None or sp_max_ranks is not None
                    or split_load_of is not None):
                raise ValueError(
                    "pass either planner= or the plan-defining args "
                    "(weights/budget/budget_of/load_of/strategy/overlap/"
                    "deterministic_refine/refine_rounds/capacities/"
                    "sp_max_ranks/split_load_of), not both"
                )
            if list(buckets) != planner.buckets:
                raise ValueError(
                    "buckets passed alongside planner= differ from the "
                    "planner's own table; they would be silently ignored"
                )
            if planner.n_workers != n_workers:
                raise ValueError(
                    f"shared planner is sized for {planner.n_workers} "
                    f"workers, loader for {n_workers}"
                )
            self._planner = planner
        else:
            if budget is None or budget_of is None:
                raise ValueError(
                    "budget and budget_of are required without planner="
                )
            self._planner = StepPlanner(
                buckets,
                weights,
                n_workers=n_workers,
                budget=budget,
                budget_of=budget_of,
                load_of=load_of,
                strategy=strategy if strategy is not None else "lpt",
                seed=seed,
                overlap=overlap,
                deterministic_refine=deterministic_refine,
                refine_rounds=refine_rounds if refine_rounds is not None else 16,
                capacities=capacities,
                sp_max_ranks=sp_max_ranks if sp_max_ranks is not None else 1,
                split_load_of=split_load_of,
            )
        self._make_batch = make_batch
        self._rng = np.random.default_rng(seed + 1)
        # repacking draws (random strategy) use their own stream: _repack
        # runs under _cv in the *caller's* thread during resize, while the
        # producer may be mid-_materialize on self._rng (numpy Generators
        # are not thread-safe)
        self._repack_rng = np.random.default_rng(seed + 2)
        # One condition variable guards the per-rank pending deques; plans
        # are appended atomically (all ranks at once), so rank queues only
        # ever differ by what consumers have drained.
        self._cv = threading.Condition()
        # each entry is (plan_seq, share): the sequence number ties a rank's
        # share back to the plan that emitted it, so an elastic resize can
        # regroup by TRUE plan boundary even if per-rank consumers have
        # drained ranks unevenly
        self._pending: list[Deque[tuple[int, WorkerStep]]] = [
            deque() for _ in range(n_workers)
        ]
        self._seq = 0
        # microbatches from a resize-orphaned short step, waiting to ride
        # the producer's next plan (guarded by _cv)
        self._carry: WorkerStep = []
        self._prefetch = max(prefetch, 1)
        # prefetch 0: draw a plan only when a consumer asks (guarded by _cv)
        self._on_demand = prefetch == 0
        self._wanted = False
        # close() vs resize() mutual exclusion: a close landing mid-resize
        # must see either the old fan-out or the fully rebuilt one, never a
        # partially redistributed set of queues.
        self._lifecycle = threading.Lock()
        self._plans: Deque[StepPlan] = deque(maxlen=256)
        # plans whose background knapsack refinement was adopted at the
        # push boundary (overlap telemetry; guarded by _cv)
        self._refined_adopted = 0
        # per-seq replayable snapshots captured before each plan's draw,
        # and an epoch counter so load_state_dict can invalidate a plan
        # the producer drew from pre-restore RNG state (guarded by _cv)
        self._snapshots: dict[int, dict] = {}
        self._epoch = 0
        # serializes the producer's draw+materialize (which consume the
        # replayable RNG streams) against load_state_dict resetting them:
        # a restore landing mid-draw would otherwise leave the restored
        # stream already partially consumed.  Never held across the
        # backpressure wait (that would deadlock the restoring consumer).
        self._draw_lock = threading.Lock()
        self._stop = threading.Event()
        self._error: Exception | None = None
        if resume_state is not None:
            self._apply_state(resume_state)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    @property
    def planner(self) -> StepPlanner:
        return self._planner

    @property
    def plans(self) -> list[StepPlan]:
        """Dispatch decisions emitted so far (telemetry/debugging)."""
        return list(self._plans)

    @property
    def prefetch(self) -> int:
        """Plans the producer may draw ahead of the consumers (0: none)."""
        return 0 if self._on_demand else self._prefetch

    @property
    def refined_adopted(self) -> int:
        """How many emitted plans adopted a background-refined assignment."""
        with self._cv:
            return self._refined_adopted

    # -- plan updates from the closed-loop scheduler -------------------------

    def plan_update(
        self,
        buckets: Sequence[Bucket],
        budget: float,
        weights: Sequence[float] | None = None,
    ) -> None:
        self._planner.update(buckets=list(buckets), weights=weights, budget=budget)

    # -- producer -------------------------------------------------------------

    def _materialize(self, plan: StepPlan) -> list[dict]:
        """Build every microbatch in the plan's pool once (pool order).

        Materialization is keyed by pool index, not by assignment, so an
        overlapped knapsack refinement — which only regroups the pool —
        can be adopted after the fact without rebuilding a single batch.

        A split group's k ``SplitShard`` entries consume ONE ``make_batch``
        draw (the whole window, built at the first shard's pool position,
        then sliced by ``split_packed_batch``) — so the RNG stream, and
        therefore replay, is identical whether the planner split the
        window or not."""
        out: list[dict] = []
        split_cache: dict[int, list[dict]] = {}
        for b in plan.microbatches:
            if isinstance(b, SplitShard):
                shards = split_cache.get(id(b.base))
                if shards is None:
                    whole = self._make_batch(self._rng, b.base)
                    shards = split_packed_batch(whole, b.n_ranks)
                    split_cache[id(b.base)] = shards
                out.append(shards[b.shard])
            else:
                out.append(self._make_batch(self._rng, b))
        return out

    @staticmethod
    def _fan_out(plan: StepPlan, batches: Sequence[dict]) -> list[WorkerStep]:
        return [
            [(plan.microbatches[i], batches[i]) for i in plan.assignments[w]]
            for w in range(plan.n_workers)
        ]

    def _repack(self, items: WorkerStep, n_workers: int) -> list[WorkerStep]:
        """Re-deal already-materialized microbatches across ``n_workers``
        using the planner's load function + strategy (exactly-once: items
        are moved, never duplicated or dropped).

        Split shards can't be re-dealt independently — their batches are
        sequence slices of one window and their rank placement must stay a
        contiguous ring — so they collapse back to the whole window first
        (the next planner draw decides whether to split again for the new
        world size)."""
        items = merge_split_worker_steps([list(items)])[0]
        loads = [float(self._planner.load_of(b)) for b, _ in items]
        caps = self._planner.capacities
        if caps is not None and len(caps) != n_workers:
            caps = None  # capacity vector is for the pre-resize width
        groups = assign_pool(
            loads, n_workers, self._planner.strategy, self._repack_rng, caps
        )
        return [[items[i] for i in g] for g in groups]

    def _emitted_plan(self, per_rank: list[WorkerStep]) -> StepPlan:
        """The StepPlan a re-packed fan-out actually dispatches — recorded
        in ``plans`` so telemetry always matches what consumers received
        (the pre-resize plan's assignments would be a lie)."""
        mbs: list = []
        loads: list[float] = []
        assignments: list[tuple[int, ...]] = []
        for share in per_rank:
            idxs = []
            for b, _ in share:
                idxs.append(len(mbs))
                mbs.append(b)
                loads.append(float(self._planner.load_of(b)))
            assignments.append(tuple(idxs))
        caps = self._planner.capacities
        if caps is not None and len(caps) != len(per_rank):
            caps = None  # capacity vector is for the pre-resize width
        return StepPlan(
            microbatches=tuple(mbs),
            assignments=tuple(assignments),
            loads=tuple(loads),
            strategy=self._planner.strategy,
            capacities=caps,
        )

    def _adopt_locked(self, n_workers: int) -> None:
        """Rebuild the queue fan-out in place (``self._cv`` must be held).

        Pending shares are regrouped by the plan-sequence tag each one
        carries — the TRUE plan boundary, correct even when ``worker_iter``
        consumers have drained ranks unevenly — and each regrouped pool
        becomes exactly one step of the new fan-out, so ranks stay in
        lockstep and every queued microbatch survives exactly once.  A pool
        too short to give every new rank >= 1 microbatch is not emitted
        degenerate — its items merge into the following pool, or into
        ``self._carry`` (prepended to the producer's next plan) if it was
        the last one, so no consumer ever sees an empty rank share.  Each
        re-emitted step is recorded in ``plans`` (it is a new dispatch
        decision; the pre-resize assignments were never fully delivered)."""
        old = self._pending
        if n_workers == len(old):
            return
        by_seq: dict[int, WorkerStep] = {}
        for d in old:
            for seq, share in d:
                by_seq.setdefault(seq, []).extend(share)
        new: list[Deque[tuple[int, WorkerStep]]] = [
            deque() for _ in range(n_workers)
        ]
        buf: WorkerStep = list(self._carry)
        self._carry = []
        for seq in sorted(by_seq):
            # regrouping is by whole plan boundary, so any split group is
            # complete here — collapse it before counting (k sibling
            # shards are ONE logical microbatch, not k re-dealable items)
            buf = merge_split_worker_steps([buf + by_seq[seq]])[0]
            if len(buf) >= n_workers:
                per_rank = self._repack(buf, n_workers)
                self._plans.append(self._emitted_plan(per_rank))
                self._push_locked(new, per_rank)
                buf = []
        self._carry = buf
        self._pending = new
        self.n_workers = n_workers

    def _push_locked(
        self,
        queues: list[Deque[tuple[int, WorkerStep]]],
        per_rank: list[WorkerStep],
    ) -> None:
        """Append one step's shares (tagged with a fresh plan seq)."""
        seq = self._seq
        self._seq += 1
        for w, share in enumerate(per_rank):
            queues[w].append((seq, share))

    def _capture_snapshot(self) -> dict:
        """Replayable producer state, captured BEFORE a plan's draw: a
        loader restored from it regenerates that plan (and its batches)
        and every one after it."""
        return {
            "planner": self._planner.state_dict(),
            "rng": copy.deepcopy(self._rng.bit_generator.state),
            "repack_rng": copy.deepcopy(self._repack_rng.bit_generator.state),
        }

    def _prune_snapshots_locked(self) -> None:
        """Drop snapshots too old for any rewind (``self._cv`` held)."""
        heads = [d[0][0] for d in self._pending if d]
        floor = (min(heads) if heads else self._seq) - self._REWIND_MARGIN
        for seq in [s for s in self._snapshots if s < floor]:
            del self._snapshots[seq]

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                if self._on_demand:
                    with self._cv:
                        while not (self._wanted or self._stop.is_set()):
                            self._cv.wait(0.1)
                with self._draw_lock:
                    with self._cv:
                        epoch = self._epoch
                    snap = self._capture_snapshot()
                    plan, ticket = self._planner.plan_async()
                    batches = self._materialize(plan)
                with self._cv:
                    # backpressure on the DEEPEST rank queue: like the old
                    # per-rank bounded queues, one stalled consumer caps the
                    # whole pipeline at ``prefetch`` steps of memory instead
                    # of letting its backlog grow without bound
                    while not self._stop.is_set() and self._epoch == epoch and (
                        max(len(d) for d in self._pending) >= self._prefetch
                    ):
                        self._cv.wait(0.1)
                    if self._stop.is_set():
                        return
                    if self._epoch != epoch:
                        # load_state_dict restored the RNGs after this plan
                        # was drawn: it belongs to the abandoned stream
                        continue
                    if ticket is not None:
                        # the push boundary: the refiner had the whole
                        # materialize + backpressure window (i.e. the
                        # previous steps' compute) — adopt its assignment
                        # iff it strictly lowered the predicted makespan
                        refined = ticket.best()
                        if refined is not plan:
                            self._refined_adopted += 1
                            plan = refined
                    per_rank = self._fan_out(plan, batches)
                    # elastic: the planner may have been resized (shared
                    # planner, or loader.resize between draw and push) —
                    # adopt its worker count and re-deal the stale plan
                    # instead of mis-sharding or dropping materialized work
                    target = self._planner.n_workers
                    self._adopt_locked(target)
                    if plan.n_workers != target or self._carry:
                        items = merge_split_worker_steps([
                            self._carry
                            + [it for share in per_rank for it in share]
                        ])[0]
                        if len(items) < target:
                            # a stale small plan can't give every new rank a
                            # microbatch; hold it for the next (right-sized)
                            # plan rather than emit empty shares
                            self._carry = items
                            continue
                        per_rank = self._repack(items, target)
                        self._carry = []
                        plan = self._emitted_plan(per_rank)
                        # the pushed step is a merge of partially delivered
                        # plans — not a planner draw; it has no snapshot
                        snap = None
                    self._plans.append(plan)
                    seq = self._seq
                    self._push_locked(self._pending, per_rank)
                    self._wanted = False
                    if snap is not None:
                        self._snapshots[seq] = snap
                    self._prune_snapshots_locked()
                    self._cv.notify_all()
        except Exception as e:  # noqa: BLE001 — surface to the consumer
            self._error = e
            with self._cv:
                self._cv.notify_all()

    # -- consumers -------------------------------------------------------------

    def _check_error(self) -> None:
        if self._error is not None:
            raise RuntimeError(
                "sharded loader producer failed"
            ) from self._error

    def __iter__(self) -> Iterator[list[WorkerStep]]:
        return self

    def __next__(self) -> list[WorkerStep]:
        """One full step: every rank's microbatches, same plan.

        The step is popped atomically under the lock, so an elastic resize
        can never interleave with a half-consumed step."""
        with self._cv:
            while True:
                self._check_error()
                n = len(self._pending)
                if n and all(self._pending):
                    step = [
                        self._pending[w].popleft()[1] for w in range(n)
                    ]
                    self._cv.notify_all()
                    return step
                if self._stop.is_set():  # closed: end the stream
                    raise StopIteration
                self._want_locked()
                self._cv.wait(0.1)

    def _want_locked(self) -> None:
        """A consumer waits for a plan (``self._cv`` held): with no lead,
        this is what lets the producer draw the next one."""
        if self._on_demand and not self._wanted:
            self._wanted = True
            self._cv.notify_all()

    def _get_rank(self, worker: int) -> WorkerStep:
        with self._cv:
            while True:
                self._check_error()
                if worker >= len(self._pending):
                    raise StopIteration  # rank left in an elastic shrink
                if self._pending[worker]:
                    _seq, item = self._pending[worker].popleft()
                    self._cv.notify_all()
                    return item
                if self._stop.is_set():  # closed: end the stream
                    raise StopIteration
                self._want_locked()
                self._cv.wait(0.1)

    def worker_iter(self, worker: int) -> Iterator[WorkerStep]:
        """Rank ``worker``'s stream of per-step microbatch lists."""
        if not 0 <= worker < self.n_workers:
            raise ValueError(f"worker {worker} out of range [0, {self.n_workers})")
        while True:
            try:
                step = self._get_rank(worker)
            except StopIteration:  # PEP 479: end the generator explicitly
                return
            yield step

    # -- run-state checkpointing ----------------------------------------------

    def state_dict(self, *, rewind: int = 0) -> dict:
        """Replayable state for the next *unconsumed* plan (minus ``rewind``).

        ``rewind=k`` returns the snapshot ``k`` plans earlier than the
        current queue head — for a trainer that already popped ``k`` steps
        it has not yet executed (the prefetch double-buffer), so the resumed
        run regenerates those steps too.  If the queues are momentarily
        empty the call waits for the producer's next push (it never blocks
        a healthy pipeline for long: empty queues mean the producer has
        space).  Raises if the boundary plan was re-emitted by an elastic
        resize (no planner draw to replay) or the rewind outran the
        retained snapshot window."""
        if rewind < 0:
            raise ValueError("rewind must be >= 0")
        with self._cv:
            while True:
                self._check_error()
                if self._stop.is_set():
                    raise RuntimeError("cannot checkpoint a closed loader")
                heads = [d[0][0] for d in self._pending if d]
                if heads:
                    seq = min(heads) - rewind
                    snap = self._snapshots.get(seq)
                    if snap is None:
                        raise SnapshotUnavailable(
                            f"no replayable snapshot for plan seq {seq}: "
                            f"either an elastic resize re-emitted it or "
                            f"rewind={rewind} outran the retained window — "
                            f"checkpoint again at the next plan boundary"
                        )
                    return {"version": 1, "seq": seq, **copy.deepcopy(snap)}
                self._want_locked()
                self._cv.wait(0.1)

    def _apply_state(self, sd: dict) -> None:
        """Install a :meth:`state_dict` snapshot (constructor path: the
        producer thread has not started, no locking needed)."""
        if int(sd["planner"]["n_workers"]) != self.n_workers:
            raise ValueError(
                f"resume state was captured for "
                f"{sd['planner']['n_workers']} workers, loader built for "
                f"{self.n_workers}"
            )
        self._planner.load_state_dict(sd["planner"])
        self._rng.bit_generator.state = sd["rng"]
        self._repack_rng.bit_generator.state = sd["repack_rng"]
        self._seq = int(sd.get("seq", 0))

    def load_state_dict(self, sd: dict) -> None:
        """Rewind a LIVE loader to a snapshot: pending plans are discarded,
        RNG streams restored, and the producer regenerates the stream from
        the snapshot's plan onward (a plan it drew from pre-restore state
        is invalidated by the epoch bump, never delivered; the draw lock
        keeps the reset from landing mid-draw, which would leave the
        restored streams partially consumed)."""
        with self._draw_lock, self._cv:
            if self._stop.is_set():
                raise RuntimeError("cannot restore a closed loader")
            self._epoch += 1
            for d in self._pending:
                d.clear()
            self._snapshots.clear()
            self._carry = []
            self._wanted = False
            self._plans.clear()
            self._refined_adopted = 0
            n = int(sd["planner"]["n_workers"])
            if n != len(self._pending):
                self._pending = [deque() for _ in range(n)]
            self.n_workers = n
            self._planner.load_state_dict(sd["planner"])
            self._rng.bit_generator.state = sd["rng"]
            self._repack_rng.bit_generator.state = sd["repack_rng"]
            self._seq = int(sd.get("seq", 0))
            self._cv.notify_all()

    # -- elasticity -----------------------------------------------------------

    def resize(self, n_workers: int) -> None:
        """Elastic rank join/leave: rebuild the queue fan-out in place.

        Queued microbatches are redistributed across the new rank count
        (exactly once, per plan boundary) and the planner is retargeted so
        subsequent plans are drawn for ``n_workers`` ranks.  Mutually
        exclusive with ``close()``."""
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        with self._lifecycle:
            if self._stop.is_set():
                raise RuntimeError("cannot resize a closed loader")
            if self._planner.n_workers != n_workers:
                self._planner.update(n_workers=n_workers)
            with self._cv:
                self._adopt_locked(n_workers)
                self._cv.notify_all()

    def close(self) -> None:
        with self._lifecycle:
            with self._cv:
                self._stop.set()
                for d in self._pending:
                    d.clear()
                self._cv.notify_all()
        self._thread.join(timeout=2.0)
        if self._owns_planner:
            self._planner.close()  # stop the overlap refiner thread, if any
