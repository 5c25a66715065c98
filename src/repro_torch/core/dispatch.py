"""Global step-planning engine: cluster-level microbatch dispatch (§4.5),
the port's copy of ``repro.core.dispatch`` (framework-free numpy; split
batches may also be torch tensors).

The paper's "intra-step re-alignment of sequences" is what cuts compute CV
from 39% to 18.9%, and it only works with a *global* view of the step: if
every DP rank draws its own microbatches independently (what a sharded
dataset iterator does), no rank can trade a heavy video microbatch for a
light image one.  ``StepPlanner`` assembles ONE pool of microbatches per
optimizer step — sized to the cluster-wide budget, ``n_workers x`` the
per-rank budget — and then packs the pool across ranks by fitted
``B * S^p`` load.

Dispatch strategies (pluggable, compared by ``benchmarks/bench_dispatch.py``):

* ``random``   — shuffle + round-robin deal; statistically identical to
  independent per-worker draws, kept as the controlled baseline.
* ``lpt``      — greedy Longest-Processing-Time packing (``assign_lpt``),
  the classic 4/3-approximation of makespan scheduling.
* ``knapsack`` — LPT seed followed by a pairwise move/swap refinement
  between the heaviest and lightest ranks until no exchange shrinks the
  makespan (KnapFormer/OmniBal-style rebalancing pass).

**Overlapped refinement** (KnapFormer's "balancing hidden behind compute"):
the swap refinement is the only dispatch stage whose cost grows with pool
size, and it does not need to run on the critical path.  With
``overlap=True`` a planner's :meth:`StepPlanner.plan_async` returns the
cheap LPT seed immediately and hands the knapsack-swap passes to a
:class:`PlanRefiner` daemon thread; the consumer adopts the refined
assignment at the next step boundary via :meth:`RefineTicket.best` — iff it
strictly lowers the predicted max-rank load — and otherwise dispatches the
seed.  Because refinement only *regroups* the pool (never changes its
microbatches), already-materialized batches are reusable under either
assignment.  That adoption rule is wall-clock dependent, so plain
overlapped plans are for the single-controller path only.

**Deterministic fixed-round refinement** (``PlanRefiner(rounds=k,
deterministic=True)``) removes the wall-clock dependence: the refiner runs
*exactly* ``k`` exchange rounds of :func:`refine_fixed_rounds` — stall
escapes seeded from the plan digest — and the ticket's ``best()`` *waits*
for that result instead of falling back to the seed on a slow thread.  The
adopted plan is then a pure function of (pool, loads, assignment): two
hosts that derive the same seed plan adopt the same refined plan no matter
how their threads are scheduled, which is what lets multi-host digest
agreement include overlapped refinement (ROADMAP (e)) and what makes a
killed-and-resumed run replay the identical plan stream.

**Resumable plan streams**: :meth:`StepPlanner.state_dict` /
:meth:`StepPlanner.load_state_dict` capture/restore the planner's RNG
bit-generator state and plan counter, so the draw sequence is replayable
from any step (the loader snapshots this per emitted plan; see
``data.pipeline.ShardedBucketedLoader.state_dict``).

The planner is shared state between the data pipeline (its prefetch thread
calls :meth:`StepPlanner.plan` each step) and the closed-loop scheduler
(which pushes replans via :meth:`StepPlanner.update`), so both entry points
are lock-protected.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .balancer import assign_lpt, assign_random, makespan
from .bucketing import Bucket

DISPATCH_STRATEGIES = ("random", "lpt", "knapsack")

# ring shard widths must stay tileable by the flash kernel's KV block
# (kernels/flash_attention/ring._pick_block accepts multiples of 128)
SPLIT_ALIGN = 128

# sentinel distinguishing "not passed" from an explicit None in update()
_UNSET: object = object()

# the longest a deterministic ticket waits for its fixed rounds (seconds):
# a refiner that never finishes fails the consumer instead of hanging it
DETERMINISTIC_WAIT_S = 120.0


@dataclasses.dataclass(frozen=True)
class SplitShard:
    """One rank's share of a sequence-parallel *split bucket*.

    When one packed window is too heavy for any single rank, the planner
    replaces its pool entry with ``n_ranks`` sibling shards — shard ``s``
    owns the window's ``s``-th contiguous sequence slice and is pinned to
    the ``s``-th rank of a contiguous rank window, so execution can lower
    the group onto a ``("data", "seq")`` sub-mesh and ring the KV shards
    (``kernels.flash_attention.ring``).  Siblings are indivisible: the
    refinement passes treat their pool indices as ``locked`` (moving one
    shard without the others would tear the ring apart).

    ``rank_load`` is the planner-facing per-rank cost — base load / k plus
    the ring-communication term (``core.cost_model.split_load``)."""

    base: Any  # the microbatch being split (duck-typed planner unit)
    n_ranks: int  # k — sibling count == ring size
    shard: int  # this shard's index, 0..k-1 (== offset in the rank window)
    rank_load: float

    def __post_init__(self) -> None:
        if self.n_ranks < 2:
            raise ValueError("a split bucket needs >= 2 ranks")
        if not 0 <= self.shard < self.n_ranks:
            raise ValueError(
                f"shard {self.shard} out of range [0, {self.n_ranks})"
            )

    @property
    def batch_size(self) -> int:
        return self.base.batch_size

    @property
    def seq_len(self) -> int:
        """This rank's sequence-slice width (telemetry shape)."""
        return self.base.seq_len // self.n_ranks

    @property
    def tokens(self) -> int:
        # distribute the remainder so sibling token counts sum exactly to
        # the base's (StepPlan.tokens and elastic regrouping weight on it)
        return (
            self.base.tokens + self.n_ranks - 1 - self.shard
        ) // self.n_ranks

    def load(self, p: float) -> float:
        """Planner load (duck-types ``Bucket.load``/``PackedBucket.load``;
        the split cost was fixed at plan time, so ``p`` is ignored)."""
        del p
        return self.rank_load

    def digest_key(self) -> tuple:
        """Commits the full split topology — ring size AND shard index on
        top of the base window's identity — so two hosts that split
        differently (or place shards differently) can never agree."""
        return ("split", self.n_ranks, self.shard, microbatch_key(self.base))


def split_locked_indices(plan: "StepPlan") -> frozenset:
    """Pool indices the refinement passes must never move: every
    ``SplitShard`` is pinned to its planned rank (satellite of the ring
    lowering — a shard that migrates breaks the contiguous sub-mesh)."""
    return frozenset(
        i for i, b in enumerate(plan.microbatches) if isinstance(b, SplitShard)
    )


def merge_split_worker_steps(worker_steps):
    """Collapse a split fan-out back to its logical whole-window form.

    Each split group's ``k`` sibling ``(SplitShard, shard batch)`` entries
    become ONE ``(base, merged batch)`` entry at shard 0's position (shard
    0 sits on the group's lowest rank, so rank-major enumeration — and
    therefore every microbatch's pool index and gradient RNG — is
    identical between the split and merged forms).  Shard batches are
    concatenated along the sequence axis (numpy arrays or torch tensors);
    the globally computed ``positions`` rows are dropped (a whole window
    recomputes them from its segment ids).  This is what the emulated
    engine consumes, so one gradient covers split and unsplit plans."""
    groups: dict[int, dict[int, tuple]] = {}
    for share in worker_steps:
        for b, batch in share:
            if isinstance(b, SplitShard):
                slot = groups.setdefault(id(b.base), {})
                if b.shard in slot:
                    raise ValueError(
                        f"duplicate shard {b.shard} of a split bucket"
                    )
                slot[b.shard] = (b, batch)
    if not groups:
        return [list(share) for share in worker_steps]
    merged: dict[int, tuple] = {}
    for key, slot in groups.items():
        if 0 not in slot:
            raise ValueError("split group is missing shard 0")
        k = slot[0][0].n_ranks
        if sorted(slot) != list(range(k)):
            raise ValueError(
                f"split group has shards {sorted(slot)}; expected 0..{k - 1}"
            )
        batches = [slot[s][1] for s in range(k)]
        merged[key] = (
            slot[0][0].base,
            {
                name: _concat_seq([bb[name] for bb in batches])
                for name in batches[0]
                if name != "positions"
            },
        )
    out = []
    for share in worker_steps:
        new_share = []
        for b, batch in share:
            if isinstance(b, SplitShard):
                if b.shard == 0:
                    new_share.append(merged[id(b.base)])
            else:
                new_share.append((b, batch))
        out.append(new_share)
    return out


def _concat_seq(parts: list):
    """Shard arrays joined along the sequence axis (axis 1): torch tensors
    stay tensors on their device, anything else goes through numpy."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=1)
    return np.concatenate([np.asarray(x) for x in parts], axis=1)


def microbatch_key(b) -> tuple:
    """Canonical identity of one pool microbatch, stable across processes.

    ``Bucket`` is keyed by its media shape + batch size; any other bucket
    kind (e.g. ``data.packing.PackedBucket``) provides ``digest_key()``.
    Object ids/reprs are deliberately never used — two hosts must derive
    the same key for logically identical microbatches."""
    if isinstance(b, Bucket):
        s = b.shape
        return ("bucket", s.n_frames, s.height, s.width, s.text_len, b.batch_size)
    key = getattr(b, "digest_key", None)
    if key is None:
        raise TypeError(
            f"microbatch kind {type(b).__name__} is not digestable: add a "
            f"digest_key() method so cross-host plan agreement can hash it"
        )
    return key()


def plan_digest(plan: "StepPlan") -> bytes:
    """32-byte content hash of a plan — the cross-host agreement token.

    Covers everything that determines execution: the pool's microbatch
    identities (in order), per-microbatch loads, the per-rank assignment,
    and the strategy.  Two hosts that derive byte-identical plans from the
    same seed + telemetry snapshot produce equal digests; any divergence
    (different RNG state, stale bucket table, version skew) flips the hash
    and the mesh all-gather check in ``distributed.plan_exec`` trips."""
    h = hashlib.sha256()
    h.update(plan.strategy.encode())
    h.update(np.int64(plan.n_workers).tobytes())
    for b in plan.microbatches:
        h.update(repr(microbatch_key(b)).encode())
    h.update(np.asarray(plan.loads, dtype=np.float64).tobytes())
    for group in plan.assignments:
        h.update(np.asarray(group, dtype=np.int64).tobytes())
        h.update(b"|")
    if plan.capacities is not None:
        # only hashed when set, so uniform-fleet digests are byte-stable
        # across versions that predate capacity-weighted planning
        h.update(b"cap")
        h.update(np.asarray(plan.capacities, dtype=np.float64).tobytes())
    return h.digest()


def normalized_weights(
    buckets: Sequence[Bucket], weights: Sequence[float] | None
) -> np.ndarray:
    """Validate a bucket table + sampling weights, return draw probabilities.

    Shared by the planner and both loaders so empty tables and malformed
    weights fail loudly at the call site instead of crashing (or dividing
    by zero) inside a prefetch thread."""
    if len(buckets) == 0:
        raise ValueError("bucket table is empty: nothing to draw from")
    w = np.asarray(
        weights if weights is not None else [1.0] * len(buckets),
        dtype=np.float64,
    )
    if len(w) != len(buckets):
        raise ValueError(f"{len(w)} weights for {len(buckets)} buckets")
    if (w < 0).any() or w.sum() <= 0:
        raise ValueError(
            "bucket weights must be non-negative with a positive sum"
        )
    return w / w.sum()


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """One optimizer step's dispatch decision: who runs which microbatch."""

    microbatches: tuple[Bucket, ...]  # the step's global pool
    assignments: tuple[tuple[int, ...], ...]  # per-worker indices into the pool
    loads: tuple[float, ...]  # per-microbatch packing weight (B*S^p)
    strategy: str
    #: per-worker relative speeds the pool was packed against (1.0 =
    #: nominal); None on a uniform fleet — digest-compatible with plans
    #: produced before heterogeneous-rank planning existed
    capacities: tuple[float, ...] | None = None

    @property
    def n_workers(self) -> int:
        return len(self.assignments)

    @property
    def tokens(self) -> int:
        return sum(b.tokens for b in self.microbatches)

    def worker_microbatches(self, worker: int) -> list[Bucket]:
        return [self.microbatches[i] for i in self.assignments[worker]]

    def worker_loads(self) -> list[float]:
        return [
            sum(self.loads[i] for i in group) for group in self.assignments
        ]

    def worker_times(self) -> list[float]:
        """Predicted per-worker step times: packed load over capacity
        (equal to ``worker_loads`` on a uniform fleet)."""
        if self.capacities is None:
            return self.worker_loads()
        return [
            load / cap
            for load, cap in zip(self.worker_loads(), self.capacities)
        ]

    def makespan(self) -> float:
        return max(self.worker_times())

    def compute_cv(self) -> float:
        """std/mean of per-worker packed *time* — the paper's Compute CV,
        evaluated on the plan itself (before any hardware jitter).  On a
        heterogeneous fleet the balanced quantity is finish time, so the
        CV weights each rank's load by its capacity."""
        o = np.asarray(self.worker_times(), dtype=np.float64)
        return float(o.std() / o.mean()) if o.mean() > 0 else 0.0

    def digest(self) -> bytes:
        """Content hash for cross-host agreement (see :func:`plan_digest`)."""
        return plan_digest(self)


def _apply_best_exchange(
    loads: Sequence[float],
    groups: list[list[int]],
    totals: list[float],
    hi: int,
    lo: int,
    eps: float,
    capacities: Sequence[float] | None = None,
    locked: frozenset = frozenset(),
) -> bool:
    """Apply the best single-item move/swap between workers ``hi`` and
    ``lo`` (``hi`` the slower-finishing of the pair), minimizing the pair's
    new maximum *finish time* (``total / capacity``; uniform capacities
    reduce to raw totals).  Returns True iff an exchange strictly improved
    the pair max.  The pair's maximum never increases, so the global
    makespan is monotone non-increasing under any sequence of these
    exchanges.  Workers are never emptied (a move requires the donor to
    keep >= 1 item).  Items in ``locked`` (split-bucket shards pinned to
    their ring ranks) never move in either direction."""
    c_hi = capacities[hi] if capacities is not None else 1.0
    c_lo = capacities[lo] if capacities is not None else 1.0
    pair_max = totals[hi] / c_hi
    if pair_max - totals[lo] / c_lo <= eps:
        return False
    best_max = pair_max
    best: tuple[str, int, int] | None = None
    if len(groups[hi]) > 1:
        for i in groups[hi]:
            if i in locked:
                continue
            cand = max(
                (totals[hi] - loads[i]) / c_hi,
                (totals[lo] + loads[i]) / c_lo,
            )
            if cand < best_max - eps:
                best_max, best = cand, ("move", i, -1)
    for i in groups[hi]:
        if i in locked:
            continue
        for j in groups[lo]:
            if j in locked:
                continue
            delta = loads[i] - loads[j]
            if delta <= 0:
                continue
            cand = max(
                (totals[hi] - delta) / c_hi, (totals[lo] + delta) / c_lo
            )
            if cand < best_max - eps:
                best_max, best = cand, ("swap", i, j)
    if best is None:
        return False
    kind, i, j = best
    if kind == "move":
        groups[hi].remove(i)
        groups[lo].append(i)
        totals[hi] -= loads[i]
        totals[lo] += loads[i]
    else:
        groups[hi].remove(i)
        groups[lo].remove(j)
        groups[hi].append(j)
        groups[lo].append(i)
        delta = loads[i] - loads[j]
        totals[hi] -= delta
        totals[lo] += delta
    return True


def refine_swaps(
    loads: Sequence[float],
    assignment: Sequence[Sequence[int]],
    *,
    max_rounds: int = 64,
    eps: float = 1e-12,
    capacities: Sequence[float] | None = None,
    locked: frozenset | None = None,
) -> list[list[int]]:
    """Pairwise rebalancing between the slowest- and fastest-finishing
    workers.

    Each round considers every single-item *move* (slowest -> fastest) and
    every item *swap* between the two, applies the exchange that minimizes
    the pair's new maximum finish time, and stops when no exchange improves
    it.  By construction the makespan is monotonically non-increasing, so
    the refined assignment is never worse than its LPT seed.  Workers are
    never emptied (a move requires the donor to keep >= 1 item).  With
    ``capacities`` finish times are capacity-weighted (``total / cap``);
    uniform capacities reduce to the classic load-balance pass.  ``locked``
    pool indices (split-bucket shards) are pinned to their seeded workers.
    """
    locked = locked if locked is not None else frozenset()
    groups = [list(g) for g in assignment]
    totals = [sum(loads[i] for i in g) for g in groups]
    caps = (
        [float(c) for c in capacities]
        if capacities is not None
        else [1.0] * len(groups)
    )
    for _ in range(max_rounds):
        hi = max(range(len(groups)), key=lambda r: totals[r] / caps[r])
        lo = min(range(len(groups)), key=lambda r: totals[r] / caps[r])
        if not _apply_best_exchange(
            loads, groups, totals, hi, lo, eps, capacities, locked
        ):
            break
    return groups


def refine_fixed_rounds(
    loads: Sequence[float],
    assignment: Sequence[Sequence[int]],
    *,
    rounds: int,
    seed_bytes: bytes,
    eps: float = 1e-12,
    capacities: Sequence[float] | None = None,
    locked: frozenset | None = None,
) -> list[list[int]]:
    """Exactly ``rounds`` exchange rounds — a pure function of its inputs.

    Every round first tries the greedy heaviest/lightest exchange; when
    that pair has stalled, a random *other* pair (drawn from an RNG seeded
    by ``seed_bytes``, canonically the seed plan's digest) gets one chance,
    which lets later rounds escape the local minimum the greedy pass
    converges to.  Unlike :func:`refine_swaps` there is no data-dependent
    early exit on improvement, and the RNG consumption pattern depends only
    on (loads, assignment, seed_bytes) — so every host, thread schedule,
    and resumed run computes byte-identical output.  The makespan is still
    monotone non-increasing (each exchange only ever lowers its pair's
    maximum).  ``locked`` pool indices (split-bucket shards) never move —
    the escape-pair draws still consume RNG identically, so locking does
    not perturb the deterministic stream shape."""
    if rounds < 1:
        raise ValueError("deterministic refinement needs rounds >= 1")
    locked = locked if locked is not None else frozenset()
    rng = np.random.default_rng(int.from_bytes(seed_bytes[:8], "big"))
    groups = [list(g) for g in assignment]
    totals = [sum(loads[i] for i in g) for g in groups]
    n = len(groups)
    caps = (
        [float(c) for c in capacities]
        if capacities is not None
        else [1.0] * n
    )
    for _ in range(rounds):
        hi = max(range(n), key=lambda r: totals[r] / caps[r])
        lo = min(range(n), key=lambda r: totals[r] / caps[r])
        if _apply_best_exchange(
            loads, groups, totals, hi, lo, eps, capacities, locked
        ):
            continue
        if n <= 2:
            continue  # greedy pair is the only pair: nothing left to try
        a, b = (int(x) for x in rng.choice(n, size=2, replace=False))
        if totals[a] / caps[a] < totals[b] / caps[b]:
            a, b = b, a
        _apply_best_exchange(
            loads, groups, totals, a, b, eps, capacities, locked
        )
    return groups


class RefineTicket:
    """Handle to one plan's background knapsack-swap refinement.

    In the default (opportunistic) mode ``best()`` never blocks: it returns
    the refined plan once the worker has finished AND the refinement
    *strictly* lowers the predicted max-rank load, and the LPT seed
    otherwise — so a consumer polling at a step boundary always gets a
    dispatchable plan whose makespan is <= the seed's (the adoption
    invariant the hypothesis suite pins down).

    A *deterministic* ticket (fixed-round refiner) instead **waits** for
    the refinement in ``best()``: adoption must be a pure function of the
    seed plan, never of how fast the worker thread ran, so that every host
    — and every killed-and-resumed run — dispatches the same plan.
    """

    def __init__(self, seed: StepPlan, *, deterministic: bool = False):
        self.seed = seed
        self.deterministic = deterministic
        self._done = threading.Event()
        self._refined: StepPlan | None = None

    def _finish(self, refined: StepPlan | None) -> None:
        self._refined = refined
        self._done.set()

    def ready(self) -> bool:
        return self._done.is_set()

    def best(self, *, eps: float = 1e-12) -> StepPlan:
        """The plan to dispatch *now*: refined iff done and strictly better
        (deterministic tickets block until their fixed rounds complete)."""
        if self.deterministic and not self._done.wait(DETERMINISTIC_WAIT_S):
            raise TimeoutError(
                f"deterministic refinement did not finish in "
                f"{DETERMINISTIC_WAIT_S:.0f} s"
            )
        refined = self._refined if self._done.is_set() else None
        if refined is not None and refined.makespan() < self.seed.makespan() - eps:
            return refined
        return self.seed

    def wait(self, timeout: float | None = None) -> StepPlan:
        """Block for the refinement (tests/benchmarks), then ``best()``."""
        self._done.wait(timeout)
        return self.best()


class PlanRefiner:
    """Daemon thread running knapsack-swap passes off the critical path.

    ``refine(seed)`` enqueues one LPT-seeded plan and returns immediately;
    the worker applies :func:`refine_swaps` and publishes the result on the
    ticket.  If the queue backs up past ``max_pending`` (refinement slower
    than the step cadence), the *oldest* unstarted tickets resolve to their
    seeds — a late refinement of a stale plan is worthless, and dropping it
    keeps the thread from falling ever further behind the training loop.

    With ``deterministic=True`` the worker instead runs *exactly*
    ``rounds`` exchange rounds of :func:`refine_fixed_rounds` seeded from
    the seed plan's digest, tickets block in ``best()`` until their result
    is ready, and the overflow drop above is disabled (dropping is a
    wall-clock decision; the consumer's blocking ``best()`` bounds the
    queue naturally instead).  Same inputs => same adopted plan on every
    host and every resume.
    """

    def __init__(
        self,
        *,
        max_pending: int = 4,
        max_rounds: int = 64,
        rounds: int | None = None,
        deterministic: bool = False,
    ):
        if deterministic and rounds is None:
            rounds = 16
        self._max_pending = max_pending
        self._max_rounds = max_rounds
        self.rounds = rounds
        self.deterministic = deterministic
        self._cv = threading.Condition()
        self._queue: list[RefineTicket] = []
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def refine(self, seed: StepPlan) -> RefineTicket:
        ticket = RefineTicket(seed, deterministic=self.deterministic)
        with self._cv:
            if self._closed:
                if self.deterministic:
                    # a deterministic ticket must still resolve to the
                    # fixed-round result, never timing-dependently to the
                    # seed — compute it inline on the caller's thread
                    ticket._finish(self._refined_plan(seed))
                else:
                    ticket._finish(None)  # closed refiner: seed stands
                return ticket
            self._queue.append(ticket)
            if not self.deterministic:
                while len(self._queue) > self._max_pending:
                    self._queue.pop(0)._finish(None)
            self._cv.notify()
        return ticket

    def _refined_plan(self, seed: StepPlan) -> StepPlan:
        locked = split_locked_indices(seed)
        if self.deterministic:
            groups = refine_fixed_rounds(
                seed.loads,
                seed.assignments,
                rounds=self.rounds,
                seed_bytes=seed.digest(),
                capacities=seed.capacities,
                locked=locked,
            )
        else:
            groups = refine_swaps(
                seed.loads,
                seed.assignments,
                max_rounds=self._max_rounds,
                capacities=seed.capacities,
                locked=locked,
            )
        return dataclasses.replace(
            seed,
            assignments=tuple(tuple(g) for g in groups),
            strategy="knapsack",
        )

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait(0.5)
                if self._closed and not self._queue:
                    return
                ticket = self._queue.pop(0)
            ticket._finish(self._refined_plan(ticket.seed))

    def close(self) -> None:
        with self._cv:
            self._closed = True
            for t in self._queue:
                # deterministic tickets must resolve to the fixed-round
                # result even on shutdown (a blocked best() would otherwise
                # adopt timing-dependently or hang forever)
                t._finish(self._refined_plan(t.seed) if t.deterministic else None)
            self._queue.clear()
            self._cv.notify_all()
        self._thread.join(timeout=2.0)


def assign_pool(
    loads: Sequence[float],
    n_workers: int,
    strategy: str,
    rng: np.random.Generator | None = None,
    capacities: Sequence[float] | None = None,
) -> list[list[int]]:
    """Pack one pool of microbatch loads across workers per ``strategy``.

    ``capacities`` weights lpt/knapsack packing by per-worker speed; the
    ``random`` baseline deliberately ignores it (that is the uniform
    strawman the mixed-fleet bench measures against)."""
    if strategy == "random":
        if rng is None:
            raise ValueError("random dispatch needs an rng")
        return assign_random(len(loads), n_workers, rng)
    if strategy == "lpt":
        return assign_lpt(loads, n_workers, capacities)
    if strategy == "knapsack":
        return refine_swaps(
            loads, assign_lpt(loads, n_workers, capacities),
            capacities=capacities,
        )
    raise ValueError(
        f"unknown dispatch strategy {strategy!r}; expected one of "
        f"{DISPATCH_STRATEGIES}"
    )


def partition_contiguous(
    loads: Sequence[float],
    n_groups: int,
    capacities: Sequence[float] | None = None,
) -> list[list[int]]:
    """Optimal *order-preserving* partition of ``loads`` into ``n_groups``
    contiguous, non-empty groups minimizing the max per-group finish time
    (group sum over the group's capacity).

    Contiguity is the point: the elastic remap path merges a fixed-width
    logical fan-out onto fewer physical ranks, and rank-major pool
    enumeration order — which the engines' gradient RNG
    (``fold_in(step_key, pool_index)``) depends on — survives exactly when
    logical shares are grouped contiguously.  Small inputs (logical width
    x pool size), so the O(n_groups * n^2) DP is exact and cheap."""
    n = len(loads)
    if n_groups < 1:
        raise ValueError("n_groups must be >= 1")
    if n < n_groups:
        raise ValueError(
            f"cannot split {n} items into {n_groups} non-empty groups"
        )
    caps = (
        [float(c) for c in capacities]
        if capacities is not None
        else [1.0] * n_groups
    )
    if len(caps) != n_groups:
        raise ValueError(f"{len(caps)} capacities for {n_groups} groups")
    if any(c <= 0 for c in caps):
        raise ValueError("group capacities must be positive")
    prefix = [0.0]
    for x in loads:
        prefix.append(prefix[-1] + float(x))
    inf = float("inf")
    # best[k][i]: min over splits of max finish time placing the first i
    # items into the first k groups; cut[k][i] reconstructs the partition
    best = [[inf] * (n + 1) for _ in range(n_groups + 1)]
    cut = [[0] * (n + 1) for _ in range(n_groups + 1)]
    best[0][0] = 0.0
    for k in range(1, n_groups + 1):
        for i in range(k, n - (n_groups - k) + 1):
            for j in range(k - 1, i):
                if best[k - 1][j] == inf:
                    continue
                cand = max(
                    best[k - 1][j],
                    (prefix[i] - prefix[j]) / caps[k - 1],
                )
                if cand < best[k][i]:
                    best[k][i], cut[k][i] = cand, j
    bounds = [n]
    for k in range(n_groups, 0, -1):
        bounds.append(cut[k][bounds[-1]])
    bounds.reverse()
    return [
        list(range(bounds[k], bounds[k + 1])) for k in range(n_groups)
    ]


def group_worker_steps(
    worker_steps: Sequence[Sequence],
    n_physical: int,
    capacities: Sequence[float] | None = None,
) -> list[list]:
    """Remap a fixed-width logical fan-out onto ``n_physical`` ranks.

    Logical shares are merged *contiguously* (see
    :func:`partition_contiguous`) so the flattened microbatch order — and
    therefore every microbatch's pool index, gradient RNG stream, and the
    step's pool-mean update — is byte-identical to running the logical
    fan-out directly.  This is what lets a kill-then-rejoin churn run
    replay the same deterministic plan stream (and digests) as an
    uninterrupted run while physical capacity comes and goes underneath
    it.  Shares are weighted by their token counts; ``capacities`` weights
    the physical ranks (a slow rank gets fewer logical shares)."""
    shares = [list(s) for s in worker_steps]
    if n_physical >= len(shares):
        return shares
    share_loads = [
        sum(float(getattr(b, "tokens", 1)) for b, _ in share) or 1.0
        for share in shares
    ]
    groups = partition_contiguous(share_loads, n_physical, capacities)
    return [
        [item for idx in group for item in shares[idx]] for group in groups
    ]


class StepPlanner:
    """Cluster-level microbatch dispatcher.

    Per optimizer step: draw microbatches from the weighted bucket table
    until the pool's total ``budget_of`` reaches ``n_workers * budget``
    (and every rank can get >= 1 microbatch), then pack the pool across
    ranks by ``load_of`` (defaults to ``budget_of``; pass the fitted
    ``B*S^p`` load when the pool budget is token-denominated).

    ``capacities`` (per-rank relative speeds; from the scheduler's
    telemetry on a heterogeneous fleet) scales both sides: the cluster
    budget becomes ``budget * sum(capacities)`` — a half-speed rank only
    buys half a rank's worth of pool — and lpt/knapsack pack against
    weighted finish times so fast ranks absorb the heavy microbatches.
    """

    def __init__(
        self,
        buckets: Sequence[Bucket],
        weights: Sequence[float] | None = None,
        *,
        n_workers: int,
        budget: float,
        budget_of: Callable[[Bucket], float],
        load_of: Callable[[Bucket], float] | None = None,
        strategy: str = "lpt",
        seed: int = 0,
        overlap: bool = False,
        deterministic_refine: bool = False,
        refine_rounds: int = 16,
        capacities: Sequence[float] | None = None,
        sp_max_ranks: int = 1,
        split_load_of: Callable[[Any, int], float] | None = None,
    ):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if strategy not in DISPATCH_STRATEGIES:
            raise ValueError(
                f"unknown dispatch strategy {strategy!r}; expected one of "
                f"{DISPATCH_STRATEGIES}"
            )
        if refine_rounds < 1:
            raise ValueError("refine_rounds must be >= 1")
        if sp_max_ranks < 1:
            raise ValueError("sp_max_ranks must be >= 1")
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(seed)
        self.n_workers = n_workers
        self.strategy = strategy
        self.budget = float(budget)
        self.budget_of = budget_of
        self.load_of = load_of if load_of is not None else budget_of
        self._capacities = self._checked_capacities(capacities, n_workers)
        # sequence-parallel split buckets: with sp_max_ranks >= 2 the
        # planner may replace the pool's heaviest packed window with k
        # sibling SplitShards on a contiguous rank window — adopted only
        # when the split plan's predicted makespan strictly beats the
        # unsplit plan's (so enabling SP can never plan worse).
        # split_load_of(bucket, k) prices one shard; None = base/k
        # (comm-free; wire CostModel.predict_split-style pricing here).
        self.sp_max_ranks = sp_max_ranks
        self.split_load_of = split_load_of
        # overlapped knapsack refinement: plan_async() returns the LPT seed
        # and runs the swap passes on a PlanRefiner thread (spawned lazily
        # so plain synchronous planners never start one).  deterministic
        # mode runs exactly refine_rounds digest-seeded rounds and blocks
        # adoption on the result — same adopted plan on every host/resume.
        self.overlap = overlap
        self.deterministic_refine = deterministic_refine
        self.refine_rounds = refine_rounds
        self._refiner: PlanRefiner | None = None
        self._plan_count = 0  # pools drawn so far (the resumable plan index)
        self._set_buckets(buckets, weights)

    def _set_buckets(
        self, buckets: Sequence[Bucket], weights: Sequence[float] | None
    ) -> None:
        buckets = list(buckets)
        self._probs = normalized_weights(buckets, weights)
        self._buckets = buckets

    @staticmethod
    def _checked_capacities(
        capacities: Sequence[float] | None, n_workers: int
    ) -> tuple[float, ...] | None:
        if capacities is None:
            return None
        caps = tuple(float(c) for c in capacities)
        if len(caps) != n_workers:
            raise ValueError(
                f"{len(caps)} capacities for {n_workers} workers"
            )
        if any(c <= 0 for c in caps):
            raise ValueError("worker capacities must be positive")
        return caps

    @property
    def buckets(self) -> list[Bucket]:
        """The current bucket table (snapshot)."""
        with self._lock:
            return list(self._buckets)

    @property
    def capacities(self) -> tuple[float, ...] | None:
        """Per-rank capacity vector plans are packed against (None =
        uniform fleet)."""
        with self._lock:
            return self._capacities

    # -- closed-loop / elastic updates ---------------------------------------

    def update(
        self,
        *,
        buckets: Sequence[Bucket] | None = None,
        weights: Sequence[float] | None = None,
        budget: float | None = None,
        budget_of: Callable[[Bucket], float] | None = None,
        load_of: Callable[[Bucket], float] | None = None,
        n_workers: int | None = None,
        strategy: str | None = None,
        overlap: bool | None = None,
        deterministic_refine: bool | None = None,
        refine_rounds: int | None = None,
        capacities: Sequence[float] | None = _UNSET,
        sp_max_ranks: int | None = None,
        split_load_of: Callable[[Any, int], float] | None = _UNSET,
    ) -> None:
        """Swap any part of the plan mid-training (scheduler replans,
        elastic resizes) without draining the pipeline.

        ``capacities`` follows set-if-passed semantics: omit to keep the
        current vector, pass an explicit ``None`` to return to a uniform
        fleet.  An elastic ``n_workers`` change drops a stale vector of
        the wrong width (per-rank identities do not survive renumbering)
        unless a matching one is passed in the same call."""
        stale_refiner: PlanRefiner | None = None
        with self._lock:
            if overlap is not None:
                self.overlap = overlap
            if deterministic_refine is not None:
                self.deterministic_refine = deterministic_refine
            if refine_rounds is not None:
                if refine_rounds < 1:
                    raise ValueError("refine_rounds must be >= 1")
                self.refine_rounds = refine_rounds
            if (deterministic_refine is not None or refine_rounds is not None) \
                    and self._refiner is not None:
                # the running refiner was built for the old mode; retire it
                # and let plan_async lazily respawn a matching one
                stale_refiner, self._refiner = self._refiner, None
            if strategy is not None:
                if strategy not in DISPATCH_STRATEGIES:
                    raise ValueError(f"unknown dispatch strategy {strategy!r}")
                self.strategy = strategy
            if n_workers is not None:
                if n_workers < 1:
                    raise ValueError("n_workers must be >= 1")
                self.n_workers = n_workers
            if capacities is not _UNSET:
                self._capacities = self._checked_capacities(
                    capacities, self.n_workers
                )
            elif (
                self._capacities is not None
                and len(self._capacities) != self.n_workers
            ):
                self._capacities = None
            if sp_max_ranks is not None:
                if sp_max_ranks < 1:
                    raise ValueError("sp_max_ranks must be >= 1")
                self.sp_max_ranks = sp_max_ranks
            if split_load_of is not _UNSET:
                self.split_load_of = split_load_of
            if budget is not None:
                if budget <= 0:
                    raise ValueError("budget must be positive")
                self.budget = float(budget)
            if budget_of is not None:
                self.budget_of = budget_of
                if load_of is None:
                    self.load_of = budget_of
            if load_of is not None:
                self.load_of = load_of
            if buckets is not None or weights is not None:
                self._set_buckets(
                    buckets if buckets is not None else self._buckets, weights
                )
        if stale_refiner is not None:
            stale_refiner.close()

    # -- planning ------------------------------------------------------------

    def draw_pool(self, rng: np.random.Generator | None = None) -> list[Bucket]:
        """Draw the step's global microbatch pool to the cluster budget."""
        with self._lock:
            buckets, probs = self._buckets, self._probs
            n_workers, budget = self.n_workers, self.budget
            budget_of = self.budget_of
            external = rng is not None
            rng = rng if external else self._rng
            # capacity-weighted fleets buy pool in proportion to their
            # aggregate speed (uniform: sum == n_workers, the classic)
            cluster_budget = budget * (
                sum(self._capacities)
                if self._capacities is not None
                else n_workers
            )
            pool: list[Bucket] = []
            acc = 0.0
            while acc < cluster_budget or len(pool) < n_workers:
                b = buckets[int(rng.choice(len(buckets), p=probs))]
                pool.append(b)
                acc += budget_of(b)
            if not external:
                self._plan_count += 1
            return pool

    def plan_pool(
        self, pool: Sequence[Bucket], rng: np.random.Generator | None = None
    ) -> StepPlan:
        """Pack an externally supplied pool (used by tests/benchmarks to
        compare strategies on identical pools)."""
        with self._lock:
            loads = [float(self.load_of(b)) for b in pool]
            assignment = assign_pool(
                loads, self.n_workers, self.strategy,
                rng if rng is not None else self._rng,
                self._capacities,
            )
            plan = StepPlan(
                microbatches=tuple(pool),
                assignments=tuple(tuple(g) for g in assignment),
                loads=tuple(loads),
                strategy=self.strategy,
                capacities=self._capacities,
            )
            split = self._split_candidate(
                pool, loads, plan.makespan(),
                refine=(self.strategy == "knapsack"),
                strategy=self.strategy,
            )
            return split if split is not None else plan

    def _split_candidate(
        self,
        pool: Sequence,
        loads: Sequence[float],
        base_makespan: float,
        *,
        refine: bool,
        strategy: str,
        eps: float = 1e-12,
    ) -> StepPlan | None:
        """The best split-bucket variant of (pool, loads), or None.

        Splits the pool's single heaviest packed microbatch into k sibling
        :class:`SplitShard` entries (k = 2..sp_max_ranks, shard widths
        128-aligned), pins them to the contiguous rank window with the
        best finish time, packs the remaining singles around the pinned
        preloads with capacity-aware LPT, and — for the knapsack strategy
        — refines with the shard indices locked.  Returns a plan only when
        some k's predicted makespan strictly beats ``base_makespan``, so a
        split-enabled planner is never worse than an unsplit one on its
        own cost model (the hypothesis-property invariant).  Must be
        called with ``self._lock`` held."""
        k_max = min(self.sp_max_ranks, self.n_workers)
        if k_max < 2 or not pool or strategy == "random":
            return None
        hi = max(range(len(pool)), key=lambda i: (loads[i], -i))
        b = pool[hi]
        if getattr(b, "lengths", None) is None:
            # only packed LM windows have a ring lowering (segment-aware
            # flash); rectangular media buckets stay whole
            return None
        split_load_of = self.split_load_of or (
            lambda mb, k: float(self.load_of(mb)) / k
        )
        caps = (
            list(self._capacities)
            if self._capacities is not None
            else [1.0] * self.n_workers
        )
        best: tuple[float, StepPlan] | None = None
        for k in range(2, k_max + 1):
            seq = int(b.seq_len)
            if seq % k or (seq // k) % SPLIT_ALIGN:
                continue
            rank_load = float(split_load_of(b, k))
            shards = tuple(
                SplitShard(base=b, n_ranks=k, shard=s, rank_load=rank_load)
                for s in range(k)
            )
            new_pool = tuple(pool[:hi]) + shards + tuple(pool[hi + 1 :])
            new_loads = (
                list(loads[:hi]) + [rank_load] * k + list(loads[hi + 1 :])
            )
            # contiguous rank window minimizing the slowest shard's finish
            # (ties -> lowest r0, so placement is deterministic)
            r0 = min(
                range(self.n_workers - k + 1),
                key=lambda r: max(rank_load / caps[r + s] for s in range(k)),
            )
            groups: list[list[int]] = [[] for _ in range(self.n_workers)]
            totals = [0.0] * self.n_workers
            for s in range(k):
                groups[r0 + s].append(hi + s)
                totals[r0 + s] += rank_load
            singles = [i for i in range(len(new_loads)) if not hi <= i < hi + k]
            for i in sorted(singles, key=lambda i: (-new_loads[i], i)):
                w = min(
                    range(self.n_workers),
                    key=lambda r: ((totals[r] + new_loads[i]) / caps[r], r),
                )
                groups[w].append(i)
                totals[w] += new_loads[i]
            if any(not g for g in groups):
                continue  # a plan may never hand a rank an empty share
            if refine:
                groups = refine_swaps(
                    new_loads, groups,
                    capacities=self._capacities,
                    locked=frozenset(range(hi, hi + k)),
                )
            cand = StepPlan(
                microbatches=new_pool,
                assignments=tuple(tuple(g) for g in groups),
                loads=tuple(new_loads),
                strategy=strategy,
                capacities=self._capacities,
            )
            span = cand.makespan()
            if span < base_makespan - eps and (
                best is None or span < best[0] - eps
            ):
                best = (span, cand)
        return best[1] if best is not None else None

    def plan(self) -> StepPlan:
        """Draw + pack one optimizer step."""
        return self.plan_pool(self.draw_pool())

    def plan_async(self) -> tuple[StepPlan, RefineTicket | None]:
        """Draw + pack with knapsack refinement off the critical path.

        With ``overlap`` and the ``knapsack`` strategy this returns the
        cheap LPT seed immediately plus a :class:`RefineTicket`; the caller
        dispatches ``ticket.best()`` at the step boundary (refined iff the
        background swap passes strictly lowered the predicted max-rank
        load).  Any other configuration degrades to the synchronous
        :meth:`plan` and a ``None`` ticket, so consumers can call this
        unconditionally.
        """
        pool = self.draw_pool()
        with self._lock:
            if not (self.overlap and self.strategy == "knapsack"):
                overlapped = False
            else:
                overlapped = True
                loads = [float(self.load_of(b)) for b in pool]
                seed = StepPlan(
                    microbatches=tuple(pool),
                    assignments=tuple(
                        tuple(g)
                        for g in assign_lpt(
                            loads, self.n_workers, self._capacities
                        )
                    ),
                    loads=tuple(loads),
                    strategy="lpt",
                    capacities=self._capacities,
                )
                # the split decision must live in the digest-committed
                # seed (refinement only regroups; it can never introduce
                # or undo a split) — the refiner then keeps the sibling
                # shards locked to their ring ranks
                split = self._split_candidate(
                    pool, loads, seed.makespan(),
                    refine=False, strategy="lpt",
                )
                if split is not None:
                    seed = split
                if self._refiner is None:
                    self._refiner = PlanRefiner(
                        deterministic=self.deterministic_refine,
                        rounds=self.refine_rounds,
                    )
                refiner = self._refiner
        if not overlapped:
            return self.plan_pool(pool), None
        return seed, refiner.refine(seed)

    # -- run-state checkpointing ---------------------------------------------

    def state_dict(self) -> dict:
        """JSON-serializable replayable state: the RNG bit-generator state,
        plan counter, and the numeric plan knobs.  Callables (``budget_of``
        / ``load_of``) and the bucket table are deliberately NOT captured —
        they are code + scheduler outputs, reconstructed by whoever rebuilds
        the planner (the scheduler's own ``state_dict`` replays the fit that
        produced them)."""
        with self._lock:
            return {
                "version": 1,
                "rng": self._rng.bit_generator.state,
                "plan_count": self._plan_count,
                "n_workers": self.n_workers,
                "strategy": self.strategy,
                "budget": self.budget,
                "overlap": self.overlap,
                "deterministic_refine": self.deterministic_refine,
                "refine_rounds": self.refine_rounds,
                "sp_max_ranks": self.sp_max_ranks,
                "capacities": (
                    list(self._capacities)
                    if self._capacities is not None
                    else None
                ),
            }

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict` output: the next ``plan()`` draws the
        exact pool the captured planner would have drawn next."""
        if sd.get("strategy") not in DISPATCH_STRATEGIES:
            raise ValueError(
                f"unknown dispatch strategy {sd.get('strategy')!r} in state"
            )
        with self._lock:
            self._rng.bit_generator.state = sd["rng"]
            self._plan_count = int(sd["plan_count"])
            self.n_workers = int(sd["n_workers"])
            self.strategy = sd["strategy"]
            self.budget = float(sd["budget"])
            self.overlap = bool(sd["overlap"])
            self.deterministic_refine = bool(sd["deterministic_refine"])
            self.refine_rounds = int(sd["refine_rounds"])
            # absent in pre-SP checkpoints -> splitting disabled
            self.sp_max_ranks = int(sd.get("sp_max_ranks", 1))
            # absent in pre-capacity checkpoints -> uniform fleet
            self._capacities = self._checked_capacities(
                sd.get("capacities"), self.n_workers
            )
            # an already-spawned refiner was built for the pre-restore
            # mode; retire it (plan_async lazily respawns a matching one)
            # or post-restore tickets would adopt with the OLD rules and
            # the replayed stream could silently diverge
            stale, self._refiner = self._refiner, None
        if stale is not None:
            stale.close()

    @property
    def plan_count(self) -> int:
        """Pools drawn so far (the plan index a resume replays from)."""
        with self._lock:
            return self._plan_count

    def close(self) -> None:
        """Stop the background refiner (no-op for synchronous planners)."""
        with self._lock:
            refiner, self._refiner = self._refiner, None
        if refiner is not None:
            refiner.close()

    def describe(self) -> str:
        with self._lock:
            return (
                f"StepPlanner(strategy={self.strategy}, "
                f"workers={self.n_workers}, budget={self.budget:.3e}, "
                f"buckets={len(self._buckets)})"
            )


__all__ = [
    "DISPATCH_STRATEGIES",
    "SPLIT_ALIGN",
    "PlanRefiner",
    "RefineTicket",
    "SplitShard",
    "StepPlan",
    "StepPlanner",
    "assign_pool",
    "group_worker_steps",
    "makespan",
    "merge_split_worker_steps",
    "microbatch_key",
    "normalized_weights",
    "partition_contiguous",
    "plan_digest",
    "refine_fixed_rounds",
    "refine_swaps",
    "split_locked_indices",
]
