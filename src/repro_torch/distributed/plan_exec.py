"""Execution of StepPlans across processes: the counterpart of
``repro.distributed.plan_exec`` on ``torch.distributed``, one process a
data-parallel rank.

``StepPlanner`` decides *who runs what* each optimizer step.
:class:`PlanExecutor` runs that decision with one process per rank:

* **every process receives the whole fan-out** and runs
  ``worker_steps[rank]``: each bucket shape runs the shared pool gradient
  step (``train.steps.make_pool_grad_step``), gradients accumulating in
  the parameters' dtype, so ranks run *different* shape sequences;
* **one collective per step**: each rank lifts its gradient sums to f32
  into one flat buffer, with its loss sum and a "first signature" flag
  behind them, and ONE ``all_reduce`` sums the buffers; every process
  then divides by the pool's count and applies the same AdamW update, so
  the update is the exact mean over the step's global pool.  Nothing in
  a step waits for the device over NCCL (``measure="serial"`` aside): the
  pool's count comes from the fan-out every process holds, and the loss
  and the "first signature" flag stay device scalars until the caller
  reads them (gloo's ``all_reduce`` of CUDA tensors waits on the host);
* **plan agreement**, every step: every process derives its plan
  independently (the same seed, the same gathered telemetry); the 32-byte
  digest of each process's own fan-out is all-gathered and any divergence
  raises :class:`PlanAgreementError` on every rank *before* the gradient
  collective could pair mismatched work;
* **measuring**: ``measure="serial"`` synchronises after each microbatch,
  ``"async"`` (alias ``True``) records CUDA event pairs and
  resolves them in :meth:`RankTimers.join`, which all-gathers every rank's
  records so each process returns the same rank-major record list (every
  scheduler then refits on identical telemetry and replans identically).

Gradient semantics match :func:`oracle_step`: each microbatch contributes
the gradient of its own loss, its draws keyed on ``(step_key,
pool_index)`` with ``pool_index`` the *global* rank-major index, and the
update consumes the mean over every microbatch of the pool.

Sequence-parallel split buckets (``SplitShard``) run as one ring step a
group over ``ProcessRing(k, group=sub)`` on the group's contiguous ranks;
shard 0's rank adds the group's mean gradient once, siblings add nothing.
gloo cannot send CUDA tensors point to point, so a split group of CUDA
tensors on gloo raises; it needs NCCL (two or more cards).

Deliberate differences from the reference: :meth:`PlanExecutor.
verify_agreement` takes this process's own digest (the reference, one
controller, takes every rank's), and :meth:`PlanExecutor.execute` always
checks it (no ``check_agreement`` switch: the reference's one controller
cannot disagree with itself, the port's processes can);
:class:`RankTimers` has no observer threads (CUDA events resolve at
``join``); the state is updated in place (the port's engines own their
model), and there is no ``donate``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.dispatch import SplitShard, merge_split_worker_steps, microbatch_key
from repro_torch.core.telemetry import WorkerStepRecord
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import OptimizerConfig, adamw_update
from repro_torch.train.engine import clock, seconds
from repro_torch.train.steps import NoiseHook, decay_rule, make_pool_grad_step

WorkerSteps = Sequence[Sequence[tuple[Any, Any]]]  # [rank][(bucket, batch)]

#: a leaf's offset in the flat reduction buffer is a multiple of this many
#: elements, so every leaf's slice is as aligned as a fresh allocation
_ALIGN = 64


class PlanAgreementError(RuntimeError):
    """Hosts derived different StepPlans for the same optimizer step."""


@dataclasses.dataclass(frozen=True)
class DeferredBatch:
    """A microbatch the loader drew but did not make: ``fn(*args,
    device)`` makes it (``data.synthetic.make_diffusion_batch``,
    ``make_lm_batch``).  A loader that hands these out draws every
    microbatch's seed from its generator, as the launchers do, while each
    process makes only its own rank's batches, on its own device."""

    fn: Callable[..., dict]
    args: tuple

    def make(self, device) -> dict:
        return self.fn(*self.args, device)


def place_batch(batch, device) -> dict:
    """A batch's arrays as tensors on ``device``: a :class:`DeferredBatch`
    is made there, numpy arrays and tensors are moved (other entries are
    dropped, as ``data.pipeline.to_device`` drops them)."""
    if isinstance(batch, DeferredBatch):
        return batch.make(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
    return out


def worker_steps_digest(worker_steps: WorkerSteps) -> bytes:
    """Content hash of a materialized per-rank fan-out.

    The loader-facing sibling of ``core.dispatch.plan_digest``: when a host
    only holds its plan's *materialized* form (bucket, batch), e.g. out of
    ``ShardedBucketedLoader``, this hashes the rank-major microbatch
    identities, which is exactly what execution order depends on."""
    h = hashlib.sha256()
    for share in worker_steps:
        for bucket, _batch in share:
            h.update(repr(microbatch_key(bucket)).encode())
        h.update(b"|")
    return h.digest()


def digest_to_row(digest: bytes) -> np.ndarray:
    """sha256 digest -> [8] uint32 row (the all-gather wire format)."""
    if len(digest) != 32:
        raise ValueError(f"expected a 32-byte digest, got {len(digest)}")
    return np.frombuffer(digest, dtype=np.uint8).view(np.uint32).copy()


def _state_tensors(state) -> list[torch.Tensor]:
    """A train state's parameters, then its first and second moments."""
    model = state["model"]
    out = [p.data for _, p in model.named_parameters()]
    for k in ("m", "v"):
        out += [state["opt"][k][n] for n, _ in model.named_parameters()]
    return out


_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def state_fingerprint(state) -> torch.Tensor:
    """[3P + 1] int64 on the state's device: each parameter's and moment's
    bits summed as integers, then the step.  Equal states give equal rows;
    the sums are exact in any order, so the row is a device-side check of
    agreement between processes."""
    sums = [t.detach().contiguous().view(-1).view(_INT_OF_WIDTH[t.element_size()])
            .sum(dtype=torch.int64) for t in _state_tensors(state)]
    step = torch.tensor(int(state["step"]), dtype=torch.int64, device=sums[0].device)
    return torch.stack(sums + [step])


class RankTimers:
    """This process's timing of one step, resolved and gathered at
    :meth:`join`.

    ``jobs`` are ``(t0, t1, bucket, fresh)`` marks of this rank's
    microbatches (CUDA events on the card, no synchronisation per
    microbatch); ``span`` the marks around the whole share.  ``join``
    resolves them (a microbatch that met its batch signature first is kept
    out of the records), applies ``scale`` and all-gathers every rank's
    records and time (``all_gather_object``), so every process returns the
    reference's rank-major ``(records, rank_times)``.  Every process of the
    group must call ``join`` (it is a collective)."""

    def __init__(self, step: int, rank: int, jobs: list, span, scale: float, group,
                 *, timing: str = "device"):
        self._step, self._rank, self._jobs = step, rank, jobs
        self._span, self._scale, self._group = span, scale, group
        self._timing = timing
        self._result: tuple[list[WorkerStepRecord], list[float]] | None = None

    def _local(self) -> tuple[list[WorkerStepRecord], float]:
        recs = []
        for t0, t1, bucket, fresh in self._jobs:
            if not fresh:  # first-signature set-up would poison telemetry
                recs.append(WorkerStepRecord(
                    step=self._step, worker=self._rank, batch_size=bucket.batch_size,
                    seq_len=bucket.seq_len, compute_time=seconds(t0, t1) * self._scale,
                    timing=self._timing, ring_ranks=getattr(bucket, "n_ranks", 1)))
        total = seconds(*self._span) * self._scale if self._span is not None else 0.0
        return recs, total

    def join(self) -> tuple[list[WorkerStepRecord], list[float]]:
        """Every rank's records, rank-major, and every rank's time."""
        if self._result is None:
            mine = self._local()
            world = dist.get_world_size(self._group)
            gathered: list = [None] * world
            dist.all_gather_object(gathered, mine, group=self._group)
            records = [r for recs, _ in gathered for r in recs]
            self._result = records, [t for _, t in gathered]
        return self._result


class PlanExecutor:
    """Executes one optimizer step's worth of planned microbatches with one
    process a rank of ``group`` (a ``torch.distributed`` process group; None
    is the default group).  ``device`` is this process's device (CUDA
    unless given, raising without a GPU).  Nothing is built at
    construction; split-group rings are made lazily and cached."""

    def __init__(self, group, cfg: ModelConfig, opt: OptimizerConfig, *, device=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.n_ranks = dist.get_world_size(group)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.backend = dist.get_backend(group)
        self.cfg = cfg
        self.opt = opt
        self._grad_step = make_pool_grad_step(cfg)
        self._decay = decay_rule(cfg)
        # split groups: (r0, k) -> (process group, ring or None, SP step or None)
        self._sp: dict[tuple[int, int], tuple] = {}
        self._seen_signatures: set = set()
        # stage(): this rank's next batches, made ahead on a side stream;
        # entry: id(host batch) -> (host batch, placed batch)
        self._staged: dict[int, tuple[Any, dict]] = {}
        self._side = (torch.cuda.Stream(self.device) if self.device.type == "cuda" else None)

    # -- placement ---------------------------------------------------------

    def comm_device(self) -> torch.device:
        """Where small collectives' tensors live: gloo gathers host
        tensors only, NCCL device tensors only."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


    def _fingerprints_agree(self, state) -> bool:
        row = state_fingerprint(state).to(self.comm_device())
        rows = [torch.empty_like(row) for _ in range(self.n_ranks)]
        dist.all_gather(rows, row, group=self.group)
        return all(torch.equal(r, rows[0]) for r in rows)

    def is_placed(self, state) -> bool:
        """True if ``state`` lives on this process's device and every rank
        holds the same parameters, moments and step (a collective)."""
        here = all(t.device == self.device for t in _state_tensors(state))
        flag = torch.tensor([int(here)], device=self.comm_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        return bool(flag.item()) and self._fingerprints_agree(state)

    def place_state(self, state):
        """Move ``state`` to this process's device and broadcast rank 0's
        parameters, moments and step to every rank (in place), then check
        that the ranks are equal."""
        model = state["model"].to(self.device)
        state["model"] = model
        for k in ("m", "v"):
            for n in list(state["opt"][k]):
                state["opt"][k][n] = state["opt"][k][n].to(self.device)
        src = dist.get_global_rank(self.group, 0) if self.group is not None else 0
        with torch.no_grad():
            for t in _state_tensors(state):
                buf = t.to(self.comm_device())
                dist.broadcast(buf, src=src, group=self.group)
                if buf is not t:
                    t.copy_(buf)
        step = torch.tensor([int(state["step"])], dtype=torch.int64,
                            device=self.comm_device())
        dist.broadcast(step, src=src, group=self.group)
        state["step"] = int(step.item())
        if not self._fingerprints_agree(state):
            raise RuntimeError("ranks hold different states after the broadcast")
        return state

    # -- agreement ---------------------------------------------------------

    def verify_agreement(self, digest: bytes) -> None:
        """All-gather every process's own plan digest and require
        unanimity: :class:`PlanAgreementError` on every rank otherwise."""
        row = torch.from_numpy(digest_to_row(digest).astype(np.int64)).to(self.comm_device())
        rows = [torch.empty_like(row) for _ in range(self.n_ranks)]
        dist.all_gather(rows, row, group=self.group)
        bad = [r for r in range(self.n_ranks) if not torch.equal(rows[r], rows[0])]
        if bad:
            raise PlanAgreementError(
                f"plan digests diverge across hosts: ranks {bad} disagree with rank 0, "
                f"refusing to step (a mismatched plan means mismatched collectives: "
                f"deadlock or silent grad skew)"
            )

    # -- batches -------------------------------------------------------------

    @staticmethod
    def _signature(batch: dict) -> tuple:
        return tuple(sorted((k, tuple(v.shape), str(v.dtype)) for k, v in batch.items()))

    def _take(self, batch) -> dict:
        """This rank's batch on its device: the staged copy when
        :meth:`stage` made it (the default stream then waits for the side
        stream), else made or moved now."""
        entry = self._staged.pop(id(batch), None)
        if entry is not None and entry[0] is batch:
            if self._side is not None:
                torch.cuda.current_stream(self.device).wait_stream(self._side)
            return entry[1]
        return place_batch(batch, self.device)

    def stage(self, worker_steps: WorkerSteps) -> None:
        """Make (or move) this rank's batches of a future step ahead of its
        execution, on a side stream on the card, so they overlap the
        current step's compute.  Entries are keyed by the host batch
        object's identity and pin it; a fan-out that changed between stage
        and execute misses and is made then: staging is an optimisation,
        never a correctness dependency."""
        self._staged.clear()
        if self.rank >= len(worker_steps):
            return
        main = torch.cuda.current_stream(self.device) if self._side is not None else None
        for _bucket, batch in worker_steps[self.rank]:
            if self._side is None:
                placed = place_batch(batch, self.device)
            else:
                with torch.cuda.stream(self._side):
                    placed = place_batch(batch, self.device)
                for v in placed.values():
                    v.record_stream(main)
            self._staged[id(batch)] = (batch, placed)

    # -- warmup --------------------------------------------------------------

    def warmup(self, state, batches: Sequence) -> None:
        """Run every batch signature once on this rank, so no measured step
        pays a first-signature set-up (the executor also tracks freshness
        itself and keeps such executions out of telemetry)."""
        model = state["model"]
        for batch in batches:
            b = place_batch(batch, self.device)
            self._seen_signatures.add(self._signature(b))
            self._grad_step(model, b, 0, 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time_batch(self, state, batch, *, reps: int = 3) -> list[float]:
        """Seconds of ``reps`` gradient steps of one microbatch on this
        rank, after an untimed one (CUDA events on the card)."""
        model = state["model"]
        b = place_batch(batch, self.device)
        self._seen_signatures.add(self._signature(b))
        self._grad_step(model, b, 0, 0)
        times = []
        for _ in range(reps):
            t0 = clock(self.device)
            self._grad_step(model, b, 0, 0)
            times.append(seconds(t0, clock(self.device)))
        return times

    # -- sequence-parallel split buckets -----------------------------------

    def _collect_split_groups(self, worker_steps: WorkerSteps) -> dict:
        """Index and validate the fan-out's split-bucket groups.

        Returns ``{id(base): {"k", "r0", "entries": {shard: (rank, bucket,
        batch)}}}`` in plan order (rank-major discovery).  A group must be
        complete (shards 0..k-1, each once), sit on contiguous ascending
        ranks (shard s on rank r0+s), fit the group, and carry
        equal-width shard batches with globally computed ``positions``."""
        groups: dict[int, dict] = {}
        for rank, share in enumerate(worker_steps):
            for bucket, batch in share:
                if not isinstance(bucket, SplitShard):
                    continue
                g = groups.setdefault(id(bucket.base), {"k": bucket.n_ranks, "entries": {}})
                if bucket.n_ranks != g["k"] or bucket.shard in g["entries"]:
                    raise ValueError(
                        "malformed split group: sibling shards disagree on "
                        "ring size or repeat a shard index"
                    )
                g["entries"][bucket.shard] = (rank, bucket, batch)
        for g in groups.values():
            k = g["k"]
            if sorted(g["entries"]) != list(range(k)):
                raise ValueError(
                    f"incomplete split group: shards {sorted(g['entries'])} "
                    f"present, expected 0..{k - 1}"
                )
            r0 = g["entries"][0][0]
            if r0 + k > self.n_ranks:
                raise ValueError(
                    f"split group needs ranks {r0}..{r0 + k - 1} but the "
                    f"group has {self.n_ranks} ranks"
                )
            widths = set()
            for s in range(k):
                rank, _bucket, batch = g["entries"][s]
                if rank != r0 + s:
                    raise ValueError(
                        "split shards must occupy contiguous ascending "
                        f"ranks (shard {s} on rank {rank}, expected {r0 + s})"
                    )
                if isinstance(batch, DeferredBatch) or "positions" not in batch:
                    raise ValueError(
                        "split shard batches need globally computed "
                        "'positions' (RoPE must not restart at the shard "
                        "boundary)"
                    )
                widths.add(int(np.shape(batch["tokens"])[1]))
            if len(widths) != 1:
                raise ValueError(f"split shard widths differ: {sorted(widths)}")
            g["r0"] = r0
        if groups and self.backend == "gloo" and self.device.type == "cuda":
            raise ValueError(
                "split groups on gloo with CUDA tensors: gloo sends no CUDA tensor "
                "point to point; run the ring over NCCL (one card a rank)"
            )
        return groups

    def _sp_step(self, r0: int, k: int):
        """The SP gradient step of ranks [r0, r0+k): a ``ProcessRing`` over
        a sub-group.  Every process calls ``dist.new_group`` for the same
        (r0, k) in the same order (processes outside the group too), so
        the groups are made lazily in plan order and cached by (r0, k).
        Returns None outside the group."""
        key = (r0, k)
        if key not in self._sp:
            from repro_torch.kernels.flash_attention.ring import ProcessRing
            from repro_torch.train.steps import make_sp_pool_grad_step

            ranks = list(range(r0, r0 + k))
            if self.group is not None:
                ranks = [dist.get_global_rank(self.group, r) for r in ranks]
            sub = dist.new_group(ranks=ranks)
            step = None
            if r0 <= self.rank < r0 + k:
                step = make_sp_pool_grad_step(self.cfg, ProcessRing(k, group=sub))
            self._sp[key] = (sub, step)
        return self._sp[key][1]

    # -- the step ----------------------------------------------------------

    @staticmethod
    def _logical(share) -> int:
        """Pool entries of a share: a split group counts once, at shard 0."""
        return sum(1 for b, _ in share if not isinstance(b, SplitShard) or b.shard == 0)

    def _flat(self, params: list[tuple[str, torch.Tensor]], acc: dict | None,
              tail: int) -> tuple[torch.Tensor, list[int]]:
        """This rank's f32 reduction buffer: each gradient sum lifted to f32
        at an aligned offset (zeros where ``acc`` is None), then ``tail``
        zeros."""
        offsets, n = [], 0
        for _, p in params:
            offsets.append(n)
            n += -(-p.numel() // _ALIGN) * _ALIGN
        flat = torch.zeros(n + tail, dtype=torch.float32, device=self.device)
        if acc is not None:
            for (name, p), off in zip(params, offsets):
                flat[off:off + p.numel()].copy_(acc.pop(name).reshape(-1))
        return flat, offsets

    def execute(self, state, worker_steps: WorkerSteps, *, step_key: int, digest: bytes,
                step: int = 0, measure: bool | str = False,
                time_scale: Callable[[int], float] | None = None):
        """Run one planned optimizer step: this process checks that every
        process's ``digest`` (its ``worker_steps_digest``) agrees, runs
        ``worker_steps[rank]``, then the one ``all_reduce`` and the update.

        Microbatch draws derive from ``fold_in(step_key, pool_index)`` with
        ``pool_index`` the global rank-major index (a rank starts at the
        logical microbatches of all lower ranks), as in :func:`oracle_step`.

        * ``measure=False``: no telemetry;
        * ``measure="async"`` (alias ``True``): CUDA event pairs around each
          microbatch, resolved by ``out["timers"].join()``;
        * ``measure="serial"``: the same marks and a synchronisation after
          each microbatch; ``out["records"]`` and ``out["rank_times"]``.

        Records are every rank's, rank-major, on every process.
        ``out["loss"]`` is the pool's mean loss and ``out["compiled"]`` is
        True on every process iff a microbatch of any rank met its batch
        signature first; both are device scalars, so that the call returns
        before the device has finished the step (read them after staging
        the next).  A fan-out SMALLER than the
        group (elastic shrink) is legal: the surplus processes join the
        reduction with zero sums.  A wider fan-out, or an
        empty share inside it, raises ``ValueError`` on every process."""
        if measure is True:
            measure = "async"
        if measure not in (False, "serial", "async"):
            raise ValueError(f"measure must be False, 'serial', or 'async'; got {measure!r}")
        # agreement first: processes holding different fan-outs would
        # otherwise part ways at a validation error and leave the others
        # waiting in a collective
        self.verify_agreement(digest)
        if len(worker_steps) > self.n_ranks:
            raise ValueError(
                f"plan fans out to {len(worker_steps)} ranks but the group has only "
                f"{self.n_ranks} (growing past the group requires a new group/executor)"
            )
        for r, share in enumerate(worker_steps):
            if not share:
                raise ValueError(f"rank {r} received an empty microbatch list")
        split_groups = self._collect_split_groups(worker_steps)
        # the pool's count, from the fan-out every process holds
        n = sum(self._logical(sh) for sh in worker_steps)
        if n == 0:
            raise ValueError("execute received an empty fan-out")

        model = state["model"]
        params = list(model.named_parameters())
        dev = self.device
        scale = time_scale(self.rank) if time_scale else 1.0
        share = worker_steps[self.rank] if self.rank < len(worker_steps) else []
        first = sum(self._logical(worker_steps[r]) for r in range(min(self.rank,
                                                                     len(worker_steps))))
        # split groups first, in plan order: every member enters each ring
        # in the same order (no cycle of waits), and every process makes
        # the same sub-groups; results wait for their place in the share
        pool_of: dict[int, int] = {}
        pos = 0
        for r, sh in enumerate(worker_steps):
            for b, _ in sh:
                if isinstance(b, SplitShard) and b.shard == 0:
                    pool_of[id(b.base)] = pos
                pos += int(not isinstance(b, SplitShard) or b.shard == 0)
        split_out: dict[int, tuple] = {}
        for gid, g in split_groups.items():
            sp = self._sp_step(g["r0"], g["k"])
            if sp is None:
                continue
            s = self.rank - g["r0"]
            batch = self._take(g["entries"][s][2])
            sig = ("sp", g["r0"], g["k"], self._signature(batch))
            fresh = sig not in self._seen_signatures
            self._seen_signatures.add(sig)
            t0 = clock(dev)
            loss, grads = sp(model, batch, step_key, pool_of[gid])
            if measure == "serial" and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            split_out[gid] = (loss, grads if s == 0 else None, (t0, clock(dev)), fresh)

        compiled = any(f for *_, f in split_out.values())
        acc, loss_sum = None, None
        jobs: list = []
        pool_index = first
        span0 = clock(dev)
        for bucket, batch in share:
            if isinstance(bucket, SplitShard):
                loss, grads, (t0, t1), fresh = split_out.pop(id(bucket.base))
                jobs.append((t0, t1, bucket, fresh))
                if bucket.shard != 0:
                    continue  # the group's mean already sits in shard 0's sums
                pool_index += 1
            else:
                b = self._take(batch)
                sig = self._signature(b)
                fresh = sig not in self._seen_signatures
                self._seen_signatures.add(sig)
                compiled = compiled or fresh
                t0 = clock(dev)
                loss, grads = self._grad_step(model, b, step_key, pool_index)
                if measure == "serial" and dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                jobs.append((t0, clock(dev), bucket, fresh))
                pool_index += 1
                del b
            if acc is None:
                acc = grads
            else:
                for name, g in grads.items():
                    acc[name].add_(g)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            del grads
        span = (span0, clock(dev)) if share else None
        self._staged.clear()  # anything unclaimed this step is stale

        # behind the sums: this rank's loss sum and its first-signature flag
        flat, offsets = self._flat(params, acc, 2)
        if loss_sum is not None:
            flat[-2].copy_(loss_sum)
        if compiled:
            flat[-1].fill_(1.0)
        del acc
        dist.all_reduce(flat, group=self.group)
        grads = {name: flat[off:off + p.numel()].view(p.shape) / n
                 for (name, p), off in zip(params, offsets)}
        loss = flat[-2] / n
        compiled_any = flat[-1] > 0
        adamw_update(dict(params), grads, state["opt"], state["step"], self.opt,
                     decay=self._decay)
        del grads, flat
        state["step"] += 1

        timing = "device" if dev.type == "cuda" else "host"
        out = {"loss": loss, "records": [], "compiled": compiled_any}
        if measure:
            timers = RankTimers(step, self.rank, jobs, span, scale, self.group, timing=timing)
            if measure == "serial":
                out["records"], out["rank_times"] = timers.join()
            else:
                out["timers"] = timers
        return state, out


def oracle_step(cfg: ModelConfig, opt: OptimizerConfig, state, worker_steps, *,
                step_key: int, noise: NoiseHook | None = None):
    """Single-process reference: the gradient and update a non-distributed
    trainer computes for the same global pool (rank-major enumeration,
    the same draws a microbatch).  Split fan-outs are merged first: a split
    bucket's k sibling shards collapse back into the whole window at shard
    0's pool position.  Updates ``state`` in place; returns ``(state,
    {"loss", "grad_norm", "lr"})``."""
    worker_steps = merge_split_worker_steps(worker_steps)
    model = state["model"]
    grad_fn = make_pool_grad_step(cfg, noise)
    acc = None
    loss_sum = 0.0
    n = 0
    for share in worker_steps:
        for _bucket, batch in share:
            loss, grads = grad_fn(model, place_batch(batch, model.device), step_key, n)
            if acc is None:
                acc = grads
            else:
                for name, g in grads.items():
                    acc[name].add_(g)
            loss_sum = loss_sum + loss
            n += 1
    grads = {name: g.float() / n for name, g in acc.items()}
    _, _, stats = adamw_update(dict(model.named_parameters()), grads, state["opt"],
                               state["step"], opt, decay=decay_rule(cfg))
    state["step"] += 1
    return state, {"loss": loss_sum / n, **stats}


def rel_l2(a, b) -> float:
    """Relative L2 distance between two trees of tensors or arrays (dicts
    walked in ``b``'s key order; the parity metric)."""

    def leaves(t):
        if isinstance(t, dict):
            for k in t:
                yield from leaves(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                yield from leaves(x)
        else:
            yield t

    def as_np(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().double().cpu().numpy()
        return np.asarray(x, dtype=np.float64)

    num = den = 0.0
    if isinstance(a, dict) and isinstance(b, dict):
        a = {k: a[k] for k in b}
    for x, y in zip(leaves(a), leaves(b)):
        xf, yf = as_np(x), as_np(y)
        num += float(((xf - yf) ** 2).sum())
        den += float((yf**2).sum())
    return float(np.sqrt(num / max(den, 1e-30)))


__all__ = [
    "DeferredBatch",
    "PlanAgreementError",
    "PlanExecutor",
    "RankTimers",
    "digest_to_row",
    "oracle_step",
    "place_batch",
    "rel_l2",
    "state_fingerprint",
    "worker_steps_digest",
]
