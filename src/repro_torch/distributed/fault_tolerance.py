"""Fault tolerance of the port: checkpoint cadence, failure detection,
elastic recovery (a copy of ``repro.distributed.fault_tolerance``, saving
through the port's ``checkpoint.store``).

At thousand-node scale the failure model is: some worker stops heartbeating
(hardware loss), or degrades (persistent straggler — handled by the
closed-loop scheduler's derate path in ``repro_torch.core.scheduler``).  SPMD
training cannot proceed with a hole in the mesh, so recovery is:

    detect -> pick the largest usable worker count -> restore the latest
    checkpoint under the new mesh -> replan buckets (elastic resize)

``CheckpointCadence`` balances checkpoint cost against recomputation loss
(cadence ~ sqrt(2*ckpt_cost*MTBF) — Young/Daly) and supports *emergency*
saves when the monitor reports danger (e.g. rising straggler count).

Churn on spot/preemptible fleets adds the other half of the story:

* **Scale-up** — capacity comes *back*.  :meth:`FaultTolerantRunner.
  request_join` queues recovered/new ranks; :meth:`handle_joins` runs the
  recovery sequence in reverse at the next plan boundary: resolve a full
  run-state snapshot (drain), persist it, ``recovery_plan`` for the grown
  fleet, ``on_resize`` up.
* **Graceful preemption** — the cluster manager sends a grace notice
  (SIGTERM / flag file -> :class:`PreemptionNotice`) before reclaiming
  capacity; :meth:`handle_preemption` turns it into a full run-state save
  and a clean handoff instead of the emergency weights-only degrade.
* Checkpoint I/O retries transiently-failing writes with jittered backoff
  (``store.save(max_attempts=...)``); each retry surfaces as a run event.

The port adds :class:`RankZeroRunner` for one process a rank
(``Trainer(mesh=)``): rank 0 alone writes, every rank waits at a barrier
after each save, and a preemption notice seen by any rank drains them all.
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import threading
import time
from typing import Callable, Sequence

from repro_torch.checkpoint import store

# run_state may be the blob itself or a thunk producing it: assembling the
# blob (loader snapshot, scheduler state, RNG serialization) costs real work
# per call, and the cadence only *sometimes* saves — a thunk defers that
# work to the saves that actually happen
RunState = dict | Callable[[], dict] | None


def _resolve(run_state: RunState) -> dict | None:
    return run_state() if callable(run_state) else run_state


@dataclasses.dataclass
class CheckpointCadence:
    """Young/Daly-optimal periodic checkpointing."""

    ckpt_cost_s: float  # measured time to write one checkpoint
    mtbf_s: float  # cluster-level mean time between failures
    min_interval_steps: int = 50

    def interval_steps(self, step_time_s: float) -> int:
        opt_s = math.sqrt(2.0 * self.ckpt_cost_s * self.mtbf_s)
        return max(self.min_interval_steps, int(opt_s / max(step_time_s, 1e-6)))


@dataclasses.dataclass
class WorkerHealth:
    last_heartbeat: float
    failures: int = 0


class HeartbeatMonitor:
    """Tracks liveness; a worker silent for ``timeout_s`` is declared dead.

    Death is a *latch*: once a worker has been observed dead — by timeout
    or by ``mark_dead`` — later heartbeats are ignored (a zombie's packets,
    or a flapping NIC that comes back mid-recovery, must not resurrect a
    rank the recovery already planned around).  Only an explicit
    ``reset`` (post-resize renumbering) or ``join`` (a deliberately
    re-admitted rank) revives it.

    ``mark_dead`` force-declares a worker dead regardless of heartbeats —
    the injection point for chaos tests and for external failure signals
    (a cluster manager that *knows* a node is gone should not wait out the
    timeout)."""

    def __init__(self, n_workers: int, timeout_s: float = 60.0):
        now = time.time()
        self.workers = {w: WorkerHealth(now) for w in range(n_workers)}
        self.timeout_s = timeout_s
        self._dead: set[int] = set()

    def heartbeat(self, worker: int, t: float | None = None) -> None:
        # unknown ranks are IGNORED, not auto-registered: after an elastic
        # resize the trainer may still drain one stale wider fan-out, and
        # its heartbeats must not re-add ranks the recovery just removed
        # (they would time out later and fire a spurious second failure).
        # latched-dead ranks are ignored for the same reason: a flapping
        # rank that beats again after timing out stays dead until join()
        h = self.workers.get(worker)
        if h is None or worker in self._dead:
            return
        h.last_heartbeat = t if t is not None else time.time()

    def mark_dead(self, worker: int) -> None:
        self._dead.add(worker)
        self.workers.setdefault(worker, WorkerHealth(0.0))

    def join(self, worker: int, t: float | None = None) -> None:
        """Deliberately (re-)admit a rank: clears the dead latch and
        registers a fresh heartbeat — the only path (besides ``reset``)
        that revives a latched-dead worker."""
        self._dead.discard(worker)
        self.workers[worker] = WorkerHealth(
            t if t is not None else time.time()
        )

    def dead_workers(self, now: float | None = None) -> list[int]:
        now = now if now is not None else time.time()
        for w, h in self.workers.items():
            if now - h.last_heartbeat > self.timeout_s:
                self._dead.add(w)  # observed dead: latch it
        return sorted(w for w in self._dead if w in self.workers)

    def alive(self, now: float | None = None) -> int:
        return len(self.workers) - len(self.dead_workers(now))

    def reset(self, n_workers: int) -> None:
        """Re-arm for a recovered mesh: ranks are renumbered ``0..n-1`` by
        the elastic resize, so stale identities (and dead latches) would
        misfire against the new numbering."""
        now = time.time()
        self.workers = {w: WorkerHealth(now) for w in range(n_workers)}
        self._dead.clear()


def recovery_plan(n_alive: int, *, model_parallel: int = 16) -> dict:
    """Choose the new mesh after failures.

    Keeps the model axis intact (TP/EP degree is architectural) and shrinks
    the data axis to the largest power of two that the survivors can fill —
    partial DP groups can't run SPMD programs.
    """
    if n_alive < model_parallel:
        return {"feasible": False, "reason": "fewer survivors than one model group"}
    dp = 1 << int(math.log2(n_alive // model_parallel))
    return {
        "feasible": True,
        "data_parallel": dp,
        "model_parallel": model_parallel,
        "used_workers": dp * model_parallel,
        "spare_workers": n_alive - dp * model_parallel,
    }


class PreemptionNotice:
    """Graceful-preemption channel: the grace notice a spot/preemptible
    fleet delivers before reclaiming capacity.

    Three producers feed one consumer:

    * in-process: :meth:`notify` (chaos harness, embedding applications);
    * SIGTERM: :meth:`install_signal_handler` (what real cluster managers
      send — the handler only sets an event, safe in signal context);
    * a flag file: ops touches ``path`` on shared storage to drain a run
      that can't be signalled directly.

    The trainer polls :meth:`pending` at plan boundaries and starts the
    grace drain (finish in-flight microbatches, full run-state save, clean
    handoff) instead of dying mid-step."""

    def __init__(self, flag_file: str | None = None):
        self._event = threading.Event()
        self.flag_file = flag_file
        self.grace_s: float | None = None

    def notify(self, grace_s: float = 30.0) -> None:
        if self.grace_s is None:
            self.grace_s = float(grace_s)
        self._event.set()

    def pending(self) -> bool:
        if self._event.is_set():
            return True
        if self.flag_file is not None and os.path.exists(self.flag_file):
            self.notify()
            return True
        return False

    def clear(self) -> None:
        """Re-arm after a handled (or test-injected) notice."""
        self._event.clear()
        self.grace_s = None

    def install_signal_handler(self, signum: int = signal.SIGTERM):
        """Route ``signum`` (main thread only) into :meth:`notify`; returns
        the handler it replaced, for the caller to put back."""
        return signal.signal(signum, lambda _sig, _frm: self.notify())


@dataclasses.dataclass
class FaultTolerantRunner:
    """Orchestration shim tying the pieces together for the train loop:
    periodic saves (full run state riding the manifest), dead-worker
    detection, emergency save + elastic replan on failure, queued rank
    joins (elastic scale-up), and graceful preemption drains."""

    ckpt_dir: str
    cadence: CheckpointCadence
    monitor: HeartbeatMonitor
    on_resize: Callable[[int], None] | None = None  # new dp size
    keep: int = 3  # retention: newest K checkpoints survive
    model_parallel: int = 1  # TP/EP degree recovery must keep intact
    preemption: PreemptionNotice | None = None
    save_attempts: int = 3  # bounded retry on transient checkpoint I/O
    _last_saved_step: int = 0
    # dead sets already emergency-saved/reported: a failure that CANNOT be
    # recovered (infeasible plan, no resize hook) persists in the monitor,
    # and re-saving the full model state every subsequent step would turn
    # one failure into a per-step multi-GB write
    _handled_dead: frozenset = dataclasses.field(default=frozenset())
    _pending_joins: int = 0
    # resize boundaries must not leave a weights-only churn window: after
    # any resize (or a degraded emergency save) the next snapshotable plan
    # boundary force-writes a FULL run-state checkpoint off-cadence
    _force_full_save: bool = False
    _events: list = dataclasses.field(default_factory=list)

    def note_restored(self, step: int) -> None:
        """Tell a fresh runner the run resumed from ``step``: the cadence
        counts from there instead of writing a redundant checkpoint on the
        first post-restore step (the restored checkpoint IS step's save)."""
        self._last_saved_step = max(self._last_saved_step, step)

    def note_degraded_save(self) -> None:
        """A save just degraded to weights-only (snapshot unavailable at a
        resize drain); schedule a catch-up full save at the next boundary."""
        self._force_full_save = True

    def drain_events(self) -> list[str]:
        """Collect-and-clear I/O retry events (the trainer folds them into
        the run's event log)."""
        out, self._events = self._events, []
        return out

    def _on_io_retry(self, attempt: int, exc: Exception) -> None:
        self._events.append(f"ckpt-retry#{attempt}:{type(exc).__name__}")

    def _save(self, state, step: int, run_state: dict | None) -> None:
        store.save(
            state, step, self.ckpt_dir,
            keep=self.keep, run_state=run_state,
            max_attempts=self.save_attempts,
            on_retry=self._on_io_retry,
        )
        self._last_saved_step = step

    def maybe_checkpoint(
        self, state, step: int, step_time_s: float, *, run_state: RunState = None
    ) -> bool:
        interval = self.cadence.interval_steps(step_time_s)
        if self._force_full_save or step - self._last_saved_step >= interval:
            # a SnapshotUnavailable from the thunk propagates BEFORE any
            # state changes, so a deferred save retries next boundary
            self._save(state, step, _resolve(run_state))
            self._force_full_save = False
            return True
        return False

    def emergency_checkpoint(
        self, state, step: int, *, run_state: RunState = None
    ) -> None:
        self._save(state, step, _resolve(run_state))

    # -- elastic scale-up -----------------------------------------------------

    def request_join(self, ranks: int | Sequence[int] = 1) -> int:
        """Queue newly available (or recovered) ranks for admission at the
        next plan boundary.  Accepts a count or an iterable of rank ids —
        the resize renumbers ranks anyway, so only the count matters.
        Returns the total queued."""
        n = ranks if isinstance(ranks, int) else len(list(ranks))
        if n < 0:
            raise ValueError("cannot join a negative number of ranks")
        self._pending_joins += n
        return self._pending_joins

    def handle_joins(
        self, state, step: int, *, run_state: RunState = None
    ) -> dict | None:
        """Admit queued ranks: the recovery sequence run in reverse.

        Drain to a plan boundary (the caller sits on one; ``run_state``
        raising ``SnapshotUnavailable`` propagates so the caller retries
        next boundary), persist a full run-state snapshot, pick the
        largest usable mesh for the grown fleet, ``on_resize`` up, re-arm
        the monitor.  Because the resize flows through the same
        deterministic plan stream as a failure shrink, a kill-then-rejoin
        run replays byte-identical plans."""
        if self._pending_joins <= 0:
            return None
        n_target = self.monitor.alive() + self._pending_joins
        # resolve BEFORE saving/resizing: a snapshot failure must leave the
        # join queued and the runner untouched
        blob = _resolve(run_state)
        plan = recovery_plan(n_target, model_parallel=self.model_parallel)
        joined = self._pending_joins
        if not plan.get("feasible") or self.on_resize is None:
            self._pending_joins = 0
            return {"joined": 0, "requested": joined, "plan": plan}
        self._save(state, step, blob)
        self.on_resize(plan["data_parallel"])
        self.monitor.reset(plan["used_workers"])
        self._pending_joins = 0
        self._handled_dead = frozenset()  # fresh mesh, fresh slate
        self._force_full_save = True  # cover the post-resize window too
        return {"joined": joined, "requested": joined, "plan": plan}

    # -- graceful preemption --------------------------------------------------

    def handle_preemption(
        self, state, step: int, *, run_state: RunState = None
    ) -> dict | None:
        """Consume a pending :class:`PreemptionNotice`: the caller has
        drained in-flight microbatches to a plan boundary; persist the full
        run state (bounded-retry I/O) and report the handoff.  Returns None
        when no notice is pending."""
        p = self.preemption
        if p is None or not p.pending():
            return None
        self._save(state, step, _resolve(run_state))
        return {"step": step, "grace_s": p.grace_s}

    def check_failures(self, model_parallel: int | None = None) -> dict | None:
        """Detection + resize callback only (no checkpoint) — kept for
        callers that manage their own saves; the trainer path is
        :meth:`handle_failures`.  NOTE: ``model_parallel`` now defaults to
        the runner's ``model_parallel`` field (1 for DP-only runs), not
        the old hardcoded 16 — pass it explicitly to pin a TP/EP degree."""
        dead = self.monitor.dead_workers()
        if not dead:
            return None
        mp = model_parallel if model_parallel is not None else self.model_parallel
        plan = recovery_plan(self.monitor.alive(), model_parallel=mp)
        if plan.get("feasible") and self.on_resize is not None:
            self.on_resize(plan["data_parallel"])
            self.monitor.reset(plan["used_workers"])
        return {"dead": dead, "plan": plan}

    def handle_failures(
        self, state, step: int, *, run_state: RunState = None
    ) -> dict | None:
        """The full recovery sequence the paper's failure model demands:
        detect -> emergency-save (the survivors' state is about to be
        re-sharded; persist it first) -> pick the largest usable mesh ->
        ``on_resize`` (loader/scheduler replan) -> re-arm the monitor for
        the renumbered ranks.  Returns ``None`` when everyone is alive or
        the current dead set was already handled (an unrecoverable failure
        persists in the monitor; it must not re-trigger a full-state
        emergency save every subsequent step)."""
        dead = self.monitor.dead_workers()
        if not dead or frozenset(dead) == self._handled_dead:
            return None
        self.emergency_checkpoint(state, step, run_state=run_state)
        plan = recovery_plan(
            self.monitor.alive(), model_parallel=self.model_parallel
        )
        if plan.get("feasible") and self.on_resize is not None:
            self.on_resize(plan["data_parallel"])
            self.monitor.reset(plan["used_workers"])
            self._handled_dead = frozenset()  # fresh mesh, fresh slate
            # the emergency save above may have degraded to weights-only
            # (resize drains can't always snapshot); force a full run-state
            # save at the next snapshotable boundary either way, so no
            # churn window is covered by weights alone
            self._force_full_save = True
        else:
            self._handled_dead = frozenset(dead)
        return {"dead": dead, "plan": plan}


@dataclasses.dataclass
class RankZeroRunner(FaultTolerantRunner):
    """The runner of one process of a data-parallel group (``group``, a
    ``torch.distributed`` group; None is the default group): every process
    makes the same decisions (the trainer feeds the cadence the slowest
    process's step time), rank 0 alone writes each checkpoint and every
    rank waits at a barrier after it, so no rank runs ahead of a save it
    might restore.  A preemption notice is agreed on (one small
    ``all_reduce``), so a SIGTERM that reaches one process drains them
    all at the same plan boundary."""

    group: object = None

    def _save(self, state, step: int, run_state: dict | None) -> None:
        import torch.distributed as dist

        if dist.get_rank(self.group) == 0:
            super()._save(state, step, run_state)
        else:
            self._last_saved_step = step
        dist.barrier(group=self.group)

    def handle_preemption(self, state, step: int, *, run_state: RunState = None) -> dict | None:
        import torch
        import torch.distributed as dist

        p = self.preemption
        local = p is not None and p.pending()
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(self.group) == "nccl" else torch.device("cpu"))
        flag = torch.tensor([int(local)], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        if flag.item() and not local:
            if p is None:
                raise RuntimeError("another rank was preempted; give every rank a "
                                   "PreemptionNotice")
            p.notify()
        return super().handle_preemption(state, step, run_state=run_state)
