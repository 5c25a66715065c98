"""Deterministic chaos injection of the port: replayable fleet-churn
schedules (a copy of ``repro.distributed.chaos``).

Every failure mode the fault-tolerance stack claims to survive — silent
rank death, ranks rejoining, graceful preemption, degraded hardware — is
injected here as *data*, not as hand-run kill commands: a
:class:`ChaosSchedule` is an explicit (or seed-derived) list of
:class:`ChaosEvent` fired at plan boundaries through the same
heartbeat/telemetry hooks a real cluster manager would drive.

Determinism is the point.  The run is already a pure function of
``(seed, step)`` (deterministic plan streams); making the *faults* a
pure function of ``(chaos seed, step)`` too means a churn run is exactly
replayable — the churn-parity CI job compares its consumed plan-digest log
byte-for-byte against an uninterrupted reference, something no flaky
sleep-and-SIGKILL harness can do.

Event kinds (applied after the completed optimizer step ``step``):

* ``kill``     — ``monitor.mark_dead(rank)`` for each rank; the runner's
  failure path shrinks the fleet at this boundary.
* ``join``     — ``runner.request_join(n)``; the scale-up path admits the
  ranks at this boundary.
* ``preempt``  — ``preemption.notify(grace_s)``; the trainer drains and
  hands off.
* ``slowdown`` — ``engine.set_time_scale(rank, factor)``; telemetry shows
  a degraded device and the scheduler's straggler/capacity path reacts.

Spec grammar (``ChaosSchedule.from_spec``), events separated by ``;``::

    kill@4:2,3        ranks 2 and 3 die after step 4
    join@8:2          2 ranks join after step 8
    preempt@12        graceful preemption after step 12 (default grace)
    preempt@12:5      ... with a 5 s grace period
    slowdown@6:1x2.5  rank 1 runs 2.5x slower from step 6 on
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.distributed.fault_tolerance import (
    FaultTolerantRunner,
    HeartbeatMonitor,
    PreemptionNotice,
)

EVENT_KINDS = ("kill", "join", "preempt", "slowdown")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One injected fault, bound to the plan boundary after ``step``."""

    step: int
    kind: str
    ranks: tuple[int, ...] = ()  # kill/slowdown targets; join count = len
    factor: float = 1.0  # slowdown multiplier on recorded compute time
    grace_s: float = 30.0  # preemption grace period

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown chaos event kind {self.kind!r}; expected one of "
                f"{EVENT_KINDS}"
            )
        if self.step < 0:
            raise ValueError("chaos events fire after a completed step >= 0")
        if self.kind in ("kill", "slowdown") and not self.ranks:
            raise ValueError(f"{self.kind} event needs target ranks")
        if self.kind == "slowdown" and self.factor <= 0:
            raise ValueError("slowdown factor must be positive")

    def describe(self) -> str:
        if self.kind == "kill":
            return f"kill:{','.join(map(str, self.ranks))}"
        if self.kind == "join":
            return f"join:{len(self.ranks) or 1}"
        if self.kind == "preempt":
            return f"preempt:grace={self.grace_s:g}s"
        return (
            f"slowdown:{','.join(map(str, self.ranks))}x{self.factor:g}"
        )


@dataclasses.dataclass
class ChaosContext:
    """The injection surface one trainer step exposes to the schedule."""

    monitor: HeartbeatMonitor | None = None
    runner: FaultTolerantRunner | None = None
    engine: object | None = None  # needs set_time_scale(rank, factor)
    preemption: PreemptionNotice | None = None


class ChaosSchedule:
    """An ordered, replayable set of fault events keyed by step.

    ``fire(step, ctx)`` applies every event bound to ``step`` through the
    context's hooks and returns human-readable descriptions for the run's
    event log.  Events whose hook is absent from the context are reported
    as skipped rather than silently dropped — a chaos run that quietly
    injected nothing would pass every parity check and prove nothing.
    """

    def __init__(self, events: Sequence[ChaosEvent]):
        self.events = tuple(sorted(events, key=lambda e: (e.step, e.kind)))
        self._by_step: dict[int, list[ChaosEvent]] = {}
        for e in self.events:
            self._by_step.setdefault(e.step, []).append(e)

    @classmethod
    def from_spec(cls, spec: str) -> "ChaosSchedule":
        """Parse the compact CLI grammar (see module docstring)."""
        events = []
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            try:
                head, _, arg = raw.partition(":")
                kind, at = head.split("@")
                kind = kind.strip()
                step = int(at)
                if kind == "kill":
                    ranks = tuple(int(r) for r in arg.split(","))
                    events.append(ChaosEvent(step, "kill", ranks=ranks))
                elif kind == "join":
                    n = int(arg) if arg else 1
                    events.append(
                        ChaosEvent(step, "join", ranks=tuple(range(n)))
                    )
                elif kind == "preempt":
                    grace = float(arg) if arg else 30.0
                    events.append(
                        ChaosEvent(step, "preempt", grace_s=grace)
                    )
                elif kind == "slowdown":
                    ranks_part, _, factor_part = arg.partition("x")
                    ranks = tuple(int(r) for r in ranks_part.split(","))
                    factor = float(factor_part) if factor_part else 2.0
                    events.append(
                        ChaosEvent(
                            step, "slowdown", ranks=ranks, factor=factor
                        )
                    )
                else:
                    raise ValueError(f"unknown event kind {kind!r}")
            except (ValueError, IndexError) as exc:
                raise ValueError(
                    f"bad chaos event {raw!r} (grammar: kill@S:r1,r2 | "
                    f"join@S:n | preempt@S[:grace] | slowdown@S:r1,r2[xF])"
                ) from exc
        if not events:
            # a chaos run that quietly injects nothing passes every parity
            # check and proves nothing — an empty spec is a config mistake
            raise ValueError(f"chaos spec {spec!r} contains no events")
        return cls(events)

    @classmethod
    def seeded(
        cls,
        seed: int,
        *,
        n_steps: int,
        n_workers: int,
        n_events: int = 4,
        kinds: Sequence[str] = EVENT_KINDS,
    ) -> "ChaosSchedule":
        """Derive a schedule from a seed: same seed, same faults, every
        run — the fuzzing analogue of the deterministic plan stream.
        Events land on distinct steps in ``[1, n_steps)`` (step 0 is
        excluded so every run completes at least one clean step)."""
        if n_steps < 2:
            raise ValueError("need n_steps >= 2 to place chaos events")
        for k in kinds:
            if k not in EVENT_KINDS:
                raise ValueError(f"unknown chaos event kind {k!r}")
        rng = np.random.default_rng(seed)
        n_events = min(n_events, n_steps - 1)
        steps = sorted(
            int(s) + 1
            for s in rng.choice(n_steps - 1, size=n_events, replace=False)
        )
        events = []
        for step in steps:
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == "kill":
                # never kill rank 0 (the controller) and never the whole
                # fleet: leave at least one survivor to recover on
                n_kill = int(rng.integers(1, max(2, n_workers - 1)))
                ranks = tuple(
                    sorted(
                        int(r) + 1
                        for r in rng.choice(
                            n_workers - 1, size=n_kill, replace=False
                        )
                    )
                )
                events.append(ChaosEvent(step, "kill", ranks=ranks))
            elif kind == "join":
                n = int(rng.integers(1, n_workers + 1))
                events.append(
                    ChaosEvent(step, "join", ranks=tuple(range(n)))
                )
            elif kind == "preempt":
                events.append(
                    ChaosEvent(
                        step, "preempt",
                        grace_s=float(rng.uniform(5.0, 60.0)),
                    )
                )
            else:
                rank = int(rng.integers(n_workers))
                events.append(
                    ChaosEvent(
                        step, "slowdown", ranks=(rank,),
                        factor=float(rng.uniform(1.5, 4.0)),
                    )
                )
        return cls(events)

    def events_at(self, step: int) -> list[ChaosEvent]:
        return list(self._by_step.get(step, []))

    @property
    def last_step(self) -> int:
        return max((e.step for e in self.events), default=-1)

    def fire(self, step: int, ctx: ChaosContext) -> list[str]:
        """Apply every event bound to ``step``; returns log descriptions."""
        msgs = []
        for ev in self.events_at(step):
            applied = self._apply(ev, ctx)
            tag = "chaos" if applied else "chaos-skipped"
            msgs.append(f"{tag}:{ev.describe()}")
        return msgs

    @staticmethod
    def _apply(ev: ChaosEvent, ctx: ChaosContext) -> bool:
        if ev.kind == "kill":
            if ctx.monitor is None:
                return False
            for r in ev.ranks:
                ctx.monitor.mark_dead(r)
            return True
        if ev.kind == "join":
            if ctx.runner is None:
                return False
            ctx.runner.request_join(len(ev.ranks) or 1)
            return True
        if ev.kind == "preempt":
            if ctx.preemption is None:
                return False
            ctx.preemption.notify(ev.grace_s)
            return True
        set_scale = getattr(ctx.engine, "set_time_scale", None)
        if set_scale is None:
            return False
        for r in ev.ranks:
            set_scale(r, ev.factor)
        return True


__all__ = [
    "EVENT_KINDS",
    "ChaosContext",
    "ChaosEvent",
    "ChaosSchedule",
]
