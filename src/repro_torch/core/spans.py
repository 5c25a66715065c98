"""Named spans of the port's host and device work, on the clock that
``torch.profiler`` stamps its events with: the port's one recorder and its
one device timer.

Tracing is off unless :func:`enable` turned it on.  Off, :func:`span` tests
one module-level flag and returns a shared context that does nothing: no
allocation, no clock read.  On, each span records

* its name, and its parent: the span open on the same thread when it
  opened (spans of the autograd engine's device thread, such as the
  recompute's, have none there);
* the thread's native id (``threading.get_native_id()``, the tid the
  profiler stamps);
* its host start and end in ``time.time_ns()``: the profiler's clock, on
  which an event's time is ``prof.profiler.kineto_results.trace_start_ns()``
  plus its offset;
* for a span given a ``device``, two :func:`clock` marks on that device's
  current stream, or the pair :meth:`Span.pair` hands it (the engine's own
  microbatch marks, so that the port has one timer, not two).

The records stay in memory until :func:`collect` resolves every device pair
with one synchronisation, returns them and clears them.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any

import torch

_on = False
_lock = threading.Lock()
_done: list[SpanRecord] = []
_ids = itertools.count()
_stacks = threading.local()


def clock(device: torch.device):
    """A mark on ``device``'s timeline: a recorded CUDA event on the card,
    the host clock elsewhere (where the work is synchronous)."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def seconds(start, end) -> float:
    """Seconds between two :func:`clock` marks (waits for a CUDA event)."""
    if isinstance(end, torch.cuda.Event):
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return end - start


@dataclasses.dataclass
class SpanRecord:
    """One finished span.  ``device_s`` is the seconds between its device
    marks (``None`` for a span timed on the host alone), resolved by
    :func:`collect`."""

    name: str
    id: int
    parent: int | None
    tid: int
    start_ns: int
    end_ns: int
    device_s: float | None = None
    marks: Any = dataclasses.field(default=None, repr=False)

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def seconds(self) -> float:
        """The device's seconds where the span has marks, else the host's."""
        return self.host_s if self.device_s is None else self.device_s


class _Off:
    """The context :func:`span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def pair(self, start, end) -> None:
        pass


OFF = _Off()


class Span:
    """A span being recorded (see the module's docstring)."""

    __slots__ = ("name", "device", "marks", "id", "parent", "tid", "start_ns")

    def __init__(self, name: str, device: torch.device | None):
        self.name, self.device, self.marks = name, device, None

    def __enter__(self):
        stack = _stacks.__dict__.setdefault("stack", [])
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        self.tid = threading.get_native_id()
        stack.append(self)
        self.start_ns = time.time_ns()
        if self.device is not None:
            self.marks = (clock(self.device), None)
        return self

    def pair(self, start, end) -> None:
        """Time the span's device work by two :func:`clock` marks that the
        caller took inside it."""
        self.device, self.marks = None, (start, end)

    def __exit__(self, *exc) -> bool:
        if self.device is not None:
            self.marks = (self.marks[0], clock(self.device))
        end_ns = time.time_ns()
        _stacks.stack.pop()
        rec = SpanRecord(self.name, self.id, self.parent, self.tid, self.start_ns, end_ns,
                         marks=self.marks)
        with _lock:
            _done.append(rec)
        return False


def span(name: str, device: torch.device | None = None):
    """A context that records a span named ``name`` while tracing is on
    (device-timed where ``device`` is given), and :data:`OFF` otherwise."""
    if not _on:
        return OFF
    return Span(name, device)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def collect() -> list[SpanRecord]:
    """Every span finished since the last call, in the order they ended,
    with their device seconds resolved (one synchronisation for all)."""
    global _done
    with _lock:
        out, _done = _done, []
    if any(isinstance(r.marks[1], torch.cuda.Event) for r in out if r.marks):
        torch.cuda.synchronize()
    for r in out:
        if r.marks:
            r.device_s, r.marks = seconds(*r.marks), None
    return out


__all__ = ["OFF", "Span", "SpanRecord", "clock", "collect", "disable", "enable", "enabled",
           "seconds", "span"]
