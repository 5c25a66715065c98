"""Reduction of a ``torch.profiler`` trace of whole training steps to what
the per-layer metrics read: device kernels by family and name, the
device's busy time inside the traced window, and its idle gaps labelled by
the harness's span they fall in.

The profiler records the device alone (CUDA activity): recording every
host op as well slowed the traced steps by about a tenth, which read as
idle device time.  So the window is the host clock's wall time of the
traced steps, from the first launch to the final synchronisation, and a
gap is labelled by the annotation that the harness's ``record_function``
spans leave on the device timeline (the stretch from the first to the
last kernel launched inside the span); the wall time outside the first
and last kernel is one more gap, ``"edges"``.

``FAMILIES`` is a copy of ``repro_torch.launch.profile_serve.FAMILIES``
(the categorisation ``profile_train`` reports), kept here so that the
benchmark's yardstick does not move with the program.
"""

from __future__ import annotations

import dataclasses

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("K7 flash_fwd", ("flash_fwd_",)),
    ("K8 flash_bwd_dq", ("flash_bwd_dq_",)),
    ("K9 flash_bwd_dkv", ("flash_bwd_dkv_",)),
    ("K11 ring_merge", ("merge_kernel",)),
    ("K11 ring_finalize", ("finalize_kernel",)),
    ("K1 adaln_fwd", ("adaln_fwd_kernel",)),
    ("K2 adaln_bwd_dx", ("adaln_bwd_dx_kernel",)),
    ("K10 adaln_bwd_dmod_naive", ("adaln_bwd_dmod_naive_kernel",)),
    ("K3 adaln_bwd_dmod", ("adaln_bwd_dmod_",)),
    ("K4 qk_rms_fwd", ("qk_rms_fwd_kernel",)),
    ("K13 gated_rms_fwd", ("gated_rms_fwd_kernel",)),
    ("K4 rms_fwd (rows)", ("rms_fwd_kernel",)),
    ("K12 paged_decode", ("paged_decode_",)),
    ("K5 qk_rms_bwd_dx", ("qk_rms_bwd_dx_kernel",)),
    ("K6 qk_rms_bwd_dw", ("qk_rms_bwd_dw_",)),
    ("K5 rms_bwd_dx (rows)", ("rms_bwd_dx_kernel",)),
    ("K6 rms_bwd_dw (rows)", ("rms_bwd_dw_",)),
    ("matmul f32 (cuBLAS)", ("sgemm", "f32f32_f32f32", "gemm_f32")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")),
    ("copy", ("memcpy", "memset", "copy")),
    ("elementwise / reduce", ("elementwise", "reduce", "vectorized", "cat", "index")),
)
SPANS = ("warmup", "loader.next", "trainer.step")  # the harness's own host spans
WINDOW_SPAN = "profile.window"


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


@dataclasses.dataclass
class Trace:
    """The device kernels ``(name, start_us, end_us)`` of the traced steps,
    the harness's spans on the device timeline ``(name, start_us,
    end_us)``, and the steps' wall time on the host clock."""

    kernels: list
    spans: list
    window_s: float

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for a, b in sorted((a, b) for _, a, b in self.kernels):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def seconds_by(self, key) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, a, b in self.kernels:
            k = key(name)
            out[k] = out.get(k, 0.0) + (b - a) / 1e6
        return out

    def gaps(self) -> list[tuple[str, float]]:
        """Every idle stretch between the first and the last kernel,
        ``(label, seconds)``, labelled by the innermost harness span it
        falls in (``"between spans"`` if none), and the rest of the wall
        time as ``"edges"``."""
        busy = self.busy_intervals()
        out = []
        for (_, a), (b, _) in zip(busy, busy[1:]):
            inside = [(s1 - s0, n) for n, s0, s1 in self.spans if s0 <= a and b <= s1]
            out.append((min(inside)[1] if inside else "between spans", (b - a) / 1e6))
        if busy:
            out.append(("edges", self.window_s - (busy[-1][1] - busy[0][0]) / 1e6))
        return out


def from_profiler(prof, window_s: float) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile`` of the
    device over ``window_s`` seconds of wall time."""
    import torch

    kernels, spans = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        row = (e.name, e.time_range.start, e.time_range.end)
        if e.name in (*SPANS, WINDOW_SPAN) or getattr(e, "is_user_annotation", False):
            spans.append(row)
        else:
            kernels.append(row)
    return Trace(kernels, spans, window_s)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The ``breakdown`` of a result line: the device operations with the
    most time (``"<family> | <kernel name>"``) and the longest idle gaps by
    what the host was doing."""
    by_name = tr.seconds_by(lambda n: f"{family(n)} | {n[:100]}")
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(tr.gaps(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
