"""Sequence packing: the LM-side shape-heterogeneity lever, the port's copy
of ``repro.data.packing`` (framework-free numpy).

For LM training the bucket unit is a *document*; the equal-token baseline
packs documents into fixed windows by token count alone, while the
AdaptiveLoad policy packs to a fitted ``sum(len^p)`` budget, which is the
exact analogue of Eq. 2 at document granularity.

Every window records its per-document lengths, and ``window_segment_ids`` /
``segment_id_batch`` materialize the int32 segment-id arrays the
segment-aware attention kernel consumes (``-1`` marks window padding) — so
a packed window trains without cross-document contamination and its
attention cost follows the per-segment load Σ len_i^p that
``core.cost_model.packed_load`` scores.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.cost_model import packed_load

PAD_SEGMENT_ID = -1


@dataclasses.dataclass(frozen=True)
class PackedWindow:
    doc_ids: tuple[int, ...]
    tokens: int
    load: float  # sum(len^p)
    lengths: tuple[int, ...] = ()  # per-document token counts, doc_ids order


def pack_documents(
    lengths: Sequence[int],
    *,
    window: int,
    p: float | None = None,
    load_budget: float | None = None,
) -> list[PackedWindow]:
    """First-fit-decreasing packing.

    With ``p``/``load_budget`` set, a window closes when either the token
    window or the load budget is exhausted (dual constraint); otherwise
    token-only (baseline).
    """
    order = np.argsort(-np.asarray(lengths))
    windows: list[dict] = []
    for i in order:
        n = int(lengths[i])
        if n > window:
            raise ValueError(
                f"document {i} has {n} tokens > window {window}; chunk or "
                f"drop oversize documents upstream (packing would silently "
                f"truncate its segment-id row while load scored {n}^p)"
            )
        ld = packed_load((n,), p) if p is not None else 0.0
        placed = False
        for w in windows:
            if w["tokens"] + n > window:
                continue
            if load_budget is not None and w["load"] + ld > load_budget:
                continue
            w["ids"].append(int(i))
            w["lens"].append(n)
            w["tokens"] += n
            w["load"] += ld
            placed = True
            break
        if not placed:
            windows.append({"ids": [int(i)], "lens": [n], "tokens": n, "load": ld})
    return [
        PackedWindow(tuple(w["ids"]), w["tokens"], w["load"], tuple(w["lens"]))
        for w in windows
    ]


@dataclasses.dataclass(frozen=True)
class PackedBucket:
    """A group of packed windows as a first-class dispatch unit.

    The ``StepPlanner`` pools and packs *microbatches*; for LM training a
    microbatch is ``batch_windows`` packed windows of one window length.
    ``PackedBucket`` gives that unit the same duck-typed surface as
    ``core.bucketing.Bucket`` (``batch_size``/``seq_len``/``tokens``/
    ``load``), so the planner, loaders, trainer, and mesh executor dispatch
    packed variable-length work with zero special-casing — while its load
    follows the *per-segment* Σ len_i^p that the segment-aware attention
    kernel actually executes (``CostModel.predict_packed``), not the padded
    (B, S) rectangle.
    """

    windows: tuple[PackedWindow, ...]
    window: int  # token slots per window (the padded sequence length)

    def __post_init__(self) -> None:
        if not self.windows:
            raise ValueError("PackedBucket needs >= 1 window")

    @property
    def batch_size(self) -> int:
        return len(self.windows)

    @property
    def seq_len(self) -> int:
        return self.window

    @property
    def tokens(self) -> int:
        """Real (non-padding) tokens in the microbatch."""
        return sum(w.tokens for w in self.windows)

    @property
    def lengths(self) -> tuple[int, ...]:
        """Every document length in the microbatch (all windows, in order)."""
        return tuple(n for w in self.windows for n in w.lengths)

    def load(self, p: float) -> float:
        """Per-segment load Σ len_i^p — the packed analogue of B*S^p."""
        return packed_load(self.lengths, p)

    def digest_key(self) -> tuple:
        """Canonical identity for cross-host plan agreement hashing.

        Per-window length tuples, NOT the flattened concatenation: two
        packings of the same documents into different window partitions
        have different batch shapes/segment layouts and must hash
        differently, or plan agreement would wave through a mismatched
        collective."""
        return ("packed", self.window, tuple(w.lengths for w in self.windows))


def packed_bucket_pool(
    lengths: Sequence[int],
    *,
    window: int,
    batch_windows: int = 1,
    p: float | None = None,
    load_budget: float | None = None,
) -> list[PackedBucket]:
    """Pack a document-length corpus into planner-ready ``PackedBucket``s.

    ``pack_documents`` builds the windows (dual-constraint when ``p``/
    ``load_budget`` are set); consecutive windows are then grouped
    ``batch_windows`` at a time into microbatch units."""
    windows = pack_documents(lengths, window=window, p=p, load_budget=load_budget)
    return [
        PackedBucket(tuple(windows[i : i + batch_windows]), window)
        for i in range(0, len(windows), batch_windows)
    ]


def window_segment_ids(w: PackedWindow, window: int) -> np.ndarray:
    """``[window]`` int32 segment ids for one packed window.

    Document j (in ``doc_ids`` order) occupies the next ``lengths[j]`` slots
    with id j; trailing padding gets ``PAD_SEGMENT_ID`` so the kernel masks
    it (padding attends only padding).
    """
    ids = np.full((window,), PAD_SEGMENT_ID, np.int32)
    off = 0
    for j, n in enumerate(w.lengths):
        ids[off : off + n] = j
        off += n
    return ids


def segment_id_batch(windows: Sequence[PackedWindow], window: int) -> np.ndarray:
    """``[n_windows, window]`` int32 segment ids, one row per window."""
    return np.stack([window_segment_ids(w, window) for w in windows])


def segment_relative_positions_np(segment_ids: np.ndarray) -> np.ndarray:
    """``[B, S]`` within-segment positions — numpy twin of
    ``models.attention.segment_relative_positions`` (same formula, same
    int32 output), for the loader side: a split packed batch must carry
    positions computed on the WHOLE window so RoPE does not restart at a
    shard boundary, and the loader slices before anything touches torch."""
    seg = np.asarray(segment_ids)
    b, s = seg.shape
    idx = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    boundary = np.concatenate(
        [np.ones((b, 1), dtype=bool), seg[:, 1:] != seg[:, :-1]], axis=1
    )
    run_start = np.maximum.accumulate(np.where(boundary, idx, 0), axis=1)
    return (idx - run_start).astype(np.int32)


def split_packed_batch(batch: dict, k: int) -> list[dict]:
    """Slice one packed LM batch into ``k`` contiguous sequence shards.

    Every ``[B, S]`` array is cut into equal ``[B, S/k]`` chunks; shard
    ``s`` additionally carries ``positions`` — the whole window's
    segment-relative positions, sliced — so the sequence-parallel loss
    sees globally consistent RoPE phases.  The materialization partner of
    ``core.dispatch.SplitShard``: call once per split group and hand shard
    ``s`` to rank ``r0 + s``."""
    if k < 2:
        raise ValueError(f"split fan-out k must be >= 2, got {k}")
    seq = int(np.asarray(batch["tokens"]).shape[1])
    if seq % k:
        raise ValueError(f"sequence length {seq} is not divisible by k={k}")
    full = dict(batch)
    if "positions" not in full:
        full["positions"] = segment_relative_positions_np(full["segment_ids"])
    w = seq // k
    return [
        {name: np.asarray(v)[:, s * w : (s + 1) * w] for name, v in full.items()}
        for s in range(k)
    ]


def packing_efficiency(windows: Sequence[PackedWindow], window: int) -> float:
    if not windows:
        return 0.0
    return sum(w.tokens for w in windows) / (len(windows) * window)


def load_cv(windows: Sequence[PackedWindow]) -> float:
    loads = np.array([w.load for w in windows])
    return float(loads.std() / loads.mean()) if loads.mean() > 0 else 0.0
