"""Sequence packing, the LM side of shape heterogeneity: a copy of
``repro.data.packing`` (framework-free numpy) for what packed training and
the sequence-parallel split need.

Documents are packed first-fit-decreasing into fixed windows by token
count (the reference's load-budget packing comes with the planner).
Every window records its per-document lengths, from which
``window_segment_ids`` / ``segment_id_batch`` make the int32 segment-id
rows the segment-aware attention kernels read (``-1`` marks window
padding).  ``split_packed_batch`` cuts one packed batch into ``k``
contiguous sequence shards, each carrying the whole window's
document-relative positions.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

PAD_SEGMENT_ID = -1


@dataclasses.dataclass(frozen=True)
class PackedWindow:
    doc_ids: tuple[int, ...]
    tokens: int
    lengths: tuple[int, ...] = ()  # per-document token counts, doc_ids order


def pack_documents(lengths: Sequence[int], *, window: int) -> list[PackedWindow]:
    """First-fit-decreasing packing by token count."""
    order = np.argsort(-np.asarray(lengths))
    windows: list[dict] = []
    for i in order:
        n = int(lengths[i])
        if n > window:
            raise ValueError(
                f"document {i} has {n} tokens > window {window}; chunk or "
                f"drop oversize documents upstream (packing would silently "
                f"truncate its segment-id row)"
            )
        for w in windows:
            if w["tokens"] + n <= window:
                w["ids"].append(int(i))
                w["lens"].append(n)
                w["tokens"] += n
                break
        else:
            windows.append({"ids": [int(i)], "lens": [n], "tokens": n})
    return [PackedWindow(tuple(w["ids"]), w["tokens"], tuple(w["lens"])) for w in windows]


@dataclasses.dataclass(frozen=True)
class PackedBucket:
    """A group of packed windows as one microbatch, with a bucket's
    surface (``batch_size``/``seq_len``/``tokens``)."""

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


def window_segment_ids(w: PackedWindow, window: int) -> np.ndarray:
    """``[window]`` int32 segment ids for one packed window: document j (in
    ``doc_ids`` order) occupies the next ``lengths[j]`` slots with id j;
    trailing padding gets ``PAD_SEGMENT_ID``."""
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
    """``[B, S]`` int32 positions within each run of equal segment ids (the
    numpy twin of ``models.layers.segment_relative_positions``), for the
    loader side: a split batch must carry positions computed on the WHOLE
    window, so RoPE does not restart at a shard boundary."""
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
    ``s`` also carries ``positions``, the whole window's segment-relative
    positions sliced, so the sequence-parallel loss sees globally
    consistent RoPE phases.  Shard ``s`` goes to ring rank ``s``."""
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
