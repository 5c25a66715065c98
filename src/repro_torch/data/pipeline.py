"""Bucketed data pipeline: the paper's Fig. 2 dataloader, the counterpart
of ``repro.data.pipeline.BucketedLoader`` (a copy: the loader is
framework-free; ``make_batch`` decides where batches live), and the packed
LM microbatches of ``materialize_packed_windows`` / ``make_packed_batch``
(numpy arrays, as the reference's; :func:`to_device` moves them).

``BucketedLoader`` drives ONE data-parallel worker's stream:

  shape corpus -> bucket draw -> (B_shape, S) microbatch -> accumulate to the
  step budget (tokens for the baseline, fitted B*S^p load for AdaptiveLoad)

A background prefetch thread keeps ``prefetch`` steps of synthetic batches
ready so device steps never wait on the host; ``close()`` stops it.  The
closed-loop scheduler's plan updates come with its own slice; the global
step planner and ``ShardedBucketedLoader`` with the multi-rank slice.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.bucketing import Bucket
from repro_torch.core.dispatch import normalized_weights
from repro_torch.data.packing import PackedBucket, PackedWindow, pack_documents, segment_id_batch


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

    # -- producer -------------------------------------------------------------

    def _draw_step(self) -> list[tuple[Bucket, dict]]:
        out = []
        acc = 0.0
        while acc < self.budget:
            b = self._buckets[int(self._rng.choice(len(self._buckets), p=self._probs))]
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
    vocab: int = 32_000,
    batch_windows: int = 1,
    seed: int = 0,
) -> list[dict]:
    """Pack documents by token count and materialize packed microbatches of
    ``batch_windows`` windows each:

    * ``tokens`` / ``labels`` — ``[Bw, window]`` int32 synthetic streams
      (label 0 at padding, at each document's last token and at the
      window's last slot: the loss has no ignore-index),
    * ``segment_ids`` — ``[Bw, window]`` int32 (document j -> j, padding
      -> -1), and
    * ``windows`` — the ``PackedWindow`` records.
    """
    windows = pack_documents(lengths, window=window)
    rng = np.random.default_rng(seed)
    out: list[dict] = []
    for i in range(0, len(windows), batch_windows):
        group: list[PackedWindow] = windows[i : i + batch_windows]
        out.append({**_packed_arrays(rng, group, window, vocab), "windows": group})
    return out


def _packed_arrays(rng: np.random.Generator, group: Sequence[PackedWindow], window: int,
                   vocab: int) -> dict:
    """Model-ready arrays for one group of packed windows: padding slots
    and document-final positions carry label 0 (boundary and padding
    targets neutralized to a constant class, never the next document's
    first token)."""
    seg = segment_id_batch(group, window)
    tokens = rng.integers(1, vocab, size=seg.shape, dtype=np.int64)
    tokens[seg < 0] = 0
    labels = np.roll(tokens, -1, axis=1)
    labels[seg < 0] = 0
    labels[:, -1] = 0
    labels[:, :-1][seg[:, :-1] != seg[:, 1:]] = 0
    return {
        "tokens": tokens.astype(np.int32),
        "labels": labels.astype(np.int32),
        "segment_ids": seg,
    }


def make_packed_batch(rng: np.random.Generator, bucket: PackedBucket, *,
                      vocab: int = 32_000) -> dict:
    """``make_batch`` of ``PackedBucket`` microbatches: the arrays only
    (``tokens``/``labels``/``segment_ids``)."""
    return _packed_arrays(rng, bucket.windows, bucket.window, vocab)


def to_device(batch: dict, device) -> dict:
    """The numpy arrays of a batch as tensors on ``device`` (other entries,
    such as ``windows``, are dropped)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}
