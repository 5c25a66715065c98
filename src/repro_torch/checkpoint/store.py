"""Checkpoint store of the port: npz leaves + JSON manifest, atomic swap.

A copy of ``repro.checkpoint.store`` that writes the same manifest v2, so
either package restores the other's checkpoints:

* every leaf is saved as its own entry keyed by its flattened JAX tree
  path; the manifest records paths, shapes, dtypes and the training step.
  The port's train state ``{"model", "opt": {"m", "v"}, "step"}`` is
  written as the JAX package's ``{"params", "opt": {"m", "v"}, "step"}``:
  the converter's layout (``convert.to_numpy`` with its dtype kept, and
  ``convert.jax_keys`` for the restore: the MMDiT's blocks stacked, the
  LM's ``lead/<i>``, ``blocks/s<i>`` and ``tail/<i>``), taken from the
  model's own ``cfg``, and ``step`` as a 0-d int32 leaf.  A plain
  nested dict (or list) of tensors, arrays and numbers is keyed by its own
  path, as the reference keys any pytree;
* bf16 leaves are stored as ``uint16_bits`` with dtype ``"bfloat16"``
  (npz has no bf16), and come back bit-exact through ``torch.int16``;
* the manifest optionally carries a ``run_state`` JSON blob: the run's
  *non-weight* replayable state (planner RNG streams, trainer RNG key), so
  a resumed job replays the identical plan stream, not just the weights.
  Weights-only checkpoints restore unchanged; ``load_run_state`` returns
  ``None`` for them;
* writes go to ``<dir>/tmp-<step>`` then ``os.replace`` to ``step-<n>``:
  a crash mid-write never corrupts the latest valid checkpoint.  Stale
  ``tmp-*`` directories a crash left behind are swept by the next
  ``save``/``latest_step``, age-gated so a live concurrent write is never
  mistaken for debris;
* restore writes each stored value into ``like``'s tensor on ``like``'s
  device: the restoring job's placement decides, whatever the saving job
  ran on;
* retention keeps the newest K checkpoints;
* transient I/O failures are retried with bounded jittered exponential
  backoff (the tmp-write + swap is an idempotent unit), each retry
  reported through ``on_retry``; ``FileNotFoundError`` is never retried.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.convert import BF16_BITS, jax_keys, to_numpy, to_numpy_leaf

MANIFEST_VERSION = 2

#: default bounded-retry budget for save/restore I/O (1 = no retries)
DEFAULT_MAX_ATTEMPTS = 3

#: a tmp-* directory younger than this is treated as a LIVE write, not
#: crash debris: sweeping it would delete a concurrent writer's in-flight
#: checkpoint between its mkdir and os.replace
TMP_SWEEP_MIN_AGE_S = 3600.0


def _with_retries(
    fn: Callable[[], Any],
    *,
    max_attempts: int,
    backoff_s: float,
    on_retry: Callable[[int, Exception], None] | None,
) -> Any:
    """Run an idempotent I/O closure, retrying transient ``OSError``
    (``PermissionError`` included) with jittered exponential backoff."""
    if max_attempts < 1:
        raise ValueError("max_attempts must be >= 1")
    for attempt in range(1, max_attempts + 1):
        try:
            return fn()
        except FileNotFoundError:
            raise  # a missing checkpoint is a real answer, not a flake
        except OSError as exc:
            if attempt >= max_attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            # full jitter keeps a fleet of retrying writers decorrelated
            delay = backoff_s * (2 ** (attempt - 1)) * (0.5 + random.random())
            time.sleep(delay)


# -- leaves ------------------------------------------------------------------------


def _is_train_state(tree) -> bool:
    if not (isinstance(tree, dict) and isinstance(tree.get("model"), torch.nn.Module)):
        return False
    if set(tree) != {"model", "opt", "step"}:
        raise ValueError(f"a train state holds model, opt and step, not {sorted(tree)}")
    return True


def _host_tree(state):
    """``state`` as the tree the checkpoint holds: the train state as the
    JAX package's ``{"params", "opt", "step"}`` of host arrays (bf16 kept,
    as ``BF16_BITS``), any other tree as it is."""
    if not _is_train_state(state):
        return state
    cfg = state["model"].cfg
    return {"params": to_numpy(dict(state["model"].named_parameters()), cfg, keep_dtype=True),
            "opt": {k: to_numpy(state["opt"][k], cfg, keep_dtype=True) for k in ("m", "v")},
            "step": np.asarray(int(state["step"]), np.int32)}  # a 0-d int32 leaf


def _slots(tree) -> dict[str, list[tuple[int | None, Any]]]:
    """Each leaf key of ``tree`` with the objects that hold its value: one
    ``(None, leaf)``, or ``(index, tensor)`` for each entry of a stacked
    JAX leaf (the port keeps one tensor a layer)."""
    if not _is_train_state(tree):
        return {key: [(None, leaf)] for key, leaf in _flatten_plain(tree, "")}
    model = tree["model"]
    slots: dict = {"step": [(None, tree["step"])]}
    for prefix, tensors in (("params", dict(model.named_parameters())),
                            ("opt/m", tree["opt"]["m"]), ("opt/v", tree["opt"]["v"])):
        for name, (key, idx) in jax_keys(tensors, model.cfg).items():
            slots.setdefault(f"{prefix}/{key}", []).append((idx, tensors[name]))
    return slots


def _flatten_plain(tree, prefix: str):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten_plain(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_plain(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _shape(parts) -> tuple[int, ...]:
    idx, leaf = parts[0]
    shape = tuple(np.shape(leaf)) if not isinstance(leaf, torch.Tensor) else tuple(leaf.shape)
    return shape if idx is None else (len(parts),) + shape




# -- save ----------------------------------------------------------------------------


def _sweep_tmp(d: Path, *, skip: Path | None = None) -> None:
    """Remove partial ``tmp-*`` writes a crashed job left behind.

    Age-gated: only directories untouched for ``TMP_SWEEP_MIN_AGE_S`` are
    removed, so a reader (``latest_step``) or a second writer sharing the
    directory can never destroy an in-flight save."""
    now = time.time()
    for p in d.glob("tmp-*"):
        if not p.is_dir() or p == skip:
            continue
        try:
            age = now - p.stat().st_mtime
        except OSError:
            continue  # vanished underneath us: another sweeper won
        if age >= TMP_SWEEP_MIN_AGE_S:
            shutil.rmtree(p, ignore_errors=True)


def save(
    state,
    step: int,
    directory: str | os.PathLike,
    *,
    keep: int = 3,
    run_state: dict | None = None,
    max_attempts: int = DEFAULT_MAX_ATTEMPTS,
    backoff_s: float = 0.05,
    on_retry: Callable[[int, Exception], None] | None = None,
) -> Path:
    """Write one checkpoint; ``run_state`` (JSON-serializable) rides in the
    manifest so weights and replayable run state commit atomically.

    The tmp-write + atomic-rename sequence retries up to ``max_attempts``
    times on transient ``OSError``/``PermissionError`` (jittered
    exponential backoff from ``backoff_s``); ``on_retry(attempt, exc)``
    fires once per retry."""
    d = Path(directory)
    # the copy to the host is NOT retried: it is not I/O, and a device
    # error should surface immediately
    flat = dict(_flatten_plain(_host_tree(state), ""))
    manifest = {"version": MANIFEST_VERSION, "step": int(step), "leaves": {}}
    if run_state is not None:
        manifest["run_state"] = run_state
    arrays = {}
    for i, key in enumerate(sorted(flat)):
        leaf = flat[key]
        arr = (to_numpy_leaf(leaf, keep_dtype=True) if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        name = f"a{i}"
        meta = {"entry": name, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        if arr.dtype == BF16_BITS:
            # npz cannot round-trip bf16: store the raw bits
            arr = arr.view(np.uint16)
            meta["dtype"] = "bfloat16"
            meta["stored"] = "uint16_bits"
        arrays[name] = arr
        manifest["leaves"][key] = meta

    tmp = d / f"tmp-{step}"
    final = d / f"step-{step:09d}"

    def _write() -> Path:
        # idempotent as a unit: every attempt rebuilds tmp from scratch
        # and the final os.replace is all-or-nothing
        d.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        _sweep_tmp(d, skip=tmp)
        tmp.mkdir()
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        return final

    out = _with_retries(_write, max_attempts=max_attempts, backoff_s=backoff_s,
                        on_retry=on_retry)
    _apply_retention(d, keep)
    return out


def _apply_retention(d: Path, keep: int) -> None:
    steps = sorted(p for p in d.glob("step-*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str | os.PathLike) -> int | None:
    d = Path(directory)
    if d.is_dir():
        _sweep_tmp(d)  # restart path: clear any crash debris first
    steps = sorted(p.name for p in d.glob("step-*") if p.is_dir())
    if not steps:
        return None
    return int(steps[-1].split("-")[1])


# -- restore -------------------------------------------------------------------------


def _read_manifest(directory: str | os.PathLike, step: int | None) -> tuple[Path, dict]:
    d = Path(directory)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {d}")
    src = d / f"step-{step:09d}"
    return src, json.loads((src / "manifest.json").read_text())


def load_run_state(directory: str | os.PathLike, *, step: int | None = None) -> dict | None:
    """The checkpoint's ``run_state`` blob, or ``None`` for weights-only
    checkpoints: callers fall back to a fresh run state and still restore
    the weights."""
    _, manifest = _read_manifest(directory, step)
    return manifest.get("run_state")


def _stored(arr: np.ndarray, meta: dict):
    """A stored array as a tensor (bf16 from its bits) or as numpy."""
    if meta.get("stored") == "uint16_bits":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


@torch.no_grad()
def _write(parts, value):
    """``value`` into the leaf's holders; returns the leaf as ``like`` will
    hold it (the same tensor, written in place, or the stored value)."""
    out = []
    for idx, leaf in parts:
        v = value if idx is None else value[idx]
        if isinstance(leaf, torch.Tensor):
            # np.ascontiguousarray gives a 0-d entry (a stacked scalar
            # leaf's, e.g. a cross layer's gate) one axis: keep its shape
            leaf.copy_(v if isinstance(v, torch.Tensor)
                       else torch.from_numpy(np.ascontiguousarray(v).reshape(np.shape(v))))
            out.append(leaf)
        elif isinstance(leaf, (int, float)) and not isinstance(v, torch.Tensor):
            out.append(type(leaf)(v))
        else:
            out.append(v)
    return out[0]


def restore(
    directory: str | os.PathLike,
    like,
    *,
    step: int | None = None,
    max_attempts: int = DEFAULT_MAX_ATTEMPTS,
    backoff_s: float = 0.05,
    on_retry: Callable[[int, Exception], None] | None = None,
):
    """Restore into the structure of ``like``: the port's train state, or a
    nested dict / list of tensors, arrays and numbers.  Raises if the stored
    tree does not match (missing or extra leaves, another shape, or another
    dtype for a tensor).  Each tensor of ``like`` is written in place, on
    its own device; the train state's step and every other number or array
    come back as stored.  Returns the tree (for the train state, ``like``'s
    model and moments with the stored step).  Manifest and array reads
    retry transient I/O errors as :func:`save` does (``FileNotFoundError``,
    a genuinely absent checkpoint, is not retried)."""

    def _read():
        src, manifest = _read_manifest(directory, step)
        # force the lazy NpzFile inside the retry scope so a torn read
        # surfaces here, not later at first array access
        with np.load(src / "arrays.npz") as data:
            return manifest, {k: data[k] for k in data.files}

    manifest, data = _with_retries(_read, max_attempts=max_attempts, backoff_s=backoff_s,
                                   on_retry=on_retry)

    slots = _slots(like)
    missing = set(slots) - set(manifest["leaves"])
    extra = set(manifest["leaves"]) - set(slots)
    if missing or extra:
        raise ValueError(
            f"checkpoint/tree mismatch: missing={sorted(missing)[:5]} "
            f"extra={sorted(extra)[:5]}"
        )
    stored = {key: _stored(data[meta["entry"]], meta) for key, meta in manifest["leaves"].items()}
    # every leaf is checked before the first write: a mismatch leaves
    # ``like`` as it was
    for key, value in stored.items():
        if tuple(value.shape) != _shape(slots[key]):
            raise ValueError(f"{key}: shape {tuple(value.shape)} != expected "
                             f"{_shape(slots[key])}")
        leaf = slots[key][0][1]
        if isinstance(leaf, torch.Tensor):
            dtype = value.dtype if isinstance(value, torch.Tensor) else \
                torch.from_numpy(np.empty(0, value.dtype)).dtype
            if dtype != leaf.dtype:
                raise ValueError(f"{key}: dtype {dtype} != expected {leaf.dtype}")
    values = {key: _write(slots[key], value) for key, value in stored.items()}
    if _is_train_state(like):
        return {"model": like["model"], "opt": like["opt"], "step": values["step"]}
    return _rebuild(like, "", values)


def _rebuild(tree, prefix: str, values: dict):
    if isinstance(tree, dict):
        return {k: _rebuild(v, f"{prefix}{k}/", values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, f"{prefix}{i}/", values) for i, v in enumerate(tree))
    return values[prefix[:-1]]


__all__ = ["DEFAULT_MAX_ATTEMPTS", "MANIFEST_VERSION", "TMP_SWEEP_MIN_AGE_S", "latest_step",
           "load_run_state", "restore", "save"]
