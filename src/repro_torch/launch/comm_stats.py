"""Collective byte accounting: the counterpart of ``repro.launch.hlo_stats``.

The reference parses the compiled HLO text and sums the **output-shape
bytes** of every collective op per device (for all-reduce out == in; for
all-gather the output counts the fully gathered bytes a device receives;
for reduce-scatter the output counts the reduced shard it keeps).  The
port has no HLO: it reads the collectives that
``torch.distributed.tensor.debug.CommDebugMode`` records while DTensors
redistribute (:func:`comm_recorder`), each with its output shapes and
dtypes, and sums them by the same convention under the same five op names
and the same keys.
"""

from __future__ import annotations

from collections import defaultdict

import torch

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# op-name fragments of torch's collectives (functional and c10d), by the
# reference's name; the more specific fragment comes first
_NAMES = (
    ("reduce_scatter", "reduce-scatter"),
    ("all_gather", "all-gather"),
    ("allgather", "all-gather"),
    ("all_reduce", "all-reduce"),
    ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"),
    ("alltoall", "all-to-all"),
    ("permute", "collective-permute"),
)


def op_name(name: str) -> str:
    """The reference's name of a torch collective op (``all-gather`` for
    ``_c10d_functional.all_gather_into_tensor``); raises for any other."""
    if name in COLLECTIVES:
        return name
    low = name.lower()
    for frag, ref in _NAMES:
        if frag in low:
            return ref
    raise ValueError(f"{name} is not one of the collectives {COLLECTIVES}")


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def record(op: str, outputs) -> dict:
    """One collective: its op (the reference's name or torch's) and its
    outputs, ``(shape, dtype)`` pairs (several for a tuple result)."""
    return {"op": op_name(op), "outputs": [(tuple(s), d) for s, d in outputs]}


def collective_stats(records) -> dict:
    """Per-collective-op byte totals (per device, output-shape convention),
    the reference's dict: ``bytes_by_op``, ``count_by_op``,
    ``total_bytes``, ``total_count``."""
    bytes_by_op: dict[str, int] = defaultdict(int)
    count_by_op: dict[str, int] = defaultdict(int)
    for r in records:
        op = op_name(r["op"])
        bytes_by_op[op] += sum(_nbytes(s, d) for s, d in r["outputs"])
        count_by_op[op] += 1
    return {
        "bytes_by_op": dict(bytes_by_op),
        "count_by_op": dict(count_by_op),
        "total_bytes": int(sum(bytes_by_op.values())),
        "total_count": int(sum(count_by_op.values())),
    }


def comm_recorder():
    """A ``CommDebugMode`` that also keeps :func:`record` s of what it
    counts (``.records``): the op and its output shapes and dtypes."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._pytree import tree_leaves

    class _Recorder(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.records: list[dict] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = sum(self.get_comm_counts().values())
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and sum(self.get_comm_counts().values()) > before:
                outs = [(t.shape, t.dtype) for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
                self.records.append(record(str(func), outs))
            return out

    return _Recorder()


__all__ = ["COLLECTIVES", "collective_stats", "comm_recorder", "op_name", "record"]
