"""Process-group set-up for step-plan execution: the counterpart of
``repro.launch.mesh.make_data_mesh``.

The reference builds a pure data-parallel device mesh inside one process.
The port runs one process a rank: :func:`make_data_group` joins this
process to a ``torch.distributed`` group of ``world_size`` ranks, from
arguments only (it reads no environment variable), and returns the
:class:`DataGroup` that ``distributed.plan_exec.PlanExecutor``,
``train.engine.MeshEngine`` and ``Trainer(mesh=)`` consume.  The
reference's production and host meshes belong with the dry run and are
not ported.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import resolve_device

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This process's place in a data-parallel group: ``group`` is the
    ``torch.distributed`` process group (the default group), ``device``
    the device its rank computes on."""

    group: Any
    rank: int
    world_size: int
    backend: str
    device: torch.device

    def close(self) -> None:
        """Leave the group (``destroy_process_group``)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def make_data_group(*, rank: int, world_size: int, store: str, backend: str, device=None,
                    timeout_s: float = 300.0) -> DataGroup:
    """Join the data-parallel group as ``rank`` of ``world_size``.

    ``store`` is a ``FileStore`` path (every process of the group names the
    same file) or a ``tcp://host:port`` address (rank 0 listens there);
    ``backend`` is ``"nccl"`` (one card a rank; it sets the current CUDA
    device, card ``rank`` of this host unless ``device`` names one) or
    ``"gloo"``, and nothing else is tried.  ``device`` is this rank's
    device: CUDA unless given, raising without a GPU.  Every wait of
    the group, its set-up included, is bounded by ``timeout_s``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is not in a group of {world_size}")
    device = resolve_device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        if device.index is None:  # one host: rank r on card r
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    if store.startswith("tcp://"):
        host, port = store[len("tcp://"):].rsplit(":", 1)
        kv = dist.TCPStore(host, int(port), world_size, is_master=rank == 0, timeout=timeout)
    else:
        kv = dist.FileStore(store, world_size)
    dist.init_process_group(backend, store=kv, rank=rank, world_size=world_size,
                            timeout=timeout)
    return DataGroup(group=None, rank=rank, world_size=world_size, backend=backend,
                     device=device)


__all__ = ["BACKENDS", "DataGroup", "make_data_group"]
