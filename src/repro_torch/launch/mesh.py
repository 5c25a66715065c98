"""Meshes and process groups: the counterpart of ``repro.launch.mesh``.

* :func:`make_production_mesh` — the dry run's ``("data", "model")``
  16x16 or ``("pod", "data", "model")`` 2x16x16 ``DeviceMesh``, over a
  fake process group of 256 or 512 ranks in this one process (rank 0; its
  collectives move nothing), as the reference lays its mesh over host
  placeholder devices.  The group is the process's default group, so the
  production mesh needs a process of its own.
* :func:`make_host_mesh` — a (1, 1) ``("data", "model")`` mesh on this
  process's one device (the card unless the caller asks for the CPU), over
  a real one-rank group.
* :func:`make_data_group` — step-plan execution (the reference's
  ``make_data_mesh``).  The reference builds a pure data-parallel device
  mesh inside one process; the port runs one process a rank and joins
  this process to a ``torch.distributed`` group of ``world_size`` ranks,
  from arguments only (it reads no environment variable), returning the
  :class:`DataGroup` that ``distributed.plan_exec.PlanExecutor``,
  ``train.engine.MeshEngine`` and ``Trainer(mesh=)`` consume.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import resolve_device

BACKENDS = ("nccl", "gloo")

#: the production meshes: (shape, axis names) by ``multi_pod``
PRODUCTION = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh as a ``DeviceMesh`` of CPU placeholders over a
    fake process group of ``prod(shape)`` ranks, this process rank 0
    (``torch.testing._internal.distributed.fake_pg``): DTensors on it
    place and redistribute ``meta`` tensors, recording their collectives,
    and move no data.  Starts the group unless this process already has
    that fake group; any other default group raises."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION[bool(multi_pod)]
    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != n:
            raise RuntimeError(
                f"the production mesh needs a process of its own: this one has a "
                f"{dist.get_backend()} group of {dist.get_world_size()} ranks"
            )
    else:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(device=None):
    """A (1, 1) ``("data", "model")`` mesh on this process's one device,
    CUDA unless ``device`` names another (raising without a GPU).  Starts a
    one-rank group (nccl on the card, gloo on the CPU) unless this process
    is already in a one-rank group."""
    from torch.distributed.device_mesh import DeviceMesh

    device = resolve_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError(f"the host mesh is one device; this process is in a group of "
                               f"{dist.get_world_size()}")
    else:
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return DeviceMesh(device.type, torch.zeros((1, 1), dtype=torch.int),
                      mesh_dim_names=("data", "model"))


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


__all__ = [
    "BACKENDS", "DataGroup", "PRODUCTION", "make_data_group", "make_host_mesh",
    "make_production_mesh",
]
