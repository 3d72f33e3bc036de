"""The device mesh as a process group (counterpart of
``cachedembedding_tpu/parallel/mesh.py``).

The JAX package's mesh is one named axis ``mp`` over every chip of a single
controller: the embedding shards over it and the dense towers are
data-parallel over it. Here each device is a process, and the axis is a
``torch.distributed`` group of them: NCCL on the card, gloo on the CPU. A
second group, gloo over the same ranks, carries the host-side collectives
(agreeing on numbers that live in host memory) where the first is NCCL.

Every rank sees the global batch's ids and plans the same cache windows from
them, as the JAX package's single controller does; only the dense features
and labels are split by batch. Across hosts the ranks meet over TCP (the
command line's ``--multihost``): a rank's place in the group is its global
rank, its card its local one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from cachedembedding_tpu_torch import resolve_device

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE")


@dataclasses.dataclass
class Mesh:
    """One 1-D mesh axis of ``size`` ranks: this process is ``rank`` and owns
    ``device``. ``group`` carries the device collectives, ``host_group``
    those on host tensors (the same group on the CPU)."""

    group: object
    host_group: object
    rank: int
    size: int
    device: torch.device

    def group_for(self, t: torch.Tensor):
        """The group that carries a collective on ``t``."""
        return self.host_group if t.device.type == "cpu" else self.group


def launched() -> bool:
    """Whether this process runs under a launcher that set its rank and the
    world size (``torchrun``: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR)."""
    return all(k in os.environ for k in _LAUNCHER_ENV)


def make_mesh(n_devices: Optional[int] = None, device=None, init_method: Optional[str] = None,
              rank: Optional[int] = None, local_rank: Optional[int] = None) -> Mesh:
    """A mesh of ``n_devices`` ranks (default: the whole group) on ``device``
    ("cuda", the default, or "cpu").

    It joins the default process group where one is initialized. Otherwise
    it initializes one: from a launcher's environment (``torchrun``), from
    ``init_method`` (``file://...``, or ``tcp://host:port`` across hosts)
    with the global ``rank``, or, for a mesh of one rank, in this process
    alone. The rank's card is ``local_rank``, else the launcher's
    LOCAL_RANK, else the rank modulo the visible cards. Where the JAX
    package's ``make_mesh`` takes the first ``n_devices`` of the visible
    devices, and so silently builds a smaller mesh when fewer are visible,
    this raises: a mesh larger than the process group is refused, and so is
    a rank whose card is not visible (on one host: a mesh larger than the
    visible cards)."""
    kind = resolve_device(device).type
    backend = "nccl" if kind == "cuda" else "gloo"
    if not dist.is_initialized():
        if init_method is not None:
            if n_devices is None or rank is None:
                raise ValueError("make_mesh with an init_method needs n_devices and rank")
            dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=n_devices)
        elif launched():
            dist.init_process_group(backend, init_method="env://")
        elif n_devices in (None, 1):
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            raise ValueError(f"a mesh of {n_devices} ranks needs its processes: start them with a launcher "
                             "(torchrun) or give each one init_method and its rank")
    world, me = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}: the mesh is the whole group")
    if kind == "cuda":
        visible = torch.cuda.device_count()
        if local_rank is None and "LOCAL_RANK" in os.environ:
            local_rank = int(os.environ["LOCAL_RANK"])
        if local_rank is None and n > visible:
            raise ValueError(f"a mesh of {n} ranks needs {n} CUDA devices; {visible} visible")
        local = me % visible if local_rank is None else int(local_rank)
        if local >= visible:
            raise ValueError(f"rank {me} runs on card {local}; {visible} CUDA devices are visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    group = dist.group.WORLD
    host_group = dist.new_group(backend="gloo") if backend == "nccl" else group
    return Mesh(group=group, host_group=host_group, rank=me, size=n, device=dev)


def destroy_mesh(mesh: Mesh) -> None:
    """Leave the process group the mesh made or joined (every rank calls it)."""
    if dist.is_initialized():
        dist.barrier(group=mesh.host_group)
        dist.destroy_process_group()
