"""The world as the port sees it: rank, size and the local device.

Counterpart of `ref_geotransformer_tpu/parallel/mesh.py::make_mesh`. There
one jitted program spans a mesh of devices: parameters are replicated, the
pair batch is sharded over the 'data' axis, and XLA inserts the gradient
all-reduce. The port runs one process per card, each with a full replica
and its own loader shard, and reduces explicitly (`parallel/dp.py`). So
`batch_sharding` and `replicated_sharding`, which place arrays on a mesh
inside one process, have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ref_geotransformer_tpu_torch.parallel.multihost import local_device, world


@dataclasses.dataclass(frozen=True)
class World:
    rank: int
    size: int
    device: torch.device


def make_world(device="cuda") -> Optional[World]:
    """The world of this process's group, or None when no process group is
    up: a single process, whose steps reduce nothing (the JAX package's
    `mesh=None`)."""
    if not dist.is_initialized():
        return None
    rank, size = world()
    return World(rank, size, local_device(device))
