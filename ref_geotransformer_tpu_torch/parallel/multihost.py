"""Multi-process plumbing: the process group, the rank-0 gate and the loader shards.

Counterpart of `ref_geotransformer_tpu/parallel/multihost.py`. The reference
trains on several cards through `torch.distributed.launch` + NCCL DDP
(`engine/base_trainer.py:66-78`, `README.md:179`) with a DistributedSampler
(`utils/torch.py:48-77`) and rank-0-gated logging and checkpointing
(`engine/logger.py:29-33`, `base_trainer.py:115`). The port runs one process
per card, joined in one `torch.distributed` process group:

* `initialize_multihost()` joins the group. The coordinator comes from
  torchrun's environment (`MASTER_ADDR`, `MASTER_PORT`, `RANK`,
  `WORLD_SIZE`, `LOCAL_RANK`; `env://`), present when `WORLD_SIZE` > 1, or
  from the JAX package's variables `REF_GT_COORDINATOR` (host:port),
  `REF_GT_NUM_PROCESSES` and `REF_GT_PROCESS_ID` (`tcp://`, one launch per
  host). With neither it is a single-process run and the call does nothing,
  as in the JAX package. NCCL when the device is a CUDA card, gloo on the CPU;
* `is_primary()`, `world()`, `shard_spec()` and `apply_multihost_sharding()`
  read the group (rank 0 of 1 without one);
* `local_device()` is the card of the local rank, `cuda:LOCAL_RANK`.

The JAX package has an ordering contract: `jax.distributed.initialize` must
run before any other JAX call initializes the backends. torch has no such
rule (a process group can be created after CUDA is in use, and reading the
group's state initializes nothing), so nothing here must run first; the
entry points join right after parsing their arguments because the device
they build on depends on the rank.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

COORDINATOR_ENV, NUM_PROCESSES_ENV, PROCESS_ID_ENV = "REF_GT_COORDINATOR", "REF_GT_NUM_PROCESSES", "REF_GT_PROCESS_ID"


def torchrun_env_present() -> bool:
    """True when torchrun (or torch.distributed.launch) started this process
    as one of several: the counterpart of the JAX package's `_pod_env_present`."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def initialize_multihost(
    device="cuda",
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the process group; returns (rank, world size).

    With no `init_method`, the coordinator comes from the environment (see
    the module docstring); with none there either, this is a single-process
    run and the call is a no-op. A caller may pass its own `init_method`
    (e.g. a `file://` store) with `world_size` and `rank`. The backend is
    NCCL for a CUDA `device` and gloo otherwise, unless `backend` names one;
    under NCCL the local rank's card becomes the current device.
    Idempotent: a second call returns the group it finds."""
    if dist.is_initialized():
        return world()
    if init_method is None:
        coordinator = os.environ.get(COORDINATOR_ENV)
        if coordinator:
            init_method = f"tcp://{coordinator}"
            world_size = int(os.environ[NUM_PROCESSES_ENV]) if world_size is None else world_size
            rank = int(os.environ[PROCESS_ID_ENV]) if rank is None else rank
        elif torchrun_env_present():
            init_method = "env://"  # RANK and WORLD_SIZE from the environment
        else:
            return world()
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    card = None
    if backend == "nccl":
        card = _local_card(device)
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=init_method, world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, device_id=card)
    return world()


def world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """True on the process that owns host-side side effects (log and event
    files, snapshot writes): the reference's rank-0 gate."""
    return world()[0] == 0


def _local_card(device: torch.device) -> torch.device:
    if device.index is not None:
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def local_device(device="cuda") -> torch.device:
    """`device`; a CUDA device without an index becomes the local rank's card
    (`cuda:LOCAL_RANK`) when a process group is up."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_initialized():
        return _local_card(device)
    return device


def shard_spec() -> Tuple[int, int]:
    """(num_shards, shard_index) for PairLoader, the DistributedSampler
    counterpart: each rank reads a disjoint, equal-length (wrap-padded)
    slice of the dataset (reference utils/torch.py:48-77)."""
    rank, size = world()
    return size, rank


def apply_multihost_sharding(loader) -> None:
    """Point an existing PairLoader at this rank's dataset shard."""
    loader.num_shards, loader.shard_index = shard_spec()
