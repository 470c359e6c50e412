"""Process-group start-up for a mesh of several processes.

Counterpart of ``nbody_tpu/parallel/multihost.py``. A JAX program runs one
process per host and addresses every chip of the host from it; a torch
program runs one process (rank) per card, so "multihost" here means "more
than one process", on one host or several. ``torchrun --nproc_per_node D``
starts D ranks and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``; ``initialize_multihost`` reads them when
it is given no arguments. Nothing here starts a process.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *, device: str = "cuda") -> int:
    """Start the default process group, unless one exists; return the world
    size (the number of ranks, one a device).

    `coordinator_address` is "host:port" of rank 0, with `num_processes` and
    `process_id`; without them they come from torchrun's environment. With
    device="cuda" each rank takes the card ``LOCAL_RANK`` (else its rank
    modulo the cards of the host) and the group runs NCCL; with
    device="cpu" it runs gloo."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    rank = int(env["RANK"]) if process_id is None else int(process_id)
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group was requested but "
                               "torch.cuda.is_available() is False")
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return world


def is_multihost() -> bool:
    """True when the default process group has more than one rank."""
    return dist.is_initialized() and dist.get_world_size() > 1
