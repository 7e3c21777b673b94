"""Joining the processes of a data-parallel run.

Counterpart of ``tinydiffusion_tpu/parallel/distributed.py``. JAX reads its
coordinator from ``JAX_COORDINATOR_ADDRESS`` and friends; the port reads
what ``torchrun`` sets: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT``. Without them a run is one process and
nothing here does anything. Run two processes on the CPU with::

    torchrun --nproc_per_node 2 -m tinydiffusion_torch.experiments.diffusion \\
        --device cpu ...

and one per card with ``--device cuda`` (the default).
"""

from __future__ import annotations

import atexit
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger("tinydiffusion_torch.distributed")


def maybe_initialize_distributed(device: str | torch.device = "cuda") -> bool:
    """Join the process group that torchrun's variables describe, when they
    are set. Returns whether the process is in a group.

    ``device`` is the run's: on a CUDA device the group runs NCCL and this
    process's card is ``cuda:LOCAL_RANK`` (made current here); on the CPU it
    runs gloo. Calling it again does nothing; without ``WORLD_SIZE`` and
    ``RANK`` in the environment it does nothing and returns False. A group
    that cannot be formed raises (there is no fallback to one process), and
    the group is destroyed when the process exits."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl" if on_card else "gloo", init_method="env://", rank=rank,
                            world_size=world)
    atexit.register(destroy)
    logger.info("torch.distributed initialized: rank %d/%d, backend %s", rank, world,
                dist.get_backend())
    return True


def destroy() -> None:
    """Leave and destroy the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_batch_slice(global_batch: int) -> int:
    """The batch each process takes of ``global_batch`` (JAX's rule: the
    global batch over the number of processes, rounded down)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return global_batch // world
