"""The data axis: how many processes share a batch, and what a step does
with the others.

Counterpart of the ``data`` axis of ``tinydiffusion_tpu/parallel/mesh.py``
(``make_mesh_for_batch``). Under GSPMD a JAX step on a ``data`` mesh IS the
one-device step on the global batch: XLA splits every batch-leading array
over the axis and inserts the collectives that keep the result the same. The
port writes those collectives out. A ``DataParallel`` value (rank, size and
process group; ``None`` is one device) goes to each train step, which then

- draws its randomness for the global batch from the same-seeded generator
  on every rank and keeps its rows (``shard``), the q_sample kernel's rows
  included (``row_offset``);
- normalises BatchNorm with the global statistics (``sync_batch_norm_``,
  ``all_reduce_sum``, which carries the statistics' gradients across ranks);
- sums or averages the gradients and the logged values over the group in
  one bucket (``all_reduce_grads_``) before the clip and the optimizer.

The collectives are plain ``torch.distributed`` calls on the current
stream, so a step captured in a CUDA graph captures them too (NCCL supports
capture); nothing here reads a device value. The ``model`` axis (tensor
parallelism, JAX's ``infer_state_sharding``) is not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import torch
import torch.distributed as dist
from torch import nn


def data_axis_size(batch_size: int, world: int) -> int:
    """JAX's rule: the largest process count that divides ``batch_size``
    (``gcd``; 1 at worst), with a warning for the processes left idle."""
    n = math.gcd(batch_size, world)
    if n < world:
        logging.getLogger("tinydiffusion_torch.mesh").warning(
            "batch_size=%d does not divide %d devices; using a %d-device mesh "
            "(%d devices idle). Pick a batch divisible by the device count to "
            "use the full slice.",
            batch_size, world, n, world - n)
    return n


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place on the data axis: ``rank`` in ``[0, size)``
    (``rank >= size`` marks an idle process, which trains nothing) and the
    process ``group`` of the ``size`` ranks that train."""

    rank: int
    size: int
    group: object = None  # a torch.distributed ProcessGroup

    @property
    def active(self) -> bool:
        return self.rank < self.size

    @property
    def is_main(self) -> bool:
        """Rank 0 samples, logs and writes the images and checkpoints."""
        return self.rank == 0

    def local(self, global_batch: int) -> int:
        if global_batch % self.size:
            raise ValueError(f"a global batch of {global_batch} does not split over "
                             f"{self.size} ranks")
        return global_batch // self.size

    def shard(self, x, dim: int = 0):
        """This rank's rows ``[rank * b, (rank + 1) * b)`` of ``x`` (a tensor
        or a numpy array), whose ``dim`` is the global batch: a view."""
        b = self.local(x.shape[dim])
        return x[(slice(None),) * dim + (slice(self.rank * b, (self.rank + 1) * b),)]

    def all_reduce_(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed (``"sum"``), averaged (``"mean"``) or maximised
        (``"max"``) over the group, in place. Returns ``x``."""
        reduce_op = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        dist.all_reduce(x, op=reduce_op, group=self.group)
        if op == "mean":
            x.div_(self.size)
        return x

    @torch.no_grad()
    def all_reduce_grads_(self, params, *values: torch.Tensor, op: str = "mean"):
        """The gradients of ``params`` and the 0-d ``values`` summed or
        averaged over the group (``op``: ``"sum"`` for a loss summed over the
        batch, ``"mean"`` for a batch mean) in one flat float32 bucket and
        one collective. The gradients are written back in place; returns the
        reduced ``values`` as new tensors."""
        grads = [p.grad for p in params if p.grad is not None]
        parts = [g.reshape(-1) for g in grads] + [v.reshape(1).float() for v in values]
        bucket = self.all_reduce_(torch.cat(parts), op)
        pieces = bucket.split([p.numel() for p in parts])
        if grads:
            torch._foreach_copy_(grads, [s.view_as(g) for s, g in zip(pieces, grads)])
        return tuple(s.reshape(()) for s in pieces[len(grads):])


def make_mesh_for_batch(batch_size: int) -> DataParallel | None:
    """The data axis of this process group for a global ``batch_size``:
    ``None`` (one device) without a group, else a ``DataParallel`` over the
    first ``data_axis_size(batch_size, world)`` ranks. Every rank must call
    it (a sub-group is created by all); a rank past the axis gets an idle
    value (``active`` False), and its run returns without training."""
    if not dist.is_initialized():
        return None
    world, rank = dist.get_world_size(), dist.get_rank()
    n = data_axis_size(batch_size, world)
    group = dist.new_group(list(range(n))) if n < world else dist.group.WORLD
    return DataParallel(rank, n, group if rank < n else None)


def shard(dp: DataParallel | None, x, dim: int = 0):
    """``dp.shard(x, dim)``; ``x`` itself on one device or when ``x`` is None."""
    return x if dp is None or x is None else dp.shard(x, dim)


def row_offset(dp: DataParallel | None, local_batch: int) -> int:
    """The global index of this rank's first row."""
    return 0 if dp is None else dp.rank * local_batch


def global_batch(dp: DataParallel | None, local_batch: int) -> int:
    return local_batch if dp is None else local_batch * dp.size


def is_main(dp: DataParallel | None) -> bool:
    return dp is None or dp.is_main


def from_main(dp: DataParallel | None, load):
    """``load()`` on rank 0 alone, its result sent to every rank of the group
    (pickled, ``broadcast_object_list``); on one device ``load()``. A run's
    records go through it: only rank 0 reads and writes the records' JPEG
    cache, so ranks that share one never read a file another rank is
    writing, nor some records warm and others cold, and every rank trains
    on the one process's data."""
    if dp is None or dp.size == 1:
        return load()
    box = [load() if dp.is_main else None]
    dist.broadcast_object_list(box, src=0, group=dp.group)
    return box[0]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the incoming gradients over the
    group as well, which carries every rank's loss back to each rank's
    inputs."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
        ctx.dp = dp
        return dp.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.dp.all_reduce_(grad.clone()), None


def all_reduce_sum(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """``x`` summed over the group, differentiably (``_AllReduceSum``)."""
    return _AllReduceSum.apply(x, dp)


def sync_batch_norm_(model: nn.Module, dp: DataParallel | None) -> nn.Module:
    """Point every flax-statistics BatchNorm of ``model`` (``nn.layers``'s
    ``BatchNorm1d``/``BatchNorm2d``) at ``dp``: in train mode they then
    normalise with the group's statistics. ``None`` goes back to each
    process's own batch. Returns ``model``."""
    for module in model.modules():
        if hasattr(module, "data_parallel"):
            module.data_parallel = dp
    return model
