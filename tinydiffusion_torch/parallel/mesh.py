"""The data and model axes: how many processes share a batch, how many
share a model, and what a step does with the others.

Counterpart of ``tinydiffusion_tpu/parallel/mesh.py``. Under GSPMD a JAX step
on a ``data`` mesh IS the one-device step on the global batch: XLA splits
every batch-leading array over the axis and inserts the collectives that
keep the result the same. The port writes those collectives out. A
``DataParallel`` value (rank, size and process group; ``None`` is one
device) goes to each train step, which then

- draws its randomness for the global batch from the same-seeded generator
  on every rank and keeps its rows (``shard``), the q_sample kernel's rows
  included (``row_offset``);
- normalises BatchNorm with the global statistics (``sync_batch_norm_``,
  ``all_reduce_sum``, which carries the statistics' gradients across ranks);
- sums or averages the gradients and the logged values over the group in
  one bucket (``all_reduce_grads_``) before the clip and the optimizer.

The ``model`` axis is tensor parallelism (``make_mesh``, ``Mesh``): JAX's
``infer_state_sharding`` shards every float leaf on its last dimension where
the axis divides it, and GSPMD derives the collectives. Here
``infer_state_sharding`` names each tensor's sharded torch dimension (flax's
last: dim 0 of a conv or linear weight, of a bias and of the BatchNorm
vectors; dim 1 of an embedding), ``apply_sharding`` keeps each rank's slice,
and a sharded model (the UNet28) makes each layer's input whole with
``to_full`` before it computes its slice of output channels: an all-gather
whose backward reduce-scatters the partial input gradients of a sharded
consumer, and only takes its own slice for a replicated one (whose gradient
is already whole on every model rank). A tensor left whole (the one-channel
head) has its gradient computed on every model rank; the step averages it
over the axis (``average_replicated_grads_``), so that the copies stay
equal where a card's backward is not deterministic. ``gather_state_dict``
makes the sharded state whole again for a checkpoint.

The collectives are plain ``torch.distributed`` calls on the current
stream, so a step captured in a CUDA graph captures them too (NCCL supports
capture); nothing here reads a device value.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Sequence

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
class _Axis:
    """This process's place on one mesh axis: ``rank`` in ``[0, size)`` and
    the process ``group`` of the axis's ``size`` ranks."""

    rank: int
    size: int
    group: object = None  # a torch.distributed ProcessGroup

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


@dataclasses.dataclass(frozen=True)
class DataParallel(_Axis):
    """This process's place on the data axis: ``rank`` in ``[0, size)``
    (``rank >= size`` marks an idle process, which trains nothing) and the
    process ``group`` of the ``size`` ranks that train."""

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


# --- the model axis -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelParallel(_Axis):
    """This process's place on the model axis: ``rank`` in ``[0, size)`` and
    the process ``group`` of the ``size`` ranks that share one data row."""

    def all_gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``x`` (the same shape on each), in rank order."""
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return out

    def reduce_scatter(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The sum over the group of every rank's ``parts[self.rank]`` (one
        ``reduce_scatter_tensor``, which NCCL and gloo both take)."""
        out = torch.empty_like(parts[0])
        dist.reduce_scatter_tensor(out, torch.cat(parts), group=self.group)
        return out


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` mesh over the process group: this rank's place on
    each axis. Rank r sits at ``(r // model_size, r % model_size)``, as JAX's
    ``np.asarray(devices).reshape(shape)`` places device r."""

    shape: tuple[int, int]
    data: DataParallel
    model: ModelParallel

    @property
    def dp(self) -> DataParallel | None:
        """The data axis as the steps take it: None for a single data row."""
        return self.data if self.data.size > 1 else None

    @property
    def mp(self) -> ModelParallel | None:
        """The model axis: None when it has one rank."""
        return self.model if self.model.size > 1 else None


def make_mesh(axes: Sequence[str] = ("data", "model"), shape: Sequence[int] | None = None,
              ) -> Mesh:
    """JAX's ``make_mesh`` over the torchrun world: one axis takes every
    process; two axes with no shape give ``model`` size 1. Every rank must
    call it (the axis groups are created by all). Without a process group
    the mesh is one device."""
    if tuple(axes) not in (("data",), ("data", "model")):
        raise ValueError(f"the port's mesh axes are ('data',) or ('data', 'model'), not {axes}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = tuple(shape) if shape is not None else (world,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} != {world} devices")
    d, m = (shape[0], shape[1]) if len(shape) == 2 else (shape[0], 1)
    data_groups = model_groups = [None] * world
    if world > 1:
        data_groups = [dist.new_group([i * m + j for i in range(d)]) for j in range(m)]
        model_groups = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
    return Mesh((d, m), DataParallel(rank // m, d, data_groups[rank % m]),
                ModelParallel(rank % m, m, model_groups[rank // m]))


def require_model_axis(model: nn.Module) -> None:
    if not getattr(model, "supports_model_axis", False):
        raise NotImplementedError(
            f"the model axis is ported for the UNet28 train step (unconditional and "
            f"class-conditional); {type(model).__name__} takes the data axis only")


def _sharded_dim(module: nn.Module, attr: str) -> int:
    """The torch dimension of flax's last one for ``module.<attr>``."""
    if isinstance(module, nn.Embedding):
        return 1
    if isinstance(module, (nn.Conv2d, nn.Linear, nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
        return 0
    raise NotImplementedError(f"no model-axis rule for {type(module).__name__}.{attr}: the axis "
                              "is ported for Conv2d, Linear, Embedding and the norms")


def infer_state_sharding(model: nn.Module, mesh: Mesh | int) -> dict[str, int | None]:
    """JAX's ``infer_state_sharding`` in torch's layout: for each tensor of
    ``model.state_dict()``, the dimension it is split on over the model
    axis, or None (replicated). A float tensor is split on flax's last
    dimension where that size is at least the axis size and divisible by it;
    everything else is replicated, and everything at size 1. Adam's moments
    and an EMA shadow follow their parameter's entry. ``mesh`` may be the
    axis size."""
    m = mesh if isinstance(mesh, int) else mesh.model.size
    if m > 1:
        require_model_axis(model)
    out = {}
    modules = dict(model.named_modules())
    for name, tensor in model.state_dict().items():
        owner, _, attr = name.rpartition(".")
        if m == 1 or not tensor.is_floating_point() or tensor.dim() == 0:
            out[name] = None
            continue
        dim = _sharded_dim(modules[owner], attr)
        size = tensor.shape[dim]
        out[name] = dim if size >= m and size % m == 0 else None
    return out


def apply_sharding(model: nn.Module, shardings: dict[str, int | None], mesh: Mesh,
                   state_dict: dict[str, torch.Tensor] | None = None) -> nn.Module:
    """Keep this rank's slice of every sharded tensor of ``model``, in place,
    and point the model at the model axis (its forward then makes each
    layer's input whole, ``to_full``). ``state_dict``, a whole one (the
    converter's ``io.from_jax.unet28_state_dict`` of JAX weights, say), is
    loaded first. Build the optimizer and the EMA after this: they then hold
    only this rank's shards. Each parameter left whole is marked
    (``average_replicated_grads_``). Returns ``model``."""
    mp = mesh.model
    if mp.size > 1:
        require_model_axis(model)
    if any(getattr(m, "model_parallel", None) is not None for m in model.modules()):
        raise ValueError("the model is sharded already")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, dim in shardings.items():
            owner, _, attr = name.rpartition(".")
            if dim is None:
                if mp.size > 1 and attr in modules[owner]._parameters:
                    modules[owner]._parameters[attr].replicated = True
                continue
            module = modules[owner]
            tensor = getattr(module, attr)
            part = tensor.shape[dim] // mp.size
            piece = tensor.narrow(dim, mp.rank * part, part).clone()
            if attr in module._parameters:
                module._parameters[attr] = nn.Parameter(piece, tensor.requires_grad)
            else:
                module._buffers[attr] = piece
    for module in model.modules():
        if hasattr(module, "model_parallel"):
            module.model_parallel = mp if mp.size > 1 else None
    return model


def average_replicated_grads_(mp: ModelParallel | None, model: nn.Module) -> None:
    """The gradients of the parameters that ``apply_sharding`` left whole (a
    layer too narrow to split, the one-channel head) averaged over the model
    axis in one bucket. Every model rank computes them in whole from the
    same whole inputs, but a card's backward need not give the same bits
    twice (cuDNN's weight gradients are not deterministic): the mean keeps
    the copies equal step after step."""
    if mp is not None:
        mp.all_reduce_grads_([p for p in model.parameters() if getattr(p, "replicated", False)])


def gather_state_dict(tensors: dict[str, torch.Tensor], shardings: dict[str, int | None],
                      mesh: Mesh) -> dict[str, torch.Tensor]:
    """The whole tensors of a sharded ``tensors`` (a state dict, or an EMA
    shadow by parameter name): every sharded one gathered over the model
    axis, on every rank of it. Every rank must call it."""
    out = {}
    for name, tensor in tensors.items():
        dim = shardings.get(name)
        if dim is None or mesh.model.size == 1:
            out[name] = tensor.detach().clone()
            continue
        parts = mesh.model.all_gather(tensor.detach().movedim(dim, -1))
        out[name] = torch.cat(parts, -1).movedim(-1, dim).contiguous()
    return out


def _in_width(layer: nn.Module) -> int:
    return layer.in_channels if isinstance(layer, nn.Conv2d) else layer.in_features


def out_sharded(layer: nn.Module) -> bool:
    """Whether a conv's or linear's output channels are split over the model
    axis (its weight holds fewer than its ``out_channels``)."""
    whole = layer.out_channels if isinstance(layer, nn.Conv2d) else layer.out_features
    return layer.weight.shape[0] < whole


class _ToFull(torch.autograd.Function):
    """The whole channels (dim 1) of ``parts`` concatenated in their global
    order ``[part 0 of ranks 0..m-1, part 1 of ranks 0..m-1, ...]``: one
    all-gather. Backward: the incoming gradient cut back into each rank's
    slices, then summed over the model axis when the consumer is sharded
    (each rank's gradient there is partial: a reduce-scatter) or only taken
    when it is replicated (each rank's gradient is already whole)."""

    @staticmethod
    def forward(ctx, mp: ModelParallel, reduce: bool, *parts: torch.Tensor) -> torch.Tensor:
        ctx.mp, ctx.reduce = mp, reduce
        ctx.widths = [p.shape[1] for p in parts]
        local = torch.cat([p.movedim(1, -1) for p in parts], -1)
        gathered = [g.split(ctx.widths, -1) for g in mp.all_gather(local)]
        whole = torch.cat([g[k] for k in range(len(parts)) for g in gathered], -1)
        return whole.movedim(-1, 1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mp, widths = ctx.mp, ctx.widths
        grad = grad.movedim(1, -1)
        blocks = grad.split([w * mp.size for w in widths], -1)
        per_rank = [torch.cat([b.split(w, -1)[r] for b, w in zip(blocks, widths)], -1)
                    for r in range(mp.size)]
        if ctx.reduce:
            # Summed in float32: a bfloat16 activation's m partials round once.
            mine = mp.reduce_scatter([p.float() for p in per_rank]).to(grad.dtype)
        else:
            mine = per_rank[mp.rank]
        return (None, None, *[g.movedim(-1, 1) for g in mine.split(widths, -1)])


class _SumGradients(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model axis (a whole
    input that a sharded layer reads: each rank's gradient is partial)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        total = ctx.mp.all_reduce_(grad.to(torch.float32, copy=True).contiguous())
        return total.to(grad.dtype), None


def to_full(mp: ModelParallel | None, consumer: nn.Module, *parts: torch.Tensor) -> torch.Tensor:
    """The input of ``consumer`` (a Conv2d or Linear) made whole on the model
    axis: ``parts`` (this rank's channels of each, or whole ones) concatenated
    on dim 1 in their global order. One process, or whole parts: the plain
    concatenation."""
    width = sum(p.shape[1] for p in parts)
    if mp is None:
        return parts[0] if len(parts) == 1 else torch.cat(parts, 1)
    sharded = out_sharded(consumer)
    if width == _in_width(consumer):
        x = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
        return _SumGradients.apply(x, mp) if sharded and x.requires_grad else x
    if width * mp.size != _in_width(consumer):
        raise ValueError(f"an input of {width} channels on {mp.size} model ranks for a layer of "
                         f"{_in_width(consumer)}")
    return _ToFull.apply(mp, sharded, *parts)
