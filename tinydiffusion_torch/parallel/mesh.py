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
``infer_state_sharding`` names, for each tensor, the torch dimension of
flax's last one (dim 0 of a conv or linear weight, of a bias and of the
norms' vectors; dim 1 of an embedding; the last of a parameter kept in
flax's layout, the DiT's ``pos_encoding``), or a ``HeadSplit`` where flax
keeps that dimension as (heads, head_dim) and JAX splits head_dim (the
DiT's query, key and value); ``apply_sharding`` keeps each rank's slice.
A sharded model (the UNet28, the MLP UNet, the DiT) makes each layer's
input whole with ``to_full`` before it computes its slice of output
features: an all-gather whose backward reduce-scatters the partial input
gradients of a sharded consumer, and only takes its own slice for a
replicated one (whose gradient is already whole on every model rank).
A tensor left whole (the UNet28's one-channel head) has its gradient
computed on every model rank; the step averages it over the axis
(``average_replicated_grads_``), so that the copies stay equal where a
card's backward is not deterministic. ``gather_state_dict`` makes the
sharded state whole again for a checkpoint.

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
            f"the model axis is ported for the UNet28 (unconditional and class-conditional), "
            f"the MLP UNet and the DiT; {type(model).__name__} takes the data axis only")


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """A split of torch dimension ``dim`` that flax keeps as (heads,
    head_dim) and JAX splits on head_dim: each rank holds head_dim / m of
    every head, a strided slice in torch's layout (a DiT query, key or value
    weight: flax's (D, heads, head_dim) kernel, torch's (heads * head_dim, D)
    weight)."""

    dim: int
    heads: int


def _dim_groups(spec: int | HeadSplit) -> tuple[int, int]:
    return (spec.dim, spec.heads) if isinstance(spec, HeadSplit) else (spec, 1)


def shard_of(tensor: torch.Tensor, spec: int | HeadSplit, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s slice of a whole ``tensor`` split ``spec`` ways over
    ``size`` ranks: a view."""
    dim, groups = _dim_groups(spec)
    grouped = tensor.unflatten(dim, (groups, -1))
    part = grouped.shape[dim + 1] // size
    return grouped.narrow(dim + 1, rank * part, part).flatten(dim, dim + 1)


def join_shards(parts: Sequence[torch.Tensor], spec: int | HeadSplit) -> torch.Tensor:
    """The whole tensor of every rank's slice (``shard_of``), in rank order."""
    dim, groups = _dim_groups(spec)
    return torch.cat([p.unflatten(dim, (groups, -1)) for p in parts], dim + 1).flatten(dim, dim + 1)


def _heads(modules: dict, owner: str) -> int | None:
    """The head count of a Linear whose output flax keeps as (heads,
    head_dim): the query, key and value of an attention module (one with
    ``num_heads``, as ``io.from_jax.jax_variables`` reads it); None
    elsewhere."""
    parent, _, own = owner.rpartition(".")
    heads = getattr(modules.get(parent), "num_heads", None)
    return heads if heads is not None and own in ("query", "key", "value") else None


def _flax_last(modules: dict, owner: str, attr: str, tensor: torch.Tensor) -> int | HeadSplit:
    """The torch dimension (or head split) of flax's last one for
    ``<owner>.<attr>``."""
    module, heads = modules[owner], _heads(modules, owner)
    if isinstance(module, nn.Embedding):
        return 1
    if isinstance(module, nn.Linear) and heads is not None:
        return HeadSplit(0, heads)
    if isinstance(module, (nn.Conv2d, nn.Linear, nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
        return 0
    if attr in module._parameters:  # a module's own parameter, in flax's layout
        return tensor.dim() - 1
    raise NotImplementedError(f"no model-axis rule for {type(module).__name__}.{attr}: the axis "
                              "is ported for Conv2d, Linear, Embedding, the norms and "
                              "parameters in flax's layout")


def infer_state_sharding(model: nn.Module, mesh: Mesh | int) -> dict[str, int | HeadSplit | None]:
    """JAX's ``infer_state_sharding`` in torch's layout: for each tensor of
    ``model.state_dict()``, how it is split over the model axis (a torch
    dimension, or a ``HeadSplit``), or None (replicated). A float tensor is
    split on flax's last dimension where that size is at least the axis
    size and divisible by it; everything else is replicated, and everything
    at size 1. Adam's moments and an EMA shadow follow their parameter's
    entry. ``mesh`` may be the axis size."""
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
        spec = _flax_last(modules, owner, attr, tensor)
        dim, groups = _dim_groups(spec)
        size = tensor.shape[dim] // groups
        out[name] = spec if size >= m and size % m == 0 else None
    return out


def apply_sharding(model: nn.Module, shardings: dict[str, int | HeadSplit | None], mesh: Mesh,
                   state_dict: dict[str, torch.Tensor] | None = None) -> nn.Module:
    """Keep this rank's slice of every sharded tensor of ``model``, in place,
    and point the model at the model axis (its forward then makes each
    layer's input whole, ``to_full``). ``state_dict``, a whole one (the
    converter's ``io.from_jax.state_dict_by_name`` of JAX weights, say), is
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
        for name, spec in shardings.items():
            owner, _, attr = name.rpartition(".")
            if spec is None:
                if mp.size > 1 and attr in modules[owner]._parameters:
                    modules[owner]._parameters[attr].replicated = True
                continue
            module = modules[owner]
            tensor = getattr(module, attr)
            piece = shard_of(tensor, spec, mp.rank, mp.size).clone()
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
    replicated = [p for p in model.parameters() if getattr(p, "replicated", False)]
    if mp is not None and replicated:
        mp.all_reduce_grads_(replicated)


def gather_state_dict(tensors: dict[str, torch.Tensor],
                      shardings: dict[str, int | HeadSplit | None],
                      mesh: Mesh) -> dict[str, torch.Tensor]:
    """The whole tensors of a sharded ``tensors`` (a state dict, or an EMA
    shadow by parameter name): every sharded one gathered over the model
    axis, on every rank of it. Every rank must call it."""
    out = {}
    for name, tensor in tensors.items():
        spec = shardings.get(name)
        if spec is None or mesh.model.size == 1:
            out[name] = tensor.detach().clone()
            continue
        out[name] = join_shards(mesh.model.all_gather(tensor.detach()), spec).contiguous()
    return out


def _in_width(layer: nn.Module) -> int:
    return layer.in_channels if isinstance(layer, nn.Conv2d) else layer.in_features


def _feature_dim(layer: nn.Module) -> int:
    """The dimension of a layer's input and output features: 1 of an NCHW
    conv's, the last of a linear's (B, D) or (B, S, D)."""
    return 1 if isinstance(layer, nn.Conv2d) else -1


def out_sharded(layer: nn.Module) -> bool:
    """Whether a conv's or linear's output channels are split over the model
    axis (its weight holds fewer than its ``out_channels``)."""
    whole = layer.out_channels if isinstance(layer, nn.Conv2d) else layer.out_features
    return layer.weight.shape[0] < whole


def _rank_slices(x: torch.Tensor, groups: int, size: int) -> list[torch.Tensor]:
    """Each rank's slice of a whole last dimension that ``_interleave`` built."""
    grouped = x.unflatten(-1, (groups, size, -1))
    return [grouped.select(-2, r).flatten(-2) for r in range(size)]


def _interleave(pieces: list[torch.Tensor], groups: int) -> torch.Tensor:
    """The whole last dimension of every rank's slice of it, in rank order:
    of each of ``groups`` groups, rank 0's part, rank 1's, ..."""
    return torch.cat([p.unflatten(-1, (groups, -1)) for p in pieces], -1).flatten(-2)


class _ToFull(torch.autograd.Function):
    """The whole features (dimension ``dim``) of ``parts`` concatenated in
    their global order ``[part 0 of ranks 0..m-1, part 1 of ranks 0..m-1,
    ...]``: one all-gather. With ``groups`` > 1 each part is a head split
    (``HeadSplit``): of each group, every rank's slice in rank order.
    Backward: the incoming gradient cut back into each rank's slices, then
    summed over the model axis when the consumer is sharded (each rank's
    gradient there is partial: a reduce-scatter) or only taken when it is
    replicated (each rank's gradient is already whole)."""

    @staticmethod
    def forward(ctx, mp: ModelParallel, reduce: bool, float32: bool, dim: int, groups: int,
                *parts: torch.Tensor) -> torch.Tensor:
        ctx.mp, ctx.reduce, ctx.dim, ctx.groups = mp, reduce, dim, groups
        ctx.widths = [p.shape[dim] for p in parts]
        local = torch.cat([p.movedim(dim, -1) for p in parts], -1)
        gathered = [g.split(ctx.widths, -1) for g in mp.all_gather(local)]
        whole = torch.cat([_interleave([g[k] for g in gathered], groups)
                           for k in range(len(parts))], -1)
        # float32: the whole input upcast (exact), so that its gradient, the
        # consumer's float32 partials, reaches the backward unrounded.
        return whole.movedim(-1, dim).float() if float32 else whole.movedim(-1, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mp, widths = ctx.mp, ctx.widths
        grad = grad.movedim(ctx.dim, -1)
        blocks = [_rank_slices(b, ctx.groups, mp.size)
                  for b in grad.split([w * mp.size for w in widths], -1)]
        per_rank = [torch.cat([b[r] for b in blocks], -1) for r in range(mp.size)]
        if ctx.reduce:
            # Summed in float32: a bfloat16 activation's m partials round once.
            mine = mp.reduce_scatter([p.float() for p in per_rank]).to(grad.dtype)
        else:
            mine = per_rank[mp.rank]
        return (None,) * 5 + tuple(g.movedim(-1, ctx.dim) for g in mine.split(widths, -1))


class _SumGradients(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model axis (a whole
    input that a sharded layer reads: each rank's gradient is partial)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mp: ModelParallel, float32: bool) -> torch.Tensor:
        ctx.mp = mp
        return x.float() if float32 and x.dtype != torch.float32 else x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        total = ctx.mp.all_reduce_(grad.to(torch.float32, copy=True).contiguous())
        return total.to(grad.dtype), None, None


def to_full(mp: ModelParallel | None, consumer: nn.Module, *parts: torch.Tensor,
            float32: bool = False) -> torch.Tensor:
    """The input of ``consumer`` (a Conv2d or Linear) made whole on the model
    axis: ``parts`` (this rank's features of each, or whole ones)
    concatenated on the feature dimension (1 of a conv's NCHW, the last of a
    linear's) in their global order. One process, or whole parts: the plain
    concatenation."""
    dim = _feature_dim(consumer)
    width = sum(p.shape[dim] for p in parts)
    if mp is None:
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    sharded = out_sharded(consumer)
    if width == _in_width(consumer):
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
        return _SumGradients.apply(x, mp, float32) if sharded and x.requires_grad else x
    if width * mp.size != _in_width(consumer):
        raise ValueError(f"an input of {width} features on {mp.size} model ranks for a layer of "
                         f"{_in_width(consumer)}")
    return _ToFull.apply(mp, sharded, float32 and sharded, dim, 1, *parts)


def gather_last(mp: ModelParallel | None, *parts: torch.Tensor, reduce: bool = False,
                heads: int = 1) -> torch.Tensor:
    """This rank's slices of the last dimension of ``parts`` made whole and
    concatenated (``_ToFull``): a head split of ``heads`` heads when
    ``heads`` > 1. ``reduce``: the whole tensor's consumer is sharded (its
    gradient on each rank is partial, and is summed over the axis);
    otherwise the consumer runs whole on every rank (a softmax over whole
    heads, the loss) and each rank's gradient is its slice of a whole one.
    One process: the concatenation."""
    if mp is None:
        return parts[0] if len(parts) == 1 else torch.cat(parts, -1)
    return _ToFull.apply(mp, reduce, False, -1, heads, *parts)


def gather_output(mp: ModelParallel | None, layer: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """The whole output of ``layer`` (a linear) from this rank's features of
    it, for a consumer that runs whole on every model rank (the loss):
    ``y`` itself where the layer is replicated or on one process."""
    return y if mp is None or not out_sharded(layer) else gather_last(mp, y)


class _Float32InputGrad(torch.autograd.Function):
    """A sharded conv's or linear's forward in its compute dtype (its own
    forward, ``nn.layers.flax_affine``); the backward gives its weight and
    bias gradients as that forward's would and its input gradient in
    float32, from the same low-precision operands (products exact, sums in
    float32): this rank's partial of the whole input's gradient, unrounded."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                layer: nn.Module) -> torch.Tensor:
        # The dtype of this forward: the backward runs after the caller's
        # ``computing_in`` block has given the layer its own dtype back.
        ctx.layer, ctx.dtype = layer, layer.dtype
        ctx.save_for_backward(x, weight, bias)
        return _affine(layer, x, weight, bias, ctx.dtype)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, weight, bias = ctx.saved_tensors
        layer, dtype = ctx.layer, ctx.dtype
        leaves = [t.detach().requires_grad_() for t in (weight, bias) if t is not None]
        with torch.enable_grad():
            out = _affine(layer, x.detach(), *leaves, *([None] * (bias is None)), dtype)
            param_grads = torch.autograd.grad(out, leaves, grad)
            x32 = x.detach().to(dtype).float().requires_grad_()
            out = layer.product(x32, weight.detach().to(dtype).float())
            (x_grad,) = torch.autograd.grad(out, x32, grad.float())
        return x_grad, param_grads[0], param_grads[1] if bias is not None else None, None


def _affine(layer: nn.Module, x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    from tinydiffusion_torch.nn.layers import flax_affine  # nn.layers imports this module

    return flax_affine(layer, x, weight, bias, dtype)


def apply_full_each(mp: ModelParallel | None, consumers: Sequence[nn.Module],
                    *parts: torch.Tensor) -> list[torch.Tensor]:
    """Each of ``consumers`` (layers of one input width, all sharded or all
    whole) on the input ``to_full`` makes whole once. For a bfloat16
    consumer (its ``dtype``) on a model axis, a sharded consumer computes
    its input gradient in float32 and the model axis sums those float32
    partials, rounding to the activations' dtype once after the sum: JAX's
    GSPMD step feeds each of its (float32) all-reduces from a float32
    convolution of the bf16 operands."""
    first = consumers[0]
    if mp is not None and len({out_sharded(c) for c in consumers}) > 1:
        raise ValueError("consumers of one gathered input must all be sharded or all whole")
    low = mp is not None and first.dtype != torch.float32
    if not (low and out_sharded(first) and torch.is_grad_enabled()):
        x = to_full(mp, first, *parts)
        return [c(x) for c in consumers]
    x = to_full(mp, first, *parts, float32=True)
    return [_Float32InputGrad.apply(x, c.weight, c.bias, c) for c in consumers]


def apply_full(mp: ModelParallel | None, consumer: nn.Module, *parts: torch.Tensor) -> torch.Tensor:
    """``consumer(to_full(mp, consumer, *parts))``, with the float32 input
    gradient of ``apply_full_each`` in bfloat16."""
    return apply_full_each(mp, (consumer,), *parts)[0]
