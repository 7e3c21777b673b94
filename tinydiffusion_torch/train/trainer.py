"""Diffusion training: one step for every model, K steps over a resident
dataset, and the validation loss.

Counterpart of ``tinydiffusion_tpu/train/trainer.py`` (``DiffusionTrainState``,
``create_train_state``, ``_ema_update``, ``_raw_step_fn``,
``make_resident_multi_step``, ``raw_eval_fn`` and ``make_eval_step`` (one
function here), ``make_resident_eval``, and the latent family's
``_raw_latent_step_fn``, ``make_latent_train_step``,
``make_resident_latent_multi_step``, ``raw_latent_eval_fn`` and
``make_latent_eval_step``), and of the LAION text-conditional family's
step and eval step (``_laion_raw_step``, ``make_laion_resident_step`` and
``make_laion_eval_step`` of
``tinydiffusion_tpu/experiments/conditional_diffusion_laion.py``). Per batch: ``t ~ randint(0, T)``,
q_sample, for a class-conditional model with ``label_dropout`` each label
replaced by the null class at that rate (classifier-free-guidance
training), the model forward, the MSE on eps (or v), the optimizer step,
the BatchNorm running-stat update (in the model's forward, flax's
convention: ``nn.layers.BatchNorm2d``) and, when asked, the EMA of the
params.

The noise comes from the fused q_sample (``ops.qsample.q_sample_fused``: the
CUDA kernel on a card, its plain version on the CPU), which draws and noises
in one pass. The step never waits for the device: ``t``, the kernel's seed
and the label-dropout draw come from the state's generator on the model's
device, as JAX draws them from the step's keys, and the loss comes back as a
device tensor. So a step reads nothing from the host that changes between
steps, and the resident step on a card runs as one CUDA graph, captured once
and replayed (``make_resident_steps``, which any per-batch step can use).

Every step and eval step takes ``dp``, the data axis
(``parallel.mesh.DataParallel``; None is one device), and then computes the
one-device step on the global batch, as JAX's step does under GSPMD: the
step is given this rank's rows; it draws t, the label or caption dropout,
the reparameterising noise, the DiT's dropout masks and the SD codec's
Gaussian for the global batch from the generator (seeded alike on every
rank) and keeps its rows (a seam, when given, is the global batch's value
too); the fused q_sample draws its rows of the global stream
(``row_offset``); the BatchNorms normalise with the global statistics
(``parallel.mesh.sync_batch_norm_``); and the gradients and the loss are
reduced over the group in one collective before the clip and the optimizer.
On a card the collectives are captured in the step's CUDA graph.

The generic steps (``make_train_step``, ``make_resident_multi_step``: NCHW
images, or (B, D) latents as JAX's ``make_train_step`` takes them) also take
a ``mesh`` (``parallel.mesh.make_mesh``): its data axis is ``dp``, and its
model axis runs the model tensor-parallel (the UNet28, the MLP UNet, the
DiT), the state sharded by ``parallel.mesh.apply_sharding`` (JAX's
``state_sharding``). The draws, the q_sample rows and the loss are the data
row's, the same on every model rank; the gradients of sharded and
replicated parameters alike are reduced over the data axis, and a
replicated parameter's are first averaged over the model axis, so that its
copies stay equal. Any other model on a model axis of more than one rank
raises.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusion_torch.core.graphs import GRAPH_WARMUP_STEPS, capture, warm_up
from tinydiffusion_torch.core.process import q_sample_with_noise, v_from_eps
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.io.from_jax import jax_variables
from tinydiffusion_torch.nn.layers import computing_in
from tinydiffusion_torch.ops.qsample import q_sample_fused
from tinydiffusion_torch.parallel.mesh import (
    DataParallel,
    Mesh,
    average_replicated_grads_,
    global_batch,
    require_model_axis,
    row_offset,
    shard,
    sync_batch_norm_,
)


@dataclasses.dataclass
class DiffusionTrainState:
    """Everything a step reads and writes; ``state_dict`` resumes it exactly."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # on the model's device: t and the q_sample seed
    # EMA shadow of the model's parameters (name -> tensor), or None.
    ema_params: dict[str, torch.Tensor] | None = None
    step: int = 0
    # Bumped by ``load_state_dict``, which may swap tensors that a captured
    # CUDA graph reads: the resident step captures again when it changes.
    restores: int = 0

    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "ema_params": self.ema_params,
            "step": self.step,
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore a ``state_dict``. One written before the seed came from
        ``generator`` also holds ``seed_generator``, a CPU generator of the
        old per-step seed: nothing draws from it now, so it is ignored.

        The optimizer keeps its own ``capturable``: the saved param groups
        would replace it, and one written on the host path (or before the
        resident path) says False, which a captured step cannot run with.
        Kept True, torch moves Adam's step count to the device as it loads."""
        self.model.load_state_dict(sd["model"])
        load_optimizer_state_(self.optimizer, sd["optimizer"])
        if (sd["ema_params"] is None) != (self.ema_params is None):
            raise ValueError("the checkpoint and this state disagree on having an EMA")
        if self.ema_params is not None:
            with torch.no_grad():
                for name, e in self.ema_params.items():
                    e.copy_(sd["ema_params"][name])
        self.step = int(sd["step"])
        self.generator.set_state(sd["generator"])
        self.restores += 1

    def jax_weights(self) -> dict[str, np.ndarray]:
        """The serving subset in the JAX package's npz keys: ``params``,
        ``batch_stats``, ``ema_params`` (when kept) and ``step``."""
        flat = jax_variables(self.model)
        if self.ema_params is not None:
            ema = jax_variables(self.model, self.ema_params)
            flat.update({"ema_" + k: v for k, v in ema.items() if k.startswith("params/")})
        flat["step"] = np.asarray(self.step, np.int32)
        return flat


def load_optimizer_state_(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """``optimizer.load_state_dict(saved)``, keeping the optimizer's own
    ``capturable`` (``DiffusionTrainState.load_state_dict`` says why)."""
    groups = [dict(old, capturable=ours["capturable"]) if "capturable" in ours else old
              for old, ours in zip(saved["param_groups"], optimizer.param_groups)]
    optimizer.load_state_dict(dict(saved, param_groups=groups))


def create_train_state(
    model: nn.Module, optimizer: torch.optim.Optimizer, seed: int, ema: bool = False
) -> DiffusionTrainState:
    """The state of a run from ``model``'s current weights. ``ema=True`` adds
    a shadow of the params, equal to them at the start."""
    device = next(model.parameters()).device
    return DiffusionTrainState(
        model=model,
        optimizer=optimizer,
        generator=torch.Generator(device).manual_seed(seed),
        ema_params=(
            {n: p.detach().clone() for n, p in model.named_parameters()} if ema else None
        ),
    )


@torch.no_grad()
def _ema_update(state: DiffusionTrainState, ema_decay: float) -> None:
    """``ema <- d * ema + (1 - d) * params``, no bias correction: the shadow
    starts at the init params."""
    if state.ema_params is None:
        raise ValueError(
            "ema_decay set but the train state has no ema_params; "
            "build it with create_train_state(..., ema=True)"
        )
    names = list(state.ema_params)
    params = dict(state.model.named_parameters())
    ema = [state.ema_params[n] for n in names]
    torch._foreach_mul_(ema, ema_decay)
    torch._foreach_add_(ema, [params[n].detach() for n in names], alpha=1.0 - ema_decay)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm(max_norm)`` on the gradients, in place:
    ``g / norm * max_norm`` when the global norm reaches ``max_norm``, else
    ``g`` unchanged. (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
    norm and scales also below the bound.) No host sync. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones((), device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(one, max_norm)))
    return norm


def _scheduled_lr_(optimizer: torch.optim.Optimizer, schedule: Callable) -> None:
    """Write ``schedule(count)`` into each group's learning-rate tensor, in
    place, ``count`` being the group's update count before this update (the
    optimizer's own step tensor; 0 before its first step): optax's schedule
    read at the count before the increment. Device work only, so a captured
    step recomputes the rate at every replay."""
    for group in optimizer.param_groups:
        if not isinstance(group["lr"], torch.Tensor):
            raise TypeError("a scheduled learning rate needs the optimizer built with a "
                            "tensor lr, which the step writes in place")
        count = optimizer.state.get(group["params"][0], {}).get("step")
        if count is None:
            count = torch.zeros((), device=group["lr"].device)
        group["lr"].copy_(schedule(count.to(torch.float32)))


def _step_body(
    schedule: DiffusionSchedule,
    ema_decay: float | None,
    prediction: str,
    compute_dtype: torch.dtype,
    conditional: bool = False,
    label_dropout: float = 0.0,
    null_label: int | None = None,
    dp: DataParallel | None = None,
    mesh: Mesh | None = None,
) -> Callable:
    """``body(state, x0, y=None, t=None, noise=None, keep=None, masks=None)
    -> loss``: one step's device work, without the host's ``state.step``
    count, so that a CUDA graph can capture it."""
    if mesh is not None:
        if dp is not None:
            raise ValueError("give the data axis as dp or in the mesh, not both")
        dp = mesh.dp
    mp = None if mesh is None else mesh.mp
    if prediction not in ("eps", "v"):
        raise ValueError(f"unknown prediction {prediction!r}; use 'eps' or 'v'")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} is not float32 or bfloat16")
    if label_dropout > 0 and (not conditional or null_label is None):
        raise ValueError("label_dropout requires conditional=True and a null_label")
    checked = weakref.WeakSet()  # the models seen sharded on the mesh

    def body(state: DiffusionTrainState, x0: torch.Tensor, y=None, t=None, noise=None,
             keep=None, masks=None):
        model = state.model
        if mp is not None and model not in checked:
            check_model_axis(model, mesh)
            checked.add(model)
        model.train()
        sync_batch_norm_(model, dp)
        if conditional and y is None:
            raise ValueError("a conditional step needs labels y")
        n = global_batch(dp, x0.shape[0])
        # The draws in JAX's split order (t_key, noise_key, drop_key,
        # ldrop_key), all from the state's generator on the device.
        if t is None:
            t = torch.randint(0, schedule.num_timesteps, (n,), generator=state.generator,
                              device=x0.device)
        t = shard(dp, t)
        if noise is not None:
            noise = shard(dp, noise)
            x_t = q_sample_with_noise(schedule, x0, t, noise)
        else:
            # A device value that the kernel reads, never the host.
            seed = torch.randint(0, 2**31 - 1, (), generator=state.generator,
                                 device=x0.device)
            x_t, noise = q_sample_fused(schedule, x0, t, seed, row_offset(dp, x0.shape[0]))
        options = _dropout_options(model, masks, n, state.generator, dp)
        if label_dropout > 0:
            # JAX's bernoulli(1 - p): a label is kept where its uniform
            # falls below 1 - p, and becomes the null class elsewhere.
            if keep is None:
                keep = torch.rand((n,), generator=state.generator,
                                  device=y.device) < 1.0 - label_dropout
            y = y.masked_fill(~shard(dp, keep), null_label)
        args = (y,) if conditional else ()
        with computing_in(model, compute_dtype):
            out = model(x_t, t, *args, **options)
        target = v_from_eps(schedule, x0, noise, t) if prediction == "v" else noise
        loss = F.mse_loss(out.float(), target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        average_replicated_grads_(mp, model)
        loss = reduce_grads(dp, model, loss.detach())
        state.optimizer.step()
        if ema_decay is not None:
            _ema_update(state, ema_decay)
        return loss

    return body


def _dropout_options(model: nn.Module, masks, n: int, generator: torch.Generator,
                     dp: DataParallel | None) -> dict:
    """The model's ``dropout_masks`` keyword (the DiT's; {} for a model
    without them): ``masks``, or the global batch of ``n``'s drawn from
    ``generator`` (``draw_dropout_masks``), this rank's rows of them. The
    attention masks (1, 1, S, S) are the batch's; the others (B, S, D) have
    a row a sample (and a model rank keeps its features of them)."""
    draw_masks = getattr(model, "draw_dropout_masks", None)
    if draw_masks is None:
        return {}
    if masks is None:
        masks = draw_masks(n, generator)
    return {"dropout_masks": None if masks is None else [
        (attn, shard(dp, out), shard(dp, ff)) for attn, out, ff in masks]}


def check_model_axis(model: nn.Module, mesh: Mesh) -> None:
    """Raise unless ``model`` runs on ``mesh``'s model axis: a model the axis
    is ported for, sharded by ``apply_sharding`` on this mesh."""
    require_model_axis(model)
    if getattr(model, "model_parallel", None) != mesh.model:
        raise ValueError("the model is not sharded on this mesh: call "
                         "parallel.mesh.apply_sharding before the step")


def reduce_grads(dp: DataParallel | None, model: nn.Module, loss: torch.Tensor,
                 op: str = "mean") -> torch.Tensor:
    """Under data parallelism, the gradients and the loss averaged over the
    group (``op="sum"`` for a loss summed over the batch); the loss as it is
    on one device."""
    if dp is None:
        return loss
    (loss,) = dp.all_reduce_grads_(model.parameters(), loss, op=op)
    return loss


def make_train_step(
    schedule: DiffusionSchedule,
    ema_decay: float | None = None,
    prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
    conditional: bool = False,
    label_dropout: float = 0.0,
    null_label: int | None = None,
    dp: DataParallel | None = None,
    mesh: Mesh | None = None,
) -> Callable:
    """The train step ``step(state, x0, y=None, t=None, noise=None,
    keep=None, masks=None) -> loss`` (JAX's ``make_train_step``).

    ``x0`` (B, C, H, W) float32 images or (B, D) latents on the model's
    device, and for a ``conditional`` model its integer labels ``y`` (B,).
    ``state`` is updated in place; the loss is a 0-d float32 device tensor
    (reading it syncs). The draws come from ``state.generator`` in JAX's
    order: t, the q_sample seed, the DiT's dropout masks
    (``draw_dropout_masks``, where the model has them), the kept labels.
    ``t``, ``noise``, ``masks`` (the ``draw_dropout_masks`` layout) and
    ``keep`` (B,) bool, when given, replace them: the seam the tests use to
    give the port and the JAX package the same step. ``label_dropout`` > 0 replaces each label by
    ``null_label`` where ``keep`` is False (drawn as JAX's Bernoulli of
    1 - ``label_dropout``). ``compute_dtype=torch.bfloat16`` runs the
    model in bfloat16 as flax's ``dtype=`` does (``nn.layers.computing_in``);
    the params and the loss stay float32.
    With ``dp``, ``x0`` and ``y`` are this rank's rows, the seams the global
    batch's, and the loss the global one (see the module's docstring).
    ``mesh`` replaces ``dp`` with its data axis and adds its model axis, on
    which the model must be sharded (``parallel.mesh.apply_sharding``: the
    model carries its sharding, JAX's ``state_sharding``).
    """
    body = _step_body(schedule, ema_decay, prediction, compute_dtype, conditional,
                      label_dropout, null_label, dp, mesh)

    def step(state: DiffusionTrainState, x0: torch.Tensor, y=None, t=None, noise=None,
             keep=None, masks=None):
        loss = body(state, x0, y, t, noise, keep, masks)
        state.step += 1
        return loss

    return step


@dataclasses.dataclass
class _Chunk:
    """Device buffers of a chunk of steps: its index batches, the position
    of the next step and the losses. A captured step reads and writes these."""

    idxs: torch.Tensor  # (capacity, B) int64
    pos: torch.Tensor  # () int64
    losses: torch.Tensor  # (capacity,) float32
    outputs: dict[str, torch.Tensor]  # name -> (capacity,) float32


def make_resident_steps(dataset: DeviceDataset, batch_step: Callable,
                        outputs: tuple[str, ...] = ()) -> Callable:
    """K steps over a resident dataset: ``step(state, idxs, **seams) ->
    losses``, where ``idxs`` (K, B) are index batches from
    ``dataset.epoch_index_batches`` and ``losses`` (K,) float32 stay on the
    device. Step i gathers its batch from ``dataset`` (NHWC images, and
    the label and embedding rows it holds) and runs ``batch_step(state, batch,
    **seams_i) -> loss``, which must update ``state`` without reading a
    device value and leave ``state.step`` alone. With named ``outputs``,
    ``batch_step`` returns ``(loss, {name: 0-d tensor})`` and ``step``
    returns ``(losses, {name: (K,) float32})``: per-step device values
    beside the loss (JAX's ``n_extra_out``; the conv-VAE's loss components).

    On a card, one step is captured in a ``torch.cuda.CUDAGraph`` and
    replayed K times: the host does nothing between steps but launch the
    graph. Everything that changes from one step to the next is read from
    device memory: the position in the chunk, its index row, the draws (the
    state's generator, registered with the graph), a scheduled learning rate
    (computed on the device from the optimizer's step count) and the loss
    slot it writes. The first ``GRAPH_WARMUP_STEPS`` steps of a state run eagerly on
    a side stream before the capture (``core.graphs.warm_up`` and
    ``capture``, as the sampler chains' graphs do); a restore of the state
    (``restores``), another state or a larger chunk captures again. A failed capture raises:
    there is no fallback to eager steps. The graph keeps the math mode of its
    capture, so the caller turns TF32 off first (``device.disable_tf32``),
    and the optimizer must be built with ``capturable=True`` (Adam's step
    count then lives on the device; a tensor learning rate is read there at
    each replay).

    On the CPU, which has no graphs, the same step runs eagerly K times; there
    ``seams`` (name -> K-long sequence, or None) hand step i their i-th
    entries, the seam through which the tests replay JAX's draws.

    ``step.counts`` tallies the steps run ``eager`` (warm-ups, and every step
    on the CPU), the graph ``captures`` and the graph ``replays``. Kernel
    launches recorded in the graph (q_sample, flash attention) count once a
    replay in their modules' launch counts.
    """

    def one_step(state, chunk: _Chunk, **seams) -> None:
        at = chunk.pos.view(1)
        out = batch_step(state, dataset.gather(chunk.idxs.index_select(0, at)[0]), **seams)
        loss, values = out if outputs else (out, {})
        chunk.losses.index_copy_(0, at, loss.view(1))
        for name in outputs:
            chunk.outputs[name].index_copy_(0, at, values[name].reshape(1).float())
        chunk.pos.add_(1)

    def new_chunk(idxs: torch.Tensor) -> _Chunk:
        device = dataset.device

        def zeros():
            return torch.zeros(len(idxs), dtype=torch.float32, device=device)

        return _Chunk(idxs.to(device, non_blocking=True),
                      torch.zeros((), dtype=torch.int64, device=device), zeros(),
                      {name: zeros() for name in outputs})

    def result(chunk: _Chunk, k: int):
        losses = chunk.losses[:k].clone()
        if not outputs:
            return losses
        return losses, {name: v[:k].clone() for name, v in chunk.outputs.items()}

    captured: dict = {}  # the graph of one step and what it was captured for
    counts = {"eager": 0, "captures": 0, "replays": 0}

    def step(state, idxs, **seams) -> torch.Tensor:
        idxs = torch.as_tensor(idxs, dtype=torch.int64)
        k = len(idxs)
        seams = {name: v for name, v in seams.items() if v is not None}
        if dataset.device.type != "cuda":
            chunk = new_chunk(idxs)
            for i in range(k):
                one_step(state, chunk, **{name: v[i] for name, v in seams.items()})
            state.step += k
            counts["eager"] += k
            return result(chunk, k)
        if seams:
            raise ValueError(f"the seams {sorted(seams)} run on the CPU; a card replays its "
                             "own draws")
        key = (id(state), state.restores, idxs.shape[1])
        if captured.get("key") != key or captured["chunk"].idxs.shape[0] < k:
            captured.clear()  # frees the old graph's memory pool
            # The state is held too, so that its id is not reused.
            captured.update(key=key, state=state, chunk=new_chunk(idxs), warm=0)
        chunk = captured["chunk"]
        chunk.idxs[:k].copy_(idxs.pin_memory(), non_blocking=True)
        chunk.pos.zero_()
        done = 0
        # The first steps of a state create its gradients and Adam's moments.
        while done < k and captured["warm"] < GRAPH_WARMUP_STEPS:
            warm_up(lambda: one_step(state, chunk), dataset.device)
            captured["warm"] += 1
            done += 1
        counts["eager"] += done
        if done < k and "graph" not in captured:
            # The step draws from the state's own generator, registered with
            # the graph, so that each replay advances it as an eager step does.
            # The graph keeps the math mode of this capture: TF32 is off by now.
            captured["graph"] = capture(lambda: one_step(state, chunk), dataset.device,
                                        (state.generator,))
            counts["captures"] += 1
        if done < k:
            captured["graph"].replay(k - done)
        counts["replays"] += k - done
        state.step += k
        return result(chunk, k)

    step.counts = counts
    return step


def make_resident_multi_step(
    schedule: DiffusionSchedule,
    dataset: DeviceDataset,
    ema_decay: float | None = None,
    prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
    conditional: bool = False,
    label_dropout: float = 0.0,
    null_label: int | None = None,
    dp: DataParallel | None = None,
    mesh: Mesh | None = None,
) -> Callable:
    """Train over a resident dataset: ``step(state, idxs, t=None,
    noise=None, keep=None, masks=None) -> losses`` (``make_resident_steps``).

    Each of the K steps gathers its uint8 batch (NHWC images, as in JAX, or
    (N, D) rows, normalised to (B, D) latents) and, for a ``conditional``
    model, its label row from ``dataset``, normalises it inside the step and
    runs ``make_train_step``'s per-batch logic: the same draws (t, the
    q_sample seed, the DiT's dropout masks and the label dropout), in the
    same order, as the host path. On the CPU ``t`` (K, B), ``noise`` (K, B,
    ...), ``masks`` (K of the ``draw_dropout_masks`` layout) and ``keep``
    (K, B) may replace them. With ``dp``, ``idxs`` are this rank's
    columns of the epoch's index batches; ``mesh`` as in ``make_train_step``
    (every model rank of a data row takes the same columns).
    """
    if conditional and dataset.labels is None:
        raise ValueError("a conditional resident step needs a DeviceDataset with labels")
    body = _step_body(schedule, ema_decay, prediction, compute_dtype, conditional,
                      label_dropout, null_label, dp, mesh)

    def batch_step(state, batch, t=None, noise=None, keep=None, masks=None):
        x0, y = batch if conditional else (batch, None)
        if x0.dim() == 4:
            x0 = x0.permute(0, 3, 1, 2)  # NCHW: C = 1, a view
        return body(state, x0, y, t, noise, keep, masks)

    return make_resident_steps(dataset, batch_step)


def _eval_rng(key: tuple[int, int]) -> np.random.Generator:
    """The host generator of a validation batch's draws, from ``key`` = (base
    seed, fold), JAX's ``fold_in(PRNGKey(base seed), epoch * 10000 + i)``: a
    deterministic draw per (epoch, batch), so that every validation pass of
    a run, host-streamed or resident, is the same."""
    return np.random.default_rng([int(key[0]), int(key[1])])


def keyed_normal(key: tuple[int, int], shape: tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """Standard normal float32 noise of ``shape`` on ``device``, drawn on the
    host from ``_eval_rng(key)``: a validation batch's reparameterising noise,
    the same in every pass."""
    return torch.from_numpy(_eval_rng(key).standard_normal(shape, np.float32)).to(device)


def _eval_draws(rng: np.random.Generator, schedule: DiffusionSchedule,
                dp: DataParallel | None, b: int) -> tuple[np.ndarray, int]:
    """t (this rank's rows of the global batch's) and the q_sample seed of a
    validation batch, in that order from ``rng``."""
    t_host = rng.integers(0, schedule.num_timesteps, global_batch(dp, b))
    seed = int(rng.integers(0, 2**63))
    return t_host[row_offset(dp, b):row_offset(dp, b) + b], seed


def _eval_loss(model: nn.Module, schedule: DiffusionSchedule, x0: torch.Tensor,
               t_host: np.ndarray, seed: int, args: tuple, prediction: str,
               compute_dtype: torch.dtype, dp: DataParallel | None = None) -> torch.Tensor:
    """The loss of ``model`` in eval mode on ``x0`` noised by the fused
    q_sample at ``t_host`` and ``seed`` (the global batch's under ``dp``)."""
    t = torch.from_numpy(t_host).to(x0.device)
    x_t, noise = q_sample_fused(schedule, x0, t, seed, row_offset(dp, x0.shape[0]))
    was_training = model.training
    model.eval()
    try:
        with computing_in(model, compute_dtype):
            out = model(x_t, t, *args)
    finally:
        model.train(was_training)
    target = v_from_eps(schedule, x0, noise, t) if prediction == "v" else noise
    loss = F.mse_loss(out.float(), target)
    return loss if dp is None else dp.all_reduce_(loss, "mean")


def make_eval_step(
    schedule: DiffusionSchedule,
    conditional: bool = False,
    prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
    dp: DataParallel | None = None,
) -> Callable:
    """The validation step ``eval_step(model, x0, key, y=None) -> loss``
    (JAX's ``raw_eval_fn`` and ``make_eval_step``; the reference's val pass,
    conditional_diffusion.py:274-292): one batch's loss, a 0-d float32
    device tensor, with the model in eval mode (the running BatchNorm
    statistics) and no gradients. ``key`` (base seed, fold) fixes t and then
    the fused q_sample's seed (``_eval_rng``), so a batch noised by the CUDA
    kernel on a card, or its plain version on the CPU, gets the same noise
    in every pass. ``prediction`` must match the training target. With
    ``dp``, ``x0`` is this rank's rows and the loss the global batch's."""
    if prediction not in ("eps", "v"):
        raise ValueError(f"unknown prediction {prediction!r}; use 'eps' or 'v'")

    @torch.no_grad()
    def eval_step(model: nn.Module, x0: torch.Tensor, key: tuple[int, int],
                  y=None) -> torch.Tensor:
        t_host, seed = _eval_draws(_eval_rng(key), schedule, dp, x0.shape[0])
        return _eval_loss(model, schedule, x0, t_host, seed, (y,) if conditional else (),
                          prediction, compute_dtype, dp)

    return eval_step


def make_resident_eval(
    eval_step: Callable,
    dataset: DeviceDataset,
    base_seed: int,
    fold_stride: int = 10000,
) -> Callable:
    """The validation pass over a resident split: ``call(model, epoch, idxs)
    -> (G,) losses`` on the device, one host read for the whole pass.

    Batch i of ``idxs`` (from ``dataset.epoch_index_batches``) is gathered
    on the device and scored by ``eval_step(model, x0, key, *rows)`` (``rows``:
    the labels and/or text embeddings the dataset holds) with the host
    loop's key ``(base_seed, epoch * fold_stride + i)``: the same batches,
    t and noise as the host-streamed pass, so the same losses to the bit."""

    def call(model: nn.Module, epoch: int, idxs) -> torch.Tensor:
        idxs = torch.as_tensor(idxs, dtype=torch.int64).to(dataset.device)
        losses = torch.empty(len(idxs), dtype=torch.float32, device=dataset.device)
        for i in range(len(idxs)):
            batch = dataset.gather(idxs[i])
            x0, *rows = batch if isinstance(batch, tuple) else (batch,)
            key = (base_seed, epoch * fold_stride + i)
            losses[i] = eval_step(model, x0.permute(0, 3, 1, 2), key, *rows)
        return losses

    return call


# --- the latent family: a frozen MNIST VAE in front of the denoiser ------------


def _latent_step_body(vae: nn.Module, schedule: DiffusionSchedule, ema_decay: float | None,
                      prediction: str, compute_dtype: torch.dtype,
                      dp: DataParallel | None = None) -> Callable:
    """``body(state, x0, y, z_eps=None, t=None, noise=None, masks=None) ->
    loss``: one latent step's device work (JAX's ``_raw_latent_step_fn``),
    without the host's ``state.step`` count, so that a CUDA graph can
    capture it."""
    if prediction not in ("eps", "v"):
        raise ValueError(f"unknown prediction {prediction!r}; use 'eps' or 'v'")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} is not float32 or bfloat16")

    def body(state: DiffusionTrainState, x0: torch.Tensor, y: torch.Tensor, z_eps=None,
             t=None, noise=None, masks=None):
        model, gen = state.model, state.generator
        model.train()
        sync_batch_norm_(model, dp)
        n = global_batch(dp, x0.shape[0])
        # The draws in JAX's split order (z_key, t_key, noise_key, drop_key),
        # all from the state's generator on the device.
        with torch.no_grad():  # the frozen VAE, float32
            mu, logvar = vae.encode(x0)
            if z_eps is None:
                z_eps = torch.randn((n, *mu.shape[1:]), generator=gen, device=mu.device)
            z0 = vae.reparameterize(mu, logvar, shard(dp, z_eps))
        if t is None:
            t = torch.randint(0, schedule.num_timesteps, (n,), generator=gen, device=z0.device)
        t = shard(dp, t)
        if noise is not None:
            noise = shard(dp, noise)
            z_t = q_sample_with_noise(schedule, z0, t, noise)
        else:
            seed = torch.randint(0, 2**31 - 1, (), generator=gen, device=z0.device)
            z_t, noise = q_sample_fused(schedule, z0, t, seed, row_offset(dp, z0.shape[0]))
        options = _dropout_options(model, masks, n, gen, dp)
        with computing_in(model, compute_dtype):
            out = model(z_t, t, y, **options)
        target = v_from_eps(schedule, z0, noise, t) if prediction == "v" else noise
        loss = F.mse_loss(out.float(), target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = reduce_grads(dp, model, loss.detach())
        state.optimizer.step()
        if ema_decay is not None:
            _ema_update(state, ema_decay)
        return loss

    return body


def make_latent_train_step(
    vae: nn.Module,
    schedule: DiffusionSchedule,
    ema_decay: float | None = None,
    prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
    dp: DataParallel | None = None,
) -> Callable:
    """The latent train step ``step(state, x0, y, z_eps=None, t=None,
    noise=None, masks=None) -> loss`` (JAX's ``make_latent_train_step``; the
    reference's latent_diffusion.py:201-224).

    ``x0`` (B, 1, 28, 28) float32 images in [-1, 1] and their labels ``y``
    on the model's device. The frozen ``vae`` (``models.vae_mnist.VAEMnist``,
    float32) encodes and reparameterises them without a gradient; the
    (B, latent_dim) latents are noised by the fused q_sample (the CUDA
    kernel on a card, its plain version on the CPU) and the class-conditional
    denoiser (``state.model``: the MLP UNet or the DiT, whose dropout masks
    the step draws) is trained on eps (or v) under ``compute_dtype``. The
    draws come from ``state.generator`` in JAX's order: the reparameterising
    noise, t, the q_sample seed, the dropout masks. ``z_eps`` (B,
    latent_dim), ``t``, ``noise`` (B, latent_dim) and ``masks`` (the DiT's
    ``draw_dropout_masks`` layout), when given, replace them: the seam the
    tests use to give the port JAX's draws. ``dp`` as in ``make_train_step``.
    """
    body = _latent_step_body(vae, schedule, ema_decay, prediction, compute_dtype, dp)

    def step(state: DiffusionTrainState, x0, y, z_eps=None, t=None, noise=None, masks=None):
        loss = body(state, x0, y, z_eps, t, noise, masks)
        state.step += 1
        return loss

    return step


def make_resident_latent_multi_step(
    vae: nn.Module,
    schedule: DiffusionSchedule,
    dataset: DeviceDataset,
    ema_decay: float | None = None,
    prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
    dp: DataParallel | None = None,
) -> Callable:
    """Latent training over a resident labelled dataset: ``step(state, idxs,
    z_eps=None, t=None, noise=None, masks=None) -> losses``
    (``make_resident_steps`` over ``make_latent_train_step``'s per-batch
    logic). On a card each step, the gather, the frozen encode and the
    q_sample launch included, is a replay of one CUDA graph; on the CPU the
    seams are K-long sequences of the step's own."""
    if dataset.labels is None:
        raise ValueError("a latent resident step needs a DeviceDataset with labels")
    body = _latent_step_body(vae, schedule, ema_decay, prediction, compute_dtype, dp)

    def batch_step(state, batch, z_eps=None, t=None, noise=None, masks=None):
        x0, y = batch
        return body(state, x0, y, z_eps, t, noise, masks)

    return make_resident_steps(dataset, batch_step)


def make_latent_eval_step(
    vae: nn.Module,
    schedule: DiffusionSchedule,
    prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
    dp: DataParallel | None = None,
) -> Callable:
    """The latent validation step ``eval_step(model, x0, key, y) -> loss``
    (JAX's ``raw_latent_eval_fn`` / ``make_latent_eval_step``; the
    reference's latent_diffusion.py:231-249): ``make_eval_step`` on the
    frozen VAE's latents. ``key`` fixes, in JAX's split order, the
    reparameterising noise (B, latent_dim), t and the q_sample seed."""
    if prediction not in ("eps", "v"):
        raise ValueError(f"unknown prediction {prediction!r}; use 'eps' or 'v'")

    @torch.no_grad()
    def eval_step(model: nn.Module, x0: torch.Tensor, key: tuple[int, int],
                  y: torch.Tensor) -> torch.Tensor:
        rng = _eval_rng(key)
        mu, logvar = vae.encode(x0)
        b = mu.shape[0]
        z_eps = rng.standard_normal((global_batch(dp, b), *mu.shape[1:]), np.float32)
        z_eps = torch.from_numpy(z_eps[row_offset(dp, b):row_offset(dp, b) + b]).to(mu.device)
        t_host, seed = _eval_draws(rng, schedule, dp, b)
        z0 = vae.reparameterize(mu, logvar, z_eps)
        return _eval_loss(model, schedule, z0, t_host, seed, (y,), prediction, compute_dtype, dp)

    return eval_step


# --- the LAION text-conditional family: a frozen codec (the patch codec or the
# SD-VAE) in front of the latent UNet ---------------------------------------------


def _laion_step_body(codec, schedule: DiffusionSchedule, lr_schedule: Callable,
                     clip_norm: float, ema_decay: float | None, compute_dtype: torch.dtype,
                     caption_dropout: float, null_embed: torch.Tensor | None,
                     dp: DataParallel | None = None) -> Callable:
    """``body(state, images, embeds, t=None, noise=None, keep=None,
    enc_noise=None) -> loss``: one LAION step's device work (JAX's
    ``_laion_raw_step``), without the host's ``state.step`` count, so that a
    CUDA graph can capture it."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} is not float32 or bfloat16")
    if caption_dropout > 0 and null_embed is None:
        raise ValueError("caption_dropout requires a null_embed")

    def body(state: DiffusionTrainState, images: torch.Tensor, embeds: torch.Tensor, t=None,
             noise=None, keep=None, enc_noise=None):
        model, gen = state.model, state.generator
        model.train()
        sync_batch_norm_(model, dp)
        n = global_batch(dp, images.shape[0])
        # The draws from the state's generator: the codec's Gaussian (the SD
        # codec's only; the patch codec draws nothing), t, the q_sample seed,
        # then the caption dropout. The encode runs in float32, on the
        # codec's float32 weights, whatever the denoiser's compute dtype.
        if dp is not None and enc_noise is None:
            shape = codec.noise_shape(images)
            if shape is not None:
                enc_noise = torch.randn((n, *shape[1:]), generator=gen, device=images.device)
        with torch.no_grad():
            x0 = codec.encode(images, noise=shard(dp, enc_noise), generator=gen)
        if t is None:
            t = torch.randint(0, schedule.num_timesteps, (n,), generator=gen, device=x0.device)
        t = shard(dp, t)
        if noise is not None:
            noise = shard(dp, noise)
            x_t = q_sample_with_noise(schedule, x0, t, noise)
        else:
            seed = torch.randint(0, 2**31 - 1, (), generator=gen, device=x0.device)
            x_t, noise = q_sample_fused(schedule, x0, t, seed, row_offset(dp, x0.shape[0]))
        if caption_dropout > 0:
            # JAX's bernoulli(1 - p): a row is kept where its uniform falls
            # below 1 - p, and becomes the empty-string embedding elsewhere.
            if keep is None:
                keep = torch.rand(n, generator=gen, device=embeds.device) < 1.0 - caption_dropout
            embeds = torch.where(shard(dp, keep)[:, None], embeds, null_embed.to(embeds.dtype))
        with computing_in(model, compute_dtype):
            out = model(x_t, t, embeds)
        loss = F.mse_loss(out.float(), noise)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = reduce_grads(dp, model, loss.detach())
        clip_by_global_norm_(model.parameters(), clip_norm)
        _scheduled_lr_(state.optimizer, lr_schedule)
        state.optimizer.step()
        if ema_decay is not None:
            _ema_update(state, ema_decay)
        return loss

    return body


def make_laion_train_step(
    codec,
    schedule: DiffusionSchedule,
    lr_schedule: Callable,
    clip_norm: float = 10.0,
    ema_decay: float | None = None,
    compute_dtype: torch.dtype = torch.float32,
    caption_dropout: float = 0.0,
    null_embed: torch.Tensor | None = None,
    dp: DataParallel | None = None,
) -> Callable:
    """The LAION train step ``step(state, images, embeds, t=None, noise=None,
    keep=None, enc_noise=None) -> loss`` (JAX's ``make_laion_train_step``;
    the reference's conditional_diffusion_laion.py:441-473).

    ``images`` (B, 3, S, S) float32 in [-1, 1] and their text embeddings
    ``embeds`` (B, D) on the model's device. The frozen ``codec``
    (``compat.latent_codec.LinearPatchCodec`` or ``compat.sdvae.SDVAECodec``,
    on that device) encodes them to (B, 4, S/8, S/8) latents (the SD codec
    samples them, the reference's ``latent_dist.sample()``), which the fused
    q_sample noises (the CUDA kernel on a card, its plain version on the
    CPU); the latent UNet
    (``state.model``) is trained on eps under ``compute_dtype``; the
    gradients are clipped to ``clip_norm`` by optax's rule, the learning
    rate set to ``lr_schedule(count)`` (on the device, from the optimizer's
    update count: the optimizer needs a tensor lr) and the optimizer steps.
    ``caption_dropout`` > 0 replaces each embedding row by ``null_embed``
    (D,), the empty-string embedding, where ``keep`` is False. The draws come
    from ``state.generator``, in this order: the SD codec's standard normal
    (B, 4, S/8, S/8), t, the q_sample seed, ``keep``; ``enc_noise``, ``t``
    (B,), ``noise`` (B, 4, S/8, S/8) and ``keep`` (B,) bool, when given,
    replace them: the seam the tests use to give the port JAX's draws
    (JAX's ``enc_key`` draw, transposed to NCHW, is ``enc_noise``). ``dp``
    as in ``make_train_step``: the gradients are reduced before the clip.
    """
    body = _laion_step_body(codec, schedule, lr_schedule, clip_norm, ema_decay, compute_dtype,
                            caption_dropout, null_embed, dp)

    def step(state: DiffusionTrainState, images, embeds, t=None, noise=None, keep=None,
             enc_noise=None):
        loss = body(state, images, embeds, t, noise, keep, enc_noise)
        state.step += 1
        return loss

    return step


def make_resident_laion_multi_step(
    codec,
    schedule: DiffusionSchedule,
    dataset: DeviceDataset,
    lr_schedule: Callable,
    clip_norm: float = 10.0,
    ema_decay: float | None = None,
    compute_dtype: torch.dtype = torch.float32,
    caption_dropout: float = 0.0,
    null_embed: torch.Tensor | None = None,
    dp: DataParallel | None = None,
) -> Callable:
    """LAION training over a resident set of images and text embeddings:
    ``step(state, idxs, t=None, noise=None, keep=None, enc_noise=None) ->
    losses`` (``make_resident_steps`` over ``make_laion_train_step``'s
    per-batch logic; JAX's ``make_laion_resident_step``). On a card each
    step, the gather, the codec's encode (the SD codec's Gaussian drawn from
    the state's generator, which the graph registers), the q_sample launch,
    the clip and the rate included, is a replay of one CUDA graph; on the
    CPU the seams are K-long sequences of the step's own."""
    if dataset.embeds is None or dataset.labels is not None:
        raise ValueError("a LAION resident step needs a DeviceDataset of images and embeds")
    body = _laion_step_body(codec, schedule, lr_schedule, clip_norm, ema_decay, compute_dtype,
                            caption_dropout, null_embed, dp)

    def batch_step(state, batch, t=None, noise=None, keep=None, enc_noise=None):
        images, embeds = batch
        return body(state, images.permute(0, 3, 1, 2), embeds, t, noise, keep, enc_noise)

    return make_resident_steps(dataset, batch_step)


def make_laion_eval_step(codec, schedule: DiffusionSchedule,
                         compute_dtype: torch.dtype = torch.float32,
                         dp: DataParallel | None = None) -> Callable:
    """The LAION validation step ``eval_step(model, images, key, embeds) ->
    loss`` (JAX's ``make_laion_eval_step``; the reference's
    conditional_diffusion_laion.py:499-530): ``make_eval_step`` on the
    codec's latents, the text embeddings as the model's context. ``key``
    (base seed, fold) fixes, in this order, t, the q_sample seed and the
    seed of the generator that the SD codec's Gaussian is drawn from (JAX's
    ``enc_key``; the patch codec draws nothing): every pass scores a batch
    on the same draws."""

    @torch.no_grad()
    def eval_step(model: nn.Module, images: torch.Tensor, key: tuple[int, int],
                  embeds: torch.Tensor) -> torch.Tensor:
        rng = _eval_rng(key)
        t_host, seed = _eval_draws(rng, schedule, dp, images.shape[0])
        enc_gen = torch.Generator(images.device).manual_seed(int(rng.integers(0, 2**63)))
        enc_noise = None
        shape = codec.noise_shape(images) if dp is not None else None
        if shape is not None:  # the global batch's Gaussian, this rank's rows
            enc_noise = shard(dp, torch.randn((global_batch(dp, images.shape[0]), *shape[1:]),
                                              generator=enc_gen, device=images.device))
        latents = codec.encode(images, noise=enc_noise, generator=enc_gen)
        return _eval_loss(model, schedule, latents, t_host, seed, (embeds,), "eps",
                          compute_dtype, dp)

    return eval_step
