"""Diffusion training: one step for every model, K steps over a resident
dataset, and the validation loss.

Counterpart of ``tinydiffusion_tpu/train/trainer.py`` (``DiffusionTrainState``,
``create_train_state``, ``_ema_update``, ``_raw_step_fn``,
``make_resident_multi_step``, ``raw_eval_fn`` and ``make_eval_step`` (one
function here), ``make_resident_eval``, and the latent family's
``_raw_latent_step_fn``, ``make_latent_train_step``,
``make_resident_latent_multi_step``, ``raw_latent_eval_fn`` and
``make_latent_eval_step``). Per batch: ``t ~ randint(0, T)``,
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
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusion_torch.core.process import q_sample_with_noise, v_from_eps
from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.data.device import DeviceDataset
from tinydiffusion_torch.io.from_jax import jax_variables
from tinydiffusion_torch.ops import qsample
from tinydiffusion_torch.ops.qsample import q_sample_fused


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
        opt = sd["optimizer"]
        groups = [dict(saved, capturable=ours["capturable"]) if "capturable" in ours else saved
                  for saved, ours in zip(opt["param_groups"], self.optimizer.param_groups)]
        self.optimizer.load_state_dict(dict(opt, param_groups=groups))
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


def _step_body(
    schedule: DiffusionSchedule,
    ema_decay: float | None,
    prediction: str,
    compute_dtype: torch.dtype,
    conditional: bool = False,
    label_dropout: float = 0.0,
    null_label: int | None = None,
) -> Callable:
    """``body(state, x0, y=None, t=None, noise=None, keep=None) -> loss``:
    one step's device work, without the host's ``state.step`` count, so that
    a CUDA graph can capture it."""
    if prediction not in ("eps", "v"):
        raise ValueError(f"unknown prediction {prediction!r}; use 'eps' or 'v'")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} is not float32 or bfloat16")
    if label_dropout > 0 and (not conditional or null_label is None):
        raise ValueError("label_dropout requires conditional=True and a null_label")

    def body(state: DiffusionTrainState, x0: torch.Tensor, y=None, t=None, noise=None,
             keep=None):
        model = state.model
        model.train()
        if conditional and y is None:
            raise ValueError("a conditional step needs labels y")
        if t is None:
            t = torch.randint(
                0, schedule.num_timesteps, (x0.shape[0],), generator=state.generator,
                device=x0.device,
            )
        if noise is not None:
            x_t = q_sample_with_noise(schedule, x0, t, noise)
        else:
            # After t, from the same generator (JAX: t_key, then noise_key):
            # a device value that the kernel reads, never the host.
            seed = torch.randint(0, 2**31 - 1, (), generator=state.generator,
                                 device=x0.device)
            x_t, noise = q_sample_fused(schedule, x0, t, seed)
        if label_dropout > 0:
            # JAX's bernoulli(1 - p): a label is kept where its uniform
            # falls below 1 - p, and becomes the null class elsewhere.
            if keep is None:
                keep = torch.rand(y.shape, generator=state.generator,
                                  device=y.device) < 1.0 - label_dropout
            y = y.masked_fill(~keep, null_label)
        args = (y,) if conditional else ()
        # cache_enabled=False: autocast's cache of cast weights may not
        # outlive a CUDA graph capture; each weight is cast once a step anyway.
        with torch.autocast(
            x0.device.type, dtype=compute_dtype, enabled=compute_dtype != torch.float32,
            cache_enabled=False,
        ):
            out = model(x_t, t, *args)
        target = v_from_eps(schedule, x0, noise, t) if prediction == "v" else noise
        loss = F.mse_loss(out.float(), target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        if ema_decay is not None:
            _ema_update(state, ema_decay)
        return loss.detach()

    return body


def make_train_step(
    schedule: DiffusionSchedule,
    ema_decay: float | None = None,
    prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
    conditional: bool = False,
    label_dropout: float = 0.0,
    null_label: int | None = None,
) -> Callable:
    """The train step ``step(state, x0, y=None, t=None, noise=None,
    keep=None) -> loss``.

    ``x0`` (B, C, H, W) float32 on the model's device, and for a
    ``conditional`` model its integer labels ``y`` (B,). ``state`` is
    updated in place; the loss is a 0-d float32 device tensor (reading it
    syncs). ``t``, ``noise`` and ``keep`` (B,) bool, when given, replace the
    step's own draws: the seam the tests use to give the port and the JAX
    package the same step. ``label_dropout`` > 0 replaces each label by
    ``null_label`` where ``keep`` is False (drawn as JAX's Bernoulli of
    1 - ``label_dropout``). ``compute_dtype=torch.bfloat16`` runs the
    forward under ``torch.autocast``; the params and the loss stay float32.
    """
    body = _step_body(schedule, ema_decay, prediction, compute_dtype, conditional,
                      label_dropout, null_label)

    def step(state: DiffusionTrainState, x0: torch.Tensor, y=None, t=None, noise=None,
             keep=None):
        loss = body(state, x0, y, t, noise, keep)
        state.step += 1
        return loss

    return step


# Eager steps before a capture, on a side stream: the first creates the
# gradients and Adam's moments, and cuDNN settles its algorithms.
GRAPH_WARMUP_STEPS = 2


@dataclasses.dataclass
class _Chunk:
    """Device buffers of a chunk of steps: its index batches, the position
    of the next step and the losses. A captured step reads and writes these."""

    idxs: torch.Tensor  # (capacity, B) int64
    pos: torch.Tensor  # () int64
    losses: torch.Tensor  # (capacity,) float32


def make_resident_steps(dataset: DeviceDataset, batch_step: Callable) -> Callable:
    """K steps over a resident dataset: ``step(state, idxs, **seams) ->
    losses``, where ``idxs`` (K, B) are index batches from
    ``dataset.epoch_index_batches`` and ``losses`` (K,) float32 stay on the
    device. Step i gathers its batch from ``dataset`` (NHWC images, and
    labels when it holds them) and runs ``batch_step(state, batch,
    **seams_i) -> loss``, which must update ``state`` without reading a
    device value and leave ``state.step`` alone.

    On a card, one step is captured in a ``torch.cuda.CUDAGraph`` and
    replayed K times: the host does nothing between steps but launch the
    graph. Everything that changes from one step to the next is read from
    device memory: the position in the chunk, its index row, the draws (the
    state's generator, registered with the graph) and the loss slot it
    writes. The first ``GRAPH_WARMUP_STEPS`` steps of a state run eagerly on
    a side stream before the capture; a restore of the state (``restores``),
    another state or a larger chunk captures again. A failed capture raises:
    there is no fallback to eager steps. The graph keeps the math mode of its
    capture, so the caller turns TF32 off first (``device.disable_tf32``),
    and the optimizer must be built with ``capturable=True`` (Adam's step
    count then lives on the device; a tensor learning rate is read there at
    each replay).

    On the CPU, which has no graphs, the same step runs eagerly K times; there
    ``seams`` (name -> K-long sequence, or None) hand step i their i-th
    entries, the seam through which the tests replay JAX's draws.

    ``step.counts`` tallies the steps run ``eager`` (warm-ups, and every step
    on the CPU), the graph ``captures`` and the graph ``replays``.
    """

    def one_step(state, chunk: _Chunk, **seams) -> None:
        at = chunk.pos.view(1)
        loss = batch_step(state, dataset.gather(chunk.idxs.index_select(0, at)[0]), **seams)
        chunk.losses.index_copy_(0, at, loss.view(1))
        chunk.pos.add_(1)

    def new_chunk(idxs: torch.Tensor) -> _Chunk:
        device = dataset.device
        return _Chunk(idxs.to(device, non_blocking=True), torch.zeros((), dtype=torch.int64,
                      device=device), torch.zeros(len(idxs), dtype=torch.float32, device=device))

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
            return chunk.losses
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
        while done < k and captured["warm"] < GRAPH_WARMUP_STEPS:
            main = torch.cuda.current_stream(dataset.device)
            side = torch.cuda.Stream(dataset.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                one_step(state, chunk)
            main.wait_stream(side)
            captured["warm"] += 1
            done += 1
        counts["eager"] += done
        if done < k and "graph" not in captured:
            graph = torch.cuda.CUDAGraph()
            # The step draws from the state's own generator. A generator that
            # is not registered fails the capture, or would replay the
            # captured draws every step; registered, each replay advances it
            # as an eager step does.
            graph.register_generator_state(state.generator)
            # The graph keeps the math mode of this capture: TF32 is off by now.
            before = qsample.qsample_captured
            with torch.cuda.graph(graph):
                one_step(state, chunk)
            captured["graph"] = graph
            captured["qsample_per_replay"] = qsample.qsample_captured - before
            counts["captures"] += 1
        for _ in range(k - done):
            captured["graph"].replay()
        counts["replays"] += k - done
        qsample.count_replays(captured.get("qsample_per_replay", 0), k - done)
        state.step += k
        return chunk.losses[:k].clone()

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
) -> Callable:
    """Train over a resident dataset: ``step(state, idxs, t=None,
    noise=None, keep=None) -> losses`` (``make_resident_steps``).

    Each of the K steps gathers its uint8 batch (NHWC, as in JAX) and, for a
    ``conditional`` model, its label row from ``dataset``, normalises it
    inside the step and runs ``make_train_step``'s per-batch logic: the same
    draws (t, the q_sample seed and the label dropout), in the same order,
    as the host path. On the CPU ``t`` (K, B), ``noise`` (K, B, C, H, W) and
    ``keep`` (K, B) may replace them.
    """
    if conditional and dataset.labels is None:
        raise ValueError("a conditional resident step needs a DeviceDataset with labels")
    body = _step_body(schedule, ema_decay, prediction, compute_dtype, conditional,
                      label_dropout, null_label)

    def batch_step(state, batch, t=None, noise=None, keep=None):
        x0, y = batch if conditional else (batch, None)
        return body(state, x0.permute(0, 3, 1, 2), y, t, noise, keep)  # NCHW: C = 1, a view

    return make_resident_steps(dataset, batch_step)


def _eval_rng(key: tuple[int, int]) -> np.random.Generator:
    """The host generator of a validation batch's draws, from ``key`` = (base
    seed, fold), JAX's ``fold_in(PRNGKey(base seed), epoch * 10000 + i)``: a
    deterministic draw per (epoch, batch), so that every validation pass of
    a run, host-streamed or resident, is the same."""
    return np.random.default_rng([int(key[0]), int(key[1])])


def _eval_loss(model: nn.Module, schedule: DiffusionSchedule, x0: torch.Tensor,
               t_host: np.ndarray, seed: int, args: tuple, prediction: str,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """The loss of ``model`` in eval mode on ``x0`` noised by the fused
    q_sample at ``t_host`` and ``seed``."""
    t = torch.from_numpy(t_host).to(x0.device)
    x_t, noise = q_sample_fused(schedule, x0, t, seed)
    was_training = model.training
    model.eval()
    try:
        with torch.autocast(x0.device.type, dtype=compute_dtype,
                            enabled=compute_dtype != torch.float32):
            out = model(x_t, t, *args)
    finally:
        model.train(was_training)
    target = v_from_eps(schedule, x0, noise, t) if prediction == "v" else noise
    return F.mse_loss(out.float(), target)


def make_eval_step(
    schedule: DiffusionSchedule,
    conditional: bool = False,
    prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
) -> Callable:
    """The validation step ``eval_step(model, x0, key, y=None) -> loss``
    (JAX's ``raw_eval_fn`` and ``make_eval_step``; the reference's val pass,
    conditional_diffusion.py:274-292): one batch's loss, a 0-d float32
    device tensor, with the model in eval mode (the running BatchNorm
    statistics) and no gradients. ``key`` (base seed, fold) fixes t and then
    the fused q_sample's seed (``_eval_rng``), so a batch noised by the CUDA
    kernel on a card, or its plain version on the CPU, gets the same noise
    in every pass. ``prediction`` must match the training target."""
    if prediction not in ("eps", "v"):
        raise ValueError(f"unknown prediction {prediction!r}; use 'eps' or 'v'")

    @torch.no_grad()
    def eval_step(model: nn.Module, x0: torch.Tensor, key: tuple[int, int],
                  y=None) -> torch.Tensor:
        rng = _eval_rng(key)
        t_host, seed = rng.integers(0, schedule.num_timesteps, x0.shape[0]), int(
            rng.integers(0, 2**63))
        return _eval_loss(model, schedule, x0, t_host, seed, (y,) if conditional else (),
                          prediction, compute_dtype)

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
    on the device and scored by ``eval_step(model, x0, key, y)`` with the host
    loop's key ``(base_seed, epoch * fold_stride + i)``: the same batches,
    t and noise as the host-streamed pass, so the same losses to the bit."""

    def call(model: nn.Module, epoch: int, idxs) -> torch.Tensor:
        idxs = torch.as_tensor(idxs, dtype=torch.int64).to(dataset.device)
        losses = torch.empty(len(idxs), dtype=torch.float32, device=dataset.device)
        for i in range(len(idxs)):
            batch = dataset.gather(idxs[i])
            x0, y = batch if dataset.labels is not None else (batch, None)
            key = (base_seed, epoch * fold_stride + i)
            losses[i] = eval_step(model, x0.permute(0, 3, 1, 2), key, y)
        return losses

    return call


# --- the latent family: a frozen MNIST VAE in front of the denoiser ------------


def _latent_step_body(vae: nn.Module, schedule: DiffusionSchedule, ema_decay: float | None,
                      prediction: str, compute_dtype: torch.dtype) -> Callable:
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
        # The draws in JAX's split order (z_key, t_key, noise_key, drop_key),
        # all from the state's generator on the device.
        with torch.no_grad():  # the frozen VAE, float32
            mu, logvar = vae.encode(x0)
            if z_eps is None:
                z_eps = torch.randn(mu.shape, generator=gen, device=mu.device)
            z0 = vae.reparameterize(mu, logvar, z_eps)
        if t is None:
            t = torch.randint(0, schedule.num_timesteps, (z0.shape[0],), generator=gen,
                              device=z0.device)
        if noise is not None:
            z_t = q_sample_with_noise(schedule, z0, t, noise)
        else:
            seed = torch.randint(0, 2**31 - 1, (), generator=gen, device=z0.device)
            z_t, noise = q_sample_fused(schedule, z0, t, seed)
        options = {}
        draw_masks = getattr(model, "draw_dropout_masks", None)  # the DiT's
        if draw_masks is not None:
            options["dropout_masks"] = masks if masks is not None else draw_masks(
                z0.shape[0], gen)
        with torch.autocast(z0.device.type, dtype=compute_dtype,
                            enabled=compute_dtype != torch.float32, cache_enabled=False):
            out = model(z_t, t, y, **options)
        target = v_from_eps(schedule, z0, noise, t) if prediction == "v" else noise
        loss = F.mse_loss(out.float(), target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        if ema_decay is not None:
            _ema_update(state, ema_decay)
        return loss.detach()

    return body


def make_latent_train_step(
    vae: nn.Module,
    schedule: DiffusionSchedule,
    ema_decay: float | None = None,
    prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
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
    tests use to give the port JAX's draws.
    """
    body = _latent_step_body(vae, schedule, ema_decay, prediction, compute_dtype)

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
) -> Callable:
    """Latent training over a resident labelled dataset: ``step(state, idxs,
    z_eps=None, t=None, noise=None, masks=None) -> losses``
    (``make_resident_steps`` over ``make_latent_train_step``'s per-batch
    logic). On a card each step, the gather, the frozen encode and the
    q_sample launch included, is a replay of one CUDA graph; on the CPU the
    seams are K-long sequences of the step's own."""
    if dataset.labels is None:
        raise ValueError("a latent resident step needs a DeviceDataset with labels")
    body = _latent_step_body(vae, schedule, ema_decay, prediction, compute_dtype)

    def batch_step(state, batch, z_eps=None, t=None, noise=None, masks=None):
        x0, y = batch
        return body(state, x0, y, z_eps, t, noise, masks)

    return make_resident_steps(dataset, batch_step)


def make_latent_eval_step(
    vae: nn.Module,
    schedule: DiffusionSchedule,
    prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
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
        z_eps = torch.from_numpy(rng.standard_normal(mu.shape, np.float32)).to(mu.device)
        t_host, seed = rng.integers(0, schedule.num_timesteps, mu.shape[0]), int(
            rng.integers(0, 2**63))
        z0 = vae.reparameterize(mu, logvar, z_eps)
        return _eval_loss(model, schedule, z0, t_host, seed, (y,), prediction, compute_dtype)

    return eval_step
