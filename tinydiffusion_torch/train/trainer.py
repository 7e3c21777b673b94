"""Diffusion training: one step for every model, and K steps over a
resident dataset.

Counterpart of ``tinydiffusion_tpu/train/trainer.py`` (``DiffusionTrainState``,
``create_train_state``, ``_ema_update``, ``_raw_step_fn``,
``make_resident_multi_step``; label dropout comes with the class-conditional
slice). Per batch: ``t ~ randint(0, T)``, q_sample, the model forward, the
MSE on eps (or v), the optimizer step, the BatchNorm running-stat update (in
the model's forward, flax's convention: ``nn.layers.BatchNorm2d``) and, when
asked, the EMA of the params.

The noise comes from the fused q_sample (``ops.qsample.q_sample_fused``: the
CUDA kernel on a card, its plain version on the CPU), which draws and noises
in one pass. The step never waits for the device: ``t`` and then the
kernel's seed come from the state's generator on the model's device, as JAX
draws both from the step's keys, and the loss comes back as a device tensor.
So a step reads nothing from the host that changes between steps, and the
resident step on a card runs as one CUDA graph, captured once and replayed.
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
) -> Callable:
    """``body(state, x0, t=None, noise=None) -> loss``: one step's device
    work, without the host's ``state.step`` count, so that a CUDA graph can
    capture it."""
    if prediction not in ("eps", "v"):
        raise ValueError(f"unknown prediction {prediction!r}; use 'eps' or 'v'")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} is not float32 or bfloat16")

    def body(state: DiffusionTrainState, x0: torch.Tensor, t=None, noise=None):
        model = state.model
        model.train()
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
        # cache_enabled=False: autocast's cache of cast weights may not
        # outlive a CUDA graph capture; each weight is cast once a step anyway.
        with torch.autocast(
            x0.device.type, dtype=compute_dtype, enabled=compute_dtype != torch.float32,
            cache_enabled=False,
        ):
            out = model(x_t, t)
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
) -> Callable:
    """The train step ``step(state, x0, t=None, noise=None) -> loss`` of an
    unconditional model.

    ``x0`` (B, C, H, W) float32 on the model's device. ``state`` is updated
    in place; the loss is a 0-d float32 device tensor (reading it syncs).
    ``t`` and ``noise``, when given, replace the step's own draws: the seam
    the tests use to give the port and the JAX package the same step.
    ``compute_dtype=torch.bfloat16`` runs the
    forward under ``torch.autocast``; the params and the loss stay float32.
    """
    body = _step_body(schedule, ema_decay, prediction, compute_dtype)

    def step(state: DiffusionTrainState, x0: torch.Tensor, t=None, noise=None):
        loss = body(state, x0, t, noise)
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


def make_resident_multi_step(
    schedule: DiffusionSchedule,
    dataset: DeviceDataset,
    ema_decay: float | None = None,
    prediction: str = "eps",
    compute_dtype: torch.dtype = torch.float32,
) -> Callable:
    """Train over a resident dataset: ``step(state, idxs) -> losses``, where
    ``idxs`` (K, B) are index batches from ``dataset.epoch_index_batches``
    and ``losses`` (K,) float32 stay on the device.

    Each of the K steps gathers its uint8 batch from ``dataset`` (NHWC, as in
    JAX), normalises it inside the step and runs ``make_train_step``'s
    per-batch logic: the same draws, in the same order, as the host path.

    On a card, one step is captured in a ``torch.cuda.CUDAGraph`` and
    replayed K times: the host does nothing between steps but launch the
    graph. Everything that changes from one step to the next is read from
    device memory: the position in the chunk, its index row, the ``t`` and
    seed draws (the state's generator, registered with the graph) and the
    loss slot it writes. The first ``GRAPH_WARMUP_STEPS`` steps of a state
    run eagerly on a side stream before the capture; a restore of the state
    (``restores``), another state or a larger chunk captures again. A failed
    capture raises: there is no fallback to eager steps. The graph keeps the
    math mode of its capture, so the caller turns TF32 off first
    (``device.disable_tf32``), and the optimizer must be built with
    ``capturable=True`` (Adam's step count then lives on the device).

    On the CPU, which has no graphs, the same step runs eagerly K times; there
    ``t`` (K, B) and ``noise`` (K, B, C, H, W) may replace the step's own
    draws, the seam through which the tests replay JAX's.
    """
    body = _step_body(schedule, ema_decay, prediction, compute_dtype)

    def one_step(state: DiffusionTrainState, chunk: _Chunk, t=None, noise=None) -> None:
        at = chunk.pos.view(1)
        x0 = dataset.gather(chunk.idxs.index_select(0, at)[0])
        loss = body(state, x0.permute(0, 3, 1, 2), t, noise)  # NHWC -> NCHW: C = 1, a view
        chunk.losses.index_copy_(0, at, loss.view(1))
        chunk.pos.add_(1)

    def new_chunk(idxs: torch.Tensor) -> _Chunk:
        device = dataset.device
        return _Chunk(idxs.to(device, non_blocking=True), torch.zeros((), dtype=torch.int64,
                      device=device), torch.zeros(len(idxs), dtype=torch.float32, device=device))

    captured: dict = {}  # the graph of one step and what it was captured for

    def step(state: DiffusionTrainState, idxs, t=None, noise=None) -> torch.Tensor:
        idxs = torch.as_tensor(idxs, dtype=torch.int64)
        k = len(idxs)
        if dataset.device.type != "cuda":
            chunk = new_chunk(idxs)
            for i in range(k):
                one_step(state, chunk, None if t is None else t[i],
                         None if noise is None else noise[i])
            state.step += k
            return chunk.losses
        if t is not None or noise is not None:
            raise ValueError("the (t, noise) seam runs on the CPU; a card replays its own draws")
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
        if done < k and "graph" not in captured:
            graph = torch.cuda.CUDAGraph()
            # The step draws t and its seed from the state's own generator. A
            # generator that is not registered fails the capture, or would
            # replay the captured draws every step; registered, each replay
            # advances it as an eager step does.
            graph.register_generator_state(state.generator)
            # The graph keeps the math mode of this capture: TF32 is off by now.
            before = qsample.qsample_captured
            with torch.cuda.graph(graph):
                one_step(state, chunk)
            captured["graph"] = graph
            captured["qsample_per_replay"] = qsample.qsample_captured - before
        for _ in range(k - done):
            captured["graph"].replay()
        qsample.count_replays(captured.get("qsample_per_replay", 0), k - done)
        state.step += k
        return chunk.losses[:k].clone()

    return step
