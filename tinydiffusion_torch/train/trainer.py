"""Diffusion training: one step for every model.

Counterpart of ``tinydiffusion_tpu/train/trainer.py`` (``DiffusionTrainState``,
``create_train_state``, ``_ema_update``, ``_raw_step_fn``; label dropout comes
with the class-conditional slice). Per batch: ``t ~ randint(0, T)``,
q_sample, the model forward, the MSE on eps (or v), the optimizer step, the
BatchNorm running-stat update (in the model's forward, flax's convention:
``nn.layers.BatchNorm2d``) and, when asked, the EMA of the params.

The noise comes from the fused q_sample (``ops.qsample.q_sample_fused``: the
CUDA kernel on a card, its plain version on the CPU), which draws and noises
in one pass. The step runs eagerly and never waits for the device: ``t``
comes from a generator on the model's device, the kernel's seed from a
generator on the CPU (reading a device value would sync every step), and the
loss comes back as a device tensor.
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
from tinydiffusion_torch.io.from_jax import jax_variables
from tinydiffusion_torch.ops.qsample import q_sample_fused


@dataclasses.dataclass
class DiffusionTrainState:
    """Everything a step reads and writes; ``state_dict`` resumes it exactly."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # on the model's device: t
    seed_generator: torch.Generator  # on the CPU: the fused kernel's seed per step
    # EMA shadow of the model's parameters (name -> tensor), or None.
    ema_params: dict[str, torch.Tensor] | None = None
    step: int = 0

    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "ema_params": self.ema_params,
            "step": self.step,
            "generator": self.generator.get_state(),
            "seed_generator": self.seed_generator.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        if (sd["ema_params"] is None) != (self.ema_params is None):
            raise ValueError("the checkpoint and this state disagree on having an EMA")
        if self.ema_params is not None:
            with torch.no_grad():
                for name, e in self.ema_params.items():
                    e.copy_(sd["ema_params"][name])
        self.step = int(sd["step"])
        self.generator.set_state(sd["generator"])
        self.seed_generator.set_state(sd["seed_generator"])

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
        seed_generator=torch.Generator().manual_seed(seed + 1),
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
    if prediction not in ("eps", "v"):
        raise ValueError(f"unknown prediction {prediction!r}; use 'eps' or 'v'")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} is not float32 or bfloat16")

    def step(state: DiffusionTrainState, x0: torch.Tensor, t=None, noise=None):
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
            seed = int(torch.randint(0, 2**31 - 1, (), generator=state.seed_generator))
            x_t, noise = q_sample_fused(schedule, x0, t, seed)
        with torch.autocast(
            x0.device.type, dtype=compute_dtype, enabled=compute_dtype != torch.float32
        ):
            out = model(x_t, t)
        target = v_from_eps(schedule, x0, noise, t) if prediction == "v" else noise
        loss = F.mse_loss(out.float(), target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        if ema_decay is not None:
            _ema_update(state, ema_decay)
        state.step += 1
        return loss.detach()

    return step
