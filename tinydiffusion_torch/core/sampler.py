"""Ancestral DDPM reverse sampler.

Counterpart of the DDPM part of ``tinydiffusion_tpu/core/sampler.py``
(``_reverse_step_with_noise``, ``ddpm_sample``, ``ddpm_denoising_trajectory``).
Start from x ~ N(0, I); for t = T-1 .. 0 predict eps and update

    x <- 1/sqrt(alpha_t) * (x - (1-alpha_t)/sqrt(1-abar_t) * eps_hat)
         + sqrt(beta_t) * z,        z ~ N(0, I) for t > 0, none at t = 0.

(Variance beta_t, not the posterior sigma-tilde^2, as in the reference.)

The JAX package compiles the chain into one ``lax.scan``; here it is a
Python loop over t that never reads a device value, so the host only queues
work. The per-step coefficients are tables made once, and indexing them by
a Python int gives a device scalar without a copy. ``x_init`` and
``noise_stream`` replay given noise, as in JAX: ``noise_stream[0]`` belongs
to timestep T-1. DDIM, DPM-Solver++ and inpainting come with the serving
slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from tinydiffusion_torch.core.schedule import DiffusionSchedule

# apply_fn(x, t_vec) -> predicted noise; conditioning is closed over by the
# caller so one sampler serves all models.
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _coefficients(schedule: DiffusionSchedule) -> tuple[torch.Tensor, ...]:
    """(1/sqrt(alpha), (1-alpha)/sqrt(1-abar), sqrt(beta)) tables, (T,) each."""
    return (
        schedule.reciprocal_sqrt_alphas,
        (1.0 - schedule.alphas) * torch.rsqrt(1.0 - schedule.alphas_cumprod),
        schedule.sqrt_betas,
    )


def _reverse_step_with_noise(
    coef: tuple[torch.Tensor, ...],
    apply_fn: DenoiseFn,
    x: torch.Tensor,
    t: int,
    z: torch.Tensor | None,
) -> torch.Tensor:
    """One reverse update at timestep ``t`` with the step noise ``z`` (unused
    at t = 0)."""
    c_x, c_eps, sigma = coef
    t_vec = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
    eps_hat = apply_fn(x, t_vec).to(x.dtype)
    mean = c_x[t].to(x.dtype) * (x - c_eps[t].to(x.dtype) * eps_hat)
    if t == 0:
        return mean
    return mean + sigma[t].to(x.dtype) * z


def _chain(apply_fn, schedule, shape, generator, dtype, x_init, noise_stream, timesteps,
           keep_frames: bool) -> torch.Tensor:
    """Reverse steps at ``timesteps`` from ``x_init`` (or N(0, I)), each with
    its ``noise_stream`` entry (or a fresh draw); the final x, or every x."""
    if (x_init is None or noise_stream is None) and generator is None:
        raise ValueError("the sampler needs a generator unless x_init and noise_stream are given")
    device = schedule.betas.device
    coef = _coefficients(schedule)

    def normal():
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)

    x = x_init.to(device, dtype) if x_init is not None else normal()
    frames = []
    for i, t in enumerate(timesteps):
        if noise_stream is not None:
            z = noise_stream[i].to(device, dtype)
        else:
            z = normal() if t > 0 else None
        x = _reverse_step_with_noise(coef, apply_fn, x, t, z)
        if keep_frames:
            frames.append(x)
    return torch.stack(frames) if keep_frames else x


@torch.inference_mode()
def ddpm_sample(
    apply_fn: DenoiseFn,
    schedule: DiffusionSchedule,
    shape: tuple[int, ...],
    generator: torch.Generator | None = None,
    dtype: torch.dtype = torch.float32,
    x_init: torch.Tensor | None = None,
    noise_stream: torch.Tensor | None = None,
) -> torch.Tensor:
    """The full T-step ancestral chain: x_0 samples of ``shape``, on the
    schedule's device.

    ``generator`` (on that device) draws the initial noise and every step's
    noise unless ``x_init`` / ``noise_stream`` (T, *shape) give them.
    """
    timesteps = range(schedule.num_timesteps - 1, -1, -1)
    return _chain(apply_fn, schedule, shape, generator, dtype, x_init, noise_stream,
                  timesteps, keep_frames=False)


@torch.inference_mode()
def ddpm_denoising_trajectory(
    apply_fn: DenoiseFn,
    schedule: DiffusionSchedule,
    shape: tuple[int, ...],
    generator: torch.Generator | None = None,
    stride: int = 100,
    dtype: torch.dtype = torch.float32,
    x_init: torch.Tensor | None = None,
    noise_stream: torch.Tensor | None = None,
) -> torch.Tensor:
    """Coarse strided trajectory (the reference's
    ``visualize_denoising_process``): one reverse step at each t of
    T-stride, T-2*stride, .., >= 0, recording x after each. Returns
    (T // stride, *shape); ``noise_stream`` is (T // stride, *shape)."""
    stride = min(stride, schedule.num_timesteps)
    timesteps = range(schedule.num_timesteps - stride, -1, -stride)
    return _chain(apply_fn, schedule, shape, generator, dtype, x_init, noise_stream,
                  timesteps, keep_frames=True)
