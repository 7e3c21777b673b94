"""Closed-form forward (noising) process q(x_t | x_0).

Counterpart of ``tinydiffusion_tpu/core/process.py``: draw eps ~ N(0, I) and
return ``(sqrt(abar_t) * x_0 + sqrt(1 - abar_t) * eps, eps)``, with the
per-sample scalars broadcast over the trailing dims of ``x_0`` (images
(B, C, H, W) here, latents (B, D)). ``t`` is an integer tensor (B,) on the
tables' device.
"""

from __future__ import annotations

import torch

from tinydiffusion_torch.core.schedule import DiffusionSchedule


def _per_sample(table: torch.Tensor, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return table[t].reshape((-1,) + (1,) * (like.dim() - 1)).to(like.dtype)


def q_sample(
    schedule: DiffusionSchedule,
    x_0: torch.Tensor,
    t: torch.Tensor,
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample x_t ~ q(x_t | x_0) with noise from ``generator`` (on x_0's
    device); returns (x_t, noise)."""
    noise = torch.randn(x_0.shape, generator=generator, device=x_0.device, dtype=x_0.dtype)
    return q_sample_with_noise(schedule, x_0, t, noise), noise


def q_sample_with_noise(
    schedule: DiffusionSchedule,
    x_0: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """Deterministic q_sample given the noise: the replay seam of the tests."""
    sqrt_ac = _per_sample(schedule.sqrt_alphas_cumprod, t, x_0)
    sqrt_1m_ac = _per_sample(schedule.sqrt_one_minus_alphas_cumprod, t, x_0)
    return sqrt_ac * x_0 + sqrt_1m_ac * noise


def v_from_eps(
    schedule: DiffusionSchedule, x_0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor
) -> torch.Tensor:
    """The v-prediction target (Salimans & Ho 2022, eq. 11):
    ``v = sqrt(abar_t) * eps - sqrt(1 - abar_t) * x_0``."""
    sa = _per_sample(schedule.sqrt_alphas_cumprod, t, x_0)
    sb = _per_sample(schedule.sqrt_one_minus_alphas_cumprod, t, x_0)
    return sa * noise - sb * x_0


def eps_from_v(
    schedule: DiffusionSchedule, x_t: torch.Tensor, v: torch.Tensor, t: torch.Tensor
) -> torch.Tensor:
    """eps from a v prediction at state x_t:
    ``eps = sqrt(abar_t) * v + sqrt(1 - abar_t) * x_t``."""
    sa = _per_sample(schedule.sqrt_alphas_cumprod, t, x_t)
    sb = _per_sample(schedule.sqrt_one_minus_alphas_cumprod, t, x_t)
    return sa * v + sb * x_t
