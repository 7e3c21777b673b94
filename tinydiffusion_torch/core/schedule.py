"""Noise schedules for the DDPM forward and reverse processes.

Counterpart of ``tinydiffusion_tpu/core/schedule.py``: ``betas``, ``alphas =
1 - betas`` and ``alphas_cumprod = cumprod(alphas)``, all float32 of shape
(T,), for the linear schedule (the reference's) or the cosine one (Nichol &
Dhariwal 2021, eq. 17). The tables live on one device; ``to`` moves them.
Every consumer (q_sample, the sampler, the trainer) reads only these three
tables and the derived ones below.

The cumulative product runs in order, in float32. JAX's on the CPU is a
parallel prefix scan that rounds differently; the two tables differ by up
to ~2.4e-7, and this one is the closer to the float64 product.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed DDPM schedule tables (all shape ``[T]``, float32)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    # Derived once, not per call: q_sample reads them every train step.
    sqrt_alphas_cumprod: torch.Tensor = dataclasses.field(init=False)
    sqrt_one_minus_alphas_cumprod: torch.Tensor = dataclasses.field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "sqrt_alphas_cumprod", torch.sqrt(self.alphas_cumprod))
        object.__setattr__(
            self, "sqrt_one_minus_alphas_cumprod", torch.sqrt(1.0 - self.alphas_cumprod)
        )

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @classmethod
    def from_betas(cls, betas: torch.Tensor) -> "DiffusionSchedule":
        alphas = 1.0 - betas
        return cls(betas=betas, alphas=alphas, alphas_cumprod=torch.cumprod(alphas, 0))

    @classmethod
    def linear(
        cls, num_timesteps: int = 1000, beta_start: float = 1e-4, beta_end: float = 0.02
    ) -> "DiffusionSchedule":
        """Linear beta schedule, the reference's only one."""
        return cls.from_betas(
            torch.linspace(beta_start, beta_end, num_timesteps, dtype=torch.float32)
        )

    @classmethod
    def cosine(
        cls, num_timesteps: int = 1000, s: float = 0.008, max_beta: float = 0.999
    ) -> "DiffusionSchedule":
        """Cosine abar schedule: abar_t = f(t)/f(0), f(t) = cos^2(((t/T + s)/(1 + s))
        * pi/2); beta_t = 1 - abar_t/abar_{t-1} clipped to ``max_beta``, and the
        tables rebuilt from the clipped betas so all three stay consistent."""
        steps = torch.arange(num_timesteps + 1, dtype=torch.float32)
        f = torch.cos(((steps / num_timesteps + s) / (1.0 + s)) * math.pi / 2) ** 2
        abar = f / f[0]
        return cls.from_betas(torch.clip(1.0 - abar[1:] / abar[:-1], 0.0, max_beta))

    @classmethod
    def make(cls, name: str, num_timesteps: int = 1000, **kw) -> "DiffusionSchedule":
        """Build a schedule by name: 'linear' (reference-faithful) | 'cosine'."""
        if name == "linear":
            return cls.linear(num_timesteps, **kw)
        if name == "cosine":
            return cls.cosine(num_timesteps, **kw)
        raise ValueError(f"unknown schedule {name!r}; use 'linear' or 'cosine'")

    def to(self, device: str | torch.device) -> "DiffusionSchedule":
        return DiffusionSchedule(self.betas.to(device), self.alphas.to(device),
                                 self.alphas_cumprod.to(device))

    @property
    def reciprocal_sqrt_alphas(self) -> torch.Tensor:
        return torch.rsqrt(self.alphas)

    @property
    def sqrt_betas(self) -> torch.Tensor:
        return torch.sqrt(self.betas)
