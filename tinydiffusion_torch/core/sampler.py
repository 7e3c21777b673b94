"""Reverse samplers: ancestral DDPM, DDIM and DPM-Solver++(2M).

Counterpart of ``tinydiffusion_tpu/core/sampler.py`` (``ddpm_sample`` with
inpainting, ``ddim_timesteps``, ``ddim_sample``, ``dpmpp_sample``,
``ddpm_denoising_trajectory``). The DDPM chain starts from x ~ N(0, I) and,
for t = T-1 .. 0, predicts eps and updates

    x <- 1/sqrt(alpha_t) * (x - (1-alpha_t)/sqrt(1-abar_t) * eps_hat)
         + sqrt(beta_t) * z,        z ~ N(0, I) for t > 0, none at t = 0.

(Variance beta_t, not the posterior sigma-tilde^2, as in the reference.)
DDIM and DPM-Solver++ step over a strided subsequence of the timesteps.

The JAX package compiles each chain into one ``lax.scan``; here it is a
Python loop over the steps that never reads a device value, so the host only
queues work. The per-step coefficients are tables made before the loop (the
DDPM ones from the schedule on its device; the DDIM and DPM-Solver++ ones on
the host, in numpy, from one copy of ``alphas_cumprod``, and uploaded once),
and indexing a table by a Python int gives a device scalar without a copy.

Replay seams, as in JAX: ``x_init`` replaces the initial draw,
``noise_stream[i]`` the noise of step i (DDPM: step 0 is timestep T-1; DDIM:
the eta noise) and ``known_stream[i]`` the noise that re-noises the known
region of an inpainting chain at step i. Without them the chain draws from
``generator``: x_init, then for each step its noise and then its known-region
noise.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tinydiffusion_torch.core.schedule import DiffusionSchedule

# apply_fn(x, t_vec) -> predicted noise; conditioning is closed over by the
# caller so one sampler serves all models.
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class _Draws:
    """The chain's noise: from the replay streams where given, else drawn
    from ``generator`` in the order the steps ask."""

    def __init__(self, shape, generator, dtype, device, noise_stream=None, known_stream=None):
        self.shape, self.generator, self.dtype, self.device = shape, generator, dtype, device
        self.streams = {"noise": noise_stream, "known": known_stream}

    def normal(self) -> torch.Tensor:
        if self.generator is None:
            raise ValueError("the sampler needs a generator unless every draw is given "
                             "(x_init, and noise_stream/known_stream where the chain uses them)")
        return torch.randn(self.shape, generator=self.generator, device=self.device,
                           dtype=self.dtype)

    def init(self, x_init) -> torch.Tensor:
        return x_init.to(self.device, self.dtype) if x_init is not None else self.normal()

    def step(self, kind: str, i: int) -> torch.Tensor:
        stream = self.streams[kind]
        return stream[i].to(self.device, self.dtype) if stream is not None else self.normal()


def _check_inpainting(mask, x_known) -> None:
    if (mask is None) != (x_known is None):
        raise ValueError("inpainting needs BOTH mask and x_known")


def _composite(x, mask, x_known, c_known, c_noise, zk):
    """``mask * known_t + (1 - mask) * x``, the known region at this step's
    noise level ``c_known * x_known + c_noise * zk`` (plain ``x_known`` when
    ``zk`` is None: the final step)."""
    known_t = x_known if zk is None else c_known * x_known + c_noise * zk
    return mask * known_t + (1.0 - mask) * x


def _t_vec(x: torch.Tensor, t: int) -> torch.Tensor:
    return torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)


def _ddpm_tables(schedule: DiffusionSchedule) -> tuple[torch.Tensor, ...]:
    """(1/sqrt(alpha), (1-alpha)/sqrt(1-abar), sqrt(beta), and for inpainting
    sqrt(abar_{t-1}), sqrt(1-abar_{t-1}) with abar_{-1} = 1), (T,) each."""
    abar_prev = torch.cat([schedule.alphas_cumprod.new_ones(1), schedule.alphas_cumprod[:-1]])
    return (
        schedule.reciprocal_sqrt_alphas,
        (1.0 - schedule.alphas) * torch.rsqrt(1.0 - schedule.alphas_cumprod),
        schedule.sqrt_betas,
        torch.sqrt(abar_prev),
        torch.sqrt(1.0 - abar_prev),
    )


def _ddpm_chain(apply_fn, schedule, shape, generator, dtype, x_init, noise_stream, timesteps,
                keep_frames: bool, mask=None, x_known=None, known_stream=None) -> torch.Tensor:
    """Ancestral steps at ``timesteps``; the final x, or every x."""
    device = schedule.betas.device
    c_x, c_eps, sigma, c_known, c_noise = _ddpm_tables(schedule)
    draws = _Draws(shape, generator, dtype, device, noise_stream, known_stream)
    x = draws.init(x_init)
    if mask is not None:
        mask, x_known = mask.to(device, dtype), x_known.to(device, dtype)
    frames = []
    for i, t in enumerate(timesteps):
        eps_hat = apply_fn(x, _t_vec(x, t)).to(dtype)
        x = c_x[t].to(dtype) * (x - c_eps[t].to(dtype) * eps_hat)
        if t > 0:
            x = x + sigma[t].to(dtype) * draws.step("noise", i)
        if mask is not None:
            zk = draws.step("known", i) if t > 0 else None
            x = _composite(x, mask, x_known, c_known[t].to(dtype), c_noise[t].to(dtype), zk)
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
    mask: torch.Tensor | None = None,
    x_known: torch.Tensor | None = None,
    known_stream: torch.Tensor | None = None,
) -> torch.Tensor:
    """The full T-step ancestral chain: x_0 samples of ``shape``, on the
    schedule's device.

    ``generator`` (on that device) draws the initial noise and every step's
    noise unless ``x_init`` / ``noise_stream`` (T, *shape) give them.
    ``mask``/``x_known`` (both or neither; 1 = known, broadcastable to
    ``shape``) inpaint: after every step the known region is re-composited
    at the next timestep's noise level, ``sqrt(abar_{t-1}) x_known +
    sqrt(1 - abar_{t-1}) zk``, and with plain ``x_known`` after the last, so
    the output equals ``x_known`` where ``mask`` is 1. ``known_stream``
    (T, *shape) replays the zk draws (entry T-1, at t = 0, is unused).
    """
    _check_inpainting(mask, x_known)
    timesteps = range(schedule.num_timesteps - 1, -1, -1)
    return _ddpm_chain(apply_fn, schedule, shape, generator, dtype, x_init, noise_stream,
                       timesteps, False, mask, x_known, known_stream)


def ddim_timesteps(num_timesteps: int, num_steps: int, t_start: int | None = None) -> np.ndarray:
    """Descending DDIM timestep subsequence, an int64 numpy array.

    Evenly spaced over [0, t_start] (endpoints included; ``t_start``
    defaults to T-1), so the chain always ends by predicting x_0 from t = 0.
    A ``t_start`` < T-1 is the img2img partial chain: the caller supplies an
    x_init noised to exactly that timestep.

    The grid is JAX's ``round(jnp.linspace(top, 0, n))``, computed in
    float32 as XLA's program for it reads: ``top * (1 - i * f32(1 / (n-1)))``,
    then round half to even. Where a grid point lies on a tie (k + 1/2) its
    float32 rounding decides the timestep, and float64 would decide some of
    them the other way; this reproduces the float32 one. (On the CPU, XLA
    contracts the first 352 entries of a longer grid into fused
    multiply-adds, so past 352 steps JAX's own grid may differ from this one
    at a few ties.)
    """
    top = num_timesteps - 1 if t_start is None else t_start
    if not 0 <= top < num_timesteps:
        raise ValueError(f"t_start {top} outside [0, {num_timesteps - 1}]")
    num_steps = max(1, min(num_steps, top + 1))
    if num_steps == 1:
        return np.array([top], np.int64)
    div = num_steps - 1
    step = np.arange(div, dtype=np.float32) * (np.float32(1.0) / np.float32(div))
    grid = np.concatenate([np.float32(top) * (np.float32(1.0) - step), np.zeros(1, np.float32)])
    return np.round(grid).astype(np.int64)


def _host_alphas_cumprod(schedule: DiffusionSchedule) -> np.ndarray:
    """One host copy of ``alphas_cumprod`` (float32), read before a chain."""
    return schedule.alphas_cumprod.detach().to("cpu", torch.float32).numpy()


def _ddim_tables(abar: np.ndarray, taus: np.ndarray, eta: float) -> dict[str, np.ndarray]:
    """Per-step DDIM coefficients in float32, JAX's expressions: stepping t
    -> s (s = -1: abar = 1, the final x_0 prediction)."""
    one = np.float32(1.0)
    s = np.concatenate([taus[1:], [-1]])
    abar_t = abar[taus]
    abar_s = np.where(s >= 0, abar[np.maximum(s, 0)], one).astype(np.float32)
    if eta > 0.0:
        sigma = (np.float32(eta) * np.sqrt((one - abar_s) / (one - abar_t))
                 * np.sqrt(one - abar_t / abar_s))
        sigma = np.where(s >= 0, sigma, np.float32(0.0)).astype(np.float32)
    else:
        sigma = np.zeros_like(abar_t)
    return {
        "eps_in_x0": np.sqrt(one - abar_t),
        "x0_scale": one / np.sqrt(abar_t),
        "x0_out": np.sqrt(abar_s),
        "eps_out": np.sqrt(np.maximum(one - abar_s - sigma * sigma, np.float32(0.0))),
        "sigma": sigma,
        "known_noise": np.sqrt(one - abar_s),
        "final": (s < 0),
    }


@torch.inference_mode()
def ddim_sample(
    apply_fn: DenoiseFn,
    schedule: DiffusionSchedule,
    shape: tuple[int, ...],
    generator: torch.Generator | None = None,
    num_steps: int = 50,
    eta: float = 0.0,
    dtype: torch.dtype = torch.float32,
    x_init: torch.Tensor | None = None,
    t_start: int | None = None,
    mask: torch.Tensor | None = None,
    x_known: torch.Tensor | None = None,
    noise_stream: torch.Tensor | None = None,
    known_stream: torch.Tensor | None = None,
) -> torch.Tensor:
    """DDIM (Song et al. 2020) over ``ddim_timesteps``; stepping t -> s:

        x0_hat = (x - sqrt(1-abar_t) eps_hat) / sqrt(abar_t)
        sigma  = eta * sqrt((1-abar_s)/(1-abar_t)) * sqrt(1 - abar_t/abar_s)
        x      = sqrt(abar_s) x0_hat + sqrt(1-abar_s-sigma^2) eps_hat + sigma z

    eta = 0 is deterministic given ``x_init``; the final step adds no noise.

    - img2img: ``t_start`` < T-1 and an ``x_init`` noised to exactly that
      timestep; the chain denoises the remaining [0, t_start] stretch.
    - inpainting: ``mask`` (1 = known) and ``x_known``; after every step the
      known region is re-composited at s's noise level, and with plain
      ``x_known`` after the last, so the output equals ``x_known`` there.

    ``noise_stream`` (num_steps, *shape) replays the eta noise,
    ``known_stream`` the inpainting noise; the last entry of each is unused.
    """
    _check_inpainting(mask, x_known)
    device = schedule.betas.device
    taus = ddim_timesteps(schedule.num_timesteps, num_steps, t_start)
    host = _ddim_tables(_host_alphas_cumprod(schedule), taus, float(eta))
    final = host.pop("final")
    tab = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    draws = _Draws(shape, generator, dtype, device, noise_stream, known_stream)
    x = draws.init(x_init)
    if mask is not None:
        mask, x_known = mask.to(device, dtype), x_known.to(device, dtype)
    for i, t in enumerate(taus.tolist()):
        c = {k: v[i].to(dtype) for k, v in tab.items()}
        eps_hat = apply_fn(x, _t_vec(x, t)).to(dtype)
        x0_hat = (x - c["eps_in_x0"] * eps_hat) * c["x0_scale"]
        x = c["x0_out"] * x0_hat + c["eps_out"] * eps_hat
        if eta > 0.0:
            z = draws.step("noise", i)
            if not final[i]:
                x = x + c["sigma"] * z
        if mask is not None:
            zk = draws.step("known", i)
            x = _composite(x, mask, x_known, c["x0_out"], c["known_noise"],
                           None if final[i] else zk)
    return x


def _dpmpp_coefficients(abar: np.ndarray, num_steps: int) -> tuple[np.ndarray, ...]:
    """The DPM-Solver++(2M) grid and per-step coefficients, in float64 numpy
    as JAX computes them: ``(taus, alpha_t, sigma_t, c_x, c_d, c_2)``.

    The grid is ``round(linspace(T-1, 0, n))`` in float64 (JAX's own
    ``dpmpp_sample`` builds it in numpy). With lambda = log(alpha/sigma) and
    h = lambda_s - lambda_t, a step is ``x_s = c_x x + c_d D`` with ``D = m +
    (m - m_prev) h / (2 h_prev)``; ``c_2 = c_d h / (2 h_prev)`` is zero on the
    first step and on the last, taken first-order (lower_order_final)."""
    top = len(abar) - 1
    num_steps = max(1, min(num_steps, top + 1))
    taus = np.round(np.linspace(top, 0, num_steps)).astype(np.int64)
    a = np.asarray(abar, np.float64)[taus]
    alpha_t, sigma_t = np.sqrt(a), np.sqrt(1.0 - a)
    lam = np.log(alpha_t / sigma_t)
    alpha_s = np.concatenate([alpha_t[1:], [1.0]])
    sigma_s = np.concatenate([sigma_t[1:], [0.0]])
    with np.errstate(divide="ignore"):
        lam_s = np.concatenate([lam[1:], [np.inf]])
    h = lam_s - lam
    c_x = sigma_s / sigma_t
    c_d = alpha_s * (-np.expm1(-h))
    c_2 = np.zeros_like(c_d)
    if num_steps > 2:
        c_2[1:-1] = 0.5 * c_d[1:-1] * h[1:-1] / h[:-2]
    return taus, alpha_t, sigma_t, c_x, c_d, c_2


@torch.inference_mode()
def dpmpp_sample(
    apply_fn: DenoiseFn,
    schedule: DiffusionSchedule,
    shape: tuple[int, ...],
    generator: torch.Generator | None = None,
    num_steps: int = 20,
    dtype: torch.dtype = torch.float32,
    x_init: torch.Tensor | None = None,
) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022), a second-order multistep solver of
    the probability-flow ODE in log-SNR time, one model forward a step:

        m = (x - sigma_t eps_hat) / alpha_t
        x = c_x x + c_d m + c_2 (m - m_prev)

    with the coefficients of ``_dpmpp_coefficients``, made on the host in
    float64 and uploaded once in the chain's dtype. Deterministic given
    ``x_init`` (the only draw)."""
    device = schedule.betas.device
    taus, *coeffs = _dpmpp_coefficients(_host_alphas_cumprod(schedule), num_steps)
    a_t, s_t, c_x, c_d, c_2 = (torch.from_numpy(v).to(device, dtype) for v in coeffs)
    x = _Draws(shape, generator, dtype, device).init(x_init)
    m_prev = torch.zeros_like(x)
    for i, t in enumerate(taus.tolist()):
        eps_hat = apply_fn(x, _t_vec(x, t)).to(dtype)
        m = (x - s_t[i] * eps_hat) / a_t[i]
        x = c_x[i] * x + c_d[i] * m + c_2[i] * (m - m_prev)
        m_prev = m
    return x


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
    return _ddpm_chain(apply_fn, schedule, shape, generator, dtype, x_init, noise_stream,
                       timesteps, keep_frames=True)
