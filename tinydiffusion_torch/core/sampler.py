"""Reverse samplers: ancestral DDPM, DDIM and DPM-Solver++(2M).

Counterpart of ``tinydiffusion_tpu/core/sampler.py`` (``ddpm_sample`` with
inpainting, ``ddim_timesteps``, ``ddim_sample``, ``dpmpp_sample``,
``ddpm_denoising_trajectory``). The DDPM chain starts from x ~ N(0, I) and,
for t = T-1 .. 0, predicts eps and updates

    x <- 1/sqrt(alpha_t) * (x - (1-alpha_t)/sqrt(1-abar_t) * eps_hat)
         + sqrt(beta_t) * z,        z ~ N(0, I) for t > 0, none at t = 0.

(Variance beta_t, not the posterior sigma-tilde^2, as in the reference.)
DDIM and DPM-Solver++ step over a strided subsequence of the timesteps.

The JAX package compiles each chain into one ``lax.scan``. Here each chain
is a ``Chain``: its step written once, as the scan's body, over device
buffers and indexed by a position tensor on the device that the body
advances. The timesteps and the per-step coefficients are tables made
before the chain (the DDPM ones from the schedule on its device; the DDIM
and DPM-Solver++ ones on the host, in numpy, from one copy of
``alphas_cumprod``), uploaded once in the chain's dtype; JAX's selects on
``t > 0`` and on the final DDIM step are table values too, and DPM++'s
``m_prev`` and the trajectory's frames are buffers the body writes. The
functions below run the bodies eagerly from the host (the CPU's path, and
the reference on a card); ``core.graphs.ChainRunner`` captures them in CUDA
graphs and replays them. A DDPM step at t = 0 draws nothing, so it is a
body of its own: the generator ends where the eager chain leaves it.

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


class Chain:
    """A reverse chain in JAX's scan form: its steps as bodies over device
    buffers, each body indexed by the position ``pos``, a 0-d int64 tensor
    on the device that the body advances itself. ``kinds[i]`` names the body
    of step i (``"step"``; ``"last"`` for a final DDPM step at t = 0, which
    draws nothing). A body reads its timestep and coefficients from tables
    by ``pos``, the noise from the generator or from a replay stream at
    ``pos``, and writes the carry ``x`` (and DPM++'s ``m_prev``, the
    trajectory's ``frames``) in place. Nothing in a body reads a host value
    that changes from step to step, so a CUDA graph can capture it
    (``core.graphs.ChainRunner``); ``run_eagerly`` runs the same bodies from
    the host.

    ``inputs`` (name -> tensor on the device, in the chain's dtype, or
    None): ``x_init``; ``noise`` and ``known``, the (steps, *shape) replay
    streams; ``mask`` and ``x_known``. ``draws``: whether a body draws from
    ``generator``."""

    def __init__(self, shape, dtype, timesteps: np.ndarray, inputs: dict, device):
        self.shape, self.dtype, self.inputs = tuple(shape), dtype, inputs
        self.timesteps = torch.as_tensor(timesteps, dtype=torch.int64).to(device)
        self.x = torch.empty(self.shape, dtype=dtype, device=device)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.generator = None
        self.kinds: list[str] = ["step"] * len(timesteps)
        self.bodies: dict = {}
        self.draws = False
        self.carries: list[torch.Tensor] = []  # zeroed at the start (DPM++'s m_prev)
        self.frames = None

    def table(self, values) -> torch.Tensor:
        """A per-step table on the device in the chain's dtype."""
        return torch.as_tensor(values).to(self.x.device, self.dtype)

    def at(self, table: torch.Tensor) -> torch.Tensor:
        """Entry ``pos`` of a per-step table, as a (1,) tensor."""
        return table.index_select(0, self.pos.view(1))

    def t_vec(self) -> torch.Tensor:
        return self.timesteps.index_select(0, self.pos.expand(self.shape[0]))

    def draw(self, stream: str) -> torch.Tensor:
        """This step's ``noise`` or ``known`` draw: the replay stream's entry
        at ``pos``, else a normal from the generator."""
        given = self.inputs.get(stream)
        if given is not None:
            return given.index_select(0, self.pos.view(1))[0]
        return torch.randn(self.shape, generator=self.generator, device=self.x.device,
                           dtype=self.dtype)

    def start(self, generator) -> None:
        """x from ``x_init`` or drawn from ``generator``; the position and
        the carries to zero."""
        if generator is None and (self.draws or self.inputs.get("x_init") is None):
            raise ValueError("the sampler needs a generator unless every draw is given "
                             "(x_init, and noise_stream/known_stream where the chain uses them)")
        x_init = self.inputs.get("x_init")
        self.x.copy_(x_init if x_init is not None else torch.randn(
            self.shape, generator=generator, device=self.x.device, dtype=self.dtype))
        self.pos.zero_()
        for carry in self.carries:
            carry.zero_()

    def advance(self, x: torch.Tensor) -> None:
        """The step's end: ``x`` into the carry (and the frame at ``pos``),
        then the next position."""
        self.x.copy_(x)
        if self.frames is not None:
            self.frames.index_copy_(0, self.pos.view(1), x.unsqueeze(0))
        self.pos.add_(1)

    def result(self) -> torch.Tensor:
        return self.x if self.frames is None else self.frames

    def run_eagerly(self, generator) -> torch.Tensor:
        self.generator = generator
        self.start(generator)
        for kind in self.kinds:
            self.bodies[kind]()
        return self.result()


def chain_inputs(device, dtype, x_init=None, noise_stream=None, known_stream=None, mask=None,
                 x_known=None) -> dict:
    """A chain's ``inputs`` from the samplers' arguments: on ``device``, in
    the chain's ``dtype``."""
    named = {"x_init": x_init, "noise": noise_stream, "known": known_stream, "mask": mask,
             "x_known": x_known}
    return {name: None if v is None else v.to(device, dtype) for name, v in named.items()}


def _check_inpainting(mask, x_known) -> None:
    if (mask is None) != (x_known is None):
        raise ValueError("inpainting needs BOTH mask and x_known")


def _composite(x, mask, x_known, c_known, c_noise, zk):
    """``mask * known_t + (1 - mask) * x``, the known region at this step's
    noise level ``c_known * x_known + c_noise * zk`` (plain ``x_known`` when
    ``zk`` is None: the final step)."""
    known_t = x_known if zk is None else c_known * x_known + c_noise * zk
    return mask * known_t + (1.0 - mask) * x


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


def ddpm_chain(apply_fn, schedule, shape, dtype, inputs: dict, timesteps,
               keep_frames: bool = False) -> Chain:
    """Ancestral steps at ``timesteps`` (descending): x_0, or every x as
    ``frames``. A step at t > 0 adds its noise (and re-noises the known
    region of an inpainting chain); the step at t = 0 draws nothing, and is
    the body ``"last"``."""
    device = schedule.betas.device
    chain = Chain(shape, dtype, np.asarray(timesteps, np.int64), inputs, device)
    ts = chain.timesteps
    c_x, c_eps, sigma, c_known, c_noise = (v[ts].to(dtype) for v in _ddpm_tables(schedule))
    mask, x_known = inputs.get("mask"), inputs.get("x_known")
    chain.kinds = ["step" if t > 0 else "last" for t in timesteps]
    chain.draws = "step" in chain.kinds and (inputs.get("noise") is None or (
        mask is not None and inputs.get("known") is None))
    if keep_frames:
        chain.frames = torch.empty((len(ts),) + chain.shape, dtype=dtype, device=device)

    def body(last: bool):
        def step():
            x = chain.x
            eps_hat = apply_fn(x, chain.t_vec()).to(dtype)
            x = chain.at(c_x) * (x - chain.at(c_eps) * eps_hat)
            if not last:
                x = x + chain.at(sigma) * chain.draw("noise")
            if mask is not None:
                zk = None if last else chain.draw("known")
                x = _composite(x, mask, x_known, chain.at(c_known), chain.at(c_noise), zk)
            chain.advance(x)

        return step

    chain.bodies = {"step": body(False), "last": body(True)}
    return chain


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
    inputs = chain_inputs(schedule.betas.device, dtype, x_init, noise_stream, known_stream,
                          mask, x_known)
    timesteps = range(schedule.num_timesteps - 1, -1, -1)
    return ddpm_chain(apply_fn, schedule, shape, dtype, inputs, timesteps).run_eagerly(generator)


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
    inputs = chain_inputs(schedule.betas.device, dtype, x_init, noise_stream, known_stream,
                          mask, x_known)
    return ddim_chain(apply_fn, schedule, shape, dtype, inputs, num_steps, eta,
                      t_start).run_eagerly(generator)


def ddim_chain(apply_fn, schedule, shape, dtype, inputs: dict, num_steps: int, eta: float,
               t_start: int | None = None) -> Chain:
    """The DDIM chain of ``ddim_sample``. The final step (s = -1) is a table
    value, as JAX's select: it adds no eta noise and composites plain
    ``x_known``, though each step draws alike."""
    eta = float(eta)
    taus = ddim_timesteps(schedule.num_timesteps, num_steps, t_start)
    chain = Chain(shape, dtype, taus, inputs, schedule.betas.device)
    host = _ddim_tables(_host_alphas_cumprod(schedule), taus, eta)
    final = torch.from_numpy(host.pop("final")).to(chain.x.device)
    tab = {k: chain.table(v) for k, v in host.items()}
    mask, x_known = inputs.get("mask"), inputs.get("x_known")
    chain.draws = (eta > 0.0 and inputs.get("noise") is None) or (
        mask is not None and inputs.get("known") is None)

    def step():
        x = chain.x
        c = {k: chain.at(v) for k, v in tab.items()}
        last = chain.at(final)
        eps_hat = apply_fn(x, chain.t_vec()).to(dtype)
        x0_hat = (x - c["eps_in_x0"] * eps_hat) * c["x0_scale"]
        x = c["x0_out"] * x0_hat + c["eps_out"] * eps_hat
        if eta > 0.0:
            z = chain.draw("noise")
            x = torch.where(last, x, x + c["sigma"] * z)
        if mask is not None:
            zk = chain.draw("known")
            known_t = torch.where(last, x_known, c["x0_out"] * x_known + c["known_noise"] * zk)
            x = mask * known_t + (1.0 - mask) * x
        chain.advance(x)

    chain.bodies = {"step": step}
    return chain


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
    inputs = chain_inputs(schedule.betas.device, dtype, x_init)
    return dpmpp_chain(apply_fn, schedule, shape, dtype, inputs, num_steps).run_eagerly(generator)


def dpmpp_chain(apply_fn, schedule, shape, dtype, inputs: dict, num_steps: int) -> Chain:
    """The DPM-Solver++(2M) chain of ``dpmpp_sample``; ``m_prev`` is a
    buffer that each step writes."""
    taus, *coeffs = _dpmpp_coefficients(_host_alphas_cumprod(schedule), num_steps)
    chain = Chain(shape, dtype, taus, inputs, schedule.betas.device)
    a_t, s_t, c_x, c_d, c_2 = (chain.table(v) for v in coeffs)
    m_prev = torch.zeros_like(chain.x)
    chain.carries = [m_prev]

    def step():
        x = chain.x
        eps_hat = apply_fn(x, chain.t_vec()).to(dtype)
        m = (x - chain.at(s_t) * eps_hat) / chain.at(a_t)
        x = chain.at(c_x) * x + chain.at(c_d) * m + chain.at(c_2) * (m - m_prev)
        m_prev.copy_(m)
        chain.advance(x)

    chain.bodies = {"step": step}
    return chain


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
    inputs = chain_inputs(schedule.betas.device, dtype, x_init, noise_stream)
    return trajectory_chain(apply_fn, schedule, shape, dtype, inputs,
                            stride).run_eagerly(generator)


def trajectory_chain(apply_fn, schedule, shape, dtype, inputs: dict, stride: int) -> Chain:
    """The chain of ``ddpm_denoising_trajectory``: its frames are the result."""
    stride = min(stride, schedule.num_timesteps)
    timesteps = range(schedule.num_timesteps - stride, -1, -stride)
    return ddpm_chain(apply_fn, schedule, shape, dtype, inputs, timesteps, keep_frames=True)
