"""Fused q(x_t | x_0): in-kernel noise and the noising step in one pass.

Counterpart of ``tinydiffusion_tpu/ops/qsample.py``. ``q_sample_fused``
returns ``(x_t, noise)`` with ``noise ~ N(0, I)`` drawn from a seed and
``x_t = sqrt(abar_t) * x_0 + sqrt(1 - abar_t) * noise``. As on the TPU, the
stream is the kernel's own, not ``torch.randn``'s: an opt-in for training,
where any Gaussian serves the DDPM objective.

On a CUDA tensor it launches the hand-written kernel ``csrc/qsample.cu``
(which replaces the TPU's ``_qsample_kernel``) and counts the launch in
``qsample_launches`` (a launch captured into a CUDA graph counts once for
each replay); on a CPU tensor it runs the plain version
``q_sample_fused_reference``. There is no fallback from one to the other.
The seed is a Python int or, as on the TPU, a value in device memory.

Both compute the same stream: Philox4x32-10 keyed by the 64-bit ``seed``,
counter (element group, row, 0, 0), one call per 4 elements of a row; each
uint32 becomes a uniform in (0, 1] by the JAX kernel's rule, and Box-Muller
turns the pairs into normals (cosine, then sine). So the kernel can be held
against the plain version value for value.

``row_offset`` numbers the rows from there: a call on rows ``[r, r + b)`` of
a global batch with ``row_offset=r`` draws exactly those rows of the global
call's noise. That is how a data-parallel step draws its shard (see
``parallel/mesh.py``). JAX's fused q_sample refuses a multi-device mesh,
because its stream is tied to the launch; this counter-based stream is tied
to the global row, so the sharded draw is exact and the port does not refuse.
"""

from __future__ import annotations

import contextlib
import math

import torch

from tinydiffusion_torch.core.schedule import DiffusionSchedule
from tinydiffusion_torch.ops import _build

# Kernels run since import (or since a caller reset it): eager launches, and
# the launches recorded into a CUDA graph once for each of its replays.
qsample_launches = 0
# Launches recorded into a CUDA graph under capture, which run only at replay.
qsample_captured = 0

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MAX_GROUPS = 2**31  # groups of 4 elements, one thread each: a uint32 index


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product ``m * x`` of uint32 values
    held in int64. The product can reach 2^64, past int64, so x is split into
    16-bit halves, whose products with m stay below 2^48."""
    x_hi, x_lo = x >> 16, x & 0xFFFF
    p_hi, p_lo = m * x_hi, m * x_lo  # m * x = p_hi * 2^16 + p_lo
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    return hi, lo


def philox4x32_10(
    counter: tuple[torch.Tensor, ...], key: tuple[int, int]
) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 (Random123) on int64 tensors holding uint32 values: four
    counter words (broadcastable) and a two-word key -> four uint32 words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r > 0:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (in int64) -> uniform (0, 1]: the top 24 bits, never exactly 0."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0) + 1.0 / 33554432.0


def _box_muller(bits_r: torch.Tensor, bits_theta: torch.Tensor):
    r = torch.sqrt(-2.0 * torch.log(_uniform_from_bits(bits_r)))
    theta = (2.0 * math.pi) * _uniform_from_bits(bits_theta)
    return r * torch.cos(theta), r * torch.sin(theta)


def _fused_noise(batch: int, feat: int, seed: int, device: torch.device,
                 row_offset: int = 0) -> torch.Tensor:
    """The kernel's noise for ``batch`` rows of ``feat`` elements, numbered
    from ``row_offset``: (batch, feat) float32 from the Philox stream of
    ``seed``, computed with torch ops."""
    groups = -(-feat // 4)
    g = torch.arange(groups, dtype=torch.int64, device=device)[None, :]
    row = torch.arange(row_offset, row_offset + batch, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    bits = philox4x32_10((g, row, zero, zero), (seed & _MASK32, (seed >> 32) & _MASK32))
    z0, z1 = _box_muller(bits[0], bits[1])
    z2, z3 = _box_muller(bits[2], bits[3])
    return torch.stack([z0, z1, z2, z3], dim=-1).reshape(batch, groups * 4)[:, :feat]


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"q_sample_fused takes a seed in [0, 2^64), not {seed}")
    return seed


def _check_row_offset(row_offset: int, batch: int) -> int:
    row_offset = int(row_offset)
    if row_offset < 0 or row_offset + batch > 2**32:
        raise ValueError(f"rows {row_offset}..{row_offset + batch} do not fit the kernel's "
                         "32-bit row counter")
    return row_offset


def _tensor_seed(seed: torch.Tensor) -> torch.Tensor:
    if seed.shape != () or seed.dtype != torch.int64:
        raise ValueError(f"a tensor seed must be a 0-d int64 tensor, not {seed.dtype} "
                         f"{tuple(seed.shape)}")
    return seed


def q_sample_fused_reference(
    schedule: DiffusionSchedule, x_0: torch.Tensor, t: torch.Tensor, seed: int | torch.Tensor,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``(x_t, noise)``, float32, shaped like x_0.
    A tensor ``seed`` is read as the kernel reads it: its int64 bits are the
    64-bit key (reading it syncs). The rows' noise is drawn as rows
    ``row_offset ..`` of the stream."""
    if isinstance(seed, torch.Tensor):
        seed = int(_tensor_seed(seed)) & 0xFFFFFFFFFFFFFFFF
    seed = _check_seed(seed)
    b = x_0.shape[0]
    row_offset = _check_row_offset(row_offset, b)
    x2 = x_0.reshape(b, -1).to(torch.float32)
    z = _fused_noise(b, x2.shape[1], seed, x2.device, row_offset)
    # Out-of-range timesteps clamp, as in the kernel (and a JAX gather).
    tc = t.to(torch.int64).clamp(0, schedule.num_timesteps - 1)
    sac = schedule.sqrt_alphas_cumprod[tc][:, None]
    s1m = schedule.sqrt_one_minus_alphas_cumprod[tc][:, None]
    xt = sac * x2 + s1m * z
    return xt.reshape(x_0.shape), z.reshape(x_0.shape)


def q_sample_fused(
    schedule: DiffusionSchedule, x_0: torch.Tensor, t: torch.Tensor, seed: int | torch.Tensor,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(x_t, noise)``, float32, shaped like ``x_0`` (B, ...).

    A CUDA ``x_0`` launches the kernel: it takes a contiguous float32 x_0
    (of any alignment: the kernel reads float4 only from aligned rows), an
    integer ``t`` (B,) and the schedule's tables on the same card, and
    raises on anything else. A CPU ``x_0`` runs ``q_sample_fused_reference``.
    ``seed`` is a Python int in [0, 2^64) or, as JAX's ``seed`` may be an
    array, a 0-d int64 tensor on ``x_0``'s device whose bits the kernel reads
    there: a step captured in a CUDA graph draws it on the device, so each
    replay noises with a new seed. ``row_offset`` is the global index of
    ``x_0``'s first row (a data-parallel shard's; 0 otherwise).

    The checks are the cheap ones that keep a launch from reading out of
    bounds; nothing here reads a device value. A launch while the current
    stream is being captured into a CUDA graph counts in
    ``qsample_captured``, and the graph's owner adds it to
    ``qsample_launches`` at each replay (``count_replays``).
    """
    global qsample_launches, qsample_captured
    device = x_0.device
    if device.type != "cuda":
        if device.type == "cpu":
            return q_sample_fused_reference(schedule, x_0, t, seed, row_offset)
        raise ValueError(f"q_sample_fused runs on cuda or cpu tensors, not {device}")
    if isinstance(seed, torch.Tensor):
        if seed.device != device:
            raise ValueError(f"seed lies on {seed.device}, x_0 on {device}")
        seed_ptr, seed_value = _tensor_seed(seed).data_ptr(), 0
    else:
        seed_ptr, seed_value = None, _check_seed(seed)
    sac = schedule.sqrt_alphas_cumprod
    s1m = schedule.sqrt_one_minus_alphas_cumprod
    if x_0.dtype != torch.float32:
        raise TypeError(f"the CUDA q_sample kernel takes float32 x_0, not {x_0.dtype}")
    if not x_0.is_contiguous():
        raise ValueError("the CUDA q_sample kernel takes a contiguous x_0")
    b = x_0.shape[0]
    row_offset = _check_row_offset(row_offset, b)
    if t.shape != (b,) or t.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"t must be an integer tensor of shape ({b},), not {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != device or sac.device != device or s1m.device != device:
        raise ValueError(f"t and the schedule's tables must lie on {device}, not "
                         f"{t.device}, {sac.device}, {s1m.device}")
    if sac.dtype != torch.float32 or s1m.dtype != torch.float32:
        raise TypeError("the CUDA q_sample kernel takes float32 schedule tables")
    feat = x_0.numel() // b if b else 0
    if b * -(-feat // 4) > _MAX_GROUPS:
        raise ValueError(f"the CUDA q_sample kernel takes up to {_MAX_GROUPS} groups of 4 "
                         f"elements, not {b} rows of {feat}")
    if t.dtype != torch.int64:
        t = t.to(torch.int64)  # torch.randint gives int64: no copy on the main path
    xt = torch.empty_like(x_0)
    z = torch.empty_like(x_0)
    on_device = (contextlib.nullcontext() if device.index == torch.cuda.current_device()
                 else torch.cuda.device(device))
    with on_device:
        # The current stream, read at each call: under CUDA graph capture it
        # is the capture stream, so the launch is recorded into the graph.
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _build.library().tdt_qsample_f32(
            x_0.data_ptr(), t.data_ptr(), sac.data_ptr(), s1m.data_ptr(), xt.data_ptr(),
            z.data_ptr(), b, feat, schedule.num_timesteps, seed_ptr, seed_value, row_offset,
            stream)
    if rc != 0:
        raise RuntimeError(f"q_sample kernel launch failed: cudaError {rc}")
    if torch.cuda.is_current_stream_capturing():
        qsample_captured += 1
    else:
        qsample_launches += 1
    return xt, z


def count_replays(captured: int, replays: int = 1) -> None:
    """Add the launches of ``replays`` replays of a CUDA graph into which
    ``captured`` kernels were recorded (a difference of ``qsample_captured``
    across the capture) to ``qsample_launches``."""
    global qsample_launches
    qsample_launches += captured * replays
