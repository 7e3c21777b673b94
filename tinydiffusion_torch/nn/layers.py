"""Building blocks with the JAX package's (flax's) semantics.

Counterpart of ``tinydiffusion_tpu/nn/layers.py``: the UNet blocks
(``ConvBNRelu``, ``DoubleConvBlock``, ``TimeEmbedMLP``), ``BatchNorm2d`` and
``BatchNorm1d`` that keep flax's running statistics, flax's ``LayerNorm``,
and the spectral-norm wrapper of the conv-VAE. Convolutions and dense layers
are torch's own ``nn.Conv2d`` and ``nn.Linear``: their default init
(kaiming_uniform(a=sqrt(5)) weights, U(+-1/sqrt(fan_in)) biases) is the one
the JAX package copies.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusion_torch.parallel.mesh import all_reduce_sum, to_full


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


def spectral_normalize(
    weight: torch.Tensor, u: torch.Tensor, out_dim: int, eps: float = 1e-12
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flax ``SpectralNorm`` (``n_steps=1``): ``(weight / sigma, new u, sigma)``.

    One power iteration from ``u`` (1, out) on the weight viewed as a
    (-1, out) matrix, as flax views its HWIO kernel. Here the rows come in
    torch's order rather than flax's; a row permutation changes neither the
    power iteration's ``u`` nor sigma.
    """
    n_out = weight.shape[out_dim]
    mat = weight.movedim(out_dim, -1).reshape(-1, n_out)
    # flax stops the gradient through u and v, not through sigma's matrix.
    v = _l2_normalize(u @ mat.detach().T, eps)
    u_new = _l2_normalize(v @ mat.detach(), eps)
    sigma = (v @ mat @ u_new.T)[0, 0]
    return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma)), u_new, sigma


class SpectralNorm(nn.Module):
    """Wraps a ``Conv2d`` or ``ConvTranspose2d``: its weight is divided by a
    power-iteration estimate of its largest singular value on every call.

    ``dtype`` is the wrapped flax conv's: the power iteration and the
    division run on the float32 kernel (flax's ``SpectralNorm`` normalises
    the parameter before the conv sees it), and the conv casts its input,
    the normalised kernel and the bias to ``dtype`` and convolves there.

    Unlike ``torch.nn.utils.spectral_norm`` this repeats flax's arithmetic
    exactly: one iteration per call in train AND eval mode, from the stored
    ``u``, with ``_l2_normalize(x) = x * rsqrt(sum(x^2) + 1e-12)``. ``u`` and
    the estimate ``sigma`` are written back only in train mode (flax's
    ``update_stats=train``). Like flax, nothing reads the stored ``sigma``;
    it is kept so that an exported checkpoint has every key a JAX one has.
    """

    def __init__(self, layer: nn.Conv2d | nn.ConvTranspose2d, eps: float = 1e-12,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer = layer
        self.eps = eps
        self.dtype = dtype
        self.transposed = isinstance(layer, nn.ConvTranspose2d)
        # Output channels: dim 0 of a Conv2d weight, dim 1 of a ConvTranspose2d's.
        self.out_dim = 1 if self.transposed else 0
        self.register_buffer("u", torch.randn(1, layer.weight.shape[self.out_dim]))
        self.register_buffer("sigma", torch.ones(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = self.layer
        weight, u_new, sigma = spectral_normalize(layer.weight, self.u, self.out_dim, self.eps)
        if self.training:
            self.u.copy_(u_new)
            self.sigma.copy_(sigma.detach())
        dt = self.dtype
        x, weight = x.to(dt), weight.to(dt)
        bias = None if layer.bias is None else layer.bias.to(dt)
        if self.transposed:
            return F.conv_transpose2d(x, weight, bias, layer.stride, layer.padding)
        return F.conv2d(x, weight, bias, layer.stride, layer.padding)


def _move_running_stats(bn: nn.modules.batchnorm._BatchNorm, mean: torch.Tensor,
                        var: torch.Tensor) -> None:
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)


def _flax_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                     dims: tuple[int, ...]) -> torch.Tensor:
    """Train mode: normalise over ``dims`` with the batch statistics and move
    the running ones flax's way (see ``BatchNorm2d``). Under data
    parallelism (``bn.data_parallel``) the batch is the global one."""
    if bn.data_parallel is not None:
        return _global_batch_norm(bn, x, dims, bn.data_parallel)
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=dims, unbiased=False)
    _move_running_stats(bn, mean, var)
    return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)


def _global_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                       dims: tuple[int, ...], dp) -> torch.Tensor:
    """``_flax_batch_norm`` over the group's global batch, as flax's
    BatchNorm under GSPMD: the per-channel sum and sum of squares of the
    float32 input are summed over the group in one collective, and the mean
    and biased variance ``E[x^2] - E[x]^2`` (flax's fast variance, floored at
    0) of the global batch normalise ``x`` and move the running statistics.
    The sums accumulate in float64: in float32 the difference loses a few
    ulps of the variance where the mean is large (4 ulps on a variance of
    391 in the small UNet28's decoder), where one process's two-pass
    ``var_mean`` loses none. The sum is differentiable across ranks
    (``parallel.mesh.all_reduce_sum``), so the backward carries the
    statistics' gradient terms of every rank's loss."""
    xf = x.float()
    c = xf.shape[1]
    count = xf.numel() // c * dp.size
    sums = all_reduce_sum(torch.cat([xf.sum(dims, dtype=torch.float64),
                                     (xf * xf).sum(dims, dtype=torch.float64)]), dp)
    mean64 = sums[:c] / count
    var = torch.clamp(sums[c:] / count - mean64 * mean64, min=0.0).float()
    mean = mean64.float()
    _move_running_stats(bn, mean.detach(), var.detach())
    shape = [1, c] + [1] * (xf.dim() - 2)
    scale = torch.rsqrt(var + bn.eps) * bn.weight.float()
    y = (xf - mean.view(shape)) * scale.view(shape) + bn.bias.float().view(shape)
    return y.to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax ``BatchNorm(momentum=0.9, epsilon=1e-5)``'s
    running statistics.

    Train mode normalises with the biased batch variance, as both frameworks
    do, but flax also updates ``running_var`` with the biased variance where
    torch uses the unbiased one: at the UNet28's 4x4 bottleneck with a batch
    of 8 the two differ by N/(N-1) = 1.6 %. This class follows flax, so the
    statistics after a step equal the JAX package's:
    ``running = 0.9 * running + 0.1 * batch`` for the mean and the biased
    variance, computed in float32. ``num_batches_tracked`` is kept for
    ``state_dict`` compatibility and never advanced (the momentum is fixed).
    Eval mode is torch's, which is flax's.

    A bfloat16 input (a flax BatchNorm of ``dtype=bfloat16`` after a bf16
    conv) is normalised with float32 statistics, scale and bias, and the
    output comes back in bfloat16, as flax's does.
    """

    # The data axis whose global batch train mode normalises over
    # (``parallel.mesh.sync_batch_norm_``); None: this process's batch.
    data_parallel = None

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return _flax_batch_norm(self, x, (0, 2, 3))


class BatchNorm1d(nn.BatchNorm1d):
    """``BatchNorm2d``'s flax statistics over (B, C) features: the MLP UNet's
    ``Dense -> BatchNorm`` blocks."""

    data_parallel = None  # as BatchNorm2d's

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return _flax_batch_norm(self, x, (0,))


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a flax module of the model's dtype computes in: autocast's
    when it is on for ``x``'s device, else ``x``'s own."""
    device = x.device.type
    return torch.get_autocast_dtype(device) if torch.is_autocast_enabled(device) else x.dtype


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm(epsilon=1e-5)`` over the last dim: the statistics in
    float32 with flax's fast variance, ``max(0, E[x^2] - E[x]^2)``, then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, returned in the
    compute dtype (``compute_dtype``), as a flax module of that dtype does."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float()) + self.bias.float()
        return y.to(compute_dtype(x))


class ConvBNRelu(nn.Module):
    """``Conv2d(k=3, p=1) -> BatchNorm2d -> ReLU`` on NCHW.

    ``forward(*parts)`` convolves the channel concatenation of ``parts``. On
    the model axis (``parallel.mesh.apply_sharding``) each part is this
    rank's channels, the conv holds its slice of output channels and reads
    the whole input (``to_full``); the BatchNorm and the ReLU work per
    channel, on the slice."""

    # The model axis (``parallel.mesh.ModelParallel``); None: one process.
    model_parallel = None

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel_size, padding=kernel_size // 2)
        self.bn = BatchNorm2d(features)

    def forward(self, *parts: torch.Tensor) -> torch.Tensor:
        x = to_full(self.model_parallel, self.conv, *parts)
        return F.relu(self.bn(self.conv(x)))


class DoubleConvBlock(nn.Module):
    """Two stacked ``ConvBNRelu`` at the same width: one UNet stage, on the
    channel concatenation of its inputs."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.block1 = ConvBNRelu(in_channels, features)
        self.block2 = ConvBNRelu(features, features)

    def forward(self, *parts: torch.Tensor) -> torch.Tensor:
        return self.block2(self.block1(*parts))


class TimeEmbedMLP(nn.Module):
    """``Linear(1, D) -> SiLU -> Linear(D, D)`` time embedding. The integer
    timestep enters as a raw float, as in the reference, or, with
    ``normalize``, divided by it (the DiT's ``t / 1000``).

    As in JAX, t is cast to the compute dtype before the division: under
    bfloat16 autocast t = 999 rounds to 1000 and enters as 1.0. Dividing in
    float32 and rounding the quotient would enter another value at 190 of
    the 1000 timesteps."""

    model_parallel = None  # as ConvBNRelu's

    def __init__(self, dim: int, normalize: float | None = None):
        super().__init__()
        self.normalize = normalize
        self.fc1 = nn.Linear(1, dim)
        self.fc2 = nn.Linear(dim, dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(compute_dtype(self.fc1.weight))[:, None]
        if self.normalize is not None:
            t = t / self.normalize
        return self.fc2(to_full(self.model_parallel, self.fc2, F.silu(self.fc1(t))))
