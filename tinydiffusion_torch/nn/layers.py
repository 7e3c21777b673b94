"""Building blocks with the JAX package's (flax's) semantics.

Counterpart of ``tinydiffusion_tpu/nn/layers.py``: the UNet blocks
(``ConvBNRelu``, ``DoubleConvBlock``, ``TimeEmbedMLP``), a ``BatchNorm2d``
that keeps flax's running statistics, and the spectral-norm wrapper of the
conv-VAE. Convolutions and dense layers are torch's own ``nn.Conv2d`` and
``nn.Linear``: their default init (kaiming_uniform(a=sqrt(5)) weights,
U(+-1/sqrt(fan_in)) biases) is the one the JAX package copies.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


def spectral_normalize(
    weight: torch.Tensor, u: torch.Tensor, out_dim: int, eps: float = 1e-12
) -> tuple[torch.Tensor, torch.Tensor]:
    """flax ``SpectralNorm`` (``n_steps=1``): ``(weight / sigma, new u)``.

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
    return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma)), u_new


class SpectralNorm(nn.Module):
    """Wraps a ``Conv2d`` or ``ConvTranspose2d``: its weight is divided by a
    power-iteration estimate of its largest singular value on every call.

    Unlike ``torch.nn.utils.spectral_norm`` this repeats flax's arithmetic
    exactly: one iteration per call in train AND eval mode, from the stored
    ``u``, with ``_l2_normalize(x) = x * rsqrt(sum(x^2) + 1e-12)``. ``u`` is
    written back only in train mode (flax's ``update_stats=train``).
    """

    def __init__(self, layer: nn.Conv2d | nn.ConvTranspose2d, eps: float = 1e-12):
        super().__init__()
        self.layer = layer
        self.eps = eps
        self.transposed = isinstance(layer, nn.ConvTranspose2d)
        # Output channels: dim 0 of a Conv2d weight, dim 1 of a ConvTranspose2d's.
        self.out_dim = 1 if self.transposed else 0
        self.register_buffer("u", torch.randn(1, layer.weight.shape[self.out_dim]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = self.layer
        weight, u_new = spectral_normalize(layer.weight, self.u, self.out_dim, self.eps)
        if self.training:
            self.u.copy_(u_new)
        if self.transposed:
            return F.conv_transpose2d(x, weight, layer.bias, layer.stride, layer.padding)
        return F.conv2d(x, weight, layer.bias, layer.stride, layer.padding)


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
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ConvBNRelu(nn.Module):
    """``Conv2d(k=3, p=1) -> BatchNorm2d -> ReLU`` on NCHW."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel_size, padding=kernel_size // 2)
        self.bn = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class DoubleConvBlock(nn.Module):
    """Two stacked ``ConvBNRelu`` at the same width: one UNet stage."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.block1 = ConvBNRelu(in_channels, features)
        self.block2 = ConvBNRelu(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block2(self.block1(x))


class TimeEmbedMLP(nn.Module):
    """``Linear(1, D) -> SiLU -> Linear(D, D)`` time embedding. The integer
    timestep enters as a raw float, as in the reference."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(1, dim)
        self.fc2 = nn.Linear(dim, dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.fc1.weight.dtype)[:, None]
        return self.fc2(F.silu(self.fc1(t)))
