"""Building blocks with the JAX package's (flax's) semantics.

Counterpart of ``tinydiffusion_tpu/nn/layers.py``. This slice needs only the
spectral-norm wrapper; BatchNorm comes from torch with flax's settings
(``momentum=0.1`` in torch is flax's ``momentum=0.9``; ``eps=1e-5``).
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
