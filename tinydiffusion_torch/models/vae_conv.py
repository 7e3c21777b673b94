"""Conv beta-VAE with self-attention and spectral norm, NCHW.

Counterpart of ``tinydiffusion_tpu/models/vae_conv.py`` (serving subset:
encode, reparameterize, decode; the loss and the perceptual net come with
the training slice). Module and attribute names follow the JAX ``setup``
(``enc_convs``, ``enc_res``, ``enc_attn``, ``fc_mu``, ...) so that
``io.from_jax.conv_vae_state_dict`` maps one onto the other by name.

Where the NCHW port must differ in mechanics to keep the JAX numbers:

- The bottleneck flattens and unflattens in NHWC order, because the JAX
  ``fc_mu``/``fc_logvar``/``decoder_input`` weights index features that way.
- ``SelfAttention2D`` runs on the (B, C, N) view of the NCHW map, which is
  the flash kernel's native layout, so it needs no transpose at all.
- Spectral norm and the transposed convs repeat flax's arithmetic
  (``nn.layers.SpectralNorm``, ``io.from_jax``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tinydiffusion_torch.nn.layers import SpectralNorm
from tinydiffusion_torch.ops.attention import flash_attention_unscaled_t


@dataclasses.dataclass(frozen=True)
class ConvVAEConfig:
    """The architecture fields of the JAX ``ConvVAEConfig`` (vae_laion.py:25-40
    defaults): the ``ConvVAE`` arguments. Its training fields come with the
    training slice."""

    latent_dim: int = 128
    input_channels: int = 3
    image_size: int = 256


def _batch_norm(features: int) -> nn.BatchNorm2d:
    # flax BatchNorm(momentum=0.9, epsilon=1e-5) in torch's convention.
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


class _Proj1x1T(nn.Module):
    """1x1 projection of a (B, C, N) map to (B, F, N): weight (F, C), bias (F,)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        bound = in_features ** -0.5  # torch's default Conv2d/Linear init range
        self.weight = nn.Parameter(torch.empty(features, in_features).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(features).uniform_(-bound, bound))

    def forward(self, xt: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.weight, xt) + self.bias[:, None]


class SelfAttention2D(nn.Module):
    """vae_laion.py:50-65: q, k (C -> C/8), v (C -> C) 1x1 projections,
    unscaled ``softmax(Q K^T) V`` over the H*W tokens, ``gamma * attn + x``
    with a learnable scalar ``gamma`` (init 0)."""

    def __init__(self, channels: int):
        super().__init__()
        d = max(channels // 8, 1)
        self.query = _Proj1x1T(channels, d)
        self.key = _Proj1x1T(channels, d)
        self.value = _Proj1x1T(channels, channels)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        xt = x.reshape(b, c, h * w)  # (B, C, N): the kernel's layout, no copy
        attn_t = flash_attention_unscaled_t(self.query(xt), self.key(xt), self.value(xt))
        return self.gamma * attn_t.reshape(b, c, h, w) + x


class ResidualBlockSN(nn.Module):
    """vae_laion.py:69-85: SN conv -> BN -> ReLU -> SN conv -> BN, + residual."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = SpectralNorm(nn.Conv2d(features, features, 3, padding=1, bias=False))
        self.bn1 = _batch_norm(features)
        self.conv2 = SpectralNorm(nn.Conv2d(features, features, 3, padding=1, bias=False))
        self.bn2 = _batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        return self.bn2(self.conv2(h)) + x


class ConvVAE(nn.Module):
    """vae_laion.py:88-168: the encoder and decoder of the LAION conv beta-VAE.

    Encoder: four spectral-normed stride-2 4x4 convs 3->32->64->128->256, a
    ResidualBlockSN after each, SelfAttention2D after stages 0-1, then
    ``fc_mu``/``fc_logvar`` on the flattened 256 x (S/16)^2 map. Decoder: the
    mirror image with transposed convs 256->128->64->32->3 and a sigmoid.
    """

    WIDTHS = (32, 64, 128, 256)

    def __init__(self, latent_dim: int = 128, input_channels: int = 3, image_size: int = 256):
        super().__init__()
        if image_size % 16:
            raise ValueError(f"image_size must be a multiple of 16, not {image_size}")
        self.latent_dim = latent_dim
        self.input_channels = input_channels
        self.image_size = image_size
        widths = self.WIDTHS
        enc_in = (input_channels, *widths[:-1])
        self.enc_convs = nn.ModuleList(
            SpectralNorm(nn.Conv2d(i, o, 4, stride=2, padding=1)) for i, o in zip(enc_in, widths)
        )
        self.enc_res = nn.ModuleList(ResidualBlockSN(w) for w in widths)
        self.enc_attn = nn.ModuleList(SelfAttention2D(w) for w in widths[:2])
        flat = widths[-1] * self._spatial**2
        self.fc_mu = nn.Linear(flat, latent_dim)
        self.fc_logvar = nn.Linear(flat, latent_dim)
        self.decoder_input = nn.Linear(latent_dim, flat)
        dec_out = (128, 64, 32, input_channels)
        dec_in = (widths[-1], *dec_out[:-1])
        self.dec_convs = nn.ModuleList(
            SpectralNorm(nn.ConvTranspose2d(i, o, 4, stride=2, padding=1))
            for i, o in zip(dec_in, dec_out)
        )
        self.dec_res = nn.ModuleList(ResidualBlockSN(w) for w in dec_out[:3])
        self.dec_attn = nn.ModuleList(SelfAttention2D(w) for w in dec_out[:2])

    @property
    def _spatial(self) -> int:
        return self.image_size // 16

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, C, S, S) in [0, 1] -> (mu, logvar), each (B, latent_dim)."""
        h = x
        for i in range(4):
            h = self.enc_res[i](torch.relu(self.enc_convs[i](h)))
            if i < 2:
                h = self.enc_attn[i](h)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC order, as JAX
        # logvar clamp: see the JAX ConvVAE.encode for why +10.
        return self.fc_mu(h), torch.clamp(self.fc_logvar(h), -30.0, 10.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, latent_dim) -> images (B, C, S, S) in [0, 1]."""
        s = self._spatial
        h = self.decoder_input(z).reshape(-1, s, s, self.WIDTHS[-1]).permute(0, 3, 1, 2)
        for i in range(4):
            h = self.dec_convs[i](h)
            if i < 3:
                h = self.dec_res[i](torch.relu(h))
                if i < 2:
                    h = self.dec_attn[i](h)
        return torch.sigmoid(h)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """``mu + eps * exp(logvar / 2)`` with the noise ``eps`` given explicitly,
    so a caller (or a test) can replay the JAX package's noise."""
    return mu + eps * torch.exp(0.5 * logvar)
