"""Stable Diffusion v1.4's ``AutoencoderKL``: the ``"sd"`` latent codec seam.

Counterpart of ``tinydiffusion_tpu/compat/sdvae.py`` (``SD_VAE_CONFIG``,
``vae_encode_moments``, ``vae_decode``, ``gaussian_sample``,
``SDVAEFlaxCodec``). The reference freezes diffusers' ``AutoencoderKL``
(CompVis/stable-diffusion-v1-4, subfolder ``vae``) and trains on
``vae.encode(x).latent_dist.sample() * scaling_factor``, decoding with
``vae.decode(z / scaling_factor).sample`` (conditional_diffusion_laion.py:
605-612, 460-461, 589).

The network, NCHW, with diffusers' module names, so that a diffusers state
dict loads ``strict`` (``tests/fixtures/sd_v1_4_vae_state_dict.json`` lists
the 248 keys and their shapes, 83 653 863 parameters):

- encoder: ``conv_in``, a ``DownEncoderBlock2D`` per entry of
  ``block_out_channels`` (``layers_per_block`` resnets, then, but for the
  last, a stride-2 3x3 conv after an asymmetric (0, 1, 0, 1) pad), the mid
  block (resnet, one-head attention over the H*W tokens scaled by
  1/sqrt(C), resnet), GroupNorm, SiLU, ``conv_out`` to 2 * latent moments,
  then the 1x1 ``quant_conv``;
- decoder: the 1x1 ``post_quant_conv``, ``conv_in``, the mid block, an
  ``UpDecoderBlock2D`` per width in reverse (``layers_per_block + 1``
  resnets, then, but for the last, a nearest 2x upsample and a 3x3 conv),
  GroupNorm, SiLU, ``conv_out`` to RGB;
- a resnet: GroupNorm (eps 1e-6), SiLU, 3x3 conv, twice, plus the input
  (through a 1x1 ``conv_shortcut`` where the width changes).

The codec runs in float32, as JAX's does on its float32 parameters; the
attention is dense products and a softmax, as in JAX, where it runs outside
any Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

SD_SCALING_FACTOR = 0.18215
# diffusers' config.json of CompVis/stable-diffusion-v1-4's vae.
SD_VAE_CONFIG = {
    "block_out_channels": (128, 256, 512, 512),
    "layers_per_block": 2,
    "latent_channels": 4,
    "norm_num_groups": 32,
}
GROUP_NORM_EPS = 1e-6
# DiagonalGaussianDistribution's clamp of the log variance.
LOGVAR_MIN, LOGVAR_MAX = -30.0, 20.0


def _group_norm(groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=GROUP_NORM_EPS)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = _group_norm(groups, in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = _group_norm(groups, out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Attention(nn.Module):
    """The mid block's self-attention: one head over the H*W tokens."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = _group_norm(groups, channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).view(b, c, h * w).transpose(1, 2)  # (B, N, C)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        attn = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1)
        out = self.to_out[0](attn @ v)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, groups: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, groups)
                                     for j in range(layers))
        self.downsamplers = nn.ModuleList([Downsample2D(out_ch)]) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        return x if self.downsamplers is None else self.downsamplers[0](x)


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, groups: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, groups)
                                     for j in range(layers + 1))
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)]) if upsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        return x if self.upsamplers is None else self.upsamplers[0](x)


class MidBlock2D(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels, groups),
                                      ResnetBlock2D(channels, channels, groups)])
        self.attentions = nn.ModuleList([Attention(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, widths: tuple[int, ...], layers: int, latent: int, groups: int):
        super().__init__()
        self.conv_in = nn.Conv2d(3, widths[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            DownEncoderBlock2D(widths[max(i - 1, 0)], ch, layers, groups, i < len(widths) - 1)
            for i, ch in enumerate(widths))
        self.mid_block = MidBlock2D(widths[-1], groups)
        self.conv_norm_out = _group_norm(groups, widths[-1])
        self.conv_out = nn.Conv2d(widths[-1], 2 * latent, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, widths: tuple[int, ...], layers: int, latent: int, groups: int):
        super().__init__()
        rev = tuple(reversed(widths))
        self.conv_in = nn.Conv2d(latent, rev[0], 3, padding=1)
        self.mid_block = MidBlock2D(rev[0], groups)
        self.up_blocks = nn.ModuleList(
            UpDecoderBlock2D(rev[max(i - 1, 0)], ch, layers, groups, i < len(rev) - 1)
            for i, ch in enumerate(rev))
        self.conv_norm_out = _group_norm(groups, rev[-1])
        self.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """``encode_moments(x)`` (B, 3, H, W) in [-1, 1] -> (B, 2 * latent, H/f,
    W/f) moments (f = 2 ** (len(block_out_channels) - 1)); ``decode(z)``
    unscaled latents -> (B, 3, H, W)."""

    def __init__(self, block_out_channels=SD_VAE_CONFIG["block_out_channels"],
                 layers_per_block: int = SD_VAE_CONFIG["layers_per_block"],
                 latent_channels: int = SD_VAE_CONFIG["latent_channels"],
                 norm_num_groups: int = SD_VAE_CONFIG["norm_num_groups"]):
        super().__init__()
        widths = tuple(block_out_channels)
        self.encoder = Encoder(widths, layers_per_block, latent_channels, norm_num_groups)
        self.decoder = Decoder(widths, layers_per_block, latent_channels, norm_num_groups)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)
        self.latent_channels, self.factor = latent_channels, 2 ** (len(widths) - 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))


def gaussian_sample(moments: torch.Tensor, noise: torch.Tensor | None = None,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """diffusers' ``DiagonalGaussianDistribution``: the moments split along
    the channels into (mean, logvar), logvar clamped to [-30, 20], and
    ``mean + exp(logvar / 2) * noise``. The standard normal ``noise`` (the
    mean's shape) is the argument (the seam the tests feed JAX's draw
    through) or drawn from ``generator``; with neither, the mode (the mean)."""
    mean, logvar = moments.chunk(2, dim=1)
    if noise is None and generator is None:
        return mean
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    std = torch.exp(0.5 * logvar.clamp(LOGVAR_MIN, LOGVAR_MAX))
    return mean + std * noise


class SDVAECodec:
    """The latent codec over an ``AutoencoderKL``, frozen, in eval mode:
    ``encode(images)`` (B, 3, H, W) in [-1, 1] -> scaled latents, the
    reparameterised sample with ``noise`` or ``generator`` (the reference's
    ``latent_dist.sample()``), the mode without; ``decode(latents)`` ->
    (B, 3, H, W), about [-1, 1]. Its weights live on the CPU until ``to``."""

    def __init__(self, vae: AutoencoderKL, scaling_factor: float = SD_SCALING_FACTOR):
        self.vae = vae.eval().requires_grad_(False)
        self.scaling_factor = scaling_factor

    @classmethod
    def from_torch_state_dict(cls, state_dict: dict, config: dict = SD_VAE_CONFIG,
                              scaling_factor: float = SD_SCALING_FACTOR) -> "SDVAECodec":
        """From a diffusers ``AutoencoderKL`` state dict, loaded ``strict``."""
        vae = AutoencoderKL(**config)
        vae.load_state_dict(state_dict, strict=True)
        return cls(vae, scaling_factor)

    @classmethod
    def from_pretrained(cls, model_name: str = "CompVis/stable-diffusion-v1-4") -> "SDVAECodec":
        """The reference's path: diffusers' weights (the package is imported
        here; without it this raises ``ImportError``)."""
        try:
            from diffusers import AutoencoderKL as DiffusersAutoencoderKL
        except ImportError as e:
            raise ImportError("the SD-VAE's from_pretrained needs the diffusers package") from e
        vae = DiffusersAutoencoderKL.from_pretrained(model_name, subfolder="vae").eval()
        config = {
            "block_out_channels": tuple(vae.config.block_out_channels),
            "layers_per_block": int(vae.config.layers_per_block),
            "latent_channels": int(vae.config.latent_channels),
            "norm_num_groups": int(vae.config.norm_num_groups),
        }
        return cls.from_torch_state_dict(vae.state_dict(), config,
                                         float(vae.config.scaling_factor))

    def to(self, device: str | torch.device) -> "SDVAECodec":
        self.vae.to(device)
        return self

    @torch.no_grad()
    def noise_shape(self, images: torch.Tensor) -> tuple[int, ...]:
        """The shape of the standard normal that ``encode`` draws for
        ``images``: the latents'."""
        b, _, h, w = images.shape
        f = self.vae.factor
        return (b, self.vae.latent_channels, h // f, w // f)

    def encode(self, images: torch.Tensor, noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        moments = self.vae.encode_moments(images)
        return gaussian_sample(moments, noise, generator) * self.scaling_factor

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(latents / self.scaling_factor)
