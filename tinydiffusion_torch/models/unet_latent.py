"""Text-conditional latent UNet epsilon-predictor, NCHW.

Counterpart of ``tinydiffusion_tpu/models/unet_latent.py`` (``LatentUNet``;
the reference's conditional_diffusion_laion.py:223-332). Module names follow
the flax ones (``time_mlp_fc1``, ``enc1.block1.conv``, ``time_proj1``, ...),
so ``io.from_jax.state_dict_by_name`` maps one onto the other by name.

- the sinusoidal timestep embedding (``core.embeddings``) through
  ``time_mlp_fc1 -> SiLU -> time_mlp_fc2``, plus the text context (a
  ``time_dim`` vector per sample): ``emb = t_emb + context``;
- stem ``Conv(C -> w)``; encoder stages 2w/4w/8w of double conv+BN+ReLU with
  2x2 max-pools 32 -> 16 -> 8 -> 4 (even sizes: JAX's ceil-mode pool is the
  plain one here); bottleneck conv block 8w;
- ``emb`` projected by ``time_proj{1,2,3}`` is added to each encoder skip;
- decoder: align-corners bilinear 2x upsample, concat (widths 16w/12w/6w),
  double conv 8w/4w/2w; a ``Conv(2w -> C)`` head.

The upsample is JAX's (``nn.resize``): two products with the dense (2n, n)
align-corners interpolation matrix, along H and then along W, in the compute
dtype (in bfloat16 the matrix and the intermediate rounded as flax rounds
them). It equals ``F.interpolate(bilinear, align_corners=True)`` in float32,
and its backward is two products, where that op's CUDA backward adds with
atomics: so the bfloat16 train step is bit-reproducible on a card
(``chip_smoke.py``'s ``laion_parity``; in float32 cuDNN's default
convolution algorithms are not). The matrices of the latent grid's three
upsamples (``latent_size`` 32: 4, 8 and 16 up) are buffers on the model's
device.

The model computes in its ``dtype``, flax's ``dtype=`` (float32, or what
``nn.layers.computing_in`` sets). As in JAX the sinusoid and
the context enter in it: ``time_mlp_fc2``'s output is in ``dtype``, and the
context is cast to it before the sum, where a float32 context would promote
the sum. The output is float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusion_torch.core.embeddings import sinusoidal_frequencies, sinusoidal_time_embedding
from tinydiffusion_torch.nn.layers import (
    Conv2d,
    ConvBNRelu,
    DoubleConvBlock,
    FlaxDtype,
    Linear,
    silu,
)
from tinydiffusion_torch.nn.resize import (
    register_resize_matrices,
    resize_matrix,
    upsample_bilinear_2x,
)


class LatentUNet(FlaxDtype, nn.Module):
    """(B, C, S, S) latents, (B,) timesteps and (B, time_dim) context -> eps."""

    def __init__(self, time_dim: int = 768, in_channels: int = 4, base_width: int = 32,
                 latent_size: int = 32):
        super().__init__()
        w = base_width
        self.time_dim = time_dim
        # The sinusoid's table and the upsample matrices, on the model's
        # device; not weights.
        self.register_buffer("freqs", sinusoidal_frequencies(time_dim), persistent=False)
        register_resize_matrices(self, [(n, 2 * n) for n in (latent_size // 8, latent_size // 4,
                                                             latent_size // 2)])
        self.time_mlp_fc1 = Linear(time_dim, time_dim)
        self.time_mlp_fc2 = Linear(time_dim, time_dim)
        self.initial_conv = Conv2d(in_channels, w, 3, padding=1)
        self.enc1 = DoubleConvBlock(w, 2 * w)
        self.enc2 = DoubleConvBlock(2 * w, 4 * w)
        self.enc3 = DoubleConvBlock(4 * w, 8 * w)
        self.bottleneck = ConvBNRelu(8 * w, 8 * w)
        self.time_proj1 = Linear(time_dim, 2 * w)
        self.time_proj2 = Linear(time_dim, 4 * w)
        self.time_proj3 = Linear(time_dim, 8 * w)
        self.dec3 = DoubleConvBlock(16 * w, 8 * w)
        self.dec2 = DoubleConvBlock(12 * w, 4 * w)
        self.dec1 = DoubleConvBlock(6 * w, 2 * w)
        self.final_conv = Conv2d(2 * w, in_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        x = x.to(dtype)
        t_emb = sinusoidal_time_embedding(t, self.time_dim, self.freqs).to(dtype)
        t_emb = self.time_mlp_fc2(silu(self.time_mlp_fc1(t_emb)))
        emb = t_emb + context.to(dtype)

        x0 = self.initial_conv(x)
        e1 = self.enc1(x0)  # 32
        e2 = self.enc2(F.max_pool2d(e1, 2))  # 16
        e3 = self.enc3(F.max_pool2d(e2, 2))  # 8
        b = self.bottleneck(F.max_pool2d(e3, 2))  # 4

        def skip(e: torch.Tensor, proj: Linear) -> torch.Tensor:
            return e + proj(emb)[:, :, None, None]

        def _up(x: torch.Tensor) -> torch.Tensor:
            n = x.shape[-1]
            return upsample_bilinear_2x(x, resize_matrix(self, n, 2 * n))

        d3 = self.dec3(torch.cat([_up(b), skip(e3, self.time_proj3)], dim=1))
        d2 = self.dec2(torch.cat([_up(d3), skip(e2, self.time_proj2)], dim=1))
        d1 = self.dec1(torch.cat([_up(d2), skip(e1, self.time_proj1)], dim=1))
        return self.final_conv(d1).float()
