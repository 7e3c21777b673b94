"""Pixel-space UNet epsilon-predictor for 28x28 images, NCHW.

Counterpart of ``tinydiffusion_tpu/models/unet28.py`` (the reference's
``NoiseModel`` and its class-conditional variant). Module names follow the
JAX ones (``time_embedding``, ``enc1.block1.conv``, ``time_proj1``, ...), so
``io.from_jax.unet28_state_dict`` maps one onto the other by name.

- time embedding: the raw integer timestep as a float ->
  ``Linear(1, 256) -> SiLU -> Linear``; with ``num_classes``, an
  ``Embedding(num_classes, 256)`` is added to it;
- stem ``Conv(C -> w)``; encoder stages 2w/4w/8w of double conv+BN+ReLU
  with ceil-mode 2x2 max-pool 28 -> 14 -> 7 -> 4; bottleneck conv block 8w;
- the time embedding, projected by ``time_proj{1,2,3}`` (flax ``Dense``,
  here ``nn.Linear``), is added to each encoder skip;
- decoder: align-corners bilinear 2x upsample, the skip resized
  align-corners to 8/16/32, concat, double conv 4w/2w/w; resize 32 -> 28
  and a ``Conv(w -> out_channels)`` head.

On the model axis (``parallel.mesh.apply_sharding``, tensor parallelism)
every conv and dense layer holds a slice of its output channels and reads
its whole input through ``parallel.mesh.to_full``: an all-gather before each
layer (the two halves of each decoder concatenation gathered in one, in the
global order ``[upsampled, skip]``), whose backward reduce-scatters the
input gradient; BatchNorm, ReLU, the pool, the resizes and the time
projection's add work per channel on the slice. The one-channel
``final_conv`` stays whole on every rank, so its gathered input's gradient
is taken, not summed. The output is then whole on every rank.

The model computes in its ``dtype``, flax's ``dtype=`` (float32, or what
``nn.layers.computing_in`` sets): every layer rounds where flax's rounds
(``nn.layers``), the parameters stay float32. The resizes are
JAX's two products on its interpolation matrices in the activations' dtype
(``nn.resize``; the matrices of the five resizes are buffers), and the pool
is torch's ``F.max_pool2d(ceil_mode=True)``, whose backward routes a tied
window's gradient to its first maximum: the rule the JAX package's custom
VJP copies. Inputs and outputs are NCHW; inside, the activations are kept
channels-last. The output is float32 whatever the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusion_torch.nn.layers import (
    Conv2d,
    ConvBNRelu,
    DoubleConvBlock,
    FlaxDtype,
    Linear,
    TimeEmbedMLP,
)
from tinydiffusion_torch.nn.resize import (
    register_resize_matrices,
    resize_bilinear_align_corners,
    resize_matrix,
)
from tinydiffusion_torch.parallel.mesh import apply_full

# (from, to) of every resize of a 28x28 input: the 2x upsamples, the skips'
# resizes and the head's 32 -> 28.
RESIZES = ((4, 8), (7, 8), (8, 16), (14, 16), (16, 32), (28, 32), (32, 28))


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class UNet28(FlaxDtype, nn.Module):
    """UNet denoiser for (B, C, 28, 28) images; eps- (or v-) prediction.

    ``num_classes=None`` -> unconditional; ``num_classes=10`` ->
    class-conditional (``forward`` then needs labels ``y``).
    """

    supports_model_axis = True
    model_parallel = None  # set by parallel.mesh.apply_sharding

    def __init__(
        self,
        time_dim: int = 256,
        num_classes: int | None = None,
        in_channels: int = 1,
        out_channels: int = 1,
        base_width: int = 64,
    ):
        super().__init__()
        w = base_width
        self.num_classes = num_classes
        self.time_embedding = TimeEmbedMLP(time_dim)
        if num_classes is not None:
            self.class_embedding = nn.Embedding(num_classes, time_dim)  # N(0, 1) init
        self.initial_conv = Conv2d(in_channels, w, 3, padding=1)
        self.enc1 = DoubleConvBlock(w, 2 * w)
        self.enc2 = DoubleConvBlock(2 * w, 4 * w)
        self.enc3 = DoubleConvBlock(4 * w, 8 * w)
        self.bottleneck = ConvBNRelu(8 * w, 8 * w)
        self.time_proj1 = Linear(time_dim, 2 * w)
        self.time_proj2 = Linear(time_dim, 4 * w)
        self.time_proj3 = Linear(time_dim, 8 * w)
        self.dec3 = DoubleConvBlock(16 * w, 4 * w)
        self.dec2 = DoubleConvBlock(8 * w, 2 * w)
        self.dec1 = DoubleConvBlock(4 * w, w)
        self.final_conv = Conv2d(w, out_channels, 3, padding=1)
        register_resize_matrices(self, RESIZES)

    def _resize(self, x: torch.Tensor, size: int) -> torch.Tensor:
        m = resize_matrix(self, x.shape[-1], size)
        return resize_bilinear_align_corners(x, m, m)

    def forward(
        self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor | None = None
    ) -> torch.Tensor:
        x = x.to(self.dtype)
        emb = self.time_embedding(t)
        if self.num_classes is not None:
            if y is None:
                raise ValueError("class-conditional model requires labels y")
            emb = emb + self.class_embedding(y).to(self.dtype)  # flax Embed's dtype

        # NHWC inside, as in JAX: torch's NCHW bilinear-resize kernel on the
        # card loops over batch x channels in each thread, which at the 4x4-
        # 16x16 maps (and B * C up to 65536) makes it most of the step's
        # device time; its channels-last kernel does not. cuDNN takes NHWC
        # too. The layers keep the layout of their input, so one copy here
        # sets it (a 1-channel input is both layouts at once, so the copy
        # comes after the stem).
        mp = self.model_parallel
        x0 = self.initial_conv(x).contiguous(memory_format=torch.channels_last)
        e1 = self.enc1(x0)  # 28
        e2 = self.enc2(_pool(e1))  # 14
        e3 = self.enc3(_pool(e2))  # 7
        b = self.bottleneck(_pool(e3))  # 4

        def skip(e: torch.Tensor, proj: Linear, size: int) -> torch.Tensor:
            return self._resize(e + apply_full(mp, proj, emb)[:, :, None, None], size)

        d3 = self.dec3(self._resize(b, 8), skip(e3, self.time_proj3, 8))
        d2 = self.dec2(self._resize(d3, 16), skip(e2, self.time_proj2, 16))
        d1 = self.dec1(self._resize(d2, 32), skip(e1, self.time_proj1, 32))
        return apply_full(mp, self.final_conv, self._resize(d1, 28)).float()
