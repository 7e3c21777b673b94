"""The class-conditional MLP "UNet" eps-predictor over the MNIST VAE's latents.

Counterpart of ``tinydiffusion_tpu/models/mlp_unet.py`` (``MLPUNetLatent``;
the reference's latent_diffusion.py:16-128). Stem ``Linear(20, 512)``;
encoder double ``Linear -> BatchNorm1d -> ReLU`` blocks 512->256, 256->128,
128->64; bottleneck 64; the raw-t ``TimeEmbedMLP`` plus an
``Embedding(10, 256)``; time projections to 64/128/256. Module names are the
JAX ones, so ``io.from_jax.mlp_unet_state_dict`` maps them by name.

The decoder quirk is kept: time is added to the decoder's input before the
encoder skip is concatenated, ``dec3(cat(b + t1, e3))``,
``dec2(cat(d3 + t2, e2))``, ``dec1(cat(d2 + t3, e1))``, unlike the pixel
UNet, which adds it to the skip. The model computes in its ``dtype``, flax's
``dtype=`` (float32, or what ``nn.layers.computing_in`` sets); the output is
float32 whatever it is.

On the model axis (``parallel.mesh.apply_sharding``, tensor parallelism)
each ``Linear`` holds a slice of its output features and reads its whole
input through ``parallel.mesh.apply_full`` (an all-gather whose backward
reduce-scatters the input gradient); the two halves of each decoder
concatenation are gathered in one, in the global order ``[b + t, e]``.
BatchNorm keeps per-feature statistics, local to the slice (global over
the data axis, ``sync_batch_norm_``); ReLU and the time projection's add
work on the slice. ``final_fc``'s output (split where the axis divides
``latent_dim``) is gathered whole for the loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusion_torch.nn.layers import BatchNorm1d, FlaxDtype, Linear, TimeEmbedMLP
from tinydiffusion_torch.parallel.mesh import apply_full, gather_output


class DenseBNRelu(nn.Module):
    """``Linear -> BatchNorm1d -> ReLU`` on the concatenation of ``parts``
    (on the model axis: this rank's features of each, ``apply_full``)."""

    model_parallel = None  # set by parallel.mesh.apply_sharding

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.fc = Linear(in_features, features)
        self.bn = BatchNorm1d(features)

    def forward(self, *parts: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(apply_full(self.model_parallel, self.fc, *parts)))


class DoubleDenseBlock(nn.Module):
    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.block1 = DenseBNRelu(in_features, hidden)
        self.block2 = DenseBNRelu(hidden, out)

    def forward(self, *parts: torch.Tensor) -> torch.Tensor:
        return self.block2(self.block1(*parts))


class MLPUNetLatent(FlaxDtype, nn.Module):
    supports_model_axis = True
    model_parallel = None  # set by parallel.mesh.apply_sharding

    def __init__(self, time_dim: int = 256, num_classes: int = 10, latent_dim: int = 20):
        super().__init__()
        self.time_embedding = TimeEmbedMLP(time_dim)
        self.class_embedding = nn.Embedding(num_classes, time_dim)  # N(0, 1) init
        self.initial_fc = Linear(latent_dim, 512)
        self.enc1 = DoubleDenseBlock(512, 512, 256)
        self.enc2 = DoubleDenseBlock(256, 256, 128)
        self.enc3 = DoubleDenseBlock(128, 128, 64)
        self.bottleneck = DenseBNRelu(64, 64)
        self.time_proj1 = Linear(time_dim, 64)
        self.time_proj2 = Linear(time_dim, 128)
        self.time_proj3 = Linear(time_dim, 256)
        self.dec3 = DoubleDenseBlock(128, 128, 128)
        self.dec2 = DoubleDenseBlock(256, 256, 256)
        self.dec1 = DoubleDenseBlock(512, 512, 512)
        self.final_fc = Linear(512, latent_dim)

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        mp = self.model_parallel
        x = x.to(self.dtype)
        emb = self.time_embedding(t) + self.class_embedding(y).to(self.dtype)
        e1 = self.enc1(apply_full(mp, self.initial_fc, x))
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        b = self.bottleneck(e3)
        d3 = self.dec3(b + apply_full(mp, self.time_proj1, emb), e3)
        d2 = self.dec2(d3 + apply_full(mp, self.time_proj2, emb), e2)
        d1 = self.dec1(d2 + apply_full(mp, self.time_proj3, emb), e1)
        return gather_output(mp, self.final_fc, apply_full(mp, self.final_fc, d1)).float()
