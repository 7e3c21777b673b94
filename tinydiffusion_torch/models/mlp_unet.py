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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusion_torch.nn.layers import BatchNorm1d, FlaxDtype, Linear, TimeEmbedMLP


class DenseBNRelu(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.fc = Linear(in_features, features)
        self.bn = BatchNorm1d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.fc(x)))


class DoubleDenseBlock(nn.Module):
    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.block1 = DenseBNRelu(in_features, hidden)
        self.block2 = DenseBNRelu(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block2(self.block1(x))


class MLPUNetLatent(FlaxDtype, nn.Module):
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
        x = x.to(self.dtype)
        emb = self.time_embedding(t) + self.class_embedding(y).to(self.dtype)
        e1 = self.enc1(self.initial_fc(x))
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        b = self.bottleneck(e3)
        d3 = self.dec3(torch.cat([b + self.time_proj1(emb), e3], dim=-1))
        d2 = self.dec2(torch.cat([d3 + self.time_proj2(emb), e2], dim=-1))
        d1 = self.dec1(torch.cat([d2 + self.time_proj3(emb), e1], dim=-1))
        return self.final_fc(d1).float()
