"""FID: the Frechet distance between feature-space Gaussians of two image sets.

Counterpart of ``tinydiffusion_tpu/eval/fid.py``, with its names:
``FeatureNet``, ``train_feature_net``, ``classifier_accuracy``,
``featurize``, ``frechet_gaussian_stats``, ``fid_from_stats`` and
``fid_score``; and ``load_feature_net`` / ``save_feature_net`` for the
JAX package's flat npz layout (``checkpoints/fid_classifier{,_rgb256}``),
which the tools restore where JAX's restore an Orbax template. The
features come from ``FeatureNet``, a small conv classifier trained in the
repository (no Inception download offline), so the values compare sampler
with sampler and checkpoint with checkpoint, not with Inception FIDs.

Differences from JAX, none of which changes a number:

- The model holds its weights, so the functions take ``model`` where JAX's
  take ``(model, params)``; ``train_feature_net`` returns the model alone.
- Images are numpy NHWC in [-1, 1], as in JAX; the model runs NCHW on its
  device. It flattens its last map in H, W, C order, as flax does, so
  ``fc1``'s rows keep the JAX checkpoint's order.
- ``featurize`` runs the tail batch as it is (JAX pads it to keep one
  compiled shape); with no BatchNorm a row's features do not depend on its
  batch.
- ``train_feature_net`` runs each epoch eagerly over the set on the device
  (JAX scans it in one program), its permutation from a ``torch.Generator``
  seeded with ``seed`` and its initial weights flax's: ``lecun_normal``
  kernels, zero biases.

The Gaussian fit and the trace of the matrix square root run on the host in
float64, as in JAX.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusion_torch.device import disable_tf32, resolve_device
from tinydiffusion_torch.io.checkpoint import load_weights_arrays, save_weights
from tinydiffusion_torch.io.from_jax import feature_net_from_jax, jax_variables


class FeatureNet(nn.Module):
    """One 3x3 SAME conv, ReLU and 2x2/2 max-pool per entry of ``channels``
    (``conv1``, ``conv2``, ...), then ``fc1`` and ReLU (the features) and
    ``fc2`` (the logits). No BatchNorm: a row's features depend on that
    image alone. ``in_channels`` and ``image_size`` (square images) size
    ``fc1``, which flax infers at its first call."""

    def __init__(self, feature_dim: int = 128, num_classes: int = 10,
                 channels: tuple[int, ...] = (32, 64), in_channels: int = 1,
                 image_size: int = 28):
        super().__init__()
        self.feature_dim, self.num_classes = feature_dim, num_classes
        self.channels = tuple(channels)
        side, width = image_size, in_channels
        for i, ch in enumerate(self.channels):
            self.add_module(f"conv{i + 1}", nn.Conv2d(width, ch, 3, padding=1))
            side, width = side // 2, ch
        self.fc1 = nn.Linear(side * side * width, feature_dim)
        self.fc2 = nn.Linear(feature_dim, num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        for i in range(len(self.channels)):
            x = F.max_pool2d(F.relu(getattr(self, f"conv{i + 1}")(x)), 2)
        feats = F.relu(self.fc1(x.permute(0, 2, 3, 1).flatten(1)))  # flax's NHWC order
        logits = self.fc2(feats)
        return (logits, feats) if return_features else logits


def load_feature_net(path: str, model: FeatureNet) -> FeatureNet:
    """``model`` with the weights of ``<path>.npz`` (JAX's flat layout, read
    strict: a net of other widths raises)."""
    model.load_state_dict(feature_net_from_jax(load_weights_arrays(path)))
    return model


def save_feature_net(path: str, model: FeatureNet, config: dict, metadata: dict) -> None:
    """``<path>.npz`` in JAX's flat layout (bfloat16 bits, as the committed
    classifiers) and the ``<path>.json`` sidecar, which JAX's tools read too."""
    flat = {k.removeprefix("params/"): v for k, v in jax_variables(model).items()}
    save_weights(path, flat)
    with open(os.path.abspath(path) + ".json", "w") as f:
        json.dump({"config": config, "metadata": metadata}, f, indent=2)


@torch.no_grad()
def init_flax_(model: FeatureNet, generator: torch.Generator) -> FeatureNet:
    """flax's default init in place: ``lecun_normal`` kernels (a normal
    truncated at two standard deviations, its std sqrt(1 / fan_in) /
    0.8796...) and zero biases, drawn from ``generator`` on the CPU."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            w = torch.empty(module.weight.shape)
            std = math.sqrt(1.0 / (w[0].numel())) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            module.weight.copy_(w)
            module.bias.zero_()
    return model


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _nchw(images: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device).permute(
        0, 3, 1, 2)


def feature_net_step(model: FeatureNet, optimizer: torch.optim.Optimizer,
                     xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """One Adam step on the mean softmax cross-entropy of (xb NCHW, yb):
    the loss before the step."""
    loss = F.cross_entropy(model(xb), yb)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_feature_net(
    images: np.ndarray,
    labels: np.ndarray,
    *,
    epochs: int = 3,
    batch_size: int = 256,
    lr: float = 1e-3,
    seed: int = 0,
    feature_dim: int = 128,
    num_classes: int = 10,
    channels: tuple[int, ...] = (32, 64),
    device: str | torch.device = "cuda",
) -> FeatureNet:
    """Train ``FeatureNet`` on NHWC ``images`` in [-1, 1] with Adam: the
    whole batches of the set (the tail dropped, as JAX does) on ``device``,
    a fresh permutation each epoch. Returns the model in eval mode."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    n = (len(images) // batch_size) * batch_size
    if n == 0:
        raise ValueError(f"need at least one batch of {batch_size} images")
    generator = torch.Generator().manual_seed(seed)
    model = init_flax_(FeatureNet(feature_dim, num_classes, channels, images.shape[-1],
                                  images.shape[1]), generator).to(dev)
    x_all = _nchw(images[:n], dev)
    y_all = torch.as_tensor(np.asarray(labels[:n]), dtype=torch.int64, device=dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    model.train()
    for _ in range(epochs):
        perm = torch.randperm(n, generator=generator).to(dev)
        for idx in perm.view(-1, batch_size):
            feature_net_step(model, optimizer, x_all[idx], y_all[idx])
    return model.eval()


@torch.inference_mode()
def classifier_accuracy(model: FeatureNet, images: np.ndarray, labels: np.ndarray,
                        batch_size: int = 512) -> float:
    """Top-1 accuracy (a check that the feature space means something)."""
    dev = _device_of(model)
    preds = [model(_nchw(images[i:i + batch_size], dev)).argmax(-1).cpu().numpy()
             for i in range(0, len(images), batch_size)]
    return float((np.concatenate(preds) == np.asarray(labels)[: len(images)]).mean())


@torch.inference_mode()
def featurize(model: FeatureNet, images: np.ndarray, batch_size: int = 512) -> np.ndarray:
    """Feature matrix (N, feature_dim), float64, of NHWC images in [-1, 1]."""
    if len(images) == 0:
        raise ValueError("featurize needs at least one image")
    dev = _device_of(model)
    out = [model(_nchw(images[i:i + batch_size], dev), return_features=True)[1].cpu().numpy()
           for i in range(0, len(images), batch_size)]
    return np.concatenate(out).astype(np.float64)


def frechet_gaussian_stats(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mu, covariance) of a feature matrix, float64."""
    feats = np.asarray(feats, np.float64)
    if feats.ndim != 2 or len(feats) < 2:
        raise ValueError(f"need a (N>=2, D) feature matrix, got {feats.shape}")
    return feats.mean(axis=0), np.atleast_2d(np.cov(feats, rowvar=False))


def fid_from_stats(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                   sigma2: np.ndarray) -> float:
    """Frechet distance between two Gaussians. tr(sqrt(S1 S2)) is the sum of
    the square roots of the eigenvalues of S1 @ S2 (real and non-negative
    for symmetric PSD S1, S2), with the tiny negative ones that float64
    rounding leaves clipped to 0."""
    diff = np.asarray(mu1, np.float64) - np.asarray(mu2, np.float64)
    eigvals = np.linalg.eigvals(np.asarray(sigma1, np.float64) @ np.asarray(sigma2, np.float64))
    tr_covmean = np.sqrt(np.clip(eigvals.real, 0.0, None)).sum()
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_covmean)


def fid_score(model: FeatureNet, real_images: np.ndarray, gen_images: np.ndarray,
              batch_size: int = 512,
              real_stats: tuple[np.ndarray, np.ndarray] | None = None) -> float:
    """FID between real and generated NHWC sets in [-1, 1]; ``real_stats``
    skips featurizing the real set again."""
    if real_stats is None:
        real_stats = frechet_gaussian_stats(featurize(model, real_images, batch_size))
    gen_stats = frechet_gaussian_stats(featurize(model, gen_images, batch_size))
    return fid_from_stats(*real_stats, *gen_stats)
