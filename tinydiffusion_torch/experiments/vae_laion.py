"""Serve the LAION conv beta-VAE: reconstruct images and decode prior samples.

The serving subset of ``tinydiffusion_tpu/experiments/vae_laion.py`` and of
the conv-VAE rows of ``tools/fid_eval_laion.py``: load the portable ``.npz``
weights, reconstruct (encode -> reparameterize -> decode), and decode
z ~ N(0, I). Training comes with a later slice.

Precision: the checkpoint was trained and is served in float32
(``compute_dtype: float32`` in its sidecar). ``load_conv_vae`` therefore
turns TF32 off for cuDNN convolutions and for matmuls when it loads onto a
card (process-wide backend flags): PyTorch lets cuDNN convolve float32 in
TF32 by default, which keeps only ~3 decimal digits.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.

Usage::

    model = load_conv_vae("checkpoints/vae_laion_best")
    recon = reconstruct(model, x01, eps)  # x01 (B, 3, 256, 256) in [0, 1]
    samples = sample_prior(model, 16, torch.Generator("cuda").manual_seed(0))
"""

from __future__ import annotations

import dataclasses

import torch

from tinydiffusion_torch.device import disable_tf32, resolve_device
from tinydiffusion_torch.io.checkpoint import load_sidecar, load_weights_arrays
from tinydiffusion_torch.io.from_jax import conv_vae_state_dict
from tinydiffusion_torch.models.vae_conv import ConvVAE, ConvVAEConfig, reparameterize


def load_conv_vae(path: str, device: str | torch.device = "cuda") -> ConvVAE:
    """The conv-VAE of ``<path>.npz`` + ``<path>.json``, in eval mode on ``device``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    sidecar = load_sidecar(path)["config"]
    config = ConvVAEConfig(**{f.name: sidecar[f.name] for f in dataclasses.fields(ConvVAEConfig)})
    model = ConvVAE(**dataclasses.asdict(config))
    model.load_state_dict(conv_vae_state_dict(load_weights_arrays(path)))
    return model.to(dev).eval()


def _device_of(model: ConvVAE) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def reconstruct(model: ConvVAE, x01: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Encode ``x01`` (B, C, S, S) in [0, 1], sample z with the noise ``eps``
    (B, latent_dim), decode: the reconstruction (B, C, S, S) in [0, 1]."""
    dev = _device_of(model)
    mu, logvar = model.encode(x01.to(dev, torch.float32))
    return model.decode(reparameterize(mu, logvar, eps.to(dev, torch.float32)))


@torch.inference_mode()
def sample_prior(model: ConvVAE, n: int, generator: torch.Generator) -> torch.Tensor:
    """Decode ``n`` latents z ~ N(0, I) drawn from ``generator`` (which lies on
    the model's device): images (n, C, S, S) in [0, 1]."""
    dev = _device_of(model)
    z = torch.randn(n, model.latent_dim, generator=generator, device=dev)
    return model.decode(z)
