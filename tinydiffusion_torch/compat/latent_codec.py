"""The latent codecs: the SD-VAE and the offline linear projection of image patches.

Copy of ``LinearPatchCodec`` from ``tinydiffusion_tpu/compat/latent_codec.py``
(the reference encodes with the frozen Stable Diffusion VAE, 256² images to
4x32x32 latents times its scaling factor 0.18215; the committed LAION
checkpoint was trained offline with this substitute). Each 8x8x3 patch is
flattened, centred and projected on 4 orthonormal directions, then scaled
per channel; decode is the transpose. The directions start as the first 4
columns of the QR factor of a seed-7 Gaussian (192, 192) matrix;
``calibrate`` replaces them with the patches' top 4 principal axes (numpy
float64 ``eigh``) and whitens each channel, and ``state_dict`` /
``load_state_dict`` carry that basis in a checkpoint's sidecar.

Layout: the port's tensors are NCHW, and ``encode`` takes (B, 3, H, W)
images and returns (B, 4, 32, 32) latents, ``decode`` the reverse. A patch
is flattened in JAX's NHWC order (row in the patch, column, channel), the
only order in which a committed basis means anything: the permutes happen
at this class's boundary, never inside a patch.

``get_latent_codec("sd")`` is ``compat/sdvae.py``'s ``SDVAECodec`` through
diffusers' ``from_pretrained``; a codec built from a state dict in hand
(``SDVAECodec.from_torch_state_dict``) goes to the LAION step builders as
this one does. Both take ``encode(images, noise=None, generator=None)``:
the SD codec samples its latent from them, this one is deterministic and
ignores them.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tinydiffusion_torch.compat.sdvae import SD_SCALING_FACTOR, SDVAECodec


class LinearPatchCodec:
    """Fixed orthonormal patch projection (see the module docstring). Its
    tensors live on the CPU until ``to(device)``."""

    def __init__(self, image_size: int = 256, latent_size: int = 32, latent_channels: int = 4,
                 channels: int = 3, scaling_factor: float = SD_SCALING_FACTOR, seed: int = 7):
        if image_size % latent_size:
            raise ValueError(f"image_size {image_size} is not a multiple of latent_size "
                             f"{latent_size}")
        self.patch = image_size // latent_size
        self.image_size, self.latent_size = image_size, latent_size
        self.latent_channels, self.channels = latent_channels, channels
        self.scaling_factor = scaling_factor
        d = self.patch * self.patch * channels
        q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((d, d)))
        self.w = torch.from_numpy(q[:, :latent_channels].astype(np.float32))  # (d, k)
        self.mean = torch.zeros(d)
        self.scale = torch.full((latent_channels,), scaling_factor)

    def to(self, device: str | torch.device) -> "LinearPatchCodec":
        self.w, self.mean, self.scale = (a.to(device) for a in (self.w, self.mean, self.scale))
        return self

    def _to_patches(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, s, s, p * p * C), each patch flattened NHWC."""
        b, p, s = x.shape[0], self.patch, self.latent_size
        x = x.permute(0, 2, 3, 1).reshape(b, s, p, s, p, self.channels)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, s, s, p * p * self.channels)

    def _from_patches(self, patches: torch.Tensor) -> torch.Tensor:
        b, p, s = patches.shape[0], self.patch, self.latent_size
        x = patches.reshape(b, s, s, p, p, self.channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, s * p, s * p, self.channels).permute(0, 3, 1, 2).contiguous()

    def noise_shape(self, images: torch.Tensor) -> None:
        """None: ``encode`` draws no noise."""
        return None

    def encode(self, images: torch.Tensor, noise=None, generator=None) -> torch.Tensor:
        """(B, 3, H, W) images in [-1, 1] -> (B, 4, 32, 32) scaled latents,
        float32 and contiguous (the fused q_sample takes them as they are).
        ``noise`` and ``generator`` are ignored: this codec is deterministic."""
        del noise, generator
        z = (self._to_patches(images) - self.mean) @ self.w
        return (z * self.scale).permute(0, 3, 1, 2).contiguous()

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, 4, 32, 32) scaled latents -> (B, 3, H, W), about [-1, 1]."""
        z = latents.permute(0, 2, 3, 1) / self.scale
        return self._from_patches(z @ self.w.T + self.mean)

    def calibrate(self, images: torch.Tensor) -> float:
        """Fit the basis to ``images`` (B, 3, H, W): the patches' mean, their
        top ``latent_channels`` principal axes and a per-channel whitening
        scale, in numpy float64 as JAX fits it. Returns the mean scale."""
        patches = self._to_patches(images.detach().cpu().float()).numpy().astype(np.float64)
        flat = patches.reshape(-1, patches.shape[-1])
        mean = flat.mean(axis=0)
        centered = flat - mean
        cov = centered.T @ centered / max(len(centered) - 1, 1)
        eigvals, eigvecs = np.linalg.eigh(cov)  # ascending
        top = eigvecs[:, ::-1][:, : self.latent_channels]
        var = eigvals[::-1][: self.latent_channels]
        device = self.w.device
        self.mean = torch.from_numpy(mean.astype(np.float32)).to(device)
        self.w = torch.from_numpy(np.ascontiguousarray(top, np.float32)).to(device)
        scale = (1.0 / np.sqrt(np.maximum(var, 1e-12))).astype(np.float32)
        self.scale = torch.from_numpy(scale).to(device)
        self.scaling_factor = float(np.mean(scale))
        return self.scaling_factor

    def state_dict(self) -> dict:
        """The basis as JSON lists: ``w``, ``mean``, ``scale``, ``scaling_factor``."""
        return {"w": self.w.cpu().tolist(), "mean": self.mean.cpu().tolist(),
                "scale": self.scale.cpu().tolist(), "scaling_factor": self.scaling_factor}

    def load_state_dict(self, d: dict) -> None:
        w = torch.tensor(d["w"], dtype=torch.float32)
        if w.shape != self.w.shape:
            raise ValueError(f"codec basis shape {tuple(w.shape)} != expected "
                             f"{tuple(self.w.shape)} (checkpoint from a different "
                             "image/latent geometry)")
        device = self.w.device
        self.w = w.to(device)
        self.mean = torch.tensor(d["mean"], dtype=torch.float32, device=device)
        self.scale = torch.tensor(d["scale"], dtype=torch.float32, device=device)
        self.scaling_factor = float(d["scaling_factor"])


def get_latent_codec(name: str = "auto", image_size: int = 256):
    """``"sd"``: ``SDVAECodec.from_pretrained()`` (``ImportError`` without
    diffusers). ``"patch"``, or ``"auto"``: the patch codec (JAX's
    ``"auto"`` ends there offline, with the same warning)."""
    if name == "sd":
        return SDVAECodec.from_pretrained()
    if name not in ("patch", "auto"):
        raise ValueError(f"latent_codec={name!r}; choose 'sd', 'patch' or 'auto'")
    if name == "auto":
        logging.getLogger("tinydiffusion_torch.codec").warning(
            "SD-VAE weights unavailable (offline) — using LinearPatchCodec substitute")
    return LinearPatchCodec(image_size=image_size)
