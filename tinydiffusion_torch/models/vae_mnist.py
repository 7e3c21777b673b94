"""The MNIST MLP VAE, and its loss.

Counterpart of ``tinydiffusion_tpu/models/vae_mnist.py`` (``VAEMnist``,
``vae_loss``; the reference's vae.py:16-76). 784 -> 400 ReLU -> (mu, logvar)
of 20 each; ``z = mu + eps * exp(logvar / 2)``; 20 -> 400 ReLU -> 784
sigmoid. Module names are the JAX ones (``fc1``, ``fc21``, ``fc22``,
``fc3``, ``fc4``), so ``io.from_jax.vae_mnist_state_dict`` maps one onto the
other by name.

The model runs in float32 in every caller, as JAX's ``VAEMnist()`` does: the
frozen encoder of latent diffusion too, whatever the denoiser's dtype.
The noise ``eps`` is an argument, never drawn here: the caller draws it from
its own generator (or replays JAX's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class VAEMnist(nn.Module):
    def __init__(self, latent_dim: int = 20, hidden_dim: int = 400, input_dim: int = 784):
        super().__init__()
        self.latent_dim = latent_dim
        self.input_dim = input_dim
        self.fc1 = nn.Linear(input_dim, hidden_dim)
        self.fc21 = nn.Linear(hidden_dim, latent_dim)  # mean
        self.fc22 = nn.Linear(hidden_dim, latent_dim)  # log-variance
        self.fc3 = nn.Linear(latent_dim, hidden_dim)
        self.fc4 = nn.Linear(hidden_dim, input_dim)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(mu, logvar)`` of images ``x`` (B, ...) with ``input_dim``
        elements each (NCHW or NHWC alike: MNIST has one channel)."""
        h1 = F.relu(self.fc1(x.reshape(-1, self.input_dim)))
        return self.fc21(h1), self.fc22(h1)

    @staticmethod
    def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        return mu + eps * torch.exp(0.5 * logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, input_dim) pixel probabilities in [0, 1]."""
        return torch.sigmoid(self.fc4(F.relu(self.fc3(z))))

    def forward(self, x: torch.Tensor, eps: torch.Tensor):
        mu, logvar = self.encode(x)
        return self.decode(self.reparameterize(mu, logvar, eps)), mu, logvar


def vae_loss(recon: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor) -> torch.Tensor:
    """``BCE(recon, (x + 1) / 2, sum) + KLD``, JAX's arithmetic: x in [-1, 1]
    maps back to [0, 1] for the target, and both log terms are clamped at
    -100 as ``torch.binary_cross_entropy`` clamps them (a saturated sigmoid
    gives exact 0 or 1 in float32). Written out rather than
    ``F.binary_cross_entropy``, which sums in another order."""
    target = (x.reshape(recon.shape) + 1.0) / 2.0
    log_p = torch.clamp(torch.log(recon), min=-100.0)
    log_1mp = torch.clamp(torch.log1p(-recon), min=-100.0)
    bce = -torch.sum(target * log_p + (1.0 - target) * log_1mp)
    kld = -0.5 * torch.sum(1.0 + logvar - mu * mu - torch.exp(logvar))
    return bce + kld
