"""Conv beta-VAE with self-attention and spectral norm, NCHW; its frozen
perceptual net and its loss.

Counterpart of ``tinydiffusion_tpu/models/vae_conv.py``: ``ConvVAE``
(encode, reparameterize, decode), ``PerceptualNet`` and ``conv_vae_loss``.
Module and attribute names follow the JAX ``setup`` (``enc_convs``,
``enc_res``, ``enc_attn``, ``fc_mu``, ...) so that
``io.from_jax.conv_vae_state_dict`` maps one onto the other by name.

Where the NCHW port must differ in mechanics to keep the JAX numbers:

- The bottleneck flattens and unflattens in NHWC order, because the JAX
  ``fc_mu``/``fc_logvar``/``decoder_input`` weights index features that way.
- ``SelfAttention2D`` runs on the (B, C, N) view of the NCHW map, which is
  the flash kernel's native layout, so it needs no transpose at all.
- Spectral norm, BatchNorm statistics and the transposed convs repeat
  flax's arithmetic (``nn.layers.SpectralNorm``, ``nn.layers.BatchNorm2d``,
  ``io.from_jax``).
- The reparameterisation noise is an argument (``forward(x, eps)``), not a
  key drawn inside the model: torch cannot draw JAX's bits, so the tests
  hand the port JAX's draws.
- ``PerceptualNet``'s seeded init draws flax's distribution (he_normal: a
  truncated normal, fan_in, scale 2) from a torch generator, so its values
  differ from JAX's ``PRNGKey(123)`` init; ``io.from_jax.perceptual_state_dict``
  carries JAX's weights across when the two must agree.
- The JAX ``SelfAttention2D`` falls back to dense attention when the flash
  path raises. The port does not: an error in the kernel is an error.

``dtype`` is flax's ``dtype=`` (JAX's ``compute_dtype``): the parameters stay
float32 and each layer casts its input and its parameters to ``dtype`` where
the flax layer does. With bfloat16 the convs, the 1x1 projections and the
attention (the bf16 flash kernels) run in bf16, the BatchNorms keep float32
statistics and emit bf16, and, as in JAX, ``fc_mu``, ``fc_logvar`` and
``decoder_input`` (flax Dense layers of no dtype, which promote to float32),
the reparameterisation and the final sigmoid stay float32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusion_torch.nn.layers import BatchNorm2d, SpectralNorm
from tinydiffusion_torch.ops import attention


@dataclasses.dataclass(frozen=True)
class ConvVAEConfig:
    """The architecture fields of the JAX ``ConvVAEConfig`` (vae_laion.py:25-40
    defaults): the ``ConvVAE`` arguments. The training fields are in
    ``experiments.vae_laion.VAELaionConfig``."""

    latent_dim: int = 128
    input_channels: int = 3
    image_size: int = 256


class _Proj1x1T(nn.Module):
    """1x1 projection of a (B, C, N) map to (B, F, N): weight (F, C), bias (F,),
    computed in ``dtype`` (input, weight and bias cast, as JAX's ``_Proj1x1T``)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        bound = in_features ** -0.5  # torch's default Conv2d/Linear init range
        self.weight = nn.Parameter(torch.empty(features, in_features).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(features).uniform_(-bound, bound))
        self.dtype = dtype

    def forward(self, xt: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return torch.matmul(self.weight.to(dt), xt.to(dt)) + self.bias.to(dt)[:, None]


class SelfAttention2D(nn.Module):
    """vae_laion.py:50-65: q, k (C -> C/8), v (C -> C) 1x1 projections,
    unscaled ``softmax(Q K^T) V`` over the H*W tokens, ``gamma * attn + x``
    with a learnable scalar ``gamma`` (init 0, float32; the product runs in
    x's dtype, as JAX's ``gamma.astype(x.dtype)``). ``use_flash=False``
    takes the dense path at every N, as in JAX."""

    def __init__(self, channels: int, use_flash: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_flash = use_flash
        d = max(channels // 8, 1)
        self.query = _Proj1x1T(channels, d, dtype)
        self.key = _Proj1x1T(channels, d, dtype)
        self.value = _Proj1x1T(channels, channels, dtype)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        xt = x.reshape(b, c, h * w)  # (B, C, N): the kernel's layout, no copy
        attend = attention.flash_attention_unscaled_t if self.use_flash else attention._dense_t
        attn_t = attend(self.query(xt), self.key(xt), self.value(xt))
        return self.gamma.to(x.dtype) * attn_t.reshape(b, c, h, w) + x


class ResidualBlockSN(nn.Module):
    """vae_laion.py:69-85: SN conv -> BN -> ReLU -> SN conv -> BN, + residual.
    The BatchNorms keep flax's running statistics (biased variance)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = SpectralNorm(nn.Conv2d(features, features, 3, padding=1, bias=False),
                                  dtype=dtype)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = SpectralNorm(nn.Conv2d(features, features, 3, padding=1, bias=False),
                                  dtype=dtype)
        self.bn2 = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        return self.bn2(self.conv2(h)) + x


class ConvVAE(nn.Module):
    """vae_laion.py:88-168: the encoder and decoder of the LAION conv beta-VAE.

    Encoder: four spectral-normed stride-2 4x4 convs 3->32->64->128->256, a
    ResidualBlockSN after each, SelfAttention2D after stages 0-1, then
    ``fc_mu``/``fc_logvar`` on the flattened 256 x (S/16)^2 map. Decoder: the
    mirror image with transposed convs 256->128->64->32->3 and a sigmoid.
    ``use_flash_attention=False`` runs every attention site dense. ``dtype``
    is the compute dtype (float32 or bfloat16; the module docstring).
    """

    WIDTHS = (32, 64, 128, 256)

    def __init__(self, latent_dim: int = 128, input_channels: int = 3, image_size: int = 256,
                 use_flash_attention: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        if image_size % 16:
            raise ValueError(f"image_size must be a multiple of 16, not {image_size}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, not {dtype}")
        self.dtype = dtype
        self.latent_dim = latent_dim
        self.input_channels = input_channels
        self.image_size = image_size
        widths = self.WIDTHS
        enc_in = (input_channels, *widths[:-1])
        self.enc_convs = nn.ModuleList(
            SpectralNorm(nn.Conv2d(i, o, 4, stride=2, padding=1), dtype=dtype)
            for i, o in zip(enc_in, widths)
        )
        self.enc_res = nn.ModuleList(ResidualBlockSN(w, dtype) for w in widths)
        self.enc_attn = nn.ModuleList(
            SelfAttention2D(w, use_flash_attention, dtype) for w in widths[:2])
        flat = widths[-1] * self._spatial**2
        self.fc_mu = nn.Linear(flat, latent_dim)
        self.fc_logvar = nn.Linear(flat, latent_dim)
        self.decoder_input = nn.Linear(latent_dim, flat)
        dec_out = (128, 64, 32, input_channels)
        dec_in = (widths[-1], *dec_out[:-1])
        self.dec_convs = nn.ModuleList(
            SpectralNorm(nn.ConvTranspose2d(i, o, 4, stride=2, padding=1), dtype=dtype)
            for i, o in zip(dec_in, dec_out)
        )
        self.dec_res = nn.ModuleList(ResidualBlockSN(w, dtype) for w in dec_out[:3])
        self.dec_attn = nn.ModuleList(
            SelfAttention2D(w, use_flash_attention, dtype) for w in dec_out[:2])

    @property
    def _spatial(self) -> int:
        return self.image_size // 16

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, C, S, S) in [0, 1] -> (mu, logvar), each (B, latent_dim) float32."""
        h = x.to(self.dtype)
        for i in range(4):
            h = self.enc_res[i](torch.relu(self.enc_convs[i](h)))
            if i < 2:
                h = self.enc_attn[i](h)
        # NHWC order, as JAX; fc_mu and fc_logvar promote to float32.
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1).float()
        # logvar clamp: see the JAX ConvVAE.encode for why +10.
        return self.fc_mu(h), torch.clamp(self.fc_logvar(h), -30.0, 10.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, latent_dim) -> images (B, C, S, S) in [0, 1], float32."""
        s = self._spatial
        h = self.decoder_input(z).reshape(-1, s, s, self.WIDTHS[-1]).permute(0, 3, 1, 2)
        h = h.to(self.dtype)
        for i in range(4):
            h = self.dec_convs[i](h)
            if i < 3:
                h = self.dec_res[i](torch.relu(h))
                if i < 2:
                    h = self.dec_attn[i](h)
        return torch.sigmoid(h.float())

    def forward(self, x: torch.Tensor, eps: torch.Tensor):
        """``(recon, mu, logvar)`` of x (B, C, S, S) in [0, 1], with z drawn
        from the noise ``eps`` (B, latent_dim): the JAX ``__call__``."""
        mu, logvar = self.encode(x)
        return self.decode(reparameterize(mu, logvar, eps)), mu, logvar


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """``mu + eps * exp(logvar / 2)`` with the noise ``eps`` given explicitly,
    so a caller (or a test) can replay the JAX package's noise."""
    return mu + eps * torch.exp(0.5 * logvar)


def _he_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``he_normal``: a normal truncated at two standard deviations,
    scaled so that the variance is 2 / fan_in (flax's 0.8796 correction)."""
    fan_in = weight[0].numel()
    std = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class PerceptualNet(nn.Module):
    """vae_conv.py:179-205: the frozen feature extractor of the perceptual
    loss, shaped like VGG16 ``features[:16]``: 3x3 convs 64,64 | max-pool |
    128,128 | max-pool | 256,256,256, a ReLU after each conv.

    Frozen: its parameters never require a gradient and no optimizer holds
    them, but gradients flow through it to its input. ``seed`` draws flax's
    he_normal kernels (zero biases) from a torch generator: the offline
    substitute for the pretrained VGG16. ``compat.vgg`` loads the real one.
    ``dtype`` is flax's ``dtype=``: each conv casts its input, kernel and
    bias to it, so the features come out in ``dtype``.
    """

    WIDTHS = ((64, 64), (128, 128), (256, 256, 256))

    def __init__(self, seed: int = 123, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        generator = torch.Generator().manual_seed(seed)
        c_in = 3
        for stage, widths in enumerate(self.WIDTHS):
            for i, c_out in enumerate(widths):
                conv = nn.Conv2d(c_in, c_out, 3, padding=1)
                with torch.no_grad():
                    _he_normal_(conv.weight, generator)
                    conv.bias.zero_()
                self.add_module(f"conv{stage}_{i}", conv)
                c_in = c_out
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, S, S) -> features (B, 256, S/4, S/4)."""
        dt = self.dtype
        h = x
        for stage, widths in enumerate(self.WIDTHS):
            for i in range(len(widths)):
                conv = getattr(self, f"conv{stage}_{i}")
                h = torch.relu(F.conv2d(h.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                                        padding=1))
            if stage < 2:
                h = F.max_pool2d(h, 2, 2)
        return h


def conv_vae_loss(
    recon_x: torch.Tensor,
    x: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    recon_features: torch.Tensor,
    target_features: torch.Tensor,
    beta: float = 1.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """vae_conv.py:322-365: ``BCE(sum) + 0.1 * perceptual MSE(sum) + beta * KLD``,
    accumulated in float32, and the components ``bce``, ``perceptual``,
    ``kld``, ``logvar_max`` and ``mu_absmax`` (0-d tensors).

    The log terms are clamped at -100, as torch's ``binary_cross_entropy``
    and the JAX package do: a saturated sigmoid emits exact 0 and 1 in
    float32, where an epsilon-clip on p would round back to 1.
    """
    x, recon_x, mu, logvar = (t.float() for t in (x, recon_x, mu, logvar))
    recon_features, target_features = recon_features.float(), target_features.float()
    log_p = torch.clamp(torch.log(recon_x), min=-100.0)
    log_1mp = torch.clamp(torch.log1p(-recon_x), min=-100.0)
    bce = -torch.sum(x * log_p + (1.0 - x) * log_1mp)
    perc = torch.sum((recon_features - target_features) ** 2)
    kld = -0.5 * torch.sum(1.0 + logvar - mu**2 - torch.exp(logvar))
    total = bce + 0.1 * perc + beta * kld
    return total, {
        "bce": bce, "perceptual": perc, "kld": kld,
        "logvar_max": torch.max(logvar), "mu_absmax": torch.max(torch.abs(mu)),
    }
