"""Weight bridge: JAX variable trees (flattened npz keys) -> port ``state_dict``.

Layout rules, JAX -> PyTorch:

- Conv kernel HWIO -> OIHW.
- ConvTranspose kernel (kh, kw, in, out) -> (in, out, kh, kw) with H and W
  flipped: flax's ``ConvTranspose`` does not flip its kernel, torch's
  ``conv_transpose2d`` does (the adjoint of a correlation), so the flip
  makes ``conv_transpose2d(stride=2, padding=1)`` equal flax
  ``ConvTranspose(4x4, stride 2, "SAME")``.
- Dense kernel (in, out) -> Linear weight (out, in).
- ``_Proj1x1T`` kernel (1, 1, C, F) -> (F, C).
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.
- Spectral-norm ``u`` vectors -> the ``u`` buffers of
  ``nn.layers.SpectralNorm``. The stored ``sigma`` is dropped: flax
  recomputes sigma from ``u`` on every call and never reads it.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def conv_weight(kernel: np.ndarray) -> torch.Tensor:
    """flax Conv kernel (kh, kw, in, out) -> torch Conv2d weight (out, in, kh, kw)."""
    return torch.from_numpy(np.array(np.transpose(kernel, (3, 2, 0, 1))))


def conv_transpose_weight(kernel: np.ndarray) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, in, out) -> torch ConvTranspose2d
    weight (in, out, kh, kw), spatially flipped (see the module docstring)."""
    flipped = kernel[::-1, ::-1]
    return torch.from_numpy(np.array(np.transpose(flipped, (2, 3, 0, 1))))


def dense_weight(kernel: np.ndarray) -> torch.Tensor:
    """flax Dense kernel (in, out) -> torch Linear weight (out, in)."""
    return torch.from_numpy(np.array(kernel.T))


def proj_weight(kernel: np.ndarray) -> torch.Tensor:
    """``_Proj1x1T`` kernel (1, 1, C, F) -> (F, C)."""
    c, f = kernel.shape[2:]
    return torch.from_numpy(np.array(kernel.reshape(c, f).T))


def _vector(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}

# (pattern on the JAX key, port key template, converter). Module names follow
# the JAX ConvVAE.setup attribute names (enc_convs, enc_res, enc_attn, ...).
_CONV_VAE_RULES = [
    (r"params/enc_conv(\d)/kernel", "enc_convs.{0}.layer.weight", conv_weight),
    (r"params/dec_conv(\d)/kernel", "dec_convs.{0}.layer.weight", conv_transpose_weight),
    (r"params/(enc|dec)_conv(\d)/bias", "{0}_convs.{1}.layer.bias", _vector),
    (r"batch_stats/(enc|dec)_convs_(\d)/\w+/kernel/u", "{0}_convs.{1}.u", _vector),
    (r"params/(enc|dec)_res(\d)/(conv\d)/kernel", "{0}_res.{1}.{2}.layer.weight", conv_weight),
    (r"batch_stats/(enc|dec)_res(\d)/SpectralNorm_\d/(conv\d)/kernel/u",
     "{0}_res.{1}.{2}.u", _vector),
    (r"(?:params|batch_stats)/(enc|dec)_res(\d)/(bn\d)/(scale|bias|mean|var)",
     "{0}_res.{1}.{2}.{3}", _vector),
    (r"params/(enc|dec)_attn(\d)/(query|key|value)/kernel", "{0}_attn.{1}.{2}.weight",
     proj_weight),
    (r"params/(enc|dec)_attn(\d)/(query|key|value)/bias", "{0}_attn.{1}.{2}.bias", _vector),
    (r"params/(enc|dec)_attn(\d)/gamma", "{0}_attn.{1}.gamma", _vector),
    (r"params/(fc_mu|fc_logvar|decoder_input)/kernel", "{0}.weight", dense_weight),
    (r"params/(fc_mu|fc_logvar|decoder_input)/bias", "{0}.bias", _vector),
]
_CONV_VAE_IGNORED = re.compile(r"step|batch_stats/.*/kernel/sigma")


def conv_vae_state_dict(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Map a flattened JAX ConvVAE variable tree to ``models.vae_conv.ConvVAE``'s
    ``state_dict`` (float32 tensors on the CPU).

    Raises ``KeyError`` on a JAX key that no rule maps, so a mismatched tree
    fails here instead of loading half the weights.
    """
    out: dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        if _CONV_VAE_IGNORED.fullmatch(key):
            continue
        for pattern, template, convert in _CONV_VAE_RULES:
            m = re.fullmatch(pattern, key)
            if m:
                groups = [_BN_NAMES.get(g, g) for g in m.groups()]
                out[template.format(*groups)] = convert(np.asarray(arr, np.float32))
                break
        else:
            raise KeyError(f"no ConvVAE state_dict slot for JAX key {key!r}")
    # torch BatchNorm carries a step counter that flax has no counterpart
    # for; with a fixed momentum it is never read.
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    return out
