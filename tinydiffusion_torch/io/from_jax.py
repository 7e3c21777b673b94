"""Weight bridge between JAX variable trees (flattened npz keys) and the
port's ``state_dict``s.

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
- Embedding ``embedding`` -> Embedding ``weight``.

The UNet28's module names equal the JAX ones, so its bridge is by name in
both directions: ``unet28_state_dict`` reads a JAX tree and ``jax_variables``
writes one from any port model built of Conv2d, Linear, Embedding and
BatchNorm2d.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn


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
    return _with_bn_counters(out)


def _with_bn_counters(out: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    # torch BatchNorm carries a step counter that flax has no counterpart
    # for; with a fixed momentum it is never read.
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    return out


_COLLECTIONS = ("params", "ema_params", "batch_stats")


def unet28_state_dict(
    flat: dict[str, np.ndarray], params: str = "params"
) -> dict[str, torch.Tensor]:
    """Map a flattened JAX UNet28 variable tree to ``models.unet28.UNet28``'s
    ``state_dict`` (float32 tensors on the CPU).

    ``params`` names the collection that fills the parameters: ``params``,
    or ``ema_params`` for a checkpoint's EMA shadow; the other one and the
    top-level ``step`` are skipped. Raises ``KeyError`` on any other key.
    """
    out: dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        if key == "step":
            continue
        collection, *path, leaf = key.split("/") if "/" in key else (key, key)
        if collection in _COLLECTIONS and collection not in (params, "batch_stats"):
            continue
        if collection not in _COLLECTIONS or not path:
            raise KeyError(f"no UNet28 state_dict slot for JAX key {key!r}")
        arr = np.asarray(arr, np.float32)
        port = ".".join(path)
        if leaf == "kernel":
            convert = conv_weight if arr.ndim == 4 else dense_weight
            out[f"{port}.weight"] = convert(arr)
        elif leaf == "embedding":
            out[f"{port}.weight"] = _vector(arr)
        elif leaf in _BN_NAMES:
            out[f"{port}.{_BN_NAMES[leaf]}"] = _vector(arr)
        else:
            raise KeyError(f"no UNet28 state_dict slot for JAX key {key!r}")
    return _with_bn_counters(out)


def jax_variables(
    model: nn.Module, params: dict[str, torch.Tensor] | None = None
) -> dict[str, np.ndarray]:
    """The model's variables as ``{JAX key: float32 array}`` in flax's layout:
    ``params/...`` and ``batch_stats/...``, the inverse of
    ``unet28_state_dict``. ``params`` (port parameter name -> tensor, such as
    an EMA shadow) replaces the model's own parameter values."""
    values = {k: v.detach() for k, v in model.state_dict().items()}
    values.update(params or {})
    out: dict[str, np.ndarray] = {}
    for name, module in model.named_modules():
        path = name.replace(".", "/")

        def put(collection: str, leaf: str, attr: str, layout=lambda a: a) -> None:
            arr = values[f"{name}.{attr}"].float().cpu().numpy()
            out[f"{collection}/{path}/{leaf}"] = np.ascontiguousarray(layout(arr))

        if isinstance(module, (nn.Conv2d, nn.Linear)):
            to_flax = (lambda a: a.transpose(2, 3, 1, 0)) if isinstance(module, nn.Conv2d) else np.transpose
            put("params", "kernel", "weight", to_flax)
            put("params", "bias", "bias")
        elif isinstance(module, nn.Embedding):
            put("params", "embedding", "weight")
        elif isinstance(module, nn.BatchNorm2d):
            put("params", "scale", "weight")
            put("params", "bias", "bias")
            put("batch_stats", "mean", "running_mean")
            put("batch_stats", "var", "running_var")
    return out
