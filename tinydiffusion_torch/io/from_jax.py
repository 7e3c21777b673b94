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
- Spectral-norm ``u`` vectors and ``sigma`` estimates -> the ``u`` and
  ``sigma`` buffers of ``nn.layers.SpectralNorm``. Neither framework reads
  ``sigma``; it is carried so that the two checkpoints hold the same keys.
- Embedding ``embedding`` -> Embedding ``weight``.

- flax ``MultiHeadDotProductAttention`` kernels: query/key/value
  (in, heads, head_dim) -> Linear weight ``kernel.reshape(in, -1).T``, their
  (heads, head_dim) biases flattened; out (heads, head_dim, out) ->
  ``kernel.reshape(-1, out).T``.
- A param that is a leaf of its module (the DiT's ``pos_encoding``) -> the
  port's parameter of that name, as it is.

The module names of the UNet28, the MNIST VAE, the latent MLP UNet and the
DiT equal the JAX ones, so their bridge is by name in both directions:
``state_dict_by_name`` (as ``unet28_state_dict``, ``vae_mnist_state_dict``,
``mlp_unet_state_dict`` and ``dit_state_dict``) reads a JAX tree and
``jax_variables`` writes one from any port model built of Conv2d, Linear,
Embedding, BatchNorm, LayerNorm and flax-layout attention. The conv-VAE's
bridge is by rule in both directions: ``conv_vae_state_dict`` and
``conv_vae_jax_variables``. The perceptual net's
JAX params (``{conv0_0: {kernel, bias}, ...}``) map onto
``models.vae_conv.PerceptualNet`` with ``perceptual_state_dict``.

The pretrained seams' trees, as the JAX package converts them from the
upstream state dicts (``convert_clip_text``, ``convert_diffusers_vae``: keys
that keep transformers' and diffusers' names, nested by their dots), map
back by rule with ``clip_text_from_jax`` and ``sdvae_from_jax``: conv
kernels HWIO -> OIHW, Dense kernels (in, out) -> (out, in), embedding tables
and norm parameters as they are. The FID feature net's flat params map by
name with ``feature_net_from_jax``.
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


def conv_transpose_kernel(weight: np.ndarray) -> np.ndarray:
    """The inverse of ``conv_transpose_weight``: torch (in, out, kh, kw) ->
    flax (kh, kw, in, out), spatially flipped back."""
    return np.ascontiguousarray(np.transpose(weight, (2, 3, 0, 1))[::-1, ::-1])


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
    (r"batch_stats/(enc|dec)_convs_(\d)/\w+/kernel/(u|sigma)", "{0}_convs.{1}.{2}", _vector),
    (r"params/(enc|dec)_res(\d)/(conv\d)/kernel", "{0}_res.{1}.{2}.layer.weight", conv_weight),
    (r"batch_stats/(enc|dec)_res(\d)/SpectralNorm_\d/(conv\d)/kernel/(u|sigma)",
     "{0}_res.{1}.{2}.{3}", _vector),
    (r"(?:params|batch_stats)/(enc|dec)_res(\d)/(bn\d)/(scale|bias|mean|var)",
     "{0}_res.{1}.{2}.{3}", _vector),
    (r"params/(enc|dec)_attn(\d)/(query|key|value)/kernel", "{0}_attn.{1}.{2}.weight",
     proj_weight),
    (r"params/(enc|dec)_attn(\d)/(query|key|value)/bias", "{0}_attn.{1}.{2}.bias", _vector),
    (r"params/(enc|dec)_attn(\d)/gamma", "{0}_attn.{1}.gamma", _vector),
    (r"params/(fc_mu|fc_logvar|decoder_input)/kernel", "{0}.weight", dense_weight),
    (r"params/(fc_mu|fc_logvar|decoder_input)/bias", "{0}.bias", _vector),
]
_CONV_VAE_IGNORED = re.compile(r"step")


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


def _hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _proj_kernel(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T.reshape(1, 1, *w.T.shape))


# The inverse rules: (pattern on the port key, JAX key template, converter).
_CONV_VAE_EXPORT_RULES = [
    (r"enc_convs\.(\d)\.layer\.weight", "params/enc_conv{0}/kernel", _hwio),
    (r"dec_convs\.(\d)\.layer\.weight", "params/dec_conv{0}/kernel", conv_transpose_kernel),
    (r"(enc|dec)_convs\.(\d)\.layer\.bias", "params/{0}_conv{1}/bias", np.asarray),
    (r"(enc|dec)_convs\.(\d)\.(u|sigma)", "batch_stats/{0}_convs_{1}/{0}_conv{1}/kernel/{2}",
     np.asarray),
    (r"(enc|dec)_res\.(\d)\.(conv\d)\.layer\.weight", "params/{0}_res{1}/{2}/kernel", _hwio),
    (r"(enc|dec)_res\.(\d)\.conv1\.(u|sigma)",
     "batch_stats/{0}_res{1}/SpectralNorm_0/conv1/kernel/{2}", np.asarray),
    (r"(enc|dec)_res\.(\d)\.conv2\.(u|sigma)",
     "batch_stats/{0}_res{1}/SpectralNorm_1/conv2/kernel/{2}", np.asarray),
    (r"(enc|dec)_res\.(\d)\.(bn\d)\.weight", "params/{0}_res{1}/{2}/scale", np.asarray),
    (r"(enc|dec)_res\.(\d)\.(bn\d)\.bias", "params/{0}_res{1}/{2}/bias", np.asarray),
    (r"(enc|dec)_res\.(\d)\.(bn\d)\.running_mean", "batch_stats/{0}_res{1}/{2}/mean",
     np.asarray),
    (r"(enc|dec)_res\.(\d)\.(bn\d)\.running_var", "batch_stats/{0}_res{1}/{2}/var",
     np.asarray),
    (r"(enc|dec)_attn\.(\d)\.(query|key|value)\.weight", "params/{0}_attn{1}/{2}/kernel",
     _proj_kernel),
    (r"(enc|dec)_attn\.(\d)\.(query|key|value)\.bias", "params/{0}_attn{1}/{2}/bias",
     np.asarray),
    (r"(enc|dec)_attn\.(\d)\.gamma", "params/{0}_attn{1}/gamma", np.asarray),
    (r"(fc_mu|fc_logvar|decoder_input)\.weight", "params/{0}/kernel",
     lambda w: np.ascontiguousarray(w.T)),
    (r"(fc_mu|fc_logvar|decoder_input)\.bias", "params/{0}/bias", np.asarray),
]


def conv_vae_jax_variables(model: nn.Module) -> dict[str, np.ndarray]:
    """The inverse of ``conv_vae_state_dict``: a ``models.vae_conv.ConvVAE``'s
    parameters and buffers as ``{JAX key: float32 array}`` in flax's layout,
    ``params/...`` and ``batch_stats/...`` (the spectral norms' ``u`` and
    ``sigma`` included). BatchNorm's ``num_batches_tracked`` has no JAX
    counterpart and is left out. Raises ``KeyError`` on any other key."""
    out: dict[str, np.ndarray] = {}
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        arr = value.detach().float().cpu().numpy()
        for pattern, template, convert in _CONV_VAE_EXPORT_RULES:
            m = re.fullmatch(pattern, key)
            if m:
                out[template.format(*m.groups())] = np.asarray(convert(arr), np.float32)
                break
        else:
            raise KeyError(f"no JAX key for ConvVAE state_dict entry {key!r}")
    return out


def perceptual_state_dict(params) -> dict[str, torch.Tensor]:
    """JAX ``PerceptualNet`` params (``{conv0_0: {kernel, bias}, ...}``, HWIO
    kernels) -> ``models.vae_conv.PerceptualNet``'s ``state_dict``."""
    out: dict[str, torch.Tensor] = {}
    for name, leaves in params.items():
        out[f"{name}.weight"] = conv_weight(np.asarray(leaves["kernel"], np.float32))
        out[f"{name}.bias"] = _vector(np.asarray(leaves["bias"], np.float32))
    return out


def _with_bn_counters(out: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    # torch BatchNorm carries a step counter that flax has no counterpart
    # for; with a fixed momentum it is never read.
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    return out


_COLLECTIONS = ("params", "ema_params", "batch_stats")


def _by_name_leaf(path: list[str], leaf: str, arr: np.ndarray) -> tuple[str, torch.Tensor]:
    port = ".".join(path)
    if leaf == "kernel":
        if arr.ndim == 4:
            return f"{port}.weight", conv_weight(arr)
        if arr.ndim == 3:  # attention: q/k/v (in, heads, head_dim), out (heads, head_dim, out)
            flat = arr.reshape(-1, arr.shape[-1]) if path[-1] == "out" else arr.reshape(
                arr.shape[0], -1)
            return f"{port}.weight", dense_weight(flat)
        return f"{port}.weight", dense_weight(arr)
    if leaf == "embedding":
        return f"{port}.weight", _vector(arr)
    if leaf in _BN_NAMES:  # BatchNorm and LayerNorm leaves, Dense biases
        return f"{port}.{_BN_NAMES[leaf]}", _vector(arr.reshape(-1) if leaf == "bias" else arr)
    return ".".join(path + [leaf]), _vector(arr)  # a module's own param (pos_encoding)


def state_dict_by_name(
    flat: dict[str, np.ndarray], params: str = "params"
) -> dict[str, torch.Tensor]:
    """Map a flattened JAX variable tree onto the ``state_dict`` of the port
    model of the same module names (float32 tensors on the CPU): the UNet28,
    the MNIST VAE, the latent MLP UNet or the DiT.

    ``params`` names the collection that fills the parameters: ``params``,
    or ``ema_params`` for a checkpoint's EMA shadow; the other one and the
    top-level ``step`` are skipped. Raises ``KeyError`` on a key outside
    these collections; a key the model has no slot for fails its
    ``load_state_dict``.
    """
    out: dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        if key == "step":
            continue
        collection, *path, leaf = key.split("/") if "/" in key else (key, key)
        if collection in _COLLECTIONS and collection not in (params, "batch_stats"):
            continue
        if collection not in _COLLECTIONS:
            raise KeyError(f"no state_dict slot for JAX key {key!r}")
        name, value = _by_name_leaf(path, leaf, np.asarray(arr, np.float32))
        out[name] = value
    return _with_bn_counters(out)


unet28_state_dict = vae_mnist_state_dict = mlp_unet_state_dict = dit_state_dict = (
    state_dict_by_name)


def jax_variables(
    model: nn.Module, params: dict[str, torch.Tensor] | None = None
) -> dict[str, np.ndarray]:
    """The model's variables as ``{JAX key: float32 array}`` in flax's layout:
    ``params/...`` and ``batch_stats/...``, the inverse of
    ``state_dict_by_name``. ``params`` (port parameter name -> tensor, such
    as an EMA shadow) replaces the model's own parameter values."""
    values = {k: v.detach() for k, v in model.state_dict().items()}
    values.update(params or {})
    # A Linear inside an attention module (one with ``num_heads``) has flax's
    # (in, heads, head_dim) / (heads, head_dim, out) kernel layout.
    heads = {name: m.num_heads for name, m in model.named_modules() if hasattr(m, "num_heads")}
    out: dict[str, np.ndarray] = {}
    for name, module in model.named_modules():
        path = name.replace(".", "/")

        def put(collection: str, leaf: str, attr: str, layout=lambda a: a) -> None:
            arr = values[f"{name}.{attr}" if name else attr].float().cpu().numpy()
            key = f"{collection}/{path}/{leaf}" if path else f"{collection}/{leaf}"
            out[key] = np.ascontiguousarray(layout(arr))

        parent, _, own = name.rpartition(".")
        if isinstance(module, nn.Linear) and parent in heads:
            h = heads[parent]
            if own == "out":
                put("params", "kernel", "weight", lambda a: a.T.reshape(h, -1, a.shape[0]))
                put("params", "bias", "bias")
            else:
                put("params", "kernel", "weight", lambda a: a.T.reshape(a.shape[1], h, -1))
                put("params", "bias", "bias", lambda a: a.reshape(h, -1))
        elif isinstance(module, (nn.Conv2d, nn.Linear)):
            to_flax = (lambda a: a.transpose(2, 3, 1, 0)) if isinstance(module, nn.Conv2d) else np.transpose
            put("params", "kernel", "weight", to_flax)
            put("params", "bias", "bias")
        elif isinstance(module, nn.Embedding):
            put("params", "embedding", "weight")
        elif isinstance(module, nn.LayerNorm):
            put("params", "scale", "weight")
            put("params", "bias", "bias")
        elif isinstance(module, nn.modules.batchnorm._BatchNorm):
            put("params", "scale", "weight")
            put("params", "bias", "bias")
            put("batch_stats", "mean", "running_mean")
            put("batch_stats", "var", "running_var")
        else:  # a module's own params (the DiT's pos_encoding)
            for leaf in module._parameters:
                put("params", leaf, leaf)
    return out


def _flatten_dotted(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested tree -> ``{dotted path: float32 array}``."""
    out: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten_dotted(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.asarray(value, np.float32)
    return out


def clip_text_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX's CLIP text tree (``convert_clip_text``) -> the state dict of
    ``compat.clip.CLIPTextTransformer``: a 2-D ``weight`` outside the
    embeddings is a Dense kernel, transposed."""
    out: dict[str, torch.Tensor] = {}
    for key, arr in _flatten_dotted(tree).items():
        dense = key.endswith(".weight") and arr.ndim == 2 and "embedding" not in key
        out[key] = dense_weight(arr) if dense else _vector(arr)
    return out


def sdvae_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX's AutoencoderKL tree (``convert_diffusers_vae``) -> the state dict
    of ``compat.sdvae.AutoencoderKL`` (diffusers' keys): 4-D ``weight``s are
    HWIO conv kernels, 2-D ones Dense kernels."""
    out: dict[str, torch.Tensor] = {}
    for key, arr in _flatten_dotted(tree).items():
        if key.endswith(".weight") and arr.ndim == 4:
            out[key] = conv_weight(arr)
        elif key.endswith(".weight") and arr.ndim == 2:
            out[key] = dense_weight(arr)
        else:
            out[key] = _vector(arr)
    return out


def feature_net_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The FID feature net's flat params (``conv{i}/kernel|bias``,
    ``fc{1,2}/kernel|bias``, as ``checkpoints/fid_classifier{,_rgb256}.npz``
    hold them) -> the state dict of ``eval.fid.FeatureNet``. ``fc1``'s rows
    stay in flax's H, W, C order: the port's ``FeatureNet`` flattens its last
    map in that order."""
    return state_dict_by_name({f"params/{key}": arr for key, arr in flat.items()})
