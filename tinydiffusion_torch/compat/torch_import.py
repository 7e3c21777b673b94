"""Upstream PyTorch ``state_dict``s (the tiny-diffusion reference's models)
-> the port's models: counterpart of ``tinydiffusion_tpu/compat/torch_import.py``.

The JAX package maps the reference's names onto flax trees and transposes
every layout; the port's modules keep flax's names in torch's layouts, so
this mapping renames and reshapes only:

- ``Sequential(Conv|Linear, BN, ReLU, Conv|Linear, BN, ReLU)`` blocks
  (``enc1.0`` ... ``enc1.4``) -> ``enc1.block1.{conv|fc}``,
  ``enc1.block1.bn``, ``enc1.block2...``; the bottleneck's ``.0``/``.1`` ->
  ``bottleneck.{conv|fc}``/``bottleneck.bn``;
- ``time_embedding.0``/``.2`` (Linear, SiLU, Linear) -> ``time_embedding.fc1``/``fc2``;
- the UNet28's 1x1-conv ``time_proj{i}`` (out, in, 1, 1) -> a Linear (out, in);
- ``nn.MultiheadAttention``: the packed ``in_proj`` (3D, D) splits into the
  port's written-out ``query``, ``key`` and ``value`` Linears, ``out_proj``
  -> ``out``; the DiT's ``ff.0``/``ff.2`` -> ``ff1``/``ff2``,
  ``final_layer.0``/``.1`` -> ``final_norm``/``final_proj``.

Each function takes the upstream dict (numpy arrays or tensors) and returns
the port model's ``state_dict`` as float32 CPU tensors (BatchNorm counters
as int64); an upstream key that no rule reads raises ``KeyError``, so a
model of another shape is not half-imported. ``infer_config`` reads the
widths that the port's constructors need from the shapes.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


class _Reader:
    """The upstream dict as float32 tensors, recording which keys were read."""

    def __init__(self, sd: Mapping):
        self.sd = {k: v.detach().cpu() if isinstance(v, torch.Tensor)
                   else torch.from_numpy(np.array(v)) for k, v in sd.items()}
        self.read: set[str] = set()
        self.out: dict[str, torch.Tensor] = {}

    def get(self, key: str) -> torch.Tensor:
        self.read.add(key)
        return self.sd[key]

    def put(self, port: str, key: str, fn=lambda t: t) -> None:
        self.out[port] = fn(self.get(key)).float().contiguous()

    def params(self, port: str, upstream: str, leaves=("weight", "bias")) -> None:
        for leaf in leaves:
            self.put(f"{port}.{leaf}", f"{upstream}.{leaf}")

    def batch_norm(self, port: str, upstream: str) -> None:
        self.params(port, upstream, _BN_LEAVES)
        counter = f"{upstream}.num_batches_tracked"
        self.out[f"{port}.num_batches_tracked"] = (
            self.get(counter).long() if counter in self.sd else torch.tensor(0))

    def done(self) -> dict[str, torch.Tensor]:
        left = sorted(set(self.sd) - self.read)
        if left:
            raise KeyError(f"upstream keys that no rule reads: {left}")
        return self.out


def _double_block(r: _Reader, name: str, layer: str) -> None:
    """``Sequential(layer, BN, ReLU, layer, BN, ReLU)`` -> ``block1``/``block2``."""
    for i, block in ((0, "block1"), (3, "block2")):
        r.params(f"{name}.{block}.{layer}", f"{name}.{i}")
        r.batch_norm(f"{name}.{block}.bn", f"{name}.{i + 1}")


def _time_mlp(r: _Reader) -> None:
    r.params("time_embedding.fc1", "time_embedding.0")
    r.params("time_embedding.fc2", "time_embedding.2")


_BLOCKS = ("enc1", "enc2", "enc3", "dec3", "dec2", "dec1")


def import_unet28(sd: Mapping, conditional: bool = False) -> dict[str, torch.Tensor]:
    """The reference's NoiseModel (diffusion.py:11-162, conditional:
    conditional_diffusion.py:14-171) -> ``models.unet28.UNet28``."""
    r = _Reader(sd)
    _time_mlp(r)
    if conditional:
        r.put("class_embedding.weight", "class_embedding.weight")
    r.params("initial_conv", "initial_conv")
    for name in _BLOCKS:
        _double_block(r, name, "conv")
    r.params("bottleneck.conv", "bottleneck.0")
    r.batch_norm("bottleneck.bn", "bottleneck.1")
    r.params("final_conv", "final_conv")
    for i in (1, 2, 3):
        r.put(f"time_proj{i}.weight", f"time_proj{i}.weight", lambda w: w[:, :, 0, 0])
        r.put(f"time_proj{i}.bias", f"time_proj{i}.bias")
    return r.done()


def import_vae_mnist(sd: Mapping) -> dict[str, torch.Tensor]:
    """The reference's VAE (vae.py:37-67) -> ``models.vae_mnist.VAEMnist``."""
    r = _Reader(sd)
    for name in ("fc1", "fc21", "fc22", "fc3", "fc4"):
        r.params(name, name)
    return r.done()


def import_mlp_unet(sd: Mapping) -> dict[str, torch.Tensor]:
    """The reference's latent NoiseModel (latent_diffusion.py:16-128) ->
    ``models.mlp_unet.MLPUNetLatent``."""
    r = _Reader(sd)
    _time_mlp(r)
    r.put("class_embedding.weight", "class_embedding.weight")
    r.params("initial_fc", "initial_fc")
    r.params("final_fc", "final_fc")
    for name in _BLOCKS:
        _double_block(r, name, "fc")
    r.params("bottleneck.fc", "bottleneck.0")
    r.batch_norm("bottleneck.bn", "bottleneck.1")
    for i in (1, 2, 3):
        r.params(f"time_proj{i}", f"time_proj{i}")
    return r.done()


def import_dit(sd: Mapping, num_layers: int = 4) -> dict[str, torch.Tensor]:
    """The reference's DiT NoiseModel (diffusion_transformer.py:38-109) ->
    ``models.dit.DiT``. The heads need no splitting here: the port's
    query/key/value Linears hold all heads, as ``in_proj`` does."""
    r = _Reader(sd)
    _time_mlp(r)
    r.put("class_embedding.weight", "class_embedding.weight")
    r.params("input_proj", "input_proj")
    r.put("pos_encoding", "pos_encoding")
    r.params("final_norm", "final_layer.0")
    r.params("final_proj", "final_layer.1")
    for i in range(num_layers):
        up, port = f"transformer_blocks.{i}", f"block{i}"
        for leaf in ("weight", "bias"):
            for j, proj in enumerate(("query", "key", "value")):
                r.put(f"{port}.attention.{proj}.{leaf}", f"{up}.attention.in_proj_{leaf}",
                      lambda t, j=j: t.chunk(3)[j])
        r.params(f"{port}.attention.out", f"{up}.attention.out_proj")
        for norm in ("norm1", "norm2"):
            r.params(f"{port}.{norm}", f"{up}.{norm}")
        r.params(f"{port}.ff1", f"{up}.ff.0")
        r.params(f"{port}.ff2", f"{up}.ff.2")
    return r.done()


def infer_config(model: str, sd: Mapping[str, torch.Tensor]) -> dict:
    """The constructor widths of the port's model for an imported state dict
    (``model`` as the import tool names it), read from the shapes."""
    time_dim = int(sd["time_embedding.fc1.weight"].shape[0]) if model != "vae_mnist" else None
    if model in ("unet28", "conditional_unet28"):
        cfg = {"time_dim": time_dim, "base_width": int(sd["initial_conv.weight"].shape[0])}
        if model == "conditional_unet28":
            cfg["num_classes"] = int(sd["class_embedding.weight"].shape[0])
        return cfg
    if model == "vae_mnist":
        hidden, input_dim = sd["fc1.weight"].shape
        return {"latent_dim": int(sd["fc21.weight"].shape[0]), "hidden_dim": int(hidden),
                "input_dim": int(input_dim)}
    first = "input_proj.weight" if model == "dit" else "initial_fc.weight"
    return {"backbone": model, "time_dim": time_dim,
            "num_classes": int(sd["class_embedding.weight"].shape[0]),
            "latent_dim": int(sd[first].shape[1])}
