"""Checkpoints: the JAX package's portable ``.npz`` weights, read and
written, and the port's own resumable state.

Counterpart of ``tinydiffusion_tpu/io/checkpoint.py``. The npz stores every
float param as a bfloat16 leaf viewed as ``uint16``; ``__meta__`` is a JSON
byte string whose ``bfloat16`` list names those keys; ``batch_stats`` stay
float32. The JAX package converts with ``ml_dtypes``; this module needs only
numpy: a bfloat16 is the top half of a float32, so shifting the 16 bits left
by 16 decodes it exactly, and rounding the low 16 bits to nearest even
encodes it as ``ml_dtypes`` does.

``save_checkpoint`` writes three files: ``<path>.pt`` (``torch.save`` of the
full train state, for an exact resume), ``<path>.npz`` (the serving subset
in the JAX format, which the JAX package loads) and the ``<path>.json``
sidecar (``config`` and ``metadata``). The JAX package writes an Orbax
directory in place of the ``.pt``. ``BestKeeper`` saves when a metric
improves, as JAX's does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def bf16_bits_to_float32(bits: np.ndarray) -> np.ndarray:
    """Exact float32 values of bfloat16 numbers given as their uint16 bits."""
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32)


def load_weights_arrays(path: str) -> dict[str, np.ndarray]:
    """``<path>.npz`` as ``{jax key: array}``, bfloat16 leaves as float32.

    Keys are the JAX package's '/'-joined variable paths, for example
    ``params/enc_conv0/kernel`` or ``batch_stats/enc_res0/bn1/mean``.
    """
    with np.load(_abspath(path) + ".npz") as z:
        if "__meta__" not in z.files:
            raise ValueError(f"{path}.npz has no __meta__ entry; not a weights npz")
        meta = json.loads(bytes(z["__meta__"]).decode())
        bf16 = set(meta.get("bfloat16", ()))
        return {
            k: (bf16_bits_to_float32(z[k]) if k in bf16 else z[k])
            for k in z.files
            if k != "__meta__"
        }


def load_sidecar(path: str) -> dict:
    """The ``<path>.json`` sidecar: ``{"config": {...}, "metadata": {...}}``."""
    with open(_abspath(path) + ".json") as f:
        return json.load(f)


def float32_to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """uint16 bits of the bfloat16 nearest to each float32 (ties to even);
    NaNs stay quiet NaNs of the same sign."""
    a = np.ascontiguousarray(a, np.float32)
    bits = a.view(np.uint32)
    rounded = (bits + (0x7FFF + ((bits >> 16) & 1))) >> 16
    return np.where(np.isnan(a), (bits >> 16) | 0x0040, rounded).astype(np.uint16)


def save_weights(path: str, flat: Mapping[str, np.ndarray]) -> str:
    """Write ``{JAX key: array}`` to ``<path>.npz`` in the JAX package's
    format: float leaves outside ``batch_stats`` as bfloat16 bits, listed in
    ``__meta__``; everything else raw. Returns the npz path."""
    path = _abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, bf16_keys = {}, []
    for key in sorted(flat):
        arr = np.asarray(flat[key])
        if arr.dtype in (np.float32, np.float64) and not key.startswith("batch_stats"):
            arr = float32_to_bf16_bits(arr.astype(np.float32))
            bf16_keys.append(key)
        arrays[key] = arr
    arrays["__meta__"] = np.frombuffer(json.dumps({"bfloat16": bf16_keys}).encode(), np.uint8)
    np.savez(path + ".npz", **arrays)
    return path + ".npz"


def save_checkpoint(
    path: str,
    state,
    config: Mapping[str, Any] | None = None,
    metadata: Mapping[str, Any] | None = None,
) -> None:
    """Write ``state`` (a train state with ``state_dict()`` and
    ``jax_weights()``: ``train.trainer.DiffusionTrainState``, which also
    holds the MNIST VAE's and the latent denoisers' runs, or
    ``experiments.vae_laion.ConvVAETrainState``) as ``<path>.pt`` (full
    state), ``<path>.npz`` (JAX weights) and ``<path>.json`` (the sidecar:
    ``config`` and ``metadata``)."""
    path = _abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.pt.{os.getpid()}.tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path + ".pt")  # atomic: a reader sees the old file or the new one
    save_weights(path, state.jax_weights())
    sidecar = {"config": dict(config or {}), "metadata": dict(metadata or {})}
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2, default=str)


def restore_checkpoint(path: str, state) -> None:
    """Load ``<path>.pt`` into ``state`` in place (model, optimizer, EMA,
    step and generator), for an exact resume. A diffusion ``.pt`` written
    while the q_sample seed came from a CPU generator still loads: its
    ``seed_generator`` entry is ignored (``DiffusionTrainState.load_state_dict``)."""
    state.load_state_dict(torch.load(_abspath(path) + ".pt", weights_only=True))


def checkpoint_exists(path: str) -> bool:
    """Whether ``<path>.pt`` and its sidecar exist: a state to resume."""
    path = _abspath(path)
    return os.path.exists(path + ".pt") and os.path.exists(path + ".json")


def weights_exist(path: str) -> bool:
    """Whether ``<path>.npz`` and its sidecar exist: weights to serve or
    to build on (a JAX package's checkpoint or the port's)."""
    path = _abspath(path)
    return os.path.exists(path + ".npz") and os.path.exists(path + ".json")


class BestKeeper:
    """Save a checkpoint whenever the metric falls below its best so far,
    with the metric and the caller's keywords (``epoch``) in the sidecar's
    ``metadata``: ``BestKeeper`` of ``tinydiffusion_tpu/io/checkpoint.py``
    in its ``mode="min"``, the only one its callers use. ``enabled=False``
    (a data-parallel rank other than 0) keeps the best but writes nothing."""

    def __init__(self, path: str, enabled: bool = True):
        self.path = path
        self.enabled = enabled
        self.best: float | None = None

    def update(
        self, metric: float, state, config: Mapping[str, Any] | None = None, **metadata: Any
    ) -> bool:
        metric = float(metric)
        better = self.best is None or metric < self.best
        if better:
            self.best = metric
        if better and self.enabled:
            save_checkpoint(self.path, state, config=config,
                            metadata={"metric": metric, **metadata})
        return better
