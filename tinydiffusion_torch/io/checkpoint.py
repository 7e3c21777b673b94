"""Read the JAX package's portable ``.npz`` weights and their JSON sidecar.

Counterpart of ``tinydiffusion_tpu/io/checkpoint.py`` (``_load_weights_arrays``
and ``load_sidecar``). The npz stores every float param as a bfloat16 leaf
viewed as ``uint16``; ``__meta__`` is a JSON byte string whose ``bfloat16``
list names those keys. The JAX loader decodes them with ``ml_dtypes``; this
one needs only numpy: a bfloat16 is the top half of a float32, so shifting
the 16 bits left by 16 gives the exact float32 value.
"""

from __future__ import annotations

import json
import os

import numpy as np


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
