"""Deterministic synthetic LAION-style images, numpy only.

Copy of ``synthesize_caption`` / ``synthesize_image`` from
``tinydiffusion_tpu/data/laion.py`` (the offline record source), kept here so
the port needs neither that module's PIL import nor the JAX package. The
tests hold both to the same bytes.
"""

from __future__ import annotations

import numpy as np

_CLASSES = ("cat", "dog", "horse", "cow")


def synthesize_caption(i: int) -> str:
    """Deterministic caption of record ``i``."""
    return f"a photo of a {_CLASSES[i % len(_CLASSES)]}"


def synthesize_image(i: int, size: int) -> tuple[np.ndarray, str]:
    """Deterministic (size, size, 3) uint8 image of record ``i`` + its caption.

    Class-dependent palette and shape (circle / square / diamond / stripes)
    over a dark diagonal gradient with per-record jitter.
    """
    cls = i % len(_CLASSES)
    rng = np.random.default_rng([9176, int(i)])
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)

    base = 0.08 + 0.30 * (0.5 * (xx + yy))
    img = np.stack([base, base, base], axis=-1)

    palettes = np.array(
        [[0.85, 0.45, 0.20],   # cat: orange
         [0.30, 0.55, 0.90],   # dog: blue
         [0.45, 0.75, 0.30],   # horse: green
         [0.85, 0.80, 0.30]],  # cow: yellow
        np.float32,
    )
    color = palettes[cls] * rng.uniform(0.85, 1.1)
    cy, cx = rng.uniform(0.35, 0.65, 2)
    r = rng.uniform(0.18, 0.30)
    dy, dx = yy - cy, xx - cx
    if cls == 0:
        mask = dy * dy + dx * dx < r * r
    elif cls == 1:
        mask = np.maximum(np.abs(dy), np.abs(dx)) < r
    elif cls == 2:
        mask = (np.abs(dy) + np.abs(dx)) < 1.3 * r
    else:
        mask = (np.abs(dy) < r) & (np.sin(xx * 28.0) > 0.0)
    img = np.where(mask[..., None], color, img)
    img = img + rng.normal(0.0, 0.015, img.shape).astype(np.float32)
    img = np.clip(img, 0.0, 1.0)
    return (img * 255).astype(np.uint8), synthesize_caption(i)
