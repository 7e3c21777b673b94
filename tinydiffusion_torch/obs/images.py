"""Image-grid artifacts, written without PIL.

Counterpart of ``tinydiffusion_tpu/obs/images.py``: ``make_grid`` is the same
numpy tiling (torchvision ``make_grid`` semantics); ``save_image_grid``
encodes the PNG itself with ``zlib`` and ``struct``, because the port's
machines may have no PIL. The JAX version's optional per-tile text labels
need a font renderer and are not carried over.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def make_grid(
    images: np.ndarray,
    nrow: int = 4,
    padding: int = 2,
    normalize: bool = True,
    pad_value: float = 0.0,
) -> np.ndarray:
    """Tile NHWC images into one HWC grid (torchvision make_grid semantics:
    row-major placement, ``padding`` px between tiles, optional min/max
    normalization over the whole batch)."""
    images = np.asarray(images, dtype=np.float32)
    if images.ndim == 3:
        images = images[..., None]
    n, h, w, c = images.shape
    if normalize:
        lo, hi = images.min(), images.max()
        images = (images - lo) / max(hi - lo, 1e-8)
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.full(
        (padding + nrows * (h + padding), padding + ncol * (w + padding), c),
        pad_value,
        dtype=np.float32,
    )
    for i in range(n):
        r, col = divmod(i, ncol)
        top = padding + r * (h + padding)
        left = padding + col * (w + padding)
        grid[top : top + h, left : left + w] = images[i]
    return grid


def encode_png(pixels: np.ndarray) -> bytes:
    """8-bit grayscale (H, W, 1) or RGB (H, W, 3) uint8 pixels -> PNG bytes."""
    h, w, c = pixels.shape
    color_type = {1: 0, 3: 2}[c]  # PNG colour types: 0 gray, 2 RGB

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    # Each scanline is prefixed with filter type 0 (none).
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(pixels, np.uint8).reshape(h, w * c)],
        axis=1,
    )
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def save_image_grid(
    images: np.ndarray, path: str, nrow: int = 4, normalize: bool = True
) -> None:
    """Write NHWC images as one PNG sample sheet."""
    grid = make_grid(images, nrow=nrow, normalize=normalize)
    pixels = (np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(pixels))
