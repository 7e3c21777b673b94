"""MNIST as uint8 (N, 28, 28, 1), from IDX files or a synthetic digit set.

Counterpart of ``tinydiffusion_tpu/data/mnist.py`` (``load_mnist_u8``, the
IDX reader and ``train_val_split``). With no IDX files under ``data_root`` a deterministic synthetic
set (pixel-font glyphs + translation + intensity + noise) is generated and
cached as ``data_root/synthetic_mnist_<split>_<n>.npz``; its bytes equal the
JAX package's. The cache is written under ``data_root``, so a run that must
leave its checkout untouched passes a temporary directory.

Storage stays uint8; ``MNIST_SCALE``/``MNIST_SHIFT`` map it to [-1, 1] on
the device (``data.loader.BatchIterator.to_device``).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

# ToTensor + Normalize((0.5,), (0.5,)): u8 -> [-1, 1].
MNIST_SCALE = 2.0 / 255.0
MNIST_SHIFT = -1.0

_IDX_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}

# 7x5 pixel-font digit glyphs for the synthetic fallback.
_GLYPHS = [
    "01110 10001 10011 10101 11001 10001 01110",  # 0
    "00100 01100 00100 00100 00100 00100 01110",  # 1
    "01110 10001 00001 00010 00100 01000 11111",  # 2
    "11110 00001 00001 01110 00001 00001 11110",  # 3
    "00010 00110 01010 10010 11111 00010 00010",  # 4
    "11111 10000 11110 00001 00001 10001 01110",  # 5
    "00110 01000 10000 11110 10001 10001 01110",  # 6
    "11111 00001 00010 00100 01000 01000 01000",  # 7
    "01110 10001 10001 01110 10001 10001 01110",  # 8
    "01110 10001 10001 01111 00001 00010 01100",  # 9
]


def _open_maybe_gz(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _find_idx(data_root: str, name: str) -> str | None:
    for sub in ("", "MNIST/raw"):
        for suffix in ("", ".gz"):
            p = os.path.join(data_root, sub, name + suffix)
            if os.path.exists(p):
                return p
    return None


def _read_idx(path: str) -> np.ndarray:
    """Parse an IDX-format file (big-endian magic + dims + u8 payload)."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _glyph_bank() -> np.ndarray:
    """(10, 28, 28) float canonical digit images, upscaled pixel font."""
    bank = np.zeros((10, 28, 28), np.float32)
    for d, spec in enumerate(_GLYPHS):
        g = np.array([[c == "1" for c in r] for r in spec.split()], np.float32)  # (7, 5)
        bank[d, 3:24, 6:21] = np.kron(g, np.ones((3, 3), np.float32))  # 21 x 15
    return bank


def _synthesize(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic digit-like images: glyph + translation + intensity +
    noise, through a precomputed (10, 49, 28, 28) shift table."""
    bank = _glyph_bank()
    shifts = [(dy, dx) for dy in range(-3, 4) for dx in range(-3, 4)]
    table = np.stack([np.roll(bank, s, axis=(1, 2)) for s in shifts], axis=1)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    offs = rng.integers(0, len(shifts), n)
    imgs = table[labels, offs]
    imgs = imgs * rng.uniform(0.65, 1.0, (n, 1, 1)).astype(np.float32)
    imgs = imgs + rng.normal(0.0, 0.03, imgs.shape).astype(np.float32)
    imgs = np.clip(imgs, 0.0, 1.0)
    return (imgs * 255).astype(np.uint8)[..., None], labels


def load_mnist_u8(
    data_root: str, train: bool = True, synthetic_n: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """uint8 images (N, 28, 28, 1) + int32 labels.

    Real IDX files under ``data_root`` (or ``data_root/MNIST/raw``) win;
    otherwise the cached deterministic synthetic set.
    """
    img_name, lbl_name = _IDX_FILES[bool(train)]
    img_path, lbl_path = _find_idx(data_root, img_name), _find_idx(data_root, lbl_name)
    if img_path and lbl_path:
        return _read_idx(img_path)[..., None], _read_idx(lbl_path).astype(np.int32)

    n = synthetic_n if synthetic_n is not None else (60_000 if train else 10_000)
    split = "train" if train else "test"
    cache = os.path.join(data_root, f"synthetic_mnist_{split}_{n}.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            return z["images"], z["labels"]
    images, labels = _synthesize(n, seed=1234 if train else 5678)
    os.makedirs(data_root, exist_ok=True)
    np.savez_compressed(cache, images=images, labels=labels)
    return images, labels


def train_val_split(
    images: np.ndarray, labels: np.ndarray, val_frac: float, seed: int = 42
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic shuffled split, JAX's (the reference's 80/20 with seed
    42): ``default_rng(seed).permutation(n)``, the first ``round(n *
    val_frac)`` rows for validation. Returns (xt, yt, xv, yv)."""
    perm = np.random.default_rng(seed).permutation(len(images))
    n_val = int(round(len(images) * val_frac))
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    return images[train_idx], labels[train_idx], images[val_idx], labels[val_idx]
