"""The offline LAION-style records: synthetic images and captions, numpy only.

Copy of ``synthesize_caption``, ``synthesize_image`` and the offline branch of
``load_laion_dataset`` from ``tinydiffusion_tpu/data/laion.py``, kept here so
the port needs neither that module's PIL import nor the JAX package, and the
valid-subset rule of its ``precache_dataset`` (a record is kept when its
caption is not empty and its image not all black; the reference's
conditional_diffusion_laion.py:165-204). The tests hold both to the same
bytes.

JAX serves a ``synthetic://i`` record through its URL-fetch machinery and a
JPEG cache (``LAIONImageTextDataset``, laion.py:219-251): a cold cache hands
back the synthesized bytes (and writes a quality-95 JPEG of them), a warm
one the lossy JPEG decode. The port has no PIL, no cache and no network.
JAX's text-conditional ``run`` reads each record twice (``precache_dataset``,
then the stacking read), so it trains on the JPEG decodes, which differ from
the synthesized bytes by 3.2 levels of 255 on average (up to 96; 40 records
at 256²): ``precache_records`` hands back those decodes, computed by
``data/jpeg.py::jpeg_round_trip``. JAX's conv-VAE ``run`` reads each record
once (``experiments/vae_laion.py:215``), on the synthesized bytes, so the
port's conv-VAE takes ``synthesize_image`` as it is. The online loader
(HTTP, the md5-named cache, the failed-URL list) is not ported.
"""

from __future__ import annotations

import numpy as np

from tinydiffusion_torch.data.jpeg import jpeg_round_trip

SYNTHETIC_SCHEME = "synthetic://"

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


def load_laion_dataset(n_records: int, offline: bool = True) -> list[dict]:
    """Records with the reference's column names (``URL``, ``TEXT``): with
    ``offline``, ``synthetic://i`` and its caption for i < ``n_records``.
    ``offline=False`` (the HF dataset and HTTP fetches) raises: not ported."""
    if not offline:
        raise NotImplementedError("the online LAION loader (HTTP and the JPEG cache) is not "
                                  "ported; use offline=True (synthetic records)")
    return [{"URL": f"{SYNTHETIC_SCHEME}{i}", "TEXT": synthesize_caption(i)}
            for i in range(n_records)]


# Records a batch of the JPEG round trip (its int64 planes: ~100 MB at 256²).
_JPEG_CHUNK = 64


def precache_records(records: list[dict], image_size: int) -> tuple[np.ndarray, list[str]]:
    """The valid records as ``(images, texts)``: (N, S, S, 3) uint8 images
    and their captions, in record order, keeping a record only when its
    caption is not empty and its image not all black (JAX's
    ``precache_dataset``, which caches each image as a quality-95 JPEG, then
    ``ds[i]`` for each valid i, which reads that JPEG back: each image here
    is ``jpeg_round_trip`` of the synthesized one)."""
    images, texts = [], []
    for record in records:
        url, text = record["URL"], record.get("TEXT", "")
        if not url.startswith(SYNTHETIC_SCHEME):
            raise NotImplementedError(f"{url!r}: the port reads synthetic:// records only")
        image, _ = synthesize_image(int(url[len(SYNTHETIC_SCHEME):]), image_size)
        if text and image.any():
            images.append(image)
            texts.append(text)
    if not images:
        return np.zeros((0, image_size, image_size, 3), np.uint8), []
    images = np.stack(images)
    for start in range(0, len(images), _JPEG_CHUNK):
        images[start:start + _JPEG_CHUNK] = jpeg_round_trip(images[start:start + _JPEG_CHUNK])
    return images, texts
