"""The port's JPEG round trip (``data/jpeg.py``) against Pillow and JAX's cache, on the CPU.

JAX's text-conditional LAION ``run`` trains on what its loader reads back
from its quality-95 JPEG cache. ``jpeg_round_trip`` computes those pixels in
numpy; Pillow (libjpeg-turbo) is the oracle here, and the port never
imports it.
"""

import io

import numpy as np
import pytest
from PIL import Image

from tinydiffusion_tpu.data import laion as jax_laion
from tinydiffusion_torch.data import laion
from tinydiffusion_torch.data.jpeg import jpeg_round_trip, quant_tables


def _pillow_round_trip(image: np.ndarray, quality: int = 95) -> np.ndarray:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", quality=quality)
    return np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))


def test_records_equal_jax_warm_cache_reads(tmp_path):
    """40 records at 256²: JAX's dataset reads each once (writing its JPEG
    cache, as ``precache_dataset`` does) and again (decoding the cache, the
    read its ``run`` stacks); ``precache_records`` equals the second read
    byte for byte, and differs from the first as much as the JPEG does."""
    n, size = 40, 256
    records = laion.load_laion_dataset(n)
    ds = jax_laion.LAIONImageTextDataset(
        records, cache_dir=str(tmp_path / "cache"), failed_urls_cache=str(tmp_path / "f.json"),
        image_size=size, normalize=True, on_error="raise", as_uint8=True)
    cold = np.stack([ds[i][0] for i in range(n)])
    warm = np.stack([ds[i][0] for i in range(n)])
    images, _ = laion.precache_records(records, size)
    np.testing.assert_array_equal(images, warm)
    gap = np.abs(cold.astype(np.int64) - warm)
    assert 2.5 < gap.mean() < 4.0 and gap.max() > 50  # the loss the round trip adds


@pytest.mark.parametrize("shape", [(64, 64), (40, 24), (24, 40), (33, 17), (18, 30),
                                   (100, 76), (8, 8), (2, 3), (1, 1)])
def test_round_trip_equals_pillow_on_any_extent(shape):
    """Random and smooth images whose sides are not whole MCUs (the edge
    padding of each plane), or leave the chroma 2 columns wide (replicated,
    not fancy, upsampling)."""
    rng = np.random.default_rng(shape[0] * 101 + shape[1])
    noise = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    ramp = (np.add.outer(np.arange(shape[0]), 2 * np.arange(shape[1]))[..., None]
            * np.array([3, 5, 7])) % 256
    for image in (noise, ramp.astype(np.uint8)):
        np.testing.assert_array_equal(jpeg_round_trip(image), _pillow_round_trip(image))


def test_round_trip_batches_and_qualities():
    """A batch at once equals each image alone; other qualities' tables
    (libjpeg's scaling, clamped to [1, 255] for baseline) hold too."""
    images = np.stack([laion.synthesize_image(i, 32)[0] for i in range(4)])
    batch = jpeg_round_trip(images)
    for image, got in zip(images, batch):
        np.testing.assert_array_equal(got, jpeg_round_trip(image))
    for quality in (10, 50, 75, 100):
        np.testing.assert_array_equal(jpeg_round_trip(images[0], quality),
                                      _pillow_round_trip(images[0], quality))
    luma, chroma = quant_tables(95)
    assert luma[0, 0] == 2 and chroma[7, 7] == 10 and quant_tables(100)[0].max() == 1
    with pytest.raises(ValueError, match="uint8"):
        jpeg_round_trip(images.astype(np.float32))
