"""The port's JPEG (``data/jpeg.py``) against Pillow and JAX's cache, on the CPU.

JAX's LAION loader caches each record as a quality-95 JPEG and reads it back
with Pillow. ``encode_jpeg`` writes Pillow's file byte for byte,
``decode_jpeg`` reads baseline files as Pillow does, and ``jpeg_round_trip``
computes the pixels of the round trip; Pillow (libjpeg-turbo) is the oracle
here, and the port never imports it.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import io
import os

import numpy as np
import pytest
from PIL import Image

from tinydiffusion_tpu.data import laion as jax_laion
from tinydiffusion_torch.data import laion
from tinydiffusion_torch.data.jpeg import decode_jpeg, encode_jpeg, jpeg_round_trip, quant_tables


def _pillow_round_trip(image: np.ndarray, quality: int = 95) -> np.ndarray:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", quality=quality)
    return np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))


def test_records_equal_jax_warm_cache_reads(tmp_path):
    """40 records at 256²: JAX's dataset reads each once (writing its JPEG
    cache, as ``precache_dataset`` does) and again (decoding the cache, the
    read its ``run`` stacks); the port's dataset does the same on a cache of
    its own, and each read equals JAX's byte for byte, as do the cache
    files; the warm read differs from the cold one as much as the JPEG
    does."""
    n, size = 40, 256
    records = laion.load_laion_dataset(n)
    kw = dict(image_size=size, normalize=True, on_error="raise", as_uint8=True)
    ds = jax_laion.LAIONImageTextDataset(
        records, cache_dir=str(tmp_path / "cache"), failed_urls_cache=str(tmp_path / "f.json"),
        **kw)
    port = laion.LAIONImageTextDataset(
        records, cache_dir=str(tmp_path / "port"), failed_urls_cache=str(tmp_path / "p.json"),
        **kw)
    cold = np.stack([ds[i][0] for i in range(n)])
    warm = np.stack([ds[i][0] for i in range(n)])
    np.testing.assert_array_equal(np.stack([port[i][0] for i in range(n)]), cold)
    np.testing.assert_array_equal(np.stack([port[i][0] for i in range(n)]), warm)
    for name in os.listdir(tmp_path / "cache"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "cache" / name).read_bytes()
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


# --- the file: encode_jpeg and decode_jpeg against Pillow ------------------------------


def _pillow_file(image: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pillow_read(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    ramp = (np.add.outer(np.arange(shape[0]), 2 * np.arange(shape[1]))[..., None]
            * np.array([3, 5, 7])) % 256
    return noise, ramp.astype(np.uint8)


_SHAPES = [(1, 1), (2, 3), (8, 8), (9, 9), (15, 31), (17, 33), (33, 17), (40, 24), (64, 64),
           (100, 76)]


@pytest.mark.parametrize("shape", _SHAPES)
def test_encode_jpeg_is_pillows_file(shape):
    """Byte for byte Pillow's quality-95 file (and at other qualities), on
    sides that are no whole MCUs (the dummy blocks at the right and bottom
    edges), 1 x 1 included, and on a black image (all-zero AC: EOB only)."""
    for image in (*_images(shape, shape[0] * 31 + shape[1]), np.zeros(shape + (3,), np.uint8)):
        for quality in (95, 10, 50, 100):
            assert encode_jpeg(image, quality) == _pillow_file(image, quality=quality), quality


@pytest.mark.parametrize("options", [
    {"quality": 95}, {"quality": 90, "subsampling": 0}, {"quality": 80, "subsampling": 1},
    {"quality": 75, "subsampling": 2}, {"quality": 95, "optimize": True},
    {"quality": 85, "subsampling": 1, "optimize": True}, {"quality": 90, "qtables": "web_low"},
    {"quality": 90, "restart_marker_blocks": 3}, {"quality": 70, "restart_marker_rows": 1},
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_decode_jpeg_equals_pillow(options):
    """Pillow's 4:2:0, 4:2:2 and 4:4:4 files (the fancy upsampling of each),
    optimised Huffman tables, other quantisation tables and restart
    intervals, on sides that are no whole MCUs and chroma 2 columns wide or
    less (replicated, not fancy); greyscale files likewise."""
    for shape in _SHAPES:
        for image in _images(shape, shape[1] * 17 + shape[0]):
            data = _pillow_file(image, **options)
            np.testing.assert_array_equal(decode_jpeg(data), _pillow_read(data),
                                          err_msg=str(shape))
            grey = _pillow_file(image[..., 1], **{k: v for k, v in options.items()
                                                  if k != "subsampling"})
            np.testing.assert_array_equal(decode_jpeg(grey), _pillow_read(grey),
                                          err_msg=f"grey {shape}")


def test_decode_jpeg_takes_1x2_luma_sampling():
    """Luma sampled 1 x 2 (4:4:0: libjpeg-turbo's h1v2 fancy upsampling),
    made from a 4:2:2 file by swapping its SOF0 factors: a square of whole
    MCUs codes as many blocks either way, so the swapped file is valid."""
    image = _images((32, 32), 5)[0]
    data = bytearray(_pillow_file(image, quality=90, subsampling=1))
    sof = data.index(b"\xff\xc0")
    assert data[sof + 11] == 0x21  # component 1: h = 2, v = 1
    data[sof + 11] = 0x12
    np.testing.assert_array_equal(decode_jpeg(bytes(data)), _pillow_read(bytes(data)))


def test_decode_jpeg_round_trips_the_encoder_and_refuses_other_files():
    """``decode_jpeg(encode_jpeg(x))`` is ``jpeg_round_trip(x)``; progressive
    and CMYK files decode as Pillow decodes them (``test_torch_decoders.py``
    holds every variant); arithmetic-coded lossless, lossless, 12-bit,
    truncated and non-JPEG data raise ValueError with the reason
    (arithmetic-coded sequential and progressive files decode:
    ``test_torch_arith_jpeg.py``)."""
    image = laion.synthesize_image(3, 96)[0]
    np.testing.assert_array_equal(decode_jpeg(encode_jpeg(image)), jpeg_round_trip(image))
    progressive = _pillow_file(image, progressive=True)
    np.testing.assert_array_equal(decode_jpeg(progressive), _pillow_read(progressive))
    cmyk = io.BytesIO()
    Image.fromarray(image).convert("CMYK").save(cmyk, "JPEG")
    np.testing.assert_array_equal(decode_jpeg(cmyk.getvalue()), _pillow_read(cmyk.getvalue()))
    baseline = encode_jpeg(image)
    sof = baseline.index(b"\xff\xc0")
    for marker, reason in ((0xCB, "arithmetic-coded lossless"), (0xC3, "lossless")):
        with pytest.raises(ValueError, match=reason):
            decode_jpeg(baseline[:sof + 1] + bytes([marker]) + baseline[sof + 2:])
    with pytest.raises(ValueError, match="12-bit"):
        decode_jpeg(baseline[:sof + 4] + bytes([12]) + baseline[sof + 5:])
    data = encode_jpeg(image)
    for cut in (len(data) // 2, 300, len(data) - 40):
        with pytest.raises(ValueError, match="truncated|corrupt"):
            decode_jpeg(data[:cut])
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")
