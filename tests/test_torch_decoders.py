"""The port's image decoders against Pillow 12.1, byte for byte, on the CPU.

JAX's LAION loader reads every web record with ``Image.open(f).convert("RGB")``;
the port's ``data/laion.py::decode_image`` must give the same bytes for every
format Pillow reads there: progressive, CMYK and YCCK JPEG
(``data/jpeg.py``), Adam7 and 16-bit greyscale PNG (``data/png.py``), GIF
(``data/gif.py``), BMP (``data/bmp.py``) and WebP, lossless and lossy
(``data/webp.py``). Each file is written by Pillow at odd sizes, several
qualities and palettes, or, where Pillow writes no such file (Adam7 PNG,
4-bit, RLE and top-down BMP, a GIF with a local palette at an offset, an
animated WebP whose first frame sits at an offset), by the small writers
here, and then read by Pillow as the oracle. The committed fixtures the
card's ``laion_loader`` phase decodes without Pillow are rebuilt here, and
a progressive-JPEG and a WebP record go through both packages'
``LAIONImageTextDataset`` over a loopback server, cold and warm.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tinydiffusion_tpu.data import laion as jax_laion
from tinydiffusion_torch.data import laion
from tinydiffusion_torch.data.bmp import decode_bmp
from tinydiffusion_torch.data.gif import decode_gif
from tinydiffusion_torch.data.jpeg import decode_jpeg
from tinydiffusion_torch.data.png import _ADAM7, decode_png
from tinydiffusion_torch.data.webp import decode_webp

FIXTURES = Path(__file__).parent / "fixtures"
SIZES = [(1, 1), (7, 5), (17, 31), (48, 33)]


def _image(shape, seed: int) -> np.ndarray:
    """Smooth ramps with a block of noise and a hard edge: every decoder
    meets flat areas, gradients and detail."""
    rng = np.random.default_rng(seed)
    h, w = shape
    y, x = np.mgrid[:h, :w]
    image = np.stack([(3 * x + y) * 5 % 256, (x * y) % 256, 255 * ((x // 6 + y // 5) % 2)], -1)
    image[h // 3:h // 2 + 1, w // 4:w // 2 + 1] = rng.integers(0, 256, (3,))
    noise = rng.random((h, w, 1)) < 0.2
    return np.where(noise, rng.integers(0, 256, (h, w, 3)), image).astype(np.uint8)


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _saved(image: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **kw)
    return buf.getvalue()


def _assert_pillows(data: bytes, decode=laion.decode_image) -> None:
    want = _pillow(data)
    got = decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- JPEG -------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SIZES + [(64, 96)])
@pytest.mark.parametrize("quality", [30, 75, 95, 100])
def test_progressive_jpeg_equals_pillow(shape, quality):
    """``progressive=True`` (libjpeg-turbo's simple progression: spectral
    selection, successive approximation, EOB runs) at 4:4:4, 4:2:2 and
    4:2:0, optimised tables, greyscale, and restart intervals."""
    image = Image.fromarray(_image(shape, quality))
    for subsampling in (0, 1, 2):
        _assert_pillows(_saved(image, "JPEG", quality=quality, progressive=True,
                               subsampling=subsampling), decode_jpeg)
    _assert_pillows(_saved(image.convert("L"), "JPEG", quality=quality, progressive=True))
    _assert_pillows(_saved(image, "JPEG", quality=quality, progressive=True,
                           restart_marker_blocks=3))


@pytest.mark.parametrize("shape", SIZES)
@pytest.mark.parametrize("progressive", [False, True])
def test_cmyk_and_ycck_jpeg_equal_pillow(shape, progressive):
    """Adobe CMYK as Pillow writes it, and the same file flagged YCCK in its
    APP14 marker (transform 2), which Pillow reads through libjpeg's YCCK
    conversion."""
    data = _saved(Image.fromarray(_image(shape, 3)).convert("CMYK"), "JPEG", quality=90,
                  progressive=progressive)
    _assert_pillows(data)
    at = data.find(b"Adobe")
    assert at > 0 and data[at + 11] == 0
    _assert_pillows(data[:at + 11] + b"\x02" + data[at + 12:])


# --- PNG --------------------------------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filtered(samples: np.ndarray, depth: int, bpp: int) -> bytes:
    """Scanlines of (h, w * channels) samples, packed at ``depth`` and
    filtered with each of the five filters in turn."""
    h = samples.shape[0]
    if depth == 16:
        raw = np.stack([samples >> 8, samples & 255], -1).reshape(h, -1)
    elif depth < 8:
        per = 8 // depth
        padded = np.pad(samples, [(0, 0), (0, -samples.shape[1] % per)]).reshape(h, -1, per)
        raw = (padded << (depth * np.arange(per - 1, -1, -1))).sum(-1)
    else:
        raw = samples
    raw = raw.astype(np.int64)
    out, prev = [], np.zeros(raw.shape[1], np.int64)
    for y in range(h):
        line, kind = raw[y], y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 4:
            pa, pb = np.abs(prev - up_left), np.abs(left - up_left)
            pc = np.abs(left + prev - 2 * up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        else:
            pred = (0, left, prev, (left + prev) >> 1)[kind]
        out.append(bytes([kind]) + ((line - pred) & 255).astype(np.uint8).tobytes())
        prev = line
    return b"".join(out)


def write_png(samples: np.ndarray, color: int, depth: int, interlace: bool,
              palette: np.ndarray | None = None) -> bytes:
    """A PNG of (h, w, channels) ``samples``, Adam7-interlaced when asked
    (Pillow writes no interlaced PNG)."""
    h, w, channels = samples.shape
    bpp = max(1, channels * depth // 8)
    if interlace:
        parts = [samples[y0::dy, x0::dx] for y0, x0, dy, dx in _ADAM7]
        data = b"".join(_filtered(p.reshape(p.shape[0], -1), depth, bpp) for p in parts if p.size)
    else:
        data = _filtered(samples.reshape(h, -1), depth, bpp)
    head = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", head)
            + (_chunk(b"PLTE", palette.tobytes()) if palette is not None else b"")
            + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


_PNG_TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
              (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("color,depth", _PNG_TYPES)
def test_adam7_png_equals_pillow(color, depth):
    """Adam7 for every colour type and depth ``decode_png`` reads, at sizes
    that leave passes empty; and each non-interlaced twin."""
    rng = np.random.default_rng(color * 17 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    for h, w in [(1, 1), (2, 3), (5, 9), (13, 11), (16, 17)]:
        samples = rng.integers(0, 1 << depth, (h, w, channels))
        palette = (rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8) if color == 3
                   else None)
        for interlace in (True, False):
            _assert_pillows(write_png(samples, color, depth, interlace, palette), decode_png)


def test_16_bit_greyscale_png_equals_pillow():
    """Pillow opens a 16-bit greyscale PNG as ``I;16`` and clamps it to 255
    in ``convert("RGB")``: values from 0 to 65535, as Pillow writes them."""
    values = np.array([[0, 1, 254, 255, 256, 300, 1000, 65535]], np.uint16)
    values = np.concatenate([values, np.random.default_rng(0).integers(0, 65536, (6, 8))
                             .astype(np.uint16), np.random.default_rng(1).integers(
                                 0, 300, (6, 8)).astype(np.uint16)])
    data = _saved(Image.fromarray(values), "PNG")
    assert Image.open(io.BytesIO(data)).mode == "I;16"
    _assert_pillows(data)


# --- GIF --------------------------------------------------------------------------


def _lzw(indices: np.ndarray, min_size: int) -> bytes:
    """GIF LZW without compression: each index a code, a clear code before
    the table would grow a bit."""
    clear, size = 1 << min_size, min_size + 1
    codes, n = [clear], 0
    for v in indices.tolist():
        codes.append(v)
        n += 1
        if n == (1 << size) - clear - 3:
            codes.append(clear)
            n = 0
    codes.append(clear + 1)
    acc = bits = 0
    out = bytearray()
    for c in codes:
        acc |= c << bits
        bits += size
        while bits >= 8:
            out.append(acc & 255)
            acc >>= 8
            bits -= 8
    return bytes(out + (bytes([acc]) if bits else b""))


def _blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def write_gif(screen, frame, at, global_palette=None, local_palette=None, transparent=None,
              interlace=False, min_size=8) -> bytes:
    """A one-frame GIF89a; ``frame`` (h, w) indices placed at ``at`` (x, y)."""
    h, w = frame.shape
    out = b"GIF89a" + struct.pack("<HH", *screen)
    if global_palette is not None:
        out += bytes([0x80 | (len(global_palette).bit_length() - 2), 0, 0])
        out += global_palette.tobytes()
    else:
        out += bytes(3)
    if transparent is not None:
        out += b"\x21\xf9\x04" + bytes([1, 0, 0, transparent]) + b"\x00"
    out += b"\x21\xfe" + _blocks(b"a comment")
    flags = 0x40 if interlace else 0
    if local_palette is not None:
        flags |= 0x80 | (len(local_palette).bit_length() - 2)
    out += b"," + struct.pack("<HHHH", *at, w, h) + bytes([flags])
    if local_palette is not None:
        out += local_palette.tobytes()
    rows = frame
    if interlace:
        rows = frame[np.concatenate([np.arange(s, h, t) for s, t in ((0, 8), (4, 8), (2, 4),
                                                                     (1, 2))])]
    return out + bytes([min_size]) + _blocks(_lzw(rows.reshape(-1), min_size)) + b";"


@pytest.mark.parametrize("shape", SIZES)
def test_gif_written_by_pillow_equals_pillow(shape):
    """Pillow's GIFs: adaptive palettes of 256 and 5 colours, interlaced
    (Pillow's default from 16 pixels) or not, a transparent index, a
    greyscale image, and an animation (its first frame)."""
    rgb = _image(shape, 4)
    image = Image.fromarray(rgb)
    for kw in ({}, {"interlace": False}, {"transparency": 3}):
        _assert_pillows(_saved(image, "GIF", **kw), decode_gif)
    _assert_pillows(_saved(image.quantize(5), "GIF"))
    _assert_pillows(_saved(Image.fromarray(rgb[..., 0]), "GIF"))
    _assert_pillows(_saved(image, "GIF", save_all=True,
                           append_images=[Image.fromarray(255 - rgb)]))


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("transparent", [None, 2])
def test_gif_palettes_offsets_and_transparency_equal_pillow(interlace, transparent):
    """A frame at an offset inside the screen and one reaching past it (the
    image grows), a local palette, no palette at all (greyscale), and
    indices past a short palette (black)."""
    rng = np.random.default_rng(int(interlace) + 2 * (transparent or 0))
    frame = rng.integers(0, 8, (13, 9)).astype(np.uint8)
    palettes = [rng.integers(0, 256, (8, 3), dtype=np.uint8) for _ in range(2)]
    for screen, at in (((20, 17), (3, 2)), ((5, 5), (3, 2))):
        for glob, local in ((palettes[0], None), (palettes[0], palettes[1]), (None, None)):
            _assert_pillows(write_gif(screen, frame, at, glob, local, transparent, interlace, 3),
                            decode_gif)
    wide = rng.integers(0, 256, (13, 9)).astype(np.uint8)
    _assert_pillows(write_gif((9, 13), wide, (0, 0), palettes[0][:4], None, transparent,
                              interlace, 8), decode_gif)


# --- BMP --------------------------------------------------------------------------


def write_bmp(width, height, bits, body, palette=None, compression=0, top_down=False,
              header=40, masks=None, colors=0) -> bytes:
    """A BMP of the given pixel ``body`` (rows as stored), palette (RGB
    entries) and header (12: core; 40: info, bit-field masks after it; 56:
    masks inside)."""
    if palette is None:
        table = b""
    elif header == 12:
        table = palette[:, ::-1].tobytes()
    else:
        table = np.concatenate([palette[:, ::-1], np.zeros((len(palette), 1), np.uint8)],
                               1).tobytes()
    if header == 12:
        head = struct.pack("<IHHHH", 12, width, height, 1, bits)
        extra = b""
    else:
        head = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1,
                           bits, compression, len(body), 2835, 2835, colors, 0)
        if header == 56:
            head += struct.pack("<IIII", *masks)
            extra = b""
        else:
            extra = b"" if masks is None else struct.pack("<III", *masks[:3])
    offset = 14 + len(head) + len(extra) + len(table)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + head + extra
            + table + body)


def _packed_rows(indices: np.ndarray, bits: int) -> bytes:
    h, w = indices.shape
    per = 8 // bits
    padded = np.pad(indices, [(0, 0), (0, -w % per)]).reshape(h, -1, per)
    rows = (padded.astype(np.int64) << (bits * np.arange(per - 1, -1, -1))).sum(-1)
    stride = ((w * bits + 31) >> 3) & ~3
    return np.pad(rows.astype(np.uint8), [(0, 0), (0, stride - rows.shape[1])]).tobytes()


@pytest.mark.parametrize("shape", SIZES)
def test_bmp_written_by_pillow_equals_pillow(shape):
    """Pillow's BMPs: 24-bit RGB, 32-bit RGBA, 8-bit greyscale and palette,
    1-bit."""
    image = Image.fromarray(_image(shape, 5))
    for converted in (image, image.convert("RGBA"), image.convert("L"), image.convert("1"),
                      image.quantize(13)):
        _assert_pillows(_saved(converted, "BMP"), decode_bmp)


@pytest.mark.parametrize("shape", [(3, 5), (9, 13)])
def test_bmp_variants_equal_pillow(shape):
    """1-, 4- and 8-bit palettes bottom-up and top-down and with the core
    header; a short palette (black past it); 24-bit top-down; 32-bit BGRX
    and bit-field layouts; 16-bit 5-5-5 and 5-6-5."""
    h, w = shape
    rng = np.random.default_rng(h)
    for bits in (1, 4, 8):
        palette = rng.integers(0, 256, (1 << bits, 3), dtype=np.uint8)
        body = _packed_rows(rng.integers(0, 1 << bits, shape), bits)
        for top_down in (False, True):
            _assert_pillows(write_bmp(w, h, bits, body, palette, top_down=top_down), decode_bmp)
        _assert_pillows(write_bmp(w, h, bits, body, palette, header=12), decode_bmp)
    body = _packed_rows(rng.integers(0, 256, shape), 8)
    _assert_pillows(write_bmp(w, h, 8, body, palette[:7], colors=7), decode_bmp)
    pixels = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    stride = ((w * 24 + 31) >> 3) & ~3
    body24 = b"".join(np.pad(pixels[y, :, :3].reshape(-1), (0, stride - 3 * w)).tobytes()
                      for y in range(h))
    for top_down in (False, True):
        _assert_pillows(write_bmp(w, h, 24, body24, top_down=top_down), decode_bmp)
    _assert_pillows(write_bmp(w, h, 32, pixels.tobytes()), decode_bmp)
    for masks in ((0xFF0000, 0xFF00, 0xFF, 0), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                  (0xFF000000, 0xFF0000, 0xFF00, 0xFF)):
        _assert_pillows(write_bmp(w, h, 32, pixels.tobytes(), compression=3, header=56,
                                  masks=masks), decode_bmp)
    values = rng.integers(0, 65536, shape).astype("<u2")
    stride = ((w * 16 + 31) >> 3) & ~3
    body16 = b"".join(np.pad(values[y].view(np.uint8), (0, stride - 2 * w)).tobytes()
                      for y in range(h))
    _assert_pillows(write_bmp(w, h, 16, body16), decode_bmp)
    _assert_pillows(write_bmp(w, h, 16, body16, compression=3, masks=(0xF800, 0x7E0, 0x1F, 0)),
                    decode_bmp)


def test_rle_bmp_equals_pillow():
    """RLE8 and RLE4 streams with encoded runs, absolute runs (padded to an
    even position), row ends, a delta and the image end, bottom-up and
    top-down."""
    palette = np.random.default_rng(9).integers(0, 256, (256, 3), dtype=np.uint8)
    rle8 = bytes([3, 5, 0, 3, 1, 2, 3, 0, 0, 2, 7, 0, 4, 9, 8, 7, 6, 0, 0, 1, 4, 0, 2, 1, 1,
                  3, 3, 0, 0, 5, 9, 0, 1])
    for top_down in (False, True):
        _assert_pillows(write_bmp(7, 5, 8, rle8, palette, compression=1, top_down=top_down),
                        decode_bmp)
    rle4 = bytes([5, 0x12, 0, 4, 0x34, 0x56, 0, 0, 0, 5, 0xAB, 0xCD, 0xE0, 0, 2, 0x77, 0, 0, 3,
                  0x9F, 0, 2, 1, 1, 2, 0x33, 0, 1])
    _assert_pillows(write_bmp(9, 4, 4, rle4, palette[:16], compression=2), decode_bmp)


# --- WebP -------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SIZES + [(64, 64)])
def test_lossless_webp_equals_pillow(shape):
    """VP8L at three effort levels (its transforms, colour cache and meta
    codes), a palette image (colour indexing, packed pixels) and RGBA."""
    rgb = _image(shape, 6)
    image = Image.fromarray(rgb)
    for kw in ({}, {"quality": 0}, {"quality": 100, "method": 6}):
        _assert_pillows(_saved(image, "WEBP", lossless=True, **kw), decode_webp)
    _assert_pillows(_saved(image.quantize(7).convert("RGB"), "WEBP", lossless=True))
    alpha = np.random.default_rng(0).integers(0, 256, shape + (1,), dtype=np.uint8)
    _assert_pillows(_saved(Image.fromarray(np.concatenate([rgb, alpha], -1)), "WEBP",
                           lossless=True))


@pytest.mark.parametrize("shape", SIZES + [(64, 80)])
@pytest.mark.parametrize("quality", [5, 50, 80, 100])
def test_lossy_webp_equals_pillow(shape, quality):
    """VP8 at each quality, at two methods (segments, 16x16 and 4x4 modes,
    skipped blocks, the normal loop filter), and with alpha (VP8X and
    ALPH: the alpha dropped)."""
    rgb = _image(shape, quality)
    image = Image.fromarray(rgb)
    for method in (0, 6):
        _assert_pillows(_saved(image, "WEBP", quality=quality, method=method), decode_webp)
    alpha = (np.arange(shape[0] * shape[1]).reshape(shape + (1,)) * 7 % 256).astype(np.uint8)
    _assert_pillows(_saved(Image.fromarray(np.concatenate([rgb, alpha], -1)), "WEBP",
                           quality=quality), decode_webp)


@pytest.mark.parametrize("lossless", [False, True])
def test_animated_webp_reads_its_first_frame(lossless):
    """Pillow's animation (a frame on the whole canvas), and the first frame
    moved to an offset on a larger canvas: zeros around it, as libwebp's
    animation decoder clears a key frame's canvas."""
    frames = [Image.fromarray(_image((22, 30), k)) for k in (7, 8)]
    data = _saved(frames[0], "WEBP", save_all=True, append_images=frames[1:], duration=50,
                  lossless=lossless, quality=70)
    _assert_pillows(data, decode_webp)
    still = _saved(frames[0], "WEBP", lossless=lossless, quality=70)
    kind, size = still[12:16], int.from_bytes(still[16:20], "little")
    image_chunk = still[12:20 + size + (size & 1)]
    u24 = lambda v: v.to_bytes(3, "little")  # noqa: E731
    anmf = u24(2) + u24(3) + u24(29) + u24(21) + u24(50) + b"\x00" + image_chunk
    body = (b"VP8X" + struct.pack("<I", 10) + bytes([0x02, 0, 0, 0]) + u24(39) + u24(31)
            + b"ANIM" + struct.pack("<I", 6) + bytes(6)
            + b"ANMF" + struct.pack("<I", len(anmf)) + anmf)
    moved = b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body
    assert kind in (b"VP8 ", b"VP8L")
    want = _pillow(moved)
    assert want.shape == (32, 40, 3) and not want[:6].any() and not want[:, :4].any()
    np.testing.assert_array_equal(decode_webp(moved), want)


# --- dispatch, errors, fixtures, records ------------------------------------------


def test_decode_image_dispatches_by_magic_and_refuses_the_rest():
    rgb = _image((9, 11), 10)
    image = Image.fromarray(rgb)
    for fmt, kw in (("JPEG", {"progressive": True}), ("PNG", {}), ("GIF", {}), ("BMP", {}),
                    ("WEBP", {"lossless": True}), ("WEBP", {"quality": 60}), ("TIFF", {}),
                    ("ICO", {"sizes": [(11, 9)]})):
        _assert_pillows(_saved(image, fmt, **kw))
    for data in (b"", b"<html>not an image</html>", _saved(image, "PPM"), b"RIFF\0\0\0\0WAVE"):
        with pytest.raises(ValueError, match="cannot identify"):
            laion.decode_image(data)


@pytest.mark.parametrize("fmt,kw", [("JPEG", {"progressive": True}), ("GIF", {}), ("BMP", {}),
                                    ("WEBP", {"lossless": True}), ("WEBP", {"quality": 60})])
def test_truncated_files_raise_value_error(fmt, kw):
    """A file cut short raises ``ValueError`` (what ``on_error`` handles),
    as Pillow raises on it."""
    data = _saved(Image.fromarray(_image((40, 40), 11)), fmt, **kw)
    for cut in (len(data) // 3, len(data) // 2):
        with pytest.raises(ValueError):
            laion.decode_image(data[:cut])
        with pytest.raises((OSError, ValueError, SyntaxError)):
            _pillow(data[:cut])


def _fixture_bytes(name: str) -> bytes:
    """The committed fixture ``name`` as this file rebuilds it."""
    image = Image.fromarray(_image((45, 61), 12))
    return {
        "laion_loader_progressive.jpg": lambda: _saved(image, "JPEG", quality=85,
                                                       progressive=True),
        "laion_loader_cmyk.jpg": lambda: _saved(image.convert("CMYK"), "JPEG", quality=90),
        "laion_loader_adam7.png": lambda: write_png(_image((45, 61), 13), 2, 8, True),
        "laion_loader_grey16.png": lambda: _saved(Image.fromarray(
            (np.asarray(image.convert("L"), np.uint16) * 3 + 40)), "PNG"),
        "laion_loader.gif": lambda: _saved(image, "GIF"),
        "laion_loader.bmp": lambda: _saved(image.quantize(40), "BMP"),
        "laion_loader_lossless.webp": lambda: _saved(image, "WEBP", lossless=True),
        "laion_loader_lossy.webp": lambda: _saved(image, "WEBP", quality=80),
        # A web image's size, for the decoders' rate (the card's laion_loader).
        "laion_loader_512_progressive.jpg": lambda: _saved(
            Image.fromarray(_image((512, 512), 14)), "JPEG", quality=85, progressive=True),
        "laion_loader_512_lossy.webp": lambda: _saved(
            Image.fromarray(_image((512, 512), 14)), "WEBP", quality=80),
    }[name]()


NEW_FIXTURES = ("laion_loader_progressive.jpg", "laion_loader_cmyk.jpg", "laion_loader_adam7.png",
                "laion_loader_grey16.png", "laion_loader.gif", "laion_loader.bmp",
                "laion_loader_lossless.webp", "laion_loader_lossy.webp",
                "laion_loader_512_progressive.jpg", "laion_loader_512_lossy.webp")


@pytest.mark.parametrize("name", NEW_FIXTURES)
def test_committed_fixture_is_rebuilt_and_decodes_as_pillow(name):
    """Each fixture the card's ``laion_loader`` phase decodes is what this
    file writes, and the port's decode equals Pillow's."""
    data = (FIXTURES / name).read_bytes()
    assert data == _fixture_bytes(name)
    _assert_pillows(data)


@pytest.fixture(scope="module")
def server():
    import chip_smoke

    routes = {name: (lambda hit, name=name: (200, {}, (FIXTURES / name).read_bytes()))
              for name in ("laion_loader_progressive.jpg", "laion_loader_lossy.webp",
                           "laion_loader_lossless.webp", "laion_loader.gif")}
    s = chip_smoke._LoopbackServer(routes)
    yield s
    s.close()


def test_progressive_jpeg_and_webp_records_equal_jax(server, tmp_path):
    """A progressive JPEG, two WebPs and a GIF through both packages'
    ``LAIONImageTextDataset``: equal arrays cold (the fetch decoded, resized
    and cached as a quality-95 JPEG), equal cache files, and equal arrays
    again on each package's warm cache."""
    names = ("laion_loader_progressive.jpg", "laion_loader_lossy.webp",
             "laion_loader_lossless.webp", "laion_loader.gif")
    sets = {}
    for tag, module in (("jax", jax_laion), ("port", laion)):
        records = [{"URL": f"{server.base}/{name}?{tag}", "TEXT": name} for name in names]
        sets[tag] = lambda module=module, tag=tag, records=records: module.LAIONImageTextDataset(
            records, cache_dir=str(tmp_path / f"{tag}_cache"),
            failed_urls_cache=str(tmp_path / f"{tag}_failed.json"), image_size=32,
            normalize=False, on_error="raise", as_uint8=True)
    cold = {tag: [make()[i][0] for i in range(len(names))] for tag, make in sets.items()}
    for a, b in zip(cold["jax"], cold["port"]):
        np.testing.assert_array_equal(b, a)
    jax_cache = sorted((tmp_path / "jax_cache").iterdir())
    port_cache = sorted((tmp_path / "port_cache").iterdir())
    assert len(jax_cache) == len(port_cache) == len(names)
    assert sorted(p.read_bytes() for p in jax_cache) == sorted(p.read_bytes() for p in port_cache)
    warm = {tag: [make()[i][0] for i in range(len(names))] for tag, make in sets.items()}
    for a, b in zip(warm["jax"], warm["port"]):
        np.testing.assert_array_equal(b, a)
    for name in names:  # the warm reads asked no server
        assert server.hits[f"/{name}?port"] == server.hits[f"/{name}?jax"] == 1
