"""The LAION loader's TIFF and ICO/CUR decoders against Pillow 12.1.

``data/tiff.py`` and ``data/ico.py`` byte for byte against Pillow's
``Image.open(f).convert("RGB")``:

- on files Pillow writes (every TIFF compression and mode it writes; ICO of
  PNG and of BMP entries), and on files this module writes where Pillow
  writes none (tiles, planar configuration 2, big-endian, sub-byte grey and
  palette, associated alpha; CUR; an ICO whose equal-sized entries differ in
  depth), each checked against Pillow's decode of it;
- the committed fixtures (``tests/fixtures/laion_loader_*.tif``, ``*.ico``,
  ``*.cur``) rebuilt by this module, their digests in
  ``laion_loader_pillow.json``, which ``chip_smoke.py`` holds on the card;
- TIFF's LZW and PackBits in C (``data/csrc/tiff.c``) equal to the plain
  Python versions, and seeded corruptions refused by both alike
  (``tests/torch_decode_fuzz_worker.py``, in a subprocess);
- JPEG-in-TIFF (compression 7) of every photometric the loader reads
  (grey, RGB, YCbCr at 1 x 1, 2 x 1 and 2 x 2), in strips and tiles, with
  the C JPEG decoder equal to the plain one; corrupt streams and sampling
  factors the file contradicts refused;
- the refusals: old-style JPEG-in-TIFF, CMYK JPEG-in-TIFF and CCITT fax by
  name;
- a TIFF and an ICO record through both packages' ``LAIONImageTextDataset``
  over a loopback HTTP server.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import io
import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_decoders import _image, _saved
from tinydiffusion_tpu.data import laion as jax_laion
from tinydiffusion_torch.data import laion, tiff
from tinydiffusion_torch.data.ico import decode_ico

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _assert_pillows(data: bytes) -> None:
    """``decode_image`` equals Pillow, and for TIFF the plain version too."""
    want = _pillow(data)
    got = laion.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if data[:4] in tiff.SIGNATURES:
        np.testing.assert_array_equal(tiff.decode_tiff_reference(data), got)


# --- a TIFF writer for what Pillow does not write ---------------------------------


def lzw_encode(data: bytes) -> bytes:
    """libtiff's LZW: a clear code first, 9- to 12-bit codes most
    significant bit first, the width growing one code early (as the decoder
    reads it), a clear when the table fills, the end code last."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code: int, size: int) -> None:
        nonlocal acc, nacc
        acc, nacc = (acc << size) | code, nacc + size
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
            acc &= (1 << nacc) - 1

    def reset():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, size = reset()
    put(256, size)
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        put(table[w], size)
        table[wc], nxt = nxt, nxt + 1
        if nxt == 4094:
            put(256, size)
            table, nxt, size = reset()
        elif nxt == 1 << size:
            size += 1
        w = bytes([byte])
    if w:
        put(table[w], size)
        nxt += 1
        if nxt == 1 << size and size < 12:
            size += 1
    put(257, size)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: repeats of 3 to 128 bytes, literal runs of up to 128."""
    out, i, literal = bytearray(), 0, bytearray()

    def flush():
        while literal:
            chunk = literal[:128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
            del literal[:128]

    while i < len(data):
        run = 1
        while i + run < len(data) and data[i + run] == data[i] and run < 128:
            run += 1
        if run >= 3:
            flush()
            out += bytes([257 - run, data[i]])
            i += run
        else:
            literal.append(data[i])
            i += 1
    flush()
    return bytes(out)


def jpeg_in_tiff_stream(block: np.ndarray, photometric: int, sampling=(1, 1),
                        quality: int = 90) -> tuple[bytes, bytes]:
    """``(tables, stream)`` of a strip or tile as libtiff writes JPEG-in-TIFF:
    Pillow's baseline JPEG of ``block`` (rows, cols, spp uint8; YCbCr from
    RGB at the luma's ``sampling`` (h, v) for photometric 6, the RGB
    components as they are for 2, grey for 1) cut into an abbreviated
    tables stream (SOI, its DQT and DHT segments, EOI) and the rest (SOI,
    the frame, the scan, EOI), its APPn segments dropped."""
    image = Image.fromarray(np.ascontiguousarray(block[..., 0] if photometric == 1 else block))
    options = {"quality": quality}
    if photometric == 2:
        options["keep_rgb"] = True
    elif photometric == 6:
        options["subsampling"] = {(1, 1): 0, (2, 1): 1, (2, 2): 2}[tuple(sampling)]
    data = _saved(image, "JPEG", **options)
    tables, rest, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while data[pos + 1] != 0xDA:
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] in (0xDB, 0xC4):
            tables += data[pos:end]
        elif data[pos + 1] in (0xC0, 0xC1):
            rest += data[pos:end]
        pos = end
    return bytes(tables + b"\xff\xd9"), bytes(rest + data[pos:])


def write_tiff(samples: np.ndarray, photometric: int, *, big_endian=False, bits=8,
               compression=1, predictor=1, planar=1, tile=None, rows_per_strip=None,
               extra=(), colormap=None, sampling=(1, 1), subsampling_field=True) -> bytes:
    """A one-image TIFF of ``samples`` (H, W, spp; values fitting ``bits``),
    in strips (``rows_per_strip``) or ``tile`` (w, h) tiles, planar 1 or 2,
    compressed and predicted as asked. JPEG (compression 7): each chunk
    ``jpeg_in_tiff_stream``'s, the tables in the ``JPEGTables`` field, and
    for YCbCr the luma's ``sampling`` in the stream and, unless
    ``subsampling_field`` is False, in ``YCbCrSubsampling`` (it may say
    otherwise: a tuple)."""
    order = ">" if big_endian else "<"
    h, w, spp = samples.shape
    tw, th = tile if tile else (w, rows_per_strip or h)
    planes = [samples[..., k:k + 1] for k in range(spp)] if planar == 2 else [samples]
    chunks, tables = [], set()
    for plane in planes:
        for y in range(0, h, th):
            for x in range(0, w, tw) if tile else [0]:
                block = plane[y:y + th, x:x + tw]
                if tile:  # a tile is padded to its full size
                    pad = np.zeros((th, tw, block.shape[2]), block.dtype)
                    pad[:block.shape[0], :block.shape[1]] = block
                    block = pad
                if compression == 7:
                    table, stream = jpeg_in_tiff_stream(block.astype(np.uint8), photometric,
                                                        sampling)
                    tables.add(table)
                    chunks.append(stream)
                    continue
                block = block.astype(np.int64)
                if predictor == 2:
                    block = np.concatenate([block[:, :1], np.diff(block, axis=1)], 1) % (1 << bits)
                rows = block.reshape(block.shape[0], -1)
                if bits == 16:
                    raw = rows.astype(order + "u2").tobytes()
                elif bits == 8:
                    raw = rows.astype(np.uint8).tobytes()
                else:
                    unpacked = ((rows[..., None] >> np.arange(bits - 1, -1, -1)) & 1)
                    raw = np.packbits(unpacked.reshape(rows.shape[0], -1).astype(np.uint8),
                                      axis=1).tobytes()
                chunks.append({1: lambda b: b, 5: lzw_encode, 8: zlib.compress,
                               32946: zlib.compress, 32773: packbits_encode}[compression](raw))
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
              262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar]),
              317: (3, [predictor])}
    if tile:
        fields.update({322: (3, [tw]), 323: (3, [th])})
    else:
        fields[278] = (4, [th])
    if extra:
        fields[338] = (3, list(extra))
    if colormap is not None:
        fields[320] = (3, list(colormap))
    if compression == 7:
        assert len(tables) == 1  # one JPEGTables field serves every chunk
        fields[347] = (7, list(tables.pop()))
        if photometric == 6 and subsampling_field:
            fields[530] = (3, list(sampling if subsampling_field is True else subsampling_field))
    body = bytearray(8)
    offsets = []
    for chunk in chunks:
        offsets.append(len(body))
        body += chunk + b"\0" * (len(chunk) % 2)
    fields[324 if tile else 273] = (4, offsets)
    fields[325 if tile else 279] = (4, [len(c) for c in chunks])
    codes = {3: "H", 4: "I", 7: "B"}
    blobs = {}
    for tag, (kind, values) in sorted(fields.items()):
        packed = np.asarray(values, order + codes[kind]).tobytes()
        if len(packed) > 4:
            blobs[tag] = len(body)
            body += packed + b"\0" * (len(packed) % 2)
    ifd_at = len(body)
    body += np.asarray([len(fields)], order + "H").tobytes()
    for tag, (kind, values) in sorted(fields.items()):
        packed = np.asarray(values, order + codes[kind]).tobytes()
        value = (np.asarray([blobs[tag]], order + "I").tobytes() if tag in blobs
                 else packed.ljust(4, b"\0"))
        body += np.asarray([tag, kind], order + "H").tobytes()
        body += np.asarray([len(values)], order + "I").tobytes() + value
    body += bytes(4)
    body[:8] = (b"MM\0*" if big_endian else b"II*\0") + np.asarray([ifd_at], order + "I").tobytes()
    return bytes(body)


def _rgb(seed: int = 12, shape=(45, 61)) -> np.ndarray:
    return _image(shape, seed)


def _colormap(bits: int, seed: int = 3) -> list:
    """A random 16-bit colour map of 2 ** bits entries: reds, greens, blues."""
    return np.random.default_rng(seed).integers(0, 65536, 3 << bits).tolist()


# --- TIFF: Pillow's files ----------------------------------------------------------

PILLOW_MODES = ("RGB", "RGBA", "L", "1", "P", "CMYK", "I;16", "LA")
PILLOW_COMPRESSIONS = (None, "tiff_lzw", "packbits", "tiff_adobe_deflate", "tiff_deflate")


def _pillow_image(mode: str) -> Image.Image:
    image = Image.fromarray(_rgb())
    if mode == "I;16":
        return Image.fromarray(np.asarray(image.convert("L"), np.uint16) * 3 + 40)
    if mode == "P":
        return image.quantize(40)
    if mode in ("RGBA", "LA"):
        alpha = Image.fromarray(_rgb(13)[..., 0])
        image = image.convert(mode)
        image.putalpha(alpha)
        return image
    return image.convert(mode)


@pytest.mark.parametrize("compression", PILLOW_COMPRESSIONS, ids=lambda c: c or "raw")
@pytest.mark.parametrize("mode", PILLOW_MODES)
def test_pillow_tiff_equals_pillow(mode, compression):
    _assert_pillows(_saved(_pillow_image(mode), "TIFF", compression=compression))


@pytest.mark.parametrize("mode", ("RGB", "L", "I;16", "CMYK"))
def test_pillow_tiff_with_the_horizontal_predictor_equals_pillow(mode):
    _assert_pillows(_saved(_pillow_image(mode), "TIFF", compression="tiff_lzw",
                           tiffinfo={317: 2}))


# --- TIFF: files Pillow does not write --------------------------------------------

LAYOUTS = {"strips": {"rows_per_strip": 8}, "tiles": {"tile": (16, 16)},
           "planar": {"planar": 2, "rows_per_strip": 16},
           "planar_tiles": {"planar": 2, "tile": (32, 16)}}


@pytest.mark.parametrize("compression", (1, 5, 8, 32773))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("big_endian", (False, True), ids=("II", "MM"))
def test_written_rgb_tiff_equals_pillow(big_endian, layout, compression):
    """RGB with an alpha sample, every layout in both byte orders, with the
    predictor where the compression takes one."""
    samples = np.concatenate([_rgb(), _rgb(13)[..., :1]], -1)
    data = write_tiff(samples, 2, big_endian=big_endian, compression=compression,
                      predictor=2 if compression in (5, 8) else 1, extra=(2,), **LAYOUTS[layout])
    _assert_pillows(data)


@pytest.mark.parametrize("case", ["grey16_be", "grey16_predictor", "min_is_white8",
                                  "min_is_white4", "grey2", "bilevel_min_is_white",
                                  "palette4", "palette1", "associated_alpha", "rgb16",
                                  "cmyk_planar"])
def test_written_tiff_modes_equal_pillow(case):
    rgb = _rgb()
    grey = rgb[..., :1].astype(np.int64)
    cases = {
        "grey16_be": lambda: write_tiff(grey * 200 + 7, 1, big_endian=True, bits=16,
                                        compression=5, rows_per_strip=10),
        "grey16_predictor": lambda: write_tiff(grey * 3, 1, bits=16, compression=5, predictor=2,
                                               tile=(16, 32)),
        "min_is_white8": lambda: write_tiff(grey, 0, compression=32773),
        "min_is_white4": lambda: write_tiff(grey >> 4, 0, bits=4, compression=5),
        "grey2": lambda: write_tiff(grey >> 6, 1, bits=2, tile=(32, 16)),
        "bilevel_min_is_white": lambda: write_tiff(grey >> 7, 0, bits=1, compression=32773,
                                                   rows_per_strip=7),
        "palette4": lambda: write_tiff(grey >> 4, 3, bits=4, compression=5,
                                       colormap=_colormap(4)),
        "palette1": lambda: write_tiff(grey >> 7, 3, bits=1, big_endian=True,
                                       colormap=_colormap(1)),
        "associated_alpha": lambda: write_tiff(
            np.concatenate([rgb // 2, np.maximum(rgb[..., :1], rgb.max(-1, keepdims=True) // 2)],
                           -1), 2, extra=(1,), compression=8),
        "rgb16": lambda: write_tiff(rgb.astype(np.int64) * 257 + 3, 2, bits=16, big_endian=True,
                                    compression=5, predictor=2, rows_per_strip=9),
        "cmyk_planar": lambda: write_tiff(np.concatenate([rgb, rgb[..., :1]], -1), 5,
                                          planar=2, compression=32773, rows_per_strip=11),
    }
    _assert_pillows(cases[case]())


@pytest.mark.parametrize("compression, name", [(7, "JPEG-in-TIFF"), (6, "JPEG-in-TIFF"),
                                               (3, "CCITT fax"), (4, "CCITT fax"),
                                               (2, "CCITT fax")])
def test_jpeg_in_tiff_and_fax_are_refused_by_name(compression, name):
    data = write_tiff(_rgb()[..., :1] >> 7, 0, bits=1)
    field = data.index(struct.pack("<HHI", 259, 3, 1))
    data = data[:field + 8] + struct.pack("<H", compression) + data[field + 10:]
    for decode in (laion.decode_image, tiff.decode_tiff_reference):
        with pytest.raises(ValueError, match=name):
            decode(data)


def test_pillow_jpeg_in_tiff_is_refused():
    """Of the JPEG-in-TIFF files Pillow writes, CMYK's (photometric 5) is the
    one the loader refuses, by name."""
    with pytest.raises(ValueError, match="JPEG-in-TIFF"):
        laion.decode_image(_saved(Image.fromarray(_rgb()).convert("CMYK"), "TIFF",
                                  compression="jpeg"))


# --- JPEG-in-TIFF ------------------------------------------------------------------


@pytest.mark.parametrize("quality", (75, 95))
@pytest.mark.parametrize("mode", ("RGB", "YCbCr", "L"))
def test_pillow_jpeg_in_tiff_equals_pillow(mode, quality):
    """Pillow's JPEG-in-TIFF (libtiff's: the tables in ``JPEGTables``, an
    abbreviated stream a strip; YCbCr at 1 x 1), in one strip and in strips
    of 16 rows: Pillow's pixels, the C decoder's equal to the plain one's."""
    image = Image.fromarray(_rgb()).convert(mode)
    for strip_size in (65536, 16 * len(mode) * image.width):
        data = _saved(image, "TIFF", compression="jpeg", quality=quality, strip_size=strip_size)
        assert 347 in Image.open(io.BytesIO(data)).tag_v2
        _assert_pillows(data)


JPEG_TIFF_CASES = {
    "rgb_tiles": dict(photometric=2, tile=(32, 16)),
    "ycc420_tiles": dict(photometric=6, tile=(32, 32), sampling=(2, 2)),
    "ycc420_strips_be": dict(photometric=6, rows_per_strip=16, sampling=(2, 2), big_endian=True),
    "ycc422_strips": dict(photometric=6, rows_per_strip=8, sampling=(2, 1)),
    "ycc420_no_field": dict(photometric=6, rows_per_strip=32, sampling=(2, 2),
                            subsampling_field=False),
    "grey_tiles": dict(photometric=1, tile=(16, 16)),
}


def _jpeg_tiff(case: str, shape=(45, 61)) -> bytes:
    options = dict(JPEG_TIFF_CASES[case])
    rgb = _rgb(14, shape)
    samples = rgb[..., :1] if options["photometric"] == 1 else rgb
    return write_tiff(samples, options.pop("photometric"), compression=7, **options)


@pytest.mark.parametrize("case", sorted(JPEG_TIFF_CASES))
def test_written_jpeg_in_tiff_equals_pillow(case):
    """JPEG-in-TIFF that Pillow does not write: tiles, YCbCr with its chroma
    at half width (2 x 1) or half size (2 x 2), strips whose last is short,
    big-endian, no ``YCbCrSubsampling`` field (the stream's sampling
    governs): Pillow's pixels through libtiff."""
    _assert_pillows(_jpeg_tiff(case))


def test_jpeg_in_tiff_refuses_what_libtiff_refuses():
    """A ``YCbCrSubsampling`` field that the stream contradicts, a strip
    whose stream is taller than the strip, and tables without their SOI
    raise ``ValueError`` in both decoders, where Pillow fails too. A
    truncated stream raises as well, as the loader's other decoders do,
    where libjpeg warns and pads with zeros; tables without their EOI are
    read to their end, as libtiff reads them."""
    rgb = _rgb(14)
    good = write_tiff(rgb, 6, compression=7, tile=(32, 32), sampling=(2, 2))
    tables = good.index(b"\xff\xd8\xff\xdb")
    eoi = good.index(b"\xff\xd9", tables)
    counts = struct.pack("<HHI", 325, 4, 4)
    at = struct.unpack("<I", good[good.index(counts) + 8:good.index(counts) + 12])[0]
    half = struct.unpack("<I", good[at:at + 4])[0] // 2
    pillow_fails = {
        "sampling": write_tiff(rgb, 6, compression=7, rows_per_strip=16, sampling=(2, 2),
                               subsampling_field=(1, 1)),
        "size": write_tiff(rgb, 2, compression=7, rows_per_strip=16).replace(
            struct.pack("<HHII", 278, 4, 1, 16), struct.pack("<HHII", 278, 4, 1, 8)),
        "tables_soi": good[:tables] + b"\0\0" + good[tables + 2:],
    }
    truncated = good[:at] + struct.pack("<I", half) + good[at + 4:]
    for name, data in [*pillow_fails.items(), ("truncated", truncated)]:
        if name in pillow_fails:
            with pytest.raises(Exception):
                _pillow(data)
        for decode in (tiff.decode_tiff, tiff.decode_tiff_reference):
            with pytest.raises(ValueError):
                decode(data)
    _assert_pillows(good[:eoi] + b"\xff\xff" + good[eoi + 2:])  # fill bytes, no EOI


def test_lzw_and_packbits_in_c_equal_the_plain_versions():
    """The C entropy decoders against the Python ones on streams of every
    length, cut anywhere: the same bytes, the same counts."""
    rng = np.random.default_rng(5)
    for trial in range(60):
        n = int(rng.integers(0, 3000))
        raw = bytes(rng.integers(0, 4 if trial % 2 else 256, n).astype(np.uint8))
        for name, encode in ((tiff.LZW, lzw_encode), (tiff.PACKBITS, packbits_encode)):
            stream = encode(raw)
            for count in (n, n // 2, n + 5):
                c = tiff._NATIVE[name](stream, count)
                assert c == tiff._PLAIN[name](stream, count) == raw[:count], (name, trial)


# --- ICO and CUR ------------------------------------------------------------------


@pytest.mark.parametrize("bitmap_format", ("png", "bmp"))
@pytest.mark.parametrize("mode", ("RGB", "RGBA", "P", "L", "1"))
def test_pillow_ico_equals_pillow(mode, bitmap_format):
    image = Image.fromarray(_image((64, 64), 21)).convert(mode)
    _assert_pillows(_saved(image, "ICO", sizes=[(16, 16), (48, 48), (32, 32)],
                           bitmap_format=bitmap_format))


def _dib(image: np.ndarray, bits: int) -> bytes:
    """A DIB entry: the info header (height doubled), the palette, the
    bottom-up XOR rows and an AND mask."""
    h, w, _ = image.shape
    palette = b""
    if bits <= 8:
        colors, indices = np.unique(image.reshape(-1, 3), axis=0, return_inverse=True)
        assert len(colors) <= 1 << bits
        palette = np.concatenate([colors[:, ::-1], np.zeros((len(colors), 1), np.uint8)],
                                 1).astype(np.uint8).tobytes()
        indices = indices.reshape(h, w)
        bitsrows = ((indices[..., None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(h, -1)
        rows = np.packbits(bitsrows.astype(np.uint8), axis=1)
        ncolors = len(colors)
    else:  # BGR, and a fourth byte (Pillow's alpha) at 32 bits
        pixels = image[..., ::-1]
        if bits == 32:
            pixels = np.concatenate([pixels, image[..., :1] // 2 + 64], -1)
        rows = pixels.reshape(h, -1)
        ncolors = 0
    stride = (w * bits + 31) // 32 * 4
    xor = np.zeros((h, stride), np.uint8)
    xor[:, :rows.shape[1]] = rows
    mask = np.zeros((h, (w + 31) // 32 * 4), np.uint8)
    header = struct.pack("<iiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0, ncolors, 0)
    return header + palette + xor[::-1].tobytes() + mask.tobytes()


def write_icon(entries, kind: int = 1) -> bytes:
    """An ICO (``kind`` 1) or CUR (2) of ``(width byte, height byte, bits,
    data)`` entries."""
    out = struct.pack("<HHH", 0, kind, len(entries))
    at = 6 + 16 * len(entries)
    for w, h, bits, data in entries:
        out += bytes([w, h, 0, 0]) + struct.pack("<HHII", 1, bits, len(data), at)
        at += len(data)
    return out + b"".join(e[3] for e in entries)


def _quantized(shape, seed, colors) -> np.ndarray:
    image = Image.fromarray(_image(shape, seed)).quantize(colors)
    return np.asarray(image.convert("RGB"))


def test_written_cur_and_ico_pick_the_entry_pillow_picks():
    """CUR: the first entry, replaced only by one larger in both bytes (a
    256 byte of 0 counts as 0); ICO: the largest area, then the least depth;
    DIBs of 4, 8, 24 and 32 bits."""
    small4 = _dib(_quantized((16, 16), 1, 16), 4)
    mid8 = _dib(_quantized((32, 32), 2, 200), 8)
    mid24 = _dib(_image((32, 32), 3), 24)
    mid32 = _dib(_image((32, 32), 4), 32)
    files = [
        write_icon([(16, 16, 4, small4), (32, 32, 24, mid24)], kind=2),
        write_icon([(32, 32, 24, mid24), (16, 16, 4, small4)], kind=2),
        write_icon([(32, 32, 24, mid24), (32, 32, 8, mid8), (16, 16, 4, small4)]),
        write_icon([(16, 16, 4, small4), (32, 32, 8, mid8), (32, 32, 24, mid32)]),
    ]
    for data in files:
        _assert_pillows(data)


def test_ico_refuses_truncated_directories_and_images():
    data = _saved(Image.fromarray(_rgb()), "ICO", sizes=[(32, 32)], bitmap_format="bmp")
    for cut in (4, 10, 30, len(data) // 2):
        with pytest.raises(ValueError):
            decode_ico(data[:cut])


# --- the committed fixtures --------------------------------------------------------


def _fixture_bytes(name: str) -> bytes:
    """The committed fixture ``name`` as this module writes it."""
    rgb = _rgb()
    alpha4 = np.concatenate([rgb, _rgb(13)[..., :1]], -1)
    return {
        "laion_loader_lzw.tif": lambda: _saved(_pillow_image("RGB"), "TIFF",
                                               compression="tiff_lzw"),
        "laion_loader_predictor.tif": lambda: _saved(_pillow_image("RGB"), "TIFF",
                                                     compression="tiff_lzw", tiffinfo={317: 2}),
        "laion_loader_packbits.tif": lambda: _saved(_pillow_image("P"), "TIFF",
                                                    compression="packbits"),
        "laion_loader_deflate.tif": lambda: _saved(_pillow_image("RGBA"), "TIFF",
                                                   compression="tiff_adobe_deflate"),
        "laion_loader_cmyk.tif": lambda: _saved(_pillow_image("CMYK"), "TIFF"),
        "laion_loader_bilevel.tif": lambda: _saved(_pillow_image("1"), "TIFF",
                                                   compression="packbits"),
        "laion_loader_grey16.tif": lambda: _saved(_pillow_image("I;16"), "TIFF",
                                                  compression="tiff_deflate"),
        "laion_loader_tiles_be.tif": lambda: write_tiff(rgb, 2, big_endian=True, compression=5,
                                                        predictor=2, tile=(16, 16)),
        "laion_loader_planar.tif": lambda: write_tiff(alpha4, 2, planar=2, compression=32773,
                                                      rows_per_strip=16, extra=(2,)),
        "laion_loader_jpeg.tif": lambda: _saved(_pillow_image("YCbCr"), "TIFF",
                                                compression="jpeg", strip_size=16 * 3 * 61),
        "laion_loader_jpeg_tiles.tif": lambda: _jpeg_tiff("ycc420_tiles"),
        "laion_loader.ico": lambda: _saved(Image.fromarray(_image((48, 48), 21)).convert("RGBA"),
                                           "ICO", sizes=[(16, 16), (32, 32), (48, 48)]),
        "laion_loader_bmp.ico": lambda: _saved(Image.fromarray(_image((32, 32), 22)).quantize(30),
                                               "ICO", sizes=[(16, 16), (32, 32)],
                                               bitmap_format="bmp"),
        "laion_loader.cur": lambda: write_icon(
            [(16, 16, 4, _dib(_quantized((16, 16), 1, 16), 4)),
             (32, 32, 24, _dib(_image((32, 32), 3), 24))], kind=2),
    }[name]()


TIFF_ICO_FIXTURES = ("laion_loader_lzw.tif", "laion_loader_predictor.tif",
                     "laion_loader_packbits.tif", "laion_loader_deflate.tif",
                     "laion_loader_cmyk.tif", "laion_loader_bilevel.tif",
                     "laion_loader_grey16.tif", "laion_loader_tiles_be.tif",
                     "laion_loader_planar.tif", "laion_loader_jpeg.tif",
                     "laion_loader_jpeg_tiles.tif", "laion_loader.ico", "laion_loader_bmp.ico",
                     "laion_loader.cur")


@pytest.mark.parametrize("name", TIFF_ICO_FIXTURES)
def test_committed_fixture_is_rebuilt_and_decodes_as_pillow(name):
    """Each fixture the card's ``laion_loader`` phase decodes is what this
    module writes, its digest is listed, and the port's decode equals
    Pillow's (the C TIFF decoders equal to the plain ones)."""
    data = (FIXTURES / name).read_bytes()
    assert data == _fixture_bytes(name)
    assert len(data) < 16384
    assert name in json.loads((FIXTURES / "laion_loader_pillow.json").read_text())
    _assert_pillows(data)


# --- corruptions -------------------------------------------------------------------

FUZZ = {"lzw.tif": lambda: write_tiff(_rgb(5, (37, 45)), 2, compression=5, predictor=2,
                                      rows_per_strip=12),
        "packbits.tif": lambda: write_tiff(_rgb(6, (37, 45))[..., :1], 1, compression=32773,
                                           tile=(16, 16)),
        "jpeg.tif": lambda: write_tiff(_rgb(8, (37, 45)), 6, compression=7, tile=(16, 16),
                                       sampling=(2, 2)),
        "bmp.ico": lambda: _saved(Image.fromarray(_image((32, 32), 7)).quantize(12), "ICO",
                                  sizes=[(16, 16), (32, 32)], bitmap_format="bmp")}
FUZZ_MUTANTS = 160


@pytest.mark.parametrize("name", sorted(FUZZ))
def test_corrupt_files_raise_value_error_or_give_the_plain_bytes(name, tmp_path):
    """Seeded truncations and replaced bytes, in a subprocess (a crash is a
    failure here, not a lost worker): ``ValueError`` where the plain version
    raises it, else the plain version's bytes."""
    path = tmp_path / name
    path.write_bytes(FUZZ[name]())
    proc = subprocess.run([sys.executable, "-m", "tests.torch_decode_fuzz_worker", str(path),
                           str(sorted(FUZZ).index(name)), str(FUZZ_MUTANTS)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["mutants"] == FUZZ_MUTANTS and summary["disagreement"] is None
    assert 0 < summary["refused"]["c"] < FUZZ_MUTANTS


# --- through the datasets ----------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    import chip_smoke

    names = ("laion_loader_lzw.tif", "laion_loader_tiles_be.tif", "laion_loader.ico")
    s = chip_smoke._LoopbackServer({name: (lambda hit, name=name: (
        200, {}, (FIXTURES / name).read_bytes())) for name in names})
    s.names = names
    yield s
    s.close()


def test_tiff_and_ico_records_equal_jax(server, tmp_path):
    """TIFF and ICO records through both packages' ``LAIONImageTextDataset``
    (JAX's reads them with Pillow): equal arrays cold (the fetch decoded,
    resized and cached as a quality-95 JPEG), equal cache files, and equal
    arrays again on each package's warm cache."""
    sets = {}
    for tag, module in (("jax", jax_laion), ("port", laion)):
        records = [{"URL": f"{server.base}/{name}?{tag}", "TEXT": name} for name in server.names]
        sets[tag] = lambda module=module, tag=tag, records=records: module.LAIONImageTextDataset(
            records, cache_dir=str(tmp_path / f"{tag}_cache"),
            failed_urls_cache=str(tmp_path / f"{tag}_failed.json"), image_size=32,
            normalize=False, on_error="raise", as_uint8=True)
    n = len(server.names)
    cold = {tag: [make()[i][0] for i in range(n)] for tag, make in sets.items()}
    for a, b in zip(cold["jax"], cold["port"]):
        np.testing.assert_array_equal(b, a)
    jax_cache = sorted((tmp_path / "jax_cache").iterdir())
    port_cache = sorted((tmp_path / "port_cache").iterdir())
    assert len(jax_cache) == len(port_cache) == n
    assert sorted(p.read_bytes() for p in jax_cache) == sorted(p.read_bytes() for p in port_cache)
    warm = {tag: [make()[i][0] for i in range(n)] for tag, make in sets.items()}
    for a, b in zip(warm["jax"], warm["port"]):
        np.testing.assert_array_equal(b, a)
