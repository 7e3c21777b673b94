"""TIFF decode, as ``Image.open(f).convert("RGB")`` gives it.

JAX's LAION loader reads every web image with Pillow; the port reads TIFF
here, the first image of the file as Pillow opens it (``TiffImagePlugin``):

- little- and big-endian files (``II*\\0``, ``MM\\0*``), the first IFD;
- strips or tiles, planar configuration 1 (samples interleaved) or 2 (a
  plane a sample), rows and tiles padded as the file says;
- compression none, PackBits, LZW (libtiff's: codes most significant bit
  first, the code width growing one code early) and Deflate (both tags);
  LZW and Deflate with or without the horizontal predictor (2), which
  libtiff's other codecs and Pillow's raw reader ignore;
- the modes of Pillow's ``OPEN_INFO`` that a web file carries: bilevel,
  grey of 2, 4 and 8 bits (min-is-black, or min-is-white, inverted) and of
  16 bits (clamped to 255, as Pillow converts ``I;16``), grey with alpha;
  palette of 1 to 8 bits (the colour map's high bytes); RGB of 8 or 16 bits
  a sample, with an extra sample (alpha or other: dropped, as
  ``convert("RGB")`` drops it; associated alpha first divided out, as
  Pillow's ``RGBa`` unpacking does); CMYK of 8 bits, with Pillow's
  ``cmyk2rgb``.

JPEG-in-TIFF (compression 7, libtiff's) is read as Pillow reads it through
libtiff: each strip's or tile's abbreviated JPEG stream, the
``JPEGTables`` field's tables (tag 347) in front of it, through
``data/jpeg.py``'s decoder, for 8-bit grey (photometric 1), RGB (2: the
components as they are) and YCbCr (6: converted to RGB by libjpeg's
upsampling and colour conversion, the stream's own sampling, which a
``YCbCrSubsampling`` field (tag 530) must agree with), strips or tiles,
planar configuration 1. YCbCr without JPEG (LZW, Deflate or PackBits) is
read as Pillow reads it through libtiff's RGBA interface: the sampling
blocks of any subsampling libtiff converts (``_ycbcr``), then libtiff's
YCbCr to RGB (``data/ycbcr.py``). Old-style JPEG (compression 6), CCITT fax
(2, 3, 4), the other compressions, uncompressed YCbCr, CIELab, signed or
floating-point samples, fill order 2, the floating-point predictor and
BigTIFF raise ``ValueError`` naming what they are, as do truncated or
corrupt files. ``decode_tiff`` decodes LZW, PackBits and JPEG in C
(``data/csrc/tiff.c``, ``data/csrc/jpeg.c``); ``decode_tiff_reference`` in
Python.
"""

from __future__ import annotations

import math
import zlib

import numpy as np

from tinydiffusion_torch.data import jpeg, native
from tinydiffusion_torch.data.jpeg import _cmyk_to_rgb
from tinydiffusion_torch.data.ycbcr import LIBTIFF_LUMA, LIBTIFF_REFERENCE, LibtiffYCbCr

SIGNATURES = (b"II*\x00", b"MM\x00*")

# Field types: bytes a value, numpy dtype code.
_TYPES = {1: (1, "u1"), 2: (1, "u1"), 3: (2, "u2"), 4: (4, "u4"), 6: (1, "i1"), 7: (1, "u1"),
          8: (2, "i2"), 9: (4, "i4"), 5: (8, "u4"), 10: (8, "i4"), 11: (4, "f4"), 12: (8, "f8")}
_REFUSED_COMPRESSION = {2: "CCITT fax (modified Huffman)", 3: "CCITT fax (group 3)",
                        4: "CCITT fax (group 4)", 6: "JPEG-in-TIFF (old-style JPEG)"}
NONE, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS = 1, 5, 7, 8, 32946, 32773
# The compressions whose libtiff codec takes the horizontal predictor (and
# Pillow reads through libtiff): elsewhere the predictor field is ignored.
_PREDICTED = (LZW, DEFLATE, ADOBE_DEFLATE)
# JPEG-in-TIFF: (photometric, samples a pixel) -> the streams' colour transform.
_JPEG_COLORS = {(1, 1): "grey", (2, 3): "rgb", (6, 3): "ycc"}
# Pillow refuses an image of more pixels (twice ``Image.MAX_IMAGE_PIXELS``:
# a decompression bomb).
MAX_PIXELS = 2 * 89478485
# Pillow's MAX_SAMPLESPERPIXEL: it refuses a pixel of more samples.
MAX_SAMPLES = 6


def _lzw_decode(data: bytes, count: int) -> bytes:
    """At most ``count`` bytes of a TIFF LZW strip or tile (libtiff's new
    style): 9- to 12-bit codes, most significant bit first; 256 clears the
    table, 257 ends the data; the code width grows when the next entry
    would be the last of the current width."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        raise ValueError("unsupported TIFF compression: old-style (LSB-first) LZW")
    base = [bytes([i]) for i in range(256)] + [b"", b""]
    table, size, prev = list(base), 9, None
    out = bytearray()
    acc = nacc = pos = 0
    while len(out) < count:
        while nacc < size and pos < len(data):
            acc = (acc << 8) | data[pos]
            nacc += 8
            pos += 1
        if nacc < size:
            break  # the data ends without an end code
        code = (acc >> (nacc - size)) & ((1 << size) - 1)
        nacc -= size
        acc &= (1 << nacc) - 1
        if code == 256:
            table, size, prev = list(base), 9, None
            continue
        if code == 257:
            break
        if code < len(table):
            entry = table[code]
            added = None if prev is None else prev + entry[:1]
        elif code == len(table) and prev is not None:
            entry = added = prev + prev[:1]
        else:
            raise ValueError("corrupt TIFF data: an LZW code past the table")
        if added is not None and len(table) < 4096:
            table.append(added)
            if len(table) == (1 << size) - 1 and size < 12:
                size += 1
        out += entry
        prev = entry
    return bytes(out[:count])


def _packbits_decode(data: bytes, count: int) -> bytes:
    """At most ``count`` bytes of PackBits data: a header byte n, then n + 1
    literal bytes (n < 128) or one byte repeated 257 - n times (n > 128);
    128 is skipped."""
    out = bytearray()
    pos = 0
    while len(out) < count and pos < len(data):
        n = data[pos]
        pos += 1
        if n < 128:
            if pos + n + 1 > len(data):
                raise ValueError("truncated TIFF data: a PackBits literal run")
            out += data[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            if pos >= len(data):
                raise ValueError("truncated TIFF data: a PackBits repeat")
            out += data[pos:pos + 1] * (257 - n)
            pos += 1
    return bytes(out[:count])


def _native(fn_name: str):
    def decode(data: bytes, count: int) -> bytes:
        src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
        out = np.empty(max(count, 1), np.uint8)
        written = np.zeros(1, np.int64)
        native.check(getattr(native.library(), fn_name)(
            native.ptr(src), len(data), native.ptr(out), count, native.ptr(written)), "TIFF",
            {native.ERR_CODE: "corrupt TIFF data: an LZW code past the table",
             native.ERR_CORRUPT: "unsupported TIFF compression: old-style (LSB-first) LZW",
             native.ERR_TRUNCATED: "truncated TIFF data: a PackBits run"})
        return out[:int(written[0])].tobytes()

    return decode


_NATIVE = {LZW: _native("tdt_tiff_lzw"), PACKBITS: _native("tdt_tiff_packbits"),
           JPEG: lambda stream, color: jpeg.decode_jpeg_as(stream, color, native=True)}
_PLAIN = {LZW: _lzw_decode, PACKBITS: _packbits_decode,
          JPEG: lambda stream, color: jpeg.decode_jpeg_as(stream, color, native=False)}


def decode_tiff(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a TIFF file's first image, as Pillow 12.1's
    ``Image.open(f).convert("RGB")`` gives it; LZW, PackBits and JPEG decoded
    by the C library (``data/csrc/tiff.c``, ``jpeg.c``, built at the first
    call)."""
    return _decode(bytes(data), _NATIVE)


def decode_tiff_reference(data: bytes) -> np.ndarray:
    """The plain version of ``decode_tiff``: LZW, PackBits and JPEG in
    Python. The tests and ``chip_smoke.py`` hold the C library to it."""
    return _decode(bytes(data), _PLAIN)


def _ifd(data: bytes, order: str) -> dict[int, np.ndarray]:
    """The first IFD's fields: tag -> values (integers as int64)."""
    if len(data) < 8:
        raise ValueError("truncated TIFF file")
    pos = int.from_bytes(data[4:8], order)
    if pos + 2 > len(data):
        raise ValueError("truncated TIFF file: no image directory")
    n = int.from_bytes(data[pos:pos + 2], order)
    if pos + 2 + 12 * n > len(data):
        raise ValueError("truncated TIFF file: the image directory")
    end = "<" if order == "little" else ">"
    fields = {}
    for i in range(n):
        entry = data[pos + 2 + 12 * i:pos + 14 + 12 * i]
        tag, kind = int.from_bytes(entry[0:2], order), int.from_bytes(entry[2:4], order)
        count = int.from_bytes(entry[4:8], order)
        if kind not in _TYPES:
            continue  # Pillow skips a field of an unknown type
        size, code = _TYPES[kind]
        total = size * count
        if total <= 4:
            raw = entry[8:8 + total]
        else:
            at = int.from_bytes(entry[8:12], order)
            raw = data[at:at + total]
            if len(raw) < total:
                raise ValueError(f"truncated TIFF file: field {tag}")
        values = np.frombuffer(raw, end + code)
        if kind in (5, 10):  # rationals: numerator / denominator
            values = values.reshape(-1, 2)
        fields[tag] = values.astype(np.int64) if kind not in (11, 12) else values
    return fields


def _field(fields: dict, tag: int, default=None):
    if tag in fields:
        return [int(v) for v in np.asarray(fields[tag]).reshape(-1)]
    if default is None:
        raise ValueError(f"corrupt TIFF file: no field {tag}")
    return default


def _decode(data: bytes, codecs: dict) -> np.ndarray:
    if data[:4] not in SIGNATURES:
        if data[:4] in (b"II+\x00", b"MM\x00+"):
            raise ValueError("unsupported TIFF file: BigTIFF")
        raise ValueError("not a TIFF file")
    order = "little" if data[:2] == b"II" else "big"
    fields = _ifd(data, order)
    width, height = _field(fields, 256)[0], _field(fields, 257)[0]
    spp = _field(fields, 277, [1])[0]
    bps = _field(fields, 258, [1])
    bps = bps * spp if len(bps) == 1 and spp > 1 else bps
    photometric = _field(fields, 262)[0]
    compression = _field(fields, 259, [NONE])[0]
    predictor = _field(fields, 317, [1])[0]
    planar = _field(fields, 284, [1])[0]
    extra = _field(fields, 338, [])
    sample_format = _field(fields, 339, [1])[0]
    if not 0 < spp <= MAX_SAMPLES:
        raise ValueError(f"corrupt TIFF file: {spp} samples a pixel")
    if width <= 0 or height <= 0 or len(bps) != spp:
        raise ValueError(f"corrupt TIFF file: {width}x{height}, {spp} samples, {len(bps)} depths")
    if compression in _REFUSED_COMPRESSION:
        raise ValueError(f"unsupported TIFF compression: {_REFUSED_COMPRESSION[compression]}")
    if compression not in (NONE, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS):
        raise ValueError(f"unsupported TIFF compression {compression}")
    color = None
    if compression == JPEG:
        color = _JPEG_COLORS.get((photometric, spp))
        if color is None or bps != [8] * spp or planar != 1 or predictor != 1:
            raise ValueError(f"unsupported JPEG-in-TIFF image: photometric {photometric}, "
                             f"{spp} samples of {bps} bits, planar {planar}, predictor "
                             f"{predictor}")
    if predictor not in (1, 2):
        raise ValueError(f"unsupported TIFF predictor {predictor}")
    if _field(fields, 266, [1])[0] != 1:
        raise ValueError("unsupported TIFF fill order (least significant bit first)")
    if sample_format != 1:
        raise ValueError(f"unsupported TIFF sample format {sample_format} (signed or floating)")
    if planar not in (1, 2):
        raise ValueError(f"corrupt TIFF file: planar configuration {planar}")
    if len(set(bps)) != 1 or bps[0] not in (1, 2, 4, 8, 16):
        raise ValueError(f"unsupported TIFF sample depths {bps}")
    bits = bps[0]
    if predictor == 2 and bits < 8:
        raise ValueError("corrupt TIFF file: a horizontal predictor on sub-byte samples")
    if photometric == 6 and compression != JPEG:
        return _ycbcr(data, fields, order, width, height, spp, bps, planar, extra, compression,
                      predictor, codecs)
    samples = _samples(data, fields, order, width, height, spp, bits, compression, predictor,
                       planar, codecs, color)
    if color == "ycc":  # libjpeg converted the YCbCr samples to RGB
        photometric = 2
    return _to_rgb(samples, fields, photometric, spp, bits, extra, order)


def _chunks(fields: dict, width: int, height: int):
    """Each chunk's (offset, byte count) and geometry: ``(tiled, chunk
    width, chunk height, across)``."""
    if 322 in fields or 324 in fields:
        tw, th = _field(fields, 322)[0], _field(fields, 323)[0]
        offsets, counts = _field(fields, 324), _field(fields, 325)
        if tw <= 0 or th <= 0:
            raise ValueError(f"corrupt TIFF file: tiles of {tw}x{th}")
        return offsets, counts, (True, tw, th, math.ceil(width / tw))
    rows = min(_field(fields, 278, [2**32 - 1])[0], height)
    if rows <= 0:
        raise ValueError("corrupt TIFF file: no rows a strip")
    return _field(fields, 273), _field(fields, 279), (False, width, rows, 1)


def _samples(data, fields, order, width, height, spp, bits, compression, predictor, planar,
             codecs, color=None) -> np.ndarray:
    """The image's samples, (H, W, spp): uint8, or uint16 for 16 bits, or
    the unpacked values of sub-byte samples; a JPEG-in-TIFF image's decoded
    with the colour transform ``color``."""
    offsets, counts, (tiled, cw, ch, across) = _chunks(fields, width, height)
    planes = spp if planar == 2 else 1
    per_pixel = 1 if planar == 2 else spp
    down = math.ceil(height / ch)
    if down * ch * across * cw > MAX_PIXELS:
        raise ValueError(f"TIFF image too large: {across * cw}x{down * ch} pixels, tiles included")
    per_plane = across * down
    if len(offsets) < per_plane * planes or len(counts) < len(offsets):
        raise ValueError(f"corrupt TIFF file: {len(offsets)} chunks for {per_plane * planes}")
    row_bytes = (cw * per_pixel * bits + 7) // 8
    dtype = np.dtype(("<" if order == "little" else ">") + "u2") if bits == 16 else np.uint8
    out = np.zeros((down * ch, across * cw, spp), np.uint16 if bits == 16 else np.uint8)
    for plane in range(planes):
        for index in range(per_plane):
            rows = ch if tiled else min(ch, height - index * ch)
            expected = rows * row_bytes
            at, n = offsets[plane * per_plane + index], counts[plane * per_plane + index]
            raw = data[at:at + n]
            if len(raw) < n:
                raise ValueError("truncated TIFF file: a strip or tile")
            y, x = (index // across) * ch, (index % across) * cw
            if compression == JPEG:
                last = not tiled and index == per_plane - 1
                out[y:y + rows, x:x + cw] = _jpeg_chunk(raw, fields, color, cw, rows, last,
                                                        codecs[JPEG])
                continue
            chunk = _decompress(raw, compression, expected, codecs)
            if len(chunk) < expected:
                raise ValueError("truncated TIFF data: a strip or tile decodes short")
            block = np.frombuffer(chunk[:expected], np.uint8).reshape(rows, row_bytes)
            if bits == 16:
                values = block.view(dtype).reshape(rows, cw, per_pixel).astype(np.uint16)
            elif bits == 8:
                values = block.reshape(rows, cw, per_pixel)
            else:
                unpacked = np.unpackbits(block, axis=1).reshape(rows, -1, bits)
                unpacked = (unpacked * (1 << np.arange(bits - 1, -1, -1))).sum(-1)
                values = unpacked[:, :cw * per_pixel].reshape(rows, cw, per_pixel)
            if predictor == 2 and compression in _PREDICTED:
                # each sample the running sum of the row's differences
                values = np.cumsum(values, axis=1, dtype=values.dtype)
            channels = slice(plane, plane + 1) if planar == 2 else slice(0, spp)
            out[y:y + rows, x:x + cw, channels] = values
    return out[:height, :width]


def _jpeg_chunk(raw: bytes, fields: dict, color: str, width: int, rows: int, last: bool,
                decode) -> np.ndarray:
    """A JPEG-in-TIFF strip's or tile's (rows, width, spp) samples: its
    abbreviated stream with the ``JPEGTables`` stream's tables in front
    (``SOI tables EOI`` and ``SOI frame scans EOI`` made one stream), decoded
    by ``decode(stream, color)``, which refuses a truncated or corrupt one
    (where libjpeg warns and pads with zeros). As libtiff, the stream's size must be the
    chunk's (a last strip's may be taller, and is cut); RGB and grey streams
    have every component at full resolution, and a YCbCr stream's chroma at
    1 x 1 and its luma at the ``YCbCrSubsampling`` field's factors where
    the file gives one."""
    stream = raw
    if 347 in fields:
        tables = np.asarray(fields[347], np.uint8).tobytes()
        if tables[:2] != b"\xff\xd8" or raw[:2] != b"\xff\xd8":
            raise ValueError("corrupt TIFF file: JPEG tables or a JPEG strip without SOI")
        # libtiff's tables source ends the tables at their end, EOI or not.
        stream = tables[:-2 if tables.endswith(b"\xff\xd9") else None] + raw[2:]
    height, stream_width, comps = jpeg.frame_header(stream)
    if stream_width != width or height < rows or (height > rows and not last):
        raise ValueError(f"corrupt TIFF file: a JPEG strip or tile of {stream_width}x{height} "
                         f"for {width}x{rows}")
    factors = [c[1:] for c in comps]
    want = [(1, 1)] * len(comps)
    if color == "ycc":
        want[0] = tuple(_field(fields, 530, list(factors[0])))
    if factors != want:
        raise ValueError(f"unsupported JPEG-in-TIFF sampling factors {factors} (the file says "
                         f"{want})")
    pixels = decode(stream, color)
    return pixels[:rows, :, :1] if color == "grey" else pixels[:rows]


def _decompress(raw: bytes, compression: int, expected: int, codecs: dict) -> bytes:
    if compression == NONE:
        return raw
    if compression in (DEFLATE, ADOBE_DEFLATE):
        try:
            return zlib.decompressobj().decompress(raw, expected)
        except zlib.error as e:
            raise ValueError(f"corrupt TIFF data: {e}") from e
    return codecs[compression](raw, expected)


# The YCbCrSubsampling fields (horizontal, vertical) that libtiff's RGBA
# interface reads (tif_getimage.c's putcontig8bitYCbCr{44,42,41,22,21,12,11}tile).
_YCBCR_SAMPLINGS = {(4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)}


def _rationals(fields: dict, tag: int, count: int):
    """A RATIONAL field's values as libtiff reads them into floats
    (``(float)num / (float)den``, 0 where the denominator is 0), or None."""
    if tag not in fields:
        return None
    pairs = np.asarray(fields[tag]).reshape(-1, 2) if np.asarray(fields[tag]).ndim == 2 else None
    if pairs is None or len(pairs) != count:
        raise ValueError(f"unsupported TIFF file: field {tag} is not {count} rationals")
    num, den = pairs[:, 0].astype(np.float32), pairs[:, 1].astype(np.float32)
    return [float(n / d) if d else 0.0 for n, d in zip(num, den)]


def _ycbcr(data: bytes, fields: dict, order: str, width: int, height: int, spp: int, bps: list,
           planar: int, extra: list, compression: int, predictor: int,
           codecs: dict) -> np.ndarray:
    """A YCbCr image that is not JPEG, as Pillow reads it: through libtiff's
    RGBA interface (``TIFFRGBAImageGet``), for Pillow's one ``OPEN_INFO``
    key of photometric 6 (8-bit, 3 samples, no extra sample). Each strip or
    tile is a run of sampling blocks, each the block's h x v Y samples, then
    its Cb and Cr: Y a pixel, the chroma replicated over the block, edge
    blocks clipped; then ``TIFFYCbCrtoRGB``. As libtiff:

    - a strip is read for ``TIFFScanlineSize`` (the blocks of a row of
      blocks over v, rounded down) times its rows rounded up to v, the bytes
      past that zero (a 4 x 4 strip of an odd count of blocks a row loses its
      last block's chroma);
    - the horizontal predictor accumulates rows of that size (a tile's: its
      width times 3), stride 3; where the size does not divide as
      ``horAcc8`` and ``PredictorDecodeTile`` need, the rows stay as decoded
      (libtiff reports the error, and Pillow's reader goes on); PackBits
      takes no predictor (``_PREDICTED``);
    - a tile clipped at the right edge skips its blocks past the edge at
      each row of blocks, and ``putcontig8bitYCbCr44tile`` counts 10 bytes a
      skipped block, not 18: a 4 x 4 tile clipped by 4 or more pixels is read
      from the wrong place after its first row of blocks;
    - in planes (planar configuration 2) only 1 x 1 subsampling converts
      (``putseparate8bitYCbCr11tile``: a sample of each plane a pixel).

    Uncompressed YCbCr is refused: Pillow reads it raw as RGBX, 4 bytes a
    pixel, and finds the file truncated (in planes it gives the raw bytes as
    RGB, which the port does not copy)."""
    if spp != 3 or bps != [8, 8, 8] or extra:
        raise ValueError(f"unsupported TIFF image: YCbCr, {spp} samples of {bps} bits, planar "
                         f"{planar}, extra {tuple(extra)}")
    if compression == NONE:
        raise ValueError("unsupported TIFF image: uncompressed YCbCr (Pillow reads it as RGBX "
                         "and refuses it as truncated)")
    h, v = (_field(fields, 530, [2, 2]) + [0, 0])[:2]
    if (h, v) not in _YCBCR_SAMPLINGS:
        raise ValueError(f"unsupported TIFF YCbCr subsampling {h}x{v}")
    luma = _rationals(fields, 529, 3)
    reference = _rationals(fields, 532, 6)
    convert = LibtiffYCbCr(luma or LIBTIFF_LUMA, reference or LIBTIFF_REFERENCE)
    if planar == 2:
        if (h, v) != (1, 1):
            raise ValueError(f"unsupported TIFF image: YCbCr in planes at {h}x{v} subsampling")
        planes = _samples(data, fields, order, width, height, 3, 8, compression, predictor, 2,
                          codecs)
        return convert(planes[..., 0], planes[..., 1], planes[..., 2])
    offsets, counts, (tiled, cw, ch, across) = _chunks(fields, width, height)
    down = math.ceil(height / ch)
    if down * ch * across * cw > MAX_PIXELS:
        raise ValueError(f"TIFF image too large: {across * cw}x{down * ch} pixels, tiles included")
    if len(offsets) < across * down or len(counts) < len(offsets):
        raise ValueError(f"corrupt TIFF file: {len(offsets)} chunks for {across * down}")
    if tiled and (cw % h or ch % v):
        raise ValueError(f"unsupported TIFF file: {cw}x{ch} tiles of {h}x{v} YCbCr blocks")
    block = h * v + 2
    across_blocks = -(-cw // h)
    out = np.zeros((height, width, 3), np.uint8)
    for index in range(across * down):
        rows = ch if tiled else min(ch, height - index * ch)
        block_rows = -(-rows // v)
        full = block_rows * across_blocks * block
        if tiled:
            row_size = cw * 3  # TIFFTileRowSize
            asked = full
        else:
            row_size = across_blocks * block // v  # TIFFScanlineSize
            asked = block_rows * v * row_size
        at, n = offsets[index], counts[index]
        raw = data[at:at + n]
        if len(raw) < n:
            raise ValueError("truncated TIFF file: a strip or tile")
        chunk = _decompress(raw, compression, asked, codecs)
        if len(chunk) < asked:
            raise ValueError("truncated TIFF data: a strip or tile decodes short")
        flat = np.zeros(full, np.uint8)
        flat[:asked] = np.frombuffer(chunk[:asked], np.uint8)
        if (predictor == 2 and compression in _PREDICTED and row_size % 3 == 0
                and asked % row_size == 0):
            head = flat[:asked].reshape(-1, row_size // 3, 3)
            flat[:asked] = np.cumsum(head, axis=1, dtype=np.uint8).reshape(-1)
        # The put function's walk: each row of blocks shown, then the blocks
        # of the chunk's clipped columns skipped, at the put's own count of
        # bytes a block (putcontig8bitYCbCr44tile counts 10 for 4 x 4's 18).
        top, left = (index // across) * ch, (index % across) * cw
        shown, cols = min(rows, height - top), min(cw, width - left)
        used = -(-cols // h)
        skip = (cw - cols) // h * (10 if (h, v) == (4, 4) else block)
        at = (np.arange(-(-shown // v))[:, None] * (used * block + skip)
              + np.arange(used * block)[None, :])
        blocks = flat[at].reshape(len(at), used, block)
        luma_samples = blocks[..., :h * v].reshape(len(at), used, v, h)
        y = luma_samples.transpose(0, 2, 1, 3).reshape(len(at) * v, used * h)
        cb, cr = (np.repeat(np.repeat(blocks[..., k], v, axis=0), h, axis=1)
                  for k in (h * v, h * v + 1))
        out[top:top + shown, left:left + cols] = convert(y, cb, cr)[:shown, :cols]
    return out[:height, :width]


def _palette(fields: dict) -> np.ndarray:
    """The 256 colours of the colour map: its 16-bit entries' high bytes
    (Pillow's ``b // 256``), reds, then greens, then blues (``RGB;L``);
    black past them."""
    raw = np.asarray(fields.get(320, np.zeros(0)), np.int64).reshape(-1)
    n = min(raw.size // 3, 256)
    if n == 0:
        raise ValueError("corrupt TIFF file: a palette image without a colour map")
    table = np.zeros((256, 3), np.uint8)
    table[:n] = (raw[:3 * (raw.size // 3)].reshape(3, -1)[:, :n].T // 256).astype(np.uint8)
    return table


# Pillow's OPEN_INFO for RGB and CMYK: the extra samples each sample count
# may carry at 8 and 16 bits (0 other, 1 associated alpha, 2 alpha; 999 is
# Corel Draw's), past the three or four colour samples.
_RGB_EXTRA = {(8, 3): ((),), (8, 4): ((), (0,), (1,), (2,), (999,)),
              (8, 5): ((0, 0), (1, 0), (2, 0)), (8, 6): ((0, 0, 0), (1, 0, 0), (2, 0, 0)),
              (16, 3): ((),), (16, 4): ((), (0,), (2,))}
_CMYK_EXTRA = {4: ((),), 5: ((0,),), 6: ((0, 0),)}


def _to_rgb(s: np.ndarray, fields: dict, photometric: int, spp: int, bits: int, extra: list,
            order: str) -> np.ndarray:
    """Pillow's mode for (photometric, depths, extra samples), then its
    conversion to RGB."""
    extra = tuple(extra)
    if photometric in (0, 1) and spp == 1:
        v = s[..., 0]
        if bits == 16:
            if photometric == 0 and order == "big":
                raise ValueError("unsupported TIFF image: big-endian 16-bit min-is-white grey")
            grey = np.minimum(v, 255).astype(np.uint8)  # I;16 to RGB: clamped
        else:
            grey = (v.astype(np.int64) * 255 // ((1 << bits) - 1)).astype(np.uint8)
            if photometric == 0:
                grey = 255 - grey
        return np.repeat(grey[..., None], 3, axis=2)
    if photometric == 1 and spp == 2 and bits == 8 and extra == (2,):
        return np.repeat(s[..., :1], 3, axis=2)
    if photometric == 3 and bits <= 8 and (spp == 1 or (spp == 2 and extra in ((0,), (2,)))):
        return _palette(fields)[s[..., 0]]
    if photometric == 2 and extra in _RGB_EXTRA.get((bits, spp), ()):
        rgb = (s[..., :3] >> 8).astype(np.uint8) if bits == 16 else s[..., :3]
        if extra[:1] == (1,):  # associated alpha: Pillow's RGBa unpacking divides it out
            a = s[..., 3:4].astype(np.int64)
            scaled = np.minimum(rgb.astype(np.int64) * 255 // np.maximum(a, 1), 255)
            rgb = np.where(a == 0, 0, np.where(a == 255, rgb, scaled)).astype(np.uint8)
        return np.ascontiguousarray(rgb)
    if photometric == 5 and bits == 8 and extra in _CMYK_EXTRA.get(spp, ()):
        return _cmyk_to_rgb(255 - s[..., :4])
    names = {6: "YCbCr", 8: "CIELab", 9: "ICC Lab", 10: "ITU Lab", 32844: "LogL",
             32845: "LogLuv"}
    what = names.get(photometric, f"photometric {photometric}")
    raise ValueError(f"unsupported TIFF image: {what}, {spp} samples of {bits} bits, "
                     f"extra {extra}")
