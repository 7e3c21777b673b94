"""ICO and CUR decode, as ``Image.open(f).convert("RGB")`` gives it.

JAX's LAION loader reads every web image with Pillow; the port reads
Windows icons and cursors here, the image Pillow opens:

- ICO (``\\0\\0\\1\\0``, ``IcoImagePlugin``): the directory's entries sorted
  by colour depth, then stably by area, largest first (a width or height
  byte of 0 is 256); the first is read. An entry that starts with PNG's
  signature is a PNG (``data/png.py``); any other is a DIB, a BMP's info
  header, palette and pixels without its file header, whose height counts
  the XOR image and the AND mask below it (``data/bmp.py``, at half that
  height).
- CUR (``\\0\\0\\2\\0``, ``CurImagePlugin``): the first entry, replaced by a
  later one only when both its width and height bytes are larger; a DIB
  always, at half its height.

The AND mask and a 32-bit DIB's fourth byte give Pillow's alpha, which
``convert("RGB")`` drops; Pillow refuses an icon whose mask or alpha bytes
the file does not hold, and so does the port.

Pillow's ICO plugin decodes in its ``_open``, so every failure of it that
``Image.open`` takes for "not this format" (a short directory, no entry, a
DIB header or PNG chunk past the end) makes the walk go on to the next
plugin; the CUR plugin's too (a short directory, no entry: a TypeError).
``open_ico`` and ``open_cur`` raise ``NotThisFormat`` there
(``data/identify.py`` walks on: an uncompressed TGA starts as a cursor
does); truncated or corrupt images raise ``ValueError``.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from tinydiffusion_torch.data import bmp
from tinydiffusion_torch.data.header import Header, NotThisFormat, open_as
from tinydiffusion_torch.data.png import SIGNATURE as PNG_SIGNATURE
from tinydiffusion_torch.data.png import decode_png

SIGNATURES = (b"\x00\x00\x01\x00", b"\x00\x00\x02\x00")


def _u16(data: bytes, pos: int) -> int:
    return struct.unpack_from("<H", data, pos)[0]


def _u32(data: bytes, pos: int) -> int:
    return struct.unpack_from("<I", data, pos)[0]


def _entries(data: bytes) -> tuple[list[bytes], int]:
    """The directory's entries as Pillow reads them (16 bytes each, fewer
    at the end of the file), and the position after them."""
    n = _u16(data[:6], 4)
    entries = [data[6 + 16 * i:22 + 16 * i] for i in range(n)]
    return entries, min(6 + 16 * n, len(data))


def open_cur(data: bytes) -> Header:
    """``CurImageFile._open``: the first entry, replaced by a later one only
    when both its width and height bytes are larger; the DIB at its offset
    (none: right after the directory), at half its height. Raises
    ``NotThisFormat`` (or ``IndexError``, ``struct.error``) where Pillow's
    falls through."""
    if data[:4] != SIGNATURES[1]:
        raise NotThisFormat("not a CUR file")
    entries, after = _entries(data)
    chosen = b""
    for entry in entries:
        if not chosen:
            chosen = entry
        elif entry[0] > chosen[0] and entry[1] > chosen[1]:
            chosen = entry
    if not chosen:
        raise NotThisFormat("a CUR file with no cursors (Pillow: TypeError)")
    at = _u32(chosen, 12)
    bitmap = bmp._bitmap(data, at or after).halved()
    return Header("RGB", (bitmap.width, bitmap.height), bitmap)


def open_ico(data: bytes) -> Header:
    """``IcoImageFile._open``, which loads the image: the directory's
    entries sorted by colour depth, then stably by area, largest first; the
    first one's PNG or DIB decoded (``info``: its RGB). Raises
    ``NotThisFormat`` (or ``IndexError``, ``struct.error``) where Pillow's
    falls through, ``ValueError`` where it refuses the file."""
    if data[:4] != SIGNATURES[0]:
        raise NotThisFormat("not an ICO file")
    entries, _ = _entries(data)
    for entry in entries:  # Pillow reads each entry's fields
        entry[0], entry[1], entry[2], entry[3], _u32(entry, 12)
    chosen = sorted(sorted(entries, key=_color_depth), key=_area, reverse=True)[0]
    offset = _u32(chosen, 12)
    if data[offset:offset + 8] == PNG_SIGNATURE:
        rgb = decode_png(data[offset:])
    else:
        bitmap = bmp._bitmap(data, offset)
        if bitmap.width <= 0 or bitmap.height <= 0:
            raise NotThisFormat("an icon's DIB of no size")
        bitmap = bitmap.halved()
        width, height = bitmap.width, bitmap.height
        if _u16(chosen, 6) == 32:  # the alpha: every fourth byte of 4 a pixel
            if len(data) - bitmap.pixels_at < 4 * width * height:
                raise ValueError("truncated ICO file: its alpha (Pillow refuses it)")
        else:  # the AND mask: 1 bit a pixel, rows padded to 32 bits, at the entry's end
            stride = (width + 31) // 32 * 4
            start = offset + _u32(chosen, 8) - stride * height
            if height and (start < 0 or len(data) - start < (height - 1) * stride
                           + (width + 7) // 8):
                raise ValueError("truncated ICO file: its AND mask (Pillow refuses it)")
        rgb = bmp.pixels(data, bitmap)
    return Header("RGB", rgb.shape[1::-1], rgb)


def decode_ico(data: bytes, header: Header | None = None) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of the icon or cursor Pillow 12.1 opens in an
    ICO or CUR file, as ``Image.open(f).convert("RGB")`` gives it
    (``header``: ``open_ico``'s or ``open_cur``'s, else read here)."""
    data = bytes(data)
    header = header or open_as(open_cur if data[:4] == SIGNATURES[1] else open_ico, data)
    if isinstance(header.info, bmp.Bitmap):
        return bmp.pixels(data, header.info)
    return header.info


def _area(entry: bytes) -> int:
    return (entry[0] or 256) * (entry[1] or 256)


def _color_depth(entry: bytes) -> int:
    """Pillow's ``color_depth``: the bit count, else log2 of the colour
    count, else 256."""
    bpp, colors = _u16(entry, 6), entry[2]
    return bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
