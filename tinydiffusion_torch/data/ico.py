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
``convert("RGB")`` drops, so they are not read. Truncated or corrupt files
raise ``ValueError``.
"""

from __future__ import annotations

import math

import numpy as np

from tinydiffusion_torch.data.bmp import decode_bmp
from tinydiffusion_torch.data.png import SIGNATURE as PNG_SIGNATURE
from tinydiffusion_torch.data.png import decode_png

SIGNATURES = (b"\x00\x00\x01\x00", b"\x00\x00\x02\x00")


def _u16(data: bytes, pos: int) -> int:
    return int.from_bytes(data[pos:pos + 2], "little")


def _u32(data: bytes, pos: int) -> int:
    return int.from_bytes(data[pos:pos + 4], "little")


def decode_ico(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of the icon or cursor Pillow 12.1 opens in an
    ICO or CUR file, as ``Image.open(f).convert("RGB")`` gives it."""
    data = bytes(data)
    if data[:4] not in SIGNATURES:
        raise ValueError("not an ICO or CUR file")
    n = _u16(data, 4)
    if n == 0 or len(data) < 6 + 16 * n:
        raise ValueError("truncated ICO file: its directory")
    entries = [data[6 + 16 * i:22 + 16 * i] for i in range(n)]
    if data[:4] == SIGNATURES[1]:
        chosen = entries[0]
        for entry in entries[1:]:
            if entry[0] > chosen[0] and entry[1] > chosen[1]:
                chosen = entry
        return _dib(data, _u32(chosen, 12))
    chosen = sorted(sorted(entries, key=_color_depth), key=_area, reverse=True)[0]
    offset = _u32(chosen, 12)
    if data[offset:offset + 8] == PNG_SIGNATURE:
        return decode_png(data[offset:])
    return _dib(data, offset)


def _area(entry: bytes) -> int:
    return (entry[0] or 256) * (entry[1] or 256)


def _color_depth(entry: bytes) -> int:
    """Pillow's ``color_depth``: the bit count, else log2 of the colour
    count, else 256."""
    bpp, colors = _u16(entry, 6), entry[2]
    return bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256


def _dib(data: bytes, offset: int) -> np.ndarray:
    """The XOR image of the DIB at ``offset``: a BMP file of its header, its
    palette and its pixels, at half the header's height."""
    if offset + 4 > len(data):
        raise ValueError("truncated ICO file: an image past the end")
    header = _u32(data, offset)
    if header not in (12, 40, 52, 56, 64, 108, 124) or offset + header > len(data):
        raise ValueError(f"unsupported ICO image: a DIB header of {header} bytes")
    dib = bytearray(data[offset:])
    if header == 12:
        bits, colors, entry = _u16(dib, 10), 0, 3
        dib[6:8] = (_u16(dib, 6) // 2).to_bytes(2, "little")
        masks = 0
    else:
        bits, colors, entry = _u16(dib, 14), _u32(dib, 32), 4
        height = _u32(dib, 8)
        top_down = dib[11] == 0xFF
        half = ((2**32 - height) if top_down else height) // 2
        dib[8:12] = ((2**32 - half) if top_down else half).to_bytes(4, "little")
        # A 40-byte header's bit-field masks follow it (Pillow reads them there).
        masks = 12 if header == 40 and _u32(dib, 16) == 3 else 0
    palette = entry * (colors or 1 << bits) if bits <= 8 else 0
    pixels = 14 + header + masks + palette
    head = b"BM" + (14 + len(dib)).to_bytes(4, "little") + bytes(4) + pixels.to_bytes(4, "little")
    return decode_bmp(head + bytes(dib))
