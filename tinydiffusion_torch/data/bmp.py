"""BMP and DIB decode in numpy, as ``Image.open(f).convert("RGB")`` gives it.

JAX's LAION loader reads every web image with Pillow; the port reads BMP
here, as Pillow's ``BmpImagePlugin`` does, and DIB, a BMP without its
14-byte file header (the plugin's ``DibImageFile``, which Pillow tries on a
file that starts with an info header's size). Both go through ``_bitmap``,
the counterpart of the plugin's ``BmpImageFile._bitmap``, which also reads
the images of icons and cursors (``data/ico.py``): the core (12-byte) header and
the info headers of 40 to 124 bytes; 1-, 4- and 8-bit palette images (the
palette's entries BGR or BGRX, ``colors`` of them, 2 ** bits when the header
says 0; black past them, or every index its own grey where the palette is
the grey ramp), uncompressed or RLE8/RLE4 (``BmpRleDecoder``'s reading, its
delta escape included); 16-bit 5-5-5 (and 5-6-5 by bit fields), 24-bit BGR
and 32-bit pixels (BGRX, or any bit-field layout Pillow names); rows
bottom-up, or top-down where the height is negative. Alpha is dropped as
``convert("RGB")`` drops it. Where the plugin's header reads fail as
``Image.open`` takes for "not this format" (a size field past the end),
``open_bmp`` and ``open_dib`` raise ``NotThisFormat``; anything else the
plugin refuses, and truncated or corrupt pixels, raise ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from tinydiffusion_torch.data.header import Header, NotThisFormat, open_as

# Pillow's 32-bit bit-field layouts (r, g, b, a masks): byte offsets of R, G, B
# in each little-endian pixel.
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): (2, 1, 0), (0xFF000000, 0xFF0000, 0xFF00, 0x0): (3, 2, 1),
    (0xFF000000, 0xFF00, 0xFF, 0x0): (3, 1, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0), (0x0, 0x0, 0x0, 0x0): (2, 1, 0),
}
# 16-bit layouts: (shift, bits) of R, G and B.
_MASKS16 = {(0xF800, 0x7E0, 0x1F): ((11, 5), (5, 6), (0, 5)),
            (0x7C00, 0x3E0, 0x1F): ((10, 5), (5, 5), (0, 5))}


def _u32(data: bytes, pos: int) -> int:
    """Pillow's ``i32``: ``struct.error`` where the bytes are not there."""
    return struct.unpack_from("<I", data, pos)[0]


def _u16(data: bytes, pos: int) -> int:
    return struct.unpack_from("<H", data, pos)[0]


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """``BmpRleDecoder``: the indices of an RLE8 or RLE4 image, row by row in
    file order. An encoded run repeats one byte (RLE4: its two nibbles in
    turn); escape 0 ends a row (zeros to its end), 1 the image, 2 a delta
    (Pillow reads two bytes past the escape and takes the next two as right
    and up, zeros skipped); 3 and more is an absolute run, padded to an even
    file position."""
    out = bytearray()
    x, total = 0, width * height
    while len(out) < total:
        if pos + 2 > len(data):
            break
        n, byte = data[pos], data[pos + 1]
        pos += 2
        if n:
            n = max(0, width - x) if x + n > width else n
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * (n // 2 + 1))[:n]
            else:
                out += bytes([byte]) * n
            x += n
        elif byte == 0:
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > len(data):
                break
            right, up = data[pos + 2:pos + 4] if pos + 4 <= len(data) else (0, 0)
            pos += 4
            out += bytes(right + up * width)
            x = len(out) % width
        else:
            count = byte // 2 if rle4 else byte
            chunk = data[pos:pos + count]
            pos += len(chunk)
            if rle4:
                out += bytes(v for b in chunk for v in (b >> 4, b & 15))
            else:
                out += chunk
            if len(chunk) < count:
                break
            x += byte
            pos += pos % 2
    indices = np.zeros(total, np.uint8)
    indices[:min(len(out), total)] = np.frombuffer(bytes(out[:total]), np.uint8)
    return indices.reshape(height, width)


@dataclasses.dataclass(frozen=True)
class Bitmap:
    """A bitmap's header as ``_bitmap`` reads it: where its pixels start,
    their layout and the colour table of a palette image."""

    width: int
    height: int
    bits: int
    compression: int
    masks: tuple | None
    top_down: bool
    pixels_at: int
    table: np.ndarray | None

    def halved(self) -> "Bitmap":
        """The XOR image of an icon's or a cursor's DIB, whose height counts
        its AND mask too."""
        return dataclasses.replace(self, height=self.height // 2)


def _bitmap(data: bytes, at: int, offset: int = 0) -> Bitmap:
    """``BmpImageFile._bitmap``: the info header at ``at`` (its size first),
    the bit-field masks after a 40-byte one, the palette after them; the
    pixels at ``offset``, or right after those (0). Raises ``NotThisFormat``
    where Pillow's reads raise ``struct.error``, ``ValueError`` where it
    refuses the header."""
    header = _u32(data, at)
    h = data[at + 4:at + header]
    if header > 4 and len(h) < header - 4:
        raise ValueError("truncated BMP file: its header")
    pos = at + max(header, 4)
    masks = None
    if header == 12:
        width, height, bits = _u16(h, 0), _u16(h, 2), _u16(h, 6)
        compression, colors, entry, top_down = 0, 0, 3, False
    elif header in (40, 52, 56, 64, 108, 124):
        top_down = h[7] == 0xFF
        width, height = _u32(h, 0), (2**32 - _u32(h, 4) if top_down else _u32(h, 4))
        bits, compression, colors, entry = _u16(h, 10), _u32(h, 12), _u32(h, 28), 4
        if compression == 3:
            if len(h) >= 48:
                masks = [_u32(h, 36 + 4 * i) for i in range(4 if len(h) >= 52 else 3)]
            else:
                masks = [_u32(data, pos + 4 * i) for i in range(3)]
                pos += 12
            masks = tuple(masks + [0] * (4 - len(masks)))
    else:
        raise ValueError(f"unsupported BMP header of {header} bytes")
    colors = colors or 1 << min(bits, 64)
    if offset == 14 + header and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"unsupported BMP pixel depth ({bits})")
    if compression not in (0, 1, 2, 3) or (compression == 3 and bits not in (16, 24, 32)):
        raise ValueError(f"unsupported BMP compression {compression}")
    table = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"unsupported BMP palette of {colors} colours")
        raw = np.frombuffer(data[pos:pos + entry * colors], np.uint8)
        pos = min(pos + entry * colors, len(data))
        raw = raw[:len(raw) // entry * entry].reshape(-1, entry)[:256, 2::-1]
        # Pillow reads a grey-ramp palette (black and white for two colours)
        # as an "L" (or "1") image, any other as "P": black past its entries.
        ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        grey = ramp[[0, 255]] if colors == 2 else ramp[:colors]
        if len(raw) == len(grey) and np.array_equal(raw, grey):
            table = ramp if colors != 2 else np.concatenate([grey, ramp[2:]])
        else:
            table = np.zeros((256, 3), np.uint8)
            table[:len(raw)] = raw
    return Bitmap(width, height, bits, compression, masks, top_down, offset or pos, table)


def open_bmp(data: bytes) -> Header:
    """``BmpImageFile._open``: ``BM``, the pixels' offset, ``_bitmap``."""
    if data[:2] != b"BM":
        raise NotThisFormat("not a BMP file")
    bitmap = _bitmap(data, 14, _u32(data[:14], 10))
    return Header("RGB", (bitmap.width, bitmap.height), bitmap)


def dib_accept(prefix: bytes) -> bool:
    """``BmpImagePlugin._dib_accept``: an info header's size first (a
    shorter file raises ``struct.error``, which ``Image.open`` passes by)."""
    return _u32(prefix, 0) in (12, 40, 52, 56, 64, 108, 124)


def open_dib(data: bytes) -> Header:
    """``DibImageFile._open``: ``_bitmap`` of the file's start."""
    bitmap = _bitmap(data, 0)
    return Header("RGB", (bitmap.width, bitmap.height), bitmap)


def _opened(data: bytes, header: Header | None, open_fn) -> Bitmap:
    return (header or open_as(open_fn, data)).info


def decode_bmp(data: bytes, header: Header | None = None) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a BMP file, as Pillow 12.1's
    ``Image.open(f).convert("RGB")`` gives it (``header``: ``open_bmp``'s,
    else read here)."""
    data = bytes(data)
    return pixels(data, _opened(data, header, open_bmp))


def decode_dib(data: bytes, header: Header | None = None) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a DIB file (a BMP without its file
    header), as Pillow 12.1 gives it."""
    data = bytes(data)
    return pixels(data, _opened(data, header, open_dib))


def pixels(data: bytes, bitmap: Bitmap) -> np.ndarray:
    """The RGB of the pixels ``bitmap`` describes."""
    width, height, bits = bitmap.width, bitmap.height, bitmap.bits
    compression, masks, offset = bitmap.compression, bitmap.masks, bitmap.pixels_at
    if compression in (1, 2):
        rows = _rle(data, offset, width, height, compression == 2)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        body = data[offset:offset + stride * height]
        if len(body) < stride * height:
            raise ValueError("truncated BMP file")
        raw = np.frombuffer(body, np.uint8).reshape(height, stride)
        if bits < 8:
            rows = np.unpackbits(raw, axis=1).reshape(height, -1, bits)
            rows = (rows * (1 << np.arange(bits - 1, -1, -1))).sum(-1)[:, :width]
        elif bits == 8:
            rows = raw[:, :width]
        elif bits == 16:
            layout = _MASKS16.get(masks[:3] if masks else (0x7C00, 0x3E0, 0x1F))
            if layout is None:
                raise ValueError("unsupported BMP bit-field layout")
            pixel = raw[:, :2 * width].reshape(height, width, 2).astype(np.int64)
            pixel = pixel[..., 0] | pixel[..., 1] << 8
            rows = np.stack([((pixel >> s) & ((1 << n) - 1)) * 255 // ((1 << n) - 1)
                             for s, n in layout], axis=-1)
        else:
            size = bits // 8
            pixel = raw[:, :size * width].reshape(height, width, size)
            if bits == 24:
                if masks is not None and masks[:3] != (0xFF0000, 0xFF00, 0xFF):
                    raise ValueError("unsupported BMP bit-field layout")
                order = (2, 1, 0)
            else:
                order = _MASKS32.get(masks or (0xFF0000, 0xFF00, 0xFF, 0x0))
                if order is None:
                    raise ValueError("unsupported BMP bit-field layout")
            rows = pixel[..., list(order)]
    if not bitmap.top_down:
        rows = rows[::-1]
    if bits <= 8:
        return bitmap.table[rows]
    return np.ascontiguousarray(rows).astype(np.uint8)
