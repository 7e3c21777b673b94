"""BMP decode in numpy, as ``Image.open(f).convert("RGB")`` gives it.

JAX's LAION loader reads every web image with Pillow; the port reads BMP
here, as Pillow's ``BmpImagePlugin`` does: the core (12-byte) header and
the info headers of 40 to 124 bytes; 1-, 4- and 8-bit palette images (the
palette's entries BGR or BGRX, ``colors`` of them, 2 ** bits when the header
says 0; black past them, or every index its own grey where the palette is
the grey ramp), uncompressed or RLE8/RLE4 (``BmpRleDecoder``'s reading, its
delta escape included); 16-bit 5-5-5 (and 5-6-5 by bit fields), 24-bit BGR
and 32-bit pixels (BGRX, or any bit-field layout Pillow names); rows
bottom-up, or top-down where the height is negative. Alpha is dropped as
``convert("RGB")`` drops it. Anything else, and truncated or corrupt files,
raise ``ValueError``.
"""

from __future__ import annotations

import numpy as np

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
    return int.from_bytes(data[pos:pos + 4], "little")


def _u16(data: bytes, pos: int) -> int:
    return int.from_bytes(data[pos:pos + 2], "little")


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


def decode_bmp(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a BMP file, as Pillow 12.1's
    ``Image.open(f).convert("RGB")`` gives it."""
    data = bytes(data)
    if data[:2] != b"BM" or len(data) < 26:
        raise ValueError("not a BMP file")
    offset, header = _u32(data, 10), _u32(data, 14)
    if len(data) < 14 + header:
        raise ValueError("truncated BMP file")
    h = data[18:14 + header]
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
                masks = [_u32(data, 14 + header + 4 * i) for i in range(3)]
            masks = tuple(masks + [0] * (4 - len(masks)))
    else:
        raise ValueError(f"unsupported BMP header of {header} bytes")
    colors = colors or (1 << bits if bits <= 30 else 0)
    if offset == 14 + header and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32) or width == 0 or height == 0:
        raise ValueError(f"unsupported BMP image: {bits} bits, {width}x{height}")
    if compression not in (0, 1, 2, 3) or (compression == 3 and bits not in (16, 24, 32)):
        raise ValueError(f"unsupported BMP compression {compression}")
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"unsupported BMP palette of {colors} colours")
        start = 14 + header
        raw = np.frombuffer(data[start:start + entry * colors], np.uint8)
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
                if masks not in (None, (0xFF0000, 0xFF00, 0xFF, 0)):
                    raise ValueError("unsupported BMP bit-field layout")
                order = (2, 1, 0)
            else:
                order = _MASKS32.get(masks or (0xFF0000, 0xFF00, 0xFF, 0x0))
                if order is None:
                    raise ValueError("unsupported BMP bit-field layout")
            rows = pixel[..., list(order)]
    if not top_down:
        rows = rows[::-1]
    if bits <= 8:
        return table[rows]
    return np.ascontiguousarray(rows).astype(np.uint8)
