"""PNG decode with ``zlib`` and numpy, as ``Image.open(f).convert("RGB")`` gives it.

The LAION loader (``data/laion.py``) reads web images without Pillow.
``decode_png`` reads PNG files of every colour type, interlaced (Adam7) or
not: greyscale (bit depths 1, 2, 4 and 8; Pillow scales 1, 2 and 4 bits to
0-255; 16 bits as Pillow's ``I;16`` converts it, each value clamped to 255),
RGB, palette (1, 2, 4 and 8 bits), greyscale + alpha and RGBA (8 bits;
16-bit RGB, RGBA and greyscale + alpha by their high bytes, as Pillow's raw
modes read them), with alpha and ``tRNS`` dropped as ``convert("RGB")``
drops them. Truncated or corrupt files (bad CRCs included) raise
``ValueError``.
"""

from __future__ import annotations

import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Samples a pixel by colour type: grey, -, RGB, palette, grey + alpha, -, RGBA.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7's seven passes: (first row, first column, row step, column step).
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))


def _chunks(data: bytes):
    """(type, body) of each chunk after the signature, CRCs checked."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG file")
        length = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            raise ValueError("truncated PNG file")
        if zlib.crc32(kind + body) != int.from_bytes(crc, "big"):
            raise ValueError(f"corrupt PNG file: bad CRC in a {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG file: no IEND chunk")


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo each scanline's filter (None, Sub, Up, Average, Paeth; RFC 2083
    6.2-6.6). ``raw``: height rows of 1 + stride bytes; ``bpp``: bytes a
    pixel (at least 1)."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along each byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):  # Average and Paeth: byte by byte
            above, got = prev.tolist(), line.tolist()
            for x in range(stride):
                left = got[x - bpp] if x >= bpp else 0
                up = above[x]
                if kind == 3:
                    got[x] = (got[x] + ((left + up) >> 1)) & 0xFF
                    continue
                up_left = above[x - bpp] if x >= bpp else 0
                pa, pb, pc = abs(up - up_left), abs(left - up_left), abs(left + up - 2 * up_left)
                pred = left if pa <= pb and pa <= pc else up if pb <= pc else up_left
                got[x] = (got[x] + pred) & 0xFF
            cur = np.array(got, np.int64)
        else:
            raise ValueError(f"corrupt PNG file: filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def _pass_samples(raw: np.ndarray, height: int, width: int, channels: int,
                  depth: int) -> tuple[np.ndarray, int]:
    """The (height, width * channels) samples of the scanlines at the start
    of ``raw`` (16 bits kept whole; sub-byte depths unpacked), and the bytes
    they took."""
    stride = -(-width * channels * depth // 8)
    used = height * (stride + 1)
    if len(raw) < used:
        raise ValueError("truncated PNG data")
    rows = _unfilter(raw[:used], height, stride, max(1, channels * depth // 8))
    if depth == 16:
        samples = rows.reshape(height, width * channels, 2).astype(np.int64)
        return samples[..., 0] << 8 | samples[..., 1], used
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(height, stride * 8 // depth, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        return (bits * weights).sum(-1)[:, :width], used
    return rows.astype(np.int64), used


def decode_png(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a PNG file, as Pillow 12.1's
    ``Image.open(f).convert("RGB")`` gives it."""
    data = bytes(data)
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file (no signature)")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("corrupt PNG file: a bad IHDR chunk")
            header = (int.from_bytes(body[0:4], "big"), int.from_bytes(body[4:8], "big"),
                      *body[8:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("corrupt PNG file: no IHDR or no IDAT")
    width, height, depth, color, compression, filtering, interlace = header
    if color not in _CHANNELS or compression or filtering or width == 0 or height == 0:
        raise ValueError(f"corrupt PNG file: colour type {color}")
    if interlace not in (0, 1):
        raise ValueError(f"corrupt PNG file: interlace method {interlace}")
    if depth not in ((1, 2, 4, 8, 16) if color == 0 else (1, 2, 4, 8) if color == 3 else (8, 16)):
        raise ValueError(f"corrupt PNG file: bit depth {depth} for colour type {color}")
    if color == 3 and palette is None:
        raise ValueError("corrupt PNG file: a palette image without PLTE")
    channels = _CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt or truncated PNG data: {e}") from e
    raw = np.frombuffer(raw, np.uint8)
    if not interlace:
        samples, _ = _pass_samples(raw, height, width, channels, depth)
    else:
        # Each non-empty pass is a small image of its own scanlines, in turn.
        samples = np.zeros((height, width * channels), np.int64)
        for y0, x0, dy, dx in _ADAM7:
            ph, pw = -(-(height - y0) // dy), -(-(width - x0) // dx)
            if ph <= 0 or pw <= 0:
                continue
            part, used = _pass_samples(raw, ph, pw, channels, depth)
            raw = raw[used:]
            samples.reshape(height, width, channels)[y0::dy, x0::dx] = part.reshape(
                ph, pw, channels)
    samples = samples.reshape(height, width, channels)
    if depth == 16 and color != 0:  # Pillow's raw modes read the high bytes
        samples = samples >> 8
    if color == 3:
        # Indices past the palette read black, as Pillow's padded palette does.
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[samples[..., 0]]
    if color in (0, 4):
        grey = samples[..., 0].astype(np.int64)
        if depth < 8:  # Pillow's "1", "L;2" and "L;4" raw modes: scaled to 0-255
            grey = grey * (255 // ((1 << depth) - 1))
        elif depth == 16:  # I;16 to RGB: clamped
            grey = np.minimum(grey, 255)
        return np.repeat(grey[..., None], 3, axis=-1).astype(np.uint8)
    return np.ascontiguousarray(samples[..., :3]).astype(np.uint8)
