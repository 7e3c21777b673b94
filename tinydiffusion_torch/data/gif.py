"""GIF decode, as ``Image.open(f).convert("RGB")`` gives it.

JAX's LAION loader reads every web image with Pillow; the port reads GIF
here. Pillow opens a GIF at its first frame (``GifImagePlugin``), and so
does ``decode_gif``: the logical screen, grown to the frame's extent where
the frame reaches past it; the canvas filled with the frame's transparent
index (from its graphic control extension) or with 0; the frame's LZW data
(variable code size from the minimum code size + 1 to 12 bits, clear and end
codes, a full table kept until the next clear) placed at its offset, its rows
in the four-pass order when the frame is interlaced; then each index looked
up in the frame's local palette, else the global one (black past its
entries). As in Pillow, a file without a palette, or whose palette is the
grey ramp, reads as greyscale: each index its own grey. Transparency is dropped as
``convert("RGB")`` drops it. Later frames of an animation are not read.
Truncated or corrupt files raise ``ValueError``. ``decode_gif`` decodes the
LZW data in C (``data/csrc/gif.c``); ``decode_gif_reference`` in Python.
"""

from __future__ import annotations

import numpy as np

from tinydiffusion_torch.data import native

SIGNATURES = (b"GIF87a", b"GIF89a")


def _sub_blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """The data of the sub-blocks at ``pos`` joined, and the position after
    their zero-length terminator."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError("truncated GIF file")
        n = data[pos]
        if n == 0:
            return b"".join(parts), pos + 1
        parts.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n


def _lzw_native(data: bytes, min_size: int, count: int) -> bytes:
    """``_lzw_decode`` in C (``data/csrc/gif.c``)."""
    src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    out = np.empty(max(count, 1), np.uint8)
    written = np.zeros(1, np.int64)
    native.check(native.library().tdt_gif_lzw(native.ptr(src), len(data), min_size, native.ptr(out),
                                              count, native.ptr(written)), "GIF",
                 {native.ERR_CORRUPT: f"corrupt GIF file: an LZW code size of {min_size}",
                  native.ERR_CODE: "corrupt GIF data: an LZW code past the table"})
    return out[:int(written[0])].tobytes()


def _lzw_decode(data: bytes, min_size: int, count: int) -> bytes:
    """At most ``count`` indices of GIF's LZW stream ``data`` (codes packed
    least-significant bit first)."""
    if not 1 <= min_size <= 11:
        raise ValueError(f"corrupt GIF file: an LZW code size of {min_size}")
    clear, end = 1 << min_size, (1 << min_size) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    size, prev = min_size + 1, None
    out = bytearray()
    acc = nacc = pos = 0
    while len(out) < count:
        while nacc < size and pos < len(data):
            acc |= data[pos] << nacc
            nacc += 8
            pos += 1
        if nacc < size:
            break  # the data ends without an end code
        code = acc & ((1 << size) - 1)
        acc >>= size
        nacc -= size
        if code == clear:
            table, size, prev = list(base), min_size + 1, None
            continue
        if code == end:
            break
        if code < len(table):
            entry = table[code]
            added = None if prev is None else prev + entry[:1]
        elif code == len(table) and prev is not None:
            entry = added = prev + prev[:1]
        else:
            raise ValueError("corrupt GIF data: an LZW code past the table")
        if added is not None and len(table) < 4096:
            table.append(added)
            if len(table) == 1 << size and size < 12:
                size += 1
        out += entry
        prev = entry
    return bytes(out[:count])


def _interlaced_rows(height: int) -> np.ndarray:
    """The image row of each stored row of an interlaced frame: every 8th row
    from 0, every 8th from 4, every 4th from 2, every 2nd from 1."""
    return np.concatenate([np.arange(start, height, step)
                           for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))])


def _palette(raw: bytes) -> np.ndarray:
    """The 256 colours of a palette: its entries, black past them. Pillow
    reads a palette whose entries are the grey ramp (entry i is (i, i, i)),
    or no palette, as an "L" image: every index is its own grey."""
    entries = np.frombuffer(raw, np.uint8).reshape(-1, 3)[:256]
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    if np.array_equal(entries, ramp[:len(entries)]):
        return ramp
    table = np.zeros((256, 3), np.uint8)
    table[:len(entries)] = entries
    return table


def decode_gif(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a GIF file's first frame, as Pillow 12.1's
    ``Image.open(f).convert("RGB")`` gives it; the LZW data decoded by the C
    library (``data/csrc/gif.c``, built at the first call)."""
    return _decode(data, _lzw_native)


def decode_gif_reference(data: bytes) -> np.ndarray:
    """The plain version of ``decode_gif``: its LZW decoded in Python. The
    tests and ``chip_smoke.py`` hold the C library to it."""
    return _decode(data, _lzw_decode)


def _decode(data: bytes, lzw_decode) -> np.ndarray:
    try:
        return _decode_blocks(bytes(data), lzw_decode)
    except IndexError as e:  # a block that ends inside its header
        raise ValueError("truncated GIF file") from e


def _decode_blocks(data: bytes, lzw_decode) -> np.ndarray:
    if data[:6] not in SIGNATURES or len(data) < 13:
        raise ValueError("not a GIF file")
    width, height = int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little")
    flags = data[10]
    pos = 13
    palette = None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        if pos + n > len(data):
            raise ValueError("truncated GIF file")
        palette = _palette(data[pos:pos + n])
        pos += n
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("corrupt GIF file: no image")
        kind = data[pos]
        if kind == 0x21:  # an extension: its label, then sub-blocks
            if pos + 2 > len(data):
                raise ValueError("truncated GIF file")
            label = data[pos + 1]
            first = data[pos + 3:pos + 3 + data[pos + 2]] if pos + 2 < len(data) else b""
            if label == 0xF9 and len(first) >= 4 and first[0] & 1:
                transparency = first[3]
            _, pos = _sub_blocks(data, pos + 2)
        elif kind == 0x2C:  # the first image descriptor
            if pos + 11 > len(data):
                raise ValueError("truncated GIF file")
            x0, y0, w, h = (int.from_bytes(data[pos + 1 + 2 * i:pos + 3 + 2 * i], "little")
                            for i in range(4))
            flags = data[pos + 9]
            pos += 10
            if flags & 128:
                n = 3 << ((flags & 7) + 1)
                palette = _palette(data[pos:pos + n])
                pos += n
            min_size = data[pos]
            lzw, _ = _sub_blocks(data, pos + 1)
            break
        else:
            raise ValueError(f"corrupt GIF file: a block of kind {kind:#x}")
    if palette is None:
        palette = _palette(b"")
    width, height = max(width, x0 + w), max(height, y0 + h)
    if width == 0 or height == 0:
        raise ValueError("corrupt GIF file: an empty image")
    canvas = np.full((height, width), 0 if transparency is None else transparency, np.uint8)
    pixels = np.frombuffer(lzw_decode(lzw, min_size, w * h), np.uint8)
    if len(pixels) < w * h:
        raise ValueError("truncated GIF data")
    frame = pixels.reshape(h, w)
    if flags & 64:
        frame = frame[np.argsort(_interlaced_rows(h), kind="stable")]
    canvas[y0:y0 + h, x0:x0 + w] = frame
    return palette[canvas]
