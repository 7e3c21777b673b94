"""TGA decode, as ``Image.open(f).convert("RGB")`` gives it.

JAX's LAION loader reads every web image with Pillow; the port reads Targa
files here, as Pillow 12.1's ``TgaImagePlugin`` does. ``open_tga`` is the
plugin's ``_open``: an 18-byte header whose colour-map type is 0 or 1, both
sides over 0 and a depth of 1, 8, 16, 24 or 32 bits, an image type of 1, 2
or 3 or their run-length forms 9, 10 and 11, and a colour map of 16-, 24- or
32-bit entries; anything else is ``NotThisFormat``, and ``Image.open`` tries
the next plugin. ``decode_tga`` then reads the pixels Pillow reads: the
image type and depth pairs of the plugin's ``MODES`` (colour-mapped 8-bit,
1-bit, 8-bit and 8-bit + alpha grey, 15/16-bit, 24-bit and 32-bit BGR(A)),
the ID field skipped, the colour map from its first index on (the entries
before it black, as are the indices past it), the rows bottom-up unless the
descriptor's bit 5 says top-down, and mirrored where its bit 4 says so.
Alpha is dropped as ``convert("RGB")`` drops it; a grey image with a colour
map reads its greys through the map, as Pillow's does.

Pillow refuses, and so does the port: a pair outside ``MODES``, a
colour-mapped type without a map, a map on a 1-bit or true-colour image, a
32-bit map, a map past 256 entries, run-length 1-bit images (Pillow's
run-length decoder moves no whole byte a pixel there) and a run packet that
crosses the end of its row. A literal packet may run on into the next rows.
``decode_tga`` expands the packets in C (``data/csrc/raster.c``,
``tdt_tga_rle``); ``decode_tga_reference`` in Python.
"""

from __future__ import annotations

import struct

import numpy as np

from tinydiffusion_torch.data import native
from tinydiffusion_torch.data.header import Header, NotThisFormat, open_as

# (image type & 7, depth) -> Pillow's raw mode of the pixels.
MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
         (2, 24): "BGR", (2, 32): "BGRA"}


def open_tga(data: bytes) -> Header:
    """``TgaImageFile._open``: the header's mode and size, and where the
    pixels and the colour map are. Raises ``NotThisFormat`` (or, where
    Pillow's reads fail, ``IndexError`` and ``struct.error``)."""
    s = data[:18]
    id_len, colormaptype, imagetype, depth, flags = s[0], s[1], s[2], s[16], s[17]
    size = struct.unpack_from("<HH", s, 12)
    if colormaptype not in (0, 1) or size[0] <= 0 or size[1] <= 0 or depth not in (
            1, 8, 16, 24, 32):
        raise NotThisFormat("not a TGA file")
    if imagetype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif imagetype in (1, 9):
        mode = "P" if colormaptype else "L"
    elif imagetype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise NotThisFormat("unknown TGA mode")
    pos = min(18 + id_len, len(data))
    palette = None
    if colormaptype:
        start, length, mapdepth = struct.unpack_from("<HHB", s, 3)
        if mapdepth not in (16, 24, 32):
            raise NotThisFormat("unknown TGA map depth")
        entry = mapdepth // 8
        read = data[pos:pos + entry * length]
        pos += len(read)
        palette = (mapdepth, bytes(entry * start) + read, entry * length - len(read))
    info = {"imagetype": imagetype, "depth": depth, "top_down": bool(flags & 0x20),
            "mirrored": bool(flags & 0x10), "palette": palette, "pixels_at": pos}
    return Header(mode, size, info)


def _colors(mapdepth: int, raw: bytes) -> np.ndarray:
    """A colour map's (256, 3) RGB table: its entries (BGR, BGRA;15Z), black
    past them."""
    table = np.zeros((256, 3), np.uint8)
    if mapdepth == 24:
        rgb = np.frombuffer(raw, np.uint8).reshape(-1, 3)[:, ::-1]
    else:
        rgb = _rgb15(np.frombuffer(raw, "<u2"))
    table[:len(rgb)] = rgb
    return table


def _rgb15(pixel: np.ndarray) -> np.ndarray:
    """Pillow's BGR;15 unpacking: 5 bits a channel, times 255 // 31."""
    pixel = pixel.astype(np.int64)
    return np.stack([((pixel >> s) & 31) * 255 // 31 for s in (10, 5, 0)],
                    axis=-1).astype(np.uint8)


def _rle_native(data: bytes, depth: int, row_bytes: int, rows: int) -> np.ndarray:
    """``_rle_reference`` in C (``data/csrc/raster.c``)."""
    src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    out = np.empty(row_bytes * rows, np.uint8)
    native.check(native.library().tdt_tga_rle(native.ptr(src), len(data), depth,
                                              native.ptr(out), row_bytes, rows), "TGA",
                 _RLE_ERRORS)
    return out


_RLE_ERRORS = {native.ERR_TRUNCATED: "truncated TGA file",
               native.ERR_RANGE: "corrupt TGA data: a run packet past the end of its row "
                                 "(Pillow: buffer overrun)"}


def _rle_reference(data: bytes, depth: int, row_bytes: int, rows: int) -> np.ndarray:
    """The ``rows`` rows of ``row_bytes`` bytes that the run-length packets
    in ``data`` expand to, in file order (see the module's docstring)."""
    out = bytearray(row_bytes * rows)
    total, at, pos = len(out), 0, 0
    while at < total:
        if pos >= len(data):
            raise ValueError(_RLE_ERRORS[native.ERR_TRUNCATED])
        head = data[pos]
        count = depth * ((head & 0x7F) + 1)
        if head & 0x80:
            if pos + 1 + depth > len(data):
                raise ValueError(_RLE_ERRORS[native.ERR_TRUNCATED])
            if at % row_bytes + count > row_bytes:
                raise ValueError(_RLE_ERRORS[native.ERR_RANGE])
            out[at:at + count] = data[pos + 1:pos + 1 + depth] * (count // depth)
            pos += 1 + depth
        else:
            if pos + 1 + count > len(data):
                raise ValueError(_RLE_ERRORS[native.ERR_TRUNCATED])
            n = min(count, total - at)
            out[at:at + n] = data[pos + 1:pos + 1 + n]
            pos += 1 + count
        at += count
    return np.frombuffer(bytes(out), np.uint8)


def decode_tga(data: bytes, header: Header | None = None) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a TGA file, as Pillow 12.1's
    ``Image.open(f).convert("RGB")`` gives it (``header``: ``open_tga``'s,
    else read here)."""
    return _decode(bytes(data), header, _rle_native)


def decode_tga_reference(data: bytes, header: Header | None = None) -> np.ndarray:
    """The plain version of ``decode_tga``: its packets expanded in Python."""
    return _decode(bytes(data), header, _rle_reference)


def _decode(data: bytes, header: Header | None, rle) -> np.ndarray:
    header = header or open_as(open_tga, data)
    info, (width, height) = header.info, header.size
    imagetype, depth, palette = info["imagetype"], info["depth"], info["palette"]
    rawmode = MODES.get((imagetype & 7, depth))
    if rawmode is None or (header.mode == "L" and rawmode == "P"):
        raise ValueError(f"cannot load a TGA image of type {imagetype} at {depth} bits "
                         "(Pillow cannot either)")
    table = None
    if palette is not None:
        mapdepth, raw, missing = palette
        if header.mode in ("1", "RGB", "RGBA") or mapdepth == 32:
            raise ValueError(f"a TGA colour map on a {header.mode} image, or of {mapdepth}-bit "
                             "entries (Pillow refuses both)")
        if missing:
            raise ValueError("truncated TGA file: its colour map")
        if len(raw) > 256 * (mapdepth // 8):
            raise ValueError("a TGA colour map past 256 entries (Pillow: invalid palette size)")
        table = _colors(mapdepth, raw)
    if depth == 1:
        row_bytes, pixel = (width + 7) // 8, 0
    else:
        pixel = depth // 8
        row_bytes = width * pixel
    body = data[info["pixels_at"]:]
    if imagetype & 8:
        if depth == 1:
            raise ValueError("a run-length 1-bit TGA image (Pillow reads none)")
        # A packet of 1 + pixel bytes or more writes at most 128 pixels.
        if len(body) // (1 + pixel) * 128 * pixel < row_bytes * height:
            raise ValueError(_RLE_ERRORS[native.ERR_TRUNCATED])
        rows = rle(body, pixel, row_bytes, height).reshape(height, row_bytes)
    else:
        if len(body) < row_bytes * height:
            raise ValueError("truncated TGA file")
        rows = np.frombuffer(body, np.uint8, row_bytes * height).reshape(height, row_bytes)
    if not info["top_down"]:
        rows = rows[::-1]
    if depth == 1:
        grey = np.unpackbits(rows, axis=1)[:, :width] * np.uint8(255)
        planes = np.repeat(grey[..., None], 3, axis=-1)
    else:
        px = rows.reshape(height, width, pixel)
        if rawmode == "BGRA;15Z":
            planes = _rgb15(px[..., 0].astype(np.uint16) | px[..., 1].astype(np.uint16) << 8)
        elif rawmode in ("BGR", "BGRA"):
            planes = px[..., 2::-1]
        elif table is not None:  # P, and grey read through its map
            planes = table[px[..., 0]]
        else:
            planes = np.repeat(px[..., :1], 3, axis=-1)
    if info["mirrored"]:
        planes = planes[:, ::-1]
    return np.ascontiguousarray(planes)
