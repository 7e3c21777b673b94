"""PCX decode, as ``Image.open(f).convert("RGB")`` gives it.

JAX's LAION loader reads every web image with Pillow; the port reads
ZSoft's Paintbrush format here, as Pillow 12.1's ``PcxImagePlugin`` does.
``open_pcx`` is the plugin's ``_open``: the accept test again (byte 0 is 10,
the version 0, 2, 3 or 5), the bounding box (its size must be positive),
and the mode from the bits a pixel and the planes: 1 x 1 is ``1``; 1 x 2 and
1 x 4 are 2- and 4-bit palettes (``P;2L``, ``P;4L``: bit planes, the
header's 16-colour palette); version 5 with 8 x 1 is ``L``, or ``P`` where
the file's last 769 bytes are a 0x0C and a palette that is not the linear
grey ramp; version 5 with 8 x 3 is RGB in three planes. A header too short
for those fields, or a bad size, is ``NotThisFormat`` (the next plugin
tries the file); any other mode refuses it, as Pillow's ``OSError`` does.

``decode_pcx`` runs Pillow's ``PcxDecode.c`` from byte 128: run-length
packets (a byte of the top two bits set repeats the next byte its low six
bits times; any other byte is itself) fill each line of planes x stride
bytes, where the stride is Pillow's own (``(width x bits + 7) // 8``, made
even where the header's differs: it does not trust the header). A run
past a line's end (Pillow's overrun) or data that ends before the last
line refuses the file. Each line is then unpacked as Pillow's unpackers
read it, at their offsets: planes of ``width`` bytes for RGB and of
``(width + 7) // 8`` bytes for the bit planes of ``P;2L`` and ``P;4L``,
which Pillow moves together first where its stride is wider (by its own
count of the planes a line holds). ``decode_pcx`` runs the packets in C
(``tdt_pcx_rle``, ``data/csrc/raster.c``); ``decode_pcx_reference`` in
Python.
"""

from __future__ import annotations

import struct

import numpy as np

from tinydiffusion_torch.data import native
from tinydiffusion_torch.data.header import Header, NotThisFormat, open_as

_DATA = 128  # the 128-byte header, then the packets


def accept(prefix: bytes) -> bool:
    """``PcxImagePlugin._accept``."""
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def open_pcx(data: bytes) -> Header:
    """``PcxImageFile._open``: mode, size, and for the decode step the raw
    mode, the bytes a plane of a line, the planes and the palette (RGB
    bytes; None for ``1``, ``L`` and RGB). Raises ``NotThisFormat`` (or,
    where Pillow's reads fail, ``struct.error`` and ``IndexError``) and
    ``ValueError`` for a mode Pillow does not read."""
    s = data[:68]
    if not accept(s):
        raise NotThisFormat("not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise NotThisFormat("bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    provided = struct.unpack_from("<H", s, 66)[0]
    palette = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode, palette = "P", f"P;{planes}L", s[16:64]
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        tail = data[max(len(data) - 769, 0):][:769]
        ramp = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
        if len(tail) == 769 and tail[0] == 12 and tail[1:] != ramp:
            mode, rawmode, palette = "P", "P", tail[1:]
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise ValueError(f"unknown PCX mode ({bits} bits, {planes} planes)")
    width, height = x1 + 1 - x0, y1 + 1 - y0
    stride = (width * bits + 7) // 8
    if provided != stride:  # Pillow's own stride (CVE-2020-35653), made even
        stride += stride % 2
    return Header(mode, (width, height), (rawmode, stride, planes, palette))


def _rle_reference(packets: bytes, line: int, rows: int) -> np.ndarray:
    """``PcxDecode.c``'s packets: ``rows`` lines of ``line`` bytes."""
    out = bytearray()
    end = line * rows
    pos, x = 0, 0
    while len(out) < end:
        if pos >= len(packets):
            raise ValueError("truncated PCX file")
        b = packets[pos]
        if b & 0xC0 == 0xC0:
            if pos + 1 >= len(packets):
                raise ValueError("truncated PCX file")
            n = b & 0x3F
            if x + n > line:
                raise ValueError("corrupt PCX data: a run past the end of its line")
            out += bytes([packets[pos + 1]]) * n
            x += n
            pos += 2
        else:
            out.append(b)
            x += 1
            pos += 1
        if x >= line:
            x = 0
    return np.frombuffer(bytes(out), np.uint8).reshape(rows, line)


def _rle_native(packets: bytes, line: int, rows: int) -> np.ndarray:
    """``_rle_reference`` in C (``data/csrc/raster.c``)."""
    src = np.frombuffer(packets, np.uint8) if packets else np.zeros(1, np.uint8)
    out = np.empty((rows, line), np.uint8)
    native.check(native.library().tdt_pcx_rle(native.ptr(src), len(packets), native.ptr(out),
                                              line, rows), "PCX",
                 {native.ERR_TRUNCATED: "truncated PCX file",
                  native.ERR_RANGE: "corrupt PCX data: a run past the end of its line"})
    return out


def _pixels(lines: np.ndarray, header: Header) -> np.ndarray:
    """Unpack each line as Pillow's unpackers do, then ``convert("RGB")``."""
    rawmode, stride, planes, palette = header.info
    width = header.size[0]
    line = planes * stride
    # PcxDecode.c moves the bands of a line together where its stride
    # exceeds the unpacker's: bit planes of (width + 7) // 8 bytes for the
    # 2- and 4-bit palettes, bands of width bytes for the rest.
    bits = {"1": 1, "L": 8, "P": 8, "RGB;L": 24, "P;2L": 2, "P;4L": 4}[rawmode]
    if bits in (2, 4):
        xsize, bands, step = (width + 7) // 8, bits, line // bits
    else:
        xsize, bands = width, line // width
        step = line // bands if bands else 0
    if step > xsize:
        lines = lines.copy()
        for i in range(1, bands):
            lines[:, i * xsize:(i + 1) * xsize] = lines[:, i * step:i * step + xsize]
    if rawmode == "1":
        grey = np.unpackbits(lines, axis=1)[:, :width] * np.uint8(255)
        return np.repeat(grey[..., None], 3, axis=-1)
    if rawmode in ("P;2L", "P;4L"):
        s = (width + 7) // 8
        index = np.zeros((lines.shape[0], width), np.uint8)
        for k in range(planes):
            index |= np.unpackbits(lines[:, k * s:(k + 1) * s], axis=1)[:, :width] << k
        return np.frombuffer(palette, np.uint8).reshape(-1, 3)[index]
    if rawmode == "RGB;L":
        return np.stack([lines[:, k * width:(k + 1) * width] for k in range(3)], axis=-1)
    if rawmode == "P":
        return np.frombuffer(palette, np.uint8).reshape(256, 3)[lines[:, :width]]
    return np.repeat(lines[:, :width, None], 3, axis=-1)  # L


def _decode(data: bytes, header: Header | None, rle) -> np.ndarray:
    header = header or open_as(open_pcx, data)
    rawmode, stride, planes, _ = header.info
    return np.ascontiguousarray(
        _pixels(rle(data[_DATA:], planes * stride, header.size[1]), header))


def decode_pcx(data: bytes, header: Header | None = None) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a PCX file, as ``Image.open(f).convert(
    "RGB")`` gives it; ``ValueError`` where Pillow refuses it."""
    return _decode(data, header, _rle_native)


def decode_pcx_reference(data: bytes, header: Header | None = None) -> np.ndarray:
    """The plain version of ``decode_pcx``: its packets in Python."""
    return _decode(data, header, _rle_reference)
