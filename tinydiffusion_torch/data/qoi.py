"""QOI decode, as ``Image.open(f).convert("RGB")`` gives it.

JAX's LAION loader reads every web image with Pillow; the port reads the
Quite OK Image format here, as Pillow 12.1's ``QoiImagePlugin`` does.
``open_qoi`` is the plugin's ``_open``: ``qoif``, the width and height
(big-endian 32-bit) and the channel count (3 is RGB, any other RGBA); a
header the file does not hold is ``NotThisFormat``. ``decode_qoi`` runs
Pillow's ``QoiDecoder`` from byte 14 on: its ops until every pixel is
written (RGB, RGBA, INDEX, DIFF, LUMA and RUN; see ``data/csrc/raster.c``),
the end marker never read. Alpha is dropped as ``convert("RGB")`` drops
it. An op the file does not hold refuses the file, as Pillow does.
``decode_qoi`` runs the ops in C (``tdt_qoi_decode``);
``decode_qoi_reference`` in Python.
"""

from __future__ import annotations

import struct

import numpy as np

from tinydiffusion_torch.data import native
from tinydiffusion_torch.data.header import Header, NotThisFormat, open_as

SIGNATURE = b"qoif"
_HEADER = 14


def open_qoi(data: bytes) -> Header:
    """``QoiImageFile._open``: mode and size. Raises ``NotThisFormat`` (or,
    where Pillow's reads fail, ``IndexError`` and ``struct.error``)."""
    if data[:4] != SIGNATURE:
        raise NotThisFormat("not a QOI file")
    size = struct.unpack_from(">II", data[:12], 4)
    return Header("RGB" if data[12:13][0] == 3 else "RGBA", size)


def _ops_native(ops: bytes, pixels: int) -> np.ndarray:
    """``_ops_reference`` in C (``data/csrc/raster.c``)."""
    src = np.frombuffer(ops, np.uint8) if ops else np.zeros(1, np.uint8)
    rgb = np.empty(3 * pixels, np.uint8)
    native.check(native.library().tdt_qoi_decode(native.ptr(src), len(ops), native.ptr(rgb),
                                                 pixels), "QOI",
                 {native.ERR_TRUNCATED: "truncated QOI file"})
    return rgb


def _ops_reference(ops: bytes, pixels: int) -> np.ndarray:
    """The RGB bytes of the first ``pixels`` pixels of QOI's op stream."""
    seen = {}
    px = (0, 0, 0, 255)
    out = bytearray()
    pos, n = 0, len(ops)
    while len(out) < 3 * pixels:
        if pos >= n:
            raise ValueError("truncated QOI file")
        op = ops[pos]
        pos += 1
        if op in (0xFE, 0xFF):
            k = 3 if op == 0xFE else 4
            if pos + k > n:
                raise ValueError("truncated QOI file")
            px = tuple(ops[pos:pos + k]) + px[k:]
            pos += k
        elif op >> 6 == 0:
            px = seen.get(op & 63, (0, 0, 0, 0))
        elif op >> 6 == 1:
            px = ((px[0] + ((op >> 4) & 3) - 2) % 256, (px[1] + ((op >> 2) & 3) - 2) % 256,
                  (px[2] + (op & 3) - 2) % 256, px[3])
        elif op >> 6 == 2:
            if pos >= n:
                raise ValueError("truncated QOI file")
            second, green = ops[pos], (op & 63) - 32
            pos += 1
            px = ((px[0] + green + (second >> 4) - 8) % 256, (px[1] + green) % 256,
                  (px[2] + green + (second & 15) - 8) % 256, px[3])
        else:
            out += bytes(px[:3]) * ((op & 63) + 1)
            continue
        seen[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64] = px
        out += bytes(px[:3])
    return np.frombuffer(bytes(out[:3 * pixels]), np.uint8)


def decode_qoi(data: bytes, header: Header | None = None) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a QOI file, as Pillow 12.1's
    ``Image.open(f).convert("RGB")`` gives it (``header``: ``open_qoi``'s,
    else read here)."""
    return _decode(bytes(data), header, _ops_native)


def decode_qoi_reference(data: bytes, header: Header | None = None) -> np.ndarray:
    """The plain version of ``decode_qoi``: its ops run in Python."""
    return _decode(bytes(data), header, _ops_reference)


def _decode(data: bytes, header: Header | None, ops) -> np.ndarray:
    header = header or open_as(open_qoi, data)
    width, height = header.size
    if (len(data) - _HEADER) * 62 < width * height:  # no op writes more than 62 pixels
        raise ValueError("truncated QOI file")
    return ops(data[_HEADER:], width * height).reshape(height, width, 3)
