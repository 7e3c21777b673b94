"""Netpbm decode (PBM, PGM, PPM and PFM), as ``Image.open(f).convert("RGB")`` gives it.

JAX's LAION loader reads every web image with Pillow; the port reads the
Netpbm formats here, as Pillow 12.1's ``PpmImagePlugin`` does (its decoders
are Python, and numpy is enough here). ``open_ppm`` is the plugin's
``_open``: a magic number of up to 6 bytes (``P1``-``P6``, ``Pf`` and
Pillow's own ``P0CMYK``, ``PyP``, ``PyRGBA`` and ``PyCMYK``; ``PF``, ``P7``
and the rest are not Pillow's, and ``Image.open`` tries the next plugin),
then whitespace-separated tokens of at most 10 bytes with ``#`` comments to
the end of their line: the width and height, then a maxval (0 < maxval <
65536; over 255 a grey image opens as 32-bit ``I``) or, for ``Pf``, a scale
(finite and not 0; below 0 the floats are little-endian). ``decode_ppm``
reads the pixels as Pillow's decoders do:

- raw samples (``P4``-``P6``, the extensions) of maxval 255, and 16-bit grey
  of maxval 65535, as they are; other maxvals through ``PpmDecoder``: one
  byte a sample below 256, else two (big-endian), each
  ``min(out_max, round(v / maxval * out_max))`` with Python's rounding
  (``out_max`` 65535 for ``I``, else 255);
- plain samples (``P1``-``P3``) through ``PpmPlainDecoder``: PBM's digits
  with or without whitespace between them, the others' decimal tokens
  (``round(v / maxval * out_max)``; one over maxval, or not a number, is
  refused), comments cut out of the data too;
- ``Pf``'s 32-bit floats, bottom row first.

Then ``convert("RGB")`` from the mode: 1-bit and grey as grey, ``I``
clipped to 255, ``F`` to 0 where it is not over 0 (NaN too), to 255 from
255 on and truncated between, CMYK by Pillow's ``cmyk2rgb``, RGBA without
its alpha and ``PyP`` (a palette image with no palette) as black. A file
shorter than its pixels is refused, as Pillow refuses it.
"""

from __future__ import annotations

import math

import numpy as np

from tinydiffusion_torch.data.header import Header, NotThisFormat, open_as

# Magic number -> Pillow's mode.
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
         b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
WHITESPACE = b" \t\n\x0b\x0c\r"
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
# Pillow's ImageFile.SAFEBLOCK: the plain decoder reads the data in blocks of it.
_BLOCK = 1024 * 1024


def accept(prefix: bytes) -> bool:
    """``PpmImagePlugin._accept``."""
    return len(prefix) >= 2 and prefix.startswith(b"P") and prefix[1] in b"0123456fy"


class _Reader:
    """The file read a byte at a time, as the plugin reads its header."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int = 1) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def token(self) -> bytes:
        """``PpmImageFile._read_token``."""
        token = b""
        while len(token) <= 10:
            c = self.read()
            if not c:
                break
            if c in WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while self.read() not in b"\r\n":  # b"" (the end) is in it too
                    pass
                continue
            token += c
        if not token:
            raise ValueError("corrupt PPM file: it ends in its header")
        if len(token) > 10:
            raise ValueError(f"corrupt PPM file: a header token too long ({token!r})")
        return token


def open_ppm(data: bytes) -> Header:
    """``PpmImageFile._open``: mode, size, and the decoder Pillow picks.
    Raises ``NotThisFormat`` where Pillow's does not know the magic number,
    ``ValueError`` where it refuses the header."""
    f = _Reader(bytes(data))
    magic = b""
    for _ in range(6):
        c = f.read()
        if not c or c in WHITESPACE:
            break
        magic += c
    if magic not in MODES:
        raise NotThisFormat("not a PPM file")
    mode = MODES[magic]
    size = int(f.token()), int(f.token())
    plain = magic in (b"P1", b"P2", b"P3")
    info = {"plain": plain, "maxval": None, "scale": None}
    if mode == "F":
        scale = float(f.token())
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("corrupt PFM file: a scale of 0 or not finite")
        info["scale"] = scale
    elif mode != "1":
        maxval = int(f.token())
        if not 0 < maxval < 65536:
            raise ValueError(f"corrupt PPM file: a maxval of {maxval}")
        if maxval > 255 and mode == "L":
            mode = "I"
        info["maxval"] = maxval
    info["pixels_at"] = f.pos
    return Header(mode, size, info)


def _plain_blocks(data: bytes):
    """The plain decoders' blocks, comments cut out
    (``PpmPlainDecoder._ignore_comments``; a comment may span blocks)."""
    spans = False
    for start in range(0, len(data), _BLOCK):
        block = data[start:start + _BLOCK]
        if spans:
            end = _comment_end(block)
            if end == -1:
                continue
            block, spans = block[end + 1:], False
        while (at := block.find(b"#")) != -1:
            end = _comment_end(block, at)
            if end == -1:
                block, spans = block[:at], True
                break
            block = block[:at] + block[end + 1:]
        yield block


def _comment_end(block: bytes, start: int = 0) -> int:
    """The first CR or LF from ``start`` on, or -1."""
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


def _plain_bits(data: bytes, total: int) -> np.ndarray:
    """``PpmPlainDecoder._decode_bitonal``: the digits as 255 (0) and 0 (1)."""
    out = b""
    for block in _plain_blocks(data):  # an all-comment block ends nothing
        if len(out) == total:
            break
        digits = b"".join(block.split())
        if digits.strip(b"01"):
            raise ValueError("corrupt PBM data: a token other than 0 and 1")
        out = (out + digits)[:total]
    if len(out) < total:
        raise ValueError("truncated PBM file (Pillow: not enough image data)")
    return np.where(np.frombuffer(out, np.uint8) == ord("0"), 255, 0).astype(np.uint8)


def _plain_values(data: bytes, total: int, maxval: int, out_max: int) -> np.ndarray:
    """``PpmPlainDecoder._decode_blocks``: ``total`` decimal samples, each
    scaled to ``out_max``."""
    values, half = [], b""
    blocks = _plain_blocks(data)
    while len(values) < total:
        block = next(blocks, None)  # None at the end; b"" for an all-comment block
        if block is None:
            if not half:
                break
            block = b" "
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError(f"corrupt PPM data: a token too long ({half[:11]!r})")
        for token in tokens:
            if len(token) > 10:
                raise ValueError(f"corrupt PPM data: a token too long ({token[:11]!r})")
            value = int(token)
            if not 0 <= value <= maxval:
                raise ValueError(f"corrupt PPM data: a sample of {value} (maxval {maxval})")
            values.append(round(value / maxval * out_max))
            if len(values) == total:
                break
    if len(values) < total:
        raise ValueError("truncated PPM file (Pillow: not enough image data)")
    return np.asarray(values, np.int64)


def decode_ppm(data: bytes, header: Header | None = None) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a Netpbm file, as Pillow 12.1's
    ``Image.open(f).convert("RGB")`` gives it (``header``: ``open_ppm``'s,
    else read here)."""
    data = bytes(data)
    header = header or open_as(open_ppm, data)
    mode, (width, height), info = header.mode, header.size, header.info
    body = data[info["pixels_at"]:]
    bands = _BANDS[mode]
    total = width * height * bands
    maxval = info["maxval"]
    if mode == "1":
        if info["plain"]:
            samples = _plain_bits(body, width * height)
        else:
            stride = (width + 7) // 8
            if len(body) < stride * height:
                raise ValueError("truncated PBM file")
            rows = np.frombuffer(body, np.uint8, stride * height).reshape(height, stride)
            samples = (1 - np.unpackbits(rows, axis=1)[:, :width]) * np.uint8(255)
    elif mode == "F":
        if len(body) < 4 * total:
            raise ValueError("truncated PFM file")
        order = "<f4" if info["scale"] < 0 else ">f4"
        floats = np.frombuffer(body, order, total).reshape(height, width)[::-1]
        samples = np.where(floats >= 255, 255, np.where(floats > 0, np.trunc(floats), 0))
    else:
        out_max = 65535 if mode == "I" else 255
        if info["plain"]:
            samples = _plain_values(body, total, maxval, out_max)
        else:
            wide = maxval > 255
            if len(body) < (2 if wide else 1) * total:
                raise ValueError("truncated PPM file")
            raw = np.frombuffer(body, ">u2" if wide else np.uint8, total).astype(np.int64)
            if maxval == 255 or (maxval == 65535 and mode == "I"):
                samples = raw
            else:  # PpmDecoder: Python's round, half to even, as np.rint
                samples = np.minimum(out_max, np.rint(raw / maxval * out_max)).astype(np.int64)
        if mode == "I":
            samples = np.minimum(samples, 255)
    samples = np.asarray(samples).astype(np.uint8).reshape(height, width, bands)
    if bands == 1:
        if mode == "P":
            return np.zeros((height, width, 3), np.uint8)
        return np.repeat(samples, 3, axis=-1)
    if mode == "CMYK":  # Pillow's cmyk2rgb: nk - c * nk / 255, nk = 255 - k, rounded
        cmyk = samples.astype(np.int64)
        nk = 255 - cmyk[..., 3:]
        t = cmyk[..., :3] * nk + 128
        return (nk - (((t >> 8) + t) >> 8)).astype(np.uint8)
    return np.ascontiguousarray(samples[..., :3])
