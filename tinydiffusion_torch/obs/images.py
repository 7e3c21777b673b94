"""Image-grid artifacts and PNG input, without PIL.

Counterpart of ``tinydiffusion_tpu/obs/images.py`` (``make_grid``,
``save_image_grid`` with its per-tile labels) and of the serving CLI's
``load_image28`` (``generate.py``). The port's machines may have no PIL, so
this module encodes and decodes PNG itself with ``zlib`` and ``struct``,
draws labels from a bitmap font kept as data (``obs/font.py``), and
converts and resizes images with Pillow's own integer arithmetic:

- labels: the JAX grid draws each tile's label at ``(left + 1, top + 1)``
  in ``(255, 64, 64)`` with PIL's default font (FreeType's Aileron at size
  10 in Pillow >= 10.1). ``obs/font.py`` holds that font's anti-aliased
  coverage of every glyph it holds and of its missing-glyph box, and
  ``draw_label`` composes a string and blends it as Pillow does, so a
  labelled grid's pixels equal the JAX grid's byte for byte (digits and any
  prompt alike: a character the font lacks is drawn as Pillow's box);
- ``to_grey``: Pillow's ``convert("L")``, ``(R 19595 + G 38470 + B 7471 +
  2^15) >> 16`` (its fixed-point ITU-R 601-2 luma), alpha dropped;
  ``to_rgb``: its ``convert("RGB")``, grey repeated, alpha dropped;
- ``resize_u8``: Pillow's ``resize`` with its default filter (bicubic,
  a = -0.5) or bilinear (the LAION loader's), the support widened by the
  scale when shrinking, in its 22-bit fixed point,
  the horizontal pass first and rounded to uint8 before the vertical one,
  each channel of an RGB image alike.
"""

from __future__ import annotations

import functools
import os
import struct
import zlib

import numpy as np

from tinydiffusion_torch.obs.font import GLYPHS, MISSING_GLYPH

_LABEL_FILL = np.array([255, 64, 64], np.int64)


def _div255(v: np.ndarray) -> np.ndarray:
    """``v / 255`` rounded as Pillow's ``DIV255`` macro."""
    v = v + 128
    return ((v >> 8) + v) >> 8


@functools.lru_cache(maxsize=None)
def _glyph(ch: str) -> tuple[int, int, int, np.ndarray]:
    """(left, top, advance, coverage (h, w) int64) of a character: its glyph,
    or the font's missing-glyph box."""
    left, top, advance, hex_rows = GLYPHS.get(ch, MISSING_GLYPH)
    rows = hex_rows.split()
    width = len(rows[0]) // 2 if rows else 0
    cov = np.array([[int(r[i : i + 2], 16) for i in range(0, len(r), 2)] for r in rows],
                   np.int64).reshape(len(rows), width)
    return left, top, advance, cov


def _text_mask(text: str) -> tuple[np.ndarray, int, int]:
    """The coverage of ``text`` in the label font: ``(mask, dx, dy)``, the
    (h, w) int64 mask's top left at ``(dx, dy)`` from the text origin. The
    pen advances by whole pixels; where two glyphs overlap, coverage
    combines as ``a + b - a b / 255``, as FreeType's glyphs do in Pillow's
    ``font_render``."""
    glyphs, pen = [], 0
    for ch in text:
        left, top, advance, cov = _glyph(ch)
        if cov.size:
            glyphs.append((pen + left, top, cov))
        pen += advance
    if not glyphs:
        return np.zeros((0, 0), np.int64), 0, 0
    x0 = min(x for x, _, _ in glyphs)
    y0 = min(y for _, y, _ in glyphs)
    x1 = max(x + c.shape[1] for x, _, c in glyphs)
    y1 = max(y + c.shape[0] for _, y, c in glyphs)
    mask = np.zeros((y1 - y0, x1 - x0), np.int64)
    for x, y, cov in glyphs:
        sub = mask[y - y0 : y - y0 + cov.shape[0], x - x0 : x - x0 + cov.shape[1]]
        sub[...] = sub + cov - _div255(sub * cov)
    return mask, x0, y0


# Pillow's line spacing for multiline text in the label font: the bottom of
# "A" (its top at 2, 8 rows) plus its default spacing of 4.
_LINE_SPACING = 14


def draw_label(pixels: np.ndarray, x: int, y: int, text: str) -> None:
    """Draw ``text`` in (255, 64, 64) into RGB uint8 ``pixels`` (H, W, 3) in
    place, at text origin (x, y), clipped to the image: each pixel becomes
    ``(bg (255 - m) + fill m) / 255`` rounded as Pillow's ``DIV255``, for
    the text's coverage m (``_text_mask``). A newline starts a line
    ``_LINE_SPACING`` lower, left-aligned, as Pillow's multiline text."""
    lines = text.split("\n")
    if len(lines) > 1:
        for i, line in enumerate(lines):
            draw_label(pixels, x, y + i * _LINE_SPACING, line)
        return
    m, dx, dy = _text_mask(text)
    h, w = pixels.shape[:2]
    top, left = y + dy, x + dx
    r0, c0 = max(top, 0), max(left, 0)
    r1, c1 = min(top + m.shape[0], h), min(left + m.shape[1], w)
    if r0 >= r1 or c0 >= c1:
        return
    m = m[r0 - top : r1 - top, c0 - left : c1 - left, None]
    bg = pixels[r0:r1, c0:c1].astype(np.int64)
    pixels[r0:r1, c0:c1] = _div255(bg * (255 - m) + _LABEL_FILL * m).astype(np.uint8)


def make_grid(
    images: np.ndarray,
    nrow: int = 4,
    padding: int = 2,
    normalize: bool = True,
    pad_value: float = 0.0,
) -> np.ndarray:
    """Tile NHWC images into one HWC grid (torchvision make_grid semantics:
    row-major placement, ``padding`` px between tiles, optional min/max
    normalization over the whole batch)."""
    images = np.asarray(images, dtype=np.float32)
    if images.ndim == 3:
        images = images[..., None]
    n, h, w, c = images.shape
    if normalize:
        lo, hi = images.min(), images.max()
        images = (images - lo) / max(hi - lo, 1e-8)
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.full(
        (padding + nrows * (h + padding), padding + ncol * (w + padding), c),
        pad_value,
        dtype=np.float32,
    )
    for i in range(n):
        r, col = divmod(i, ncol)
        top = padding + r * (h + padding)
        left = padding + col * (w + padding)
        grid[top : top + h, left : left + w] = images[i]
    return grid


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type (grey, grey+a, RGB, RGBA)


def encode_png(pixels: np.ndarray) -> bytes:
    """8-bit (H, W, C) uint8 pixels -> PNG bytes: grey, grey + alpha, RGB
    or RGBA for C = 1, 2, 3, 4."""
    h, w, c = pixels.shape
    # Each scanline is prefixed with filter type 0 (none).
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(pixels, np.uint8).reshape(h, w * c)],
        axis=1,
    )
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    """Undo PNG's per-scanline filters 0-4 (bytes per pixel = c)."""
    stride = w * c
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {data.size} bytes, not {h * (stride + 1)}")
    data = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = int(data[y, 0]), data[y, 1:].astype(np.int64)
        if kind == 0:
            row = line
        elif kind == 1:  # sub: cumulative over the pixels of each channel
            row = np.cumsum(line.reshape(w, c), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # up
            row = (line + prior) & 0xFF
        elif kind in (3, 4):  # average, Paeth: each pixel needs the one before
            row = np.zeros(stride, np.int64)
            left = np.zeros(c, np.int64)
            up_left = np.zeros(c, np.int64)
            for x in range(w):
                s = slice(x * c, (x + 1) * c)
                up = prior[s]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - up_left
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
                    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
                row[s] = (line[s] + pred) & 0xFF
                left, up_left = row[s], up
        else:
            raise ValueError(f"PNG filter type {kind} is not one of 0-4")
        out[y] = row
        prior = row
    return out.reshape(h, w, c)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8: 8-bit, not interlaced, grey (C = 1),
    grey + alpha (2), RGB (3) or RGBA (4); raises on anything else."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {color}, interlace "
                         f"{interlace}: only 8-bit grey, grey+alpha, RGB or RGBA, not "
                         "interlaced, is read")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, channels)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, pixels: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(pixels))


def to_grey(pixels: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W) uint8, as Pillow's ``convert("L")``."""
    if pixels.shape[-1] <= 2:
        return np.ascontiguousarray(pixels[..., 0])
    r, g, b = (pixels[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def to_rgb(pixels: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W, 3) uint8, as Pillow's ``convert("RGB")``: a
    grey channel repeated three times, alpha dropped."""
    if pixels.shape[-1] <= 2:
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


# Pillow's filters by name: the function and its support at scale 1.
_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


def _resample_weights(in_size: int, out_size: int, resample: str = "bicubic") -> np.ndarray:
    """(out_size, in_size) int64 fixed-point weights of Pillow's
    ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the ``resample``
    filter (its support widens by the scale when downscaling)."""
    kernel, base_support = _FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    weights = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        k = kernel((np.arange(xmin, xmax) - center + 0.5) * (1.0 / filterscale))
        total = 0.0
        for v in k.tolist():  # in order, as Pillow sums them
            total += v
        if total != 0.0:
            k = k / total
        weights[xx, xmin:xmax] = np.where(k < 0, (-0.5 + k * (1 << _PRECISION_BITS)),
                                          (0.5 + k * (1 << _PRECISION_BITS))).astype(np.int64)
    return weights


def _resample_pass(img: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """One pass along the last axis: ``clip8(2^21 + sum(pixel * weight))``."""
    acc = (1 << (_PRECISION_BITS - 1)) + img.astype(np.int64) @ weights.T
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_u8(pixels: np.ndarray, width: int, height: int,
              resample: str = "bicubic") -> np.ndarray:
    """(H, W) or (H, W, C) uint8 -> (height, width) or (height, width, C),
    as Pillow's ``Image.resize((width, height), resample)`` of an "L" or
    "RGB" image (``"bicubic"``, its default, or ``"bilinear"``): every
    channel by the same two passes, horizontal first."""
    planes = np.moveaxis(pixels if pixels.ndim == 3 else pixels[..., None], -1, 0)
    h, w = planes.shape[1:]
    if w != width:
        planes = _resample_pass(planes, _resample_weights(w, width, resample))
    if h != height:
        planes = np.swapaxes(_resample_pass(np.swapaxes(planes, 1, 2),
                                            _resample_weights(h, height, resample)), 1, 2)
    out = np.ascontiguousarray(np.moveaxis(planes, 0, -1))
    return out if pixels.ndim == 3 else out[..., 0]


def load_image28(path: str) -> np.ndarray:
    """A PNG as the serving CLI takes it: grey, resized to 28x28 and mapped
    to [-1, 1]; float32 (28, 28, 1)."""
    grey = resize_u8(to_grey(read_png(path)), 28, 28)
    return (grey.astype(np.float32) / 255.0 * 2 - 1).reshape(28, 28, 1)


def save_image_grid(
    images: np.ndarray,
    path: str,
    nrow: int = 4,
    normalize: bool = True,
    labels=None,
) -> None:
    """Write NHWC images as one PNG sample sheet. ``labels`` (optional, one
    a tile: an integer or a string of printable ASCII) are drawn at the top
    left of each tile in red, on an RGB sheet, as the JAX package's grid
    draws them."""
    grid = make_grid(images, nrow=nrow, normalize=normalize)
    pixels = (np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)
    if labels is not None:
        if pixels.shape[-1] == 1:
            pixels = np.repeat(pixels, 3, axis=-1)
        h, w = np.asarray(images).shape[1:3]
        padding = 2
        for i, label in enumerate(labels):
            r, col = divmod(i, nrow)
            draw_label(pixels, padding + col * (w + padding) + 1,
                       padding + r * (h + padding) + 1, str(label))
    write_png(path, pixels)
