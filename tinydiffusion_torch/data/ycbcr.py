"""YCbCr to RGB, as Pillow and as libtiff compute it.

JAX's LAION loader reads every web image with Pillow, which converts YCbCr
samples to RGB in two ways, and a decode equals Pillow only with the right
one:

- ``pillow_ycbcr_to_rgb``: Pillow's own ``ImagingConvertYCbCr2RGB``
  (``libImaging/ConvertYCbCr.c``), which its JPEG 2000 unpackers call for a
  JP2 whose colour space is sYCC (``Jpeg2KDecode.c``'s ``j2ku_sycc_rgb``):
  four 256-entry tables of JFIF's factors at 6 fractional bits, each entry
  ``(int)(factor * 64 * (i - 128) + 0.5)`` (C's truncation toward zero),
  then ``y + (table >> 6)`` clamped to 0..255;
- ``LibtiffYCbCr``: libtiff's ``TIFFYCbCrToRGBInit`` and ``TIFFYCbCrtoRGB``
  (``tif_color.c``), which its RGBA interface (``TIFFRGBAImageGet``, Pillow's
  reader of a YCbCr TIFF that is not JPEG) calls: the ``YCbCrCoefficients``
  and ``ReferenceBlackWhite`` fields turned into tables at 16 fractional
  bits, in float32 where libtiff computes in float, with its clamps.
"""

from __future__ import annotations

import numpy as np

# JFIF's inverse factors at Pillow's 5 decimals, as 1e-5 units, and
# ConvertYCbCr.c's SCALE: R = Y + 1.40200 (Cr - 128), G = Y - 0.34414
# (Cb - 128) - 0.71414 (Cr - 128), B = Y + 1.77200 (Cb - 128).
_R_CR, _G_CB, _G_CR, _B_CB = 140200, -34414, -71414, 177200
_SCALE = 6


def _pillow_table(factor: int) -> np.ndarray:
    """``(int)(factor * 2**SCALE * (i - 128) + 0.5)`` for i in 0..255, in
    integers: the sum over 1e5 truncated toward zero."""
    num = factor * (1 << _SCALE) * (np.arange(256, dtype=np.int64) - 128) + 50000
    return np.where(num < 0, -(-num // 100000), num // 100000).astype(np.int32)


_PILLOW = {name: _pillow_table(f) for name, f in
           (("r_cr", _R_CR), ("g_cb", _G_CB), ("g_cr", _G_CR), ("b_cb", _B_CB))}


def pillow_ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Pillow's ``ImagingConvertYCbCr2RGB`` of uint8 planes: (..., 3) uint8."""
    y, cb, cr = (np.asarray(v, np.uint8) for v in (y, cb, cr))
    yy = y.astype(np.int32)
    t = _PILLOW
    rgb = (yy + (t["r_cr"][cr] >> _SCALE), yy + ((t["g_cb"][cb] + t["g_cr"][cr]) >> _SCALE),
           yy + (t["b_cb"][cb] >> _SCALE))
    return np.clip(np.stack(rgb, axis=-1), 0, 255).astype(np.uint8)


# libtiff's defaults: TIFFGetFieldDefaulted's YCbCrCoefficients (float) and,
# for a YCbCr image without the field, TIFFDefaultRefBlackWhite.
LIBTIFF_LUMA = (0.299, 0.587, 0.114)
LIBTIFF_REFERENCE = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)
_SHIFT = 16
_ONE_HALF = 1 << (_SHIFT - 1)
_F32 = np.float32


def _f32_clamp(f, lo: float, hi: float):
    """libtiff's CLAMP: ``!(f >= lo) ? lo : f > hi ? hi : f`` (NaN to lo)."""
    return _F32(lo) if not f >= lo else _F32(hi) if f > hi else f


def _fix(x) -> int:
    """``(int32_t)(x * (1L << SHIFT) + 0.5)``: the float product, then
    the double sum, truncated toward zero."""
    return int(float(_F32(x) * _F32(1 << _SHIFT)) + 0.5)


def _code_to_value(c: np.ndarray, rb, rw, cr: int) -> np.ndarray:
    """libtiff's Code2V in float32: ``(c - (int32_t)rb) * (float)cr /
    (float)(rw - rb, or 1 where that is 0)``."""
    span = _F32(rw) - _F32(rb)
    span = span if span != 0 else _F32(1)
    return ((c - int(_F32(rb))).astype(_F32) * _F32(cr)) / span


def _to_int_clamped(v: np.ndarray) -> np.ndarray:
    """``(int32_t)CLAMP(v, -128.0F * 32, 128.0F * 32)``: NaN to the low end,
    truncated toward zero."""
    v = np.where(v >= _F32(-4096), v, _F32(-4096))
    return np.trunc(np.minimum(v, _F32(4096))).astype(np.int64)


class LibtiffYCbCr:
    """``TIFFYCbCrToRGBInit``'s tables for the ``luma`` coefficients and
    ``reference`` black and white (six values); ``__call__`` is
    ``TIFFYCbCrtoRGB`` on uint8 planes. ``ValueError`` where
    ``initYCbCrConversion`` refuses the fields."""

    def __init__(self, luma=LIBTIFF_LUMA, reference=LIBTIFF_REFERENCE):
        lr, lg, lb = (_F32(v) for v in luma)
        ref = [_F32(v) for v in reference]
        if len(ref) != 6:
            raise ValueError(f"a ReferenceBlackWhite field of {len(ref)} values")
        if np.isnan([lr, lg, lb]).any() or abs(lg) < np.finfo(np.float32).tiny:
            raise ValueError("invalid values for the YCbCrCoefficients field")
        low, high = _F32(-0x7FFFFFFF + 128), _F32(0x7FFFFFFF)
        if not all(low < v < high for v in ref):
            raise ValueError("invalid values for the ReferenceBlackWhite field")
        two = _F32(2)
        f1 = two - two * lr
        f2 = lr * f1 / lg
        f3 = two - two * lb
        f4 = lb * f3 / lg
        d1, d2 = _fix(_f32_clamp(f1, 0, 2)), -_fix(_f32_clamp(f2, 0, 2))
        d3, d4 = _fix(_f32_clamp(f3, 0, 2)), -_fix(_f32_clamp(f4, 0, 2))
        x = np.arange(-128, 128, dtype=np.int64)
        half = _F32(128)
        cr = _to_int_clamped(_code_to_value(x, ref[4] - half, ref[5] - half, 127))
        cb = _to_int_clamped(_code_to_value(x, ref[2] - half, ref[3] - half, 127))
        # int32 as libtiff's: every product and the G sum fit (|D| <= 2**17,
        # |Cb|, |Cr| <= 4096).
        luma_codes = _to_int_clamped(_code_to_value(x + 128, ref[0], ref[1], 255))
        tables = ((d1 * cr + _ONE_HALF) >> _SHIFT, (d3 * cb + _ONE_HALF) >> _SHIFT, d2 * cr,
                  d4 * cb + _ONE_HALF, luma_codes)
        self.cr_r, self.cb_b, self.cr_g, self.cb_g, self.y = (t.astype(np.int32) for t in tables)

    def __call__(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
        """(..., 3) uint8 RGB of uint8 Y, Cb and Cr planes."""
        yv = self.y[np.asarray(y, np.uint8)]
        cb, cr = np.asarray(cb, np.uint8), np.asarray(cr, np.uint8)
        rgb = (yv + self.cr_r[cr], yv + ((self.cb_g[cb] + self.cr_g[cr]) >> _SHIFT),
               yv + self.cb_b[cb])
        return np.clip(np.stack(rgb, axis=-1), 0, 255).astype(np.uint8)
