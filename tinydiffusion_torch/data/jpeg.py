"""A baseline JPEG encode and decode in numpy, as Pillow's libjpeg-turbo does them.

JAX's LAION loader caches each image as ``image.save(path, "JPEG",
quality=95)`` and reads the cache back with Pillow (``tinydiffusion_tpu/
data/laion.py:224-241``), so its text-conditional ``run``, which reads every
record twice, trains on the JPEG decode. The port has no Pillow;
``jpeg_round_trip`` computes those decoded pixels with numpy integer
arithmetic, the steps of libjpeg-turbo (the library in Pillow's wheels) at
Pillow's defaults:

- encode: the integer RGB to YCbCr tables (``jccolor.c``), 4:2:0 chroma by
  ``h2v2_downsample``'s 2x2 mean with the alternating 1, 2 bias
  (``jcsample.c``), the edge replicated to whole 16x16 MCUs, the ``islow``
  forward DCT (``jfdctint.c``) of the samples less 128, and quantisation by
  the quality-scaled standard tables (``jcparam.c``, quality 95, baseline)
  with libjpeg-turbo's reciprocal multiply (``jcdctmgr.c``);
- decode: dequantisation, the ``islow`` inverse DCT with its range limit
  (``jidctint.c``), the h2v2 "fancy" triangle upsampling of the chroma with
  replicated edges (``jdsample.c``; replication where the chroma is 2
  columns wide or less) and the integer YCbCr to RGB tables
  (``jdcolor.c``).

Entropy coding is lossless, so it is left out: the quantised coefficients
go straight to the decoder.
"""

from __future__ import annotations

import numpy as np

# jcparam.c's standard tables (ITU T.81 Annex K), natural (row-major) order.
_STD_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64).reshape(8, 8)
_STD_CHROMINANCE = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], np.int64).reshape(8, 8)

# jfdctint.c / jidctint.c: 13-bit fixed-point constants, 2 extra bits in pass 1.
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def quant_tables(quality: int = 95) -> tuple[np.ndarray, np.ndarray]:
    """``jpeg_set_quality(quality, force_baseline=TRUE)``: the luminance and
    chrominance tables, (8, 8) int64 each."""
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_STD_LUMINANCE, _STD_CHROMINANCE))


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """jccolor.c's ``rgb_ycc_convert``: (..., 3) uint8 -> (..., 3) int64 Y, Cb, Cr."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b + half) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b
          + offset + half - 1) >> 16
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b
          + offset + half - 1) >> 16
    return np.stack([y, cb, cr], axis=-1)


def _downsample_h2v2(plane: np.ndarray) -> np.ndarray:
    """jcsample.c's ``h2v2_downsample``: each 2x2 sum plus a bias of 1, 2,
    1, 2, ... along the row, over 4. ``plane`` (..., H, W), H and W even."""
    s = (plane[..., 0::2, 0::2] + plane[..., 0::2, 1::2] + plane[..., 1::2, 0::2]
         + plane[..., 1::2, 1::2])
    bias = np.where(np.arange(s.shape[-1]) % 2 == 0, 1, 2)
    return (s + bias) >> 2


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(..., H, W) -> (..., H/8, W/8, 8, 8)."""
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // 8, 8, w // 8, 8).swapaxes(-3, -2)


def _unblocks(blocks: np.ndarray) -> np.ndarray:
    *lead, bh, bw, _, _ = blocks.shape
    return blocks.swapaxes(-3, -2).reshape(*lead, bh * 8, bw * 8)


def _fdct_1d(d: list, out_shift: int, dc_shift: int) -> list:
    """One pass of jfdctint.c's ``jpeg_fdct_islow`` on eight arrays: the
    outputs descaled by ``out_shift`` (the rotations) and the DC/4 terms by
    ``dc_shift`` (a left shift when negative)."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if dc_shift < 0:
        out[0], out[4] = (tmp10 + tmp11) << -dc_shift, (tmp10 - tmp11) << -dc_shift
    else:
        out[0], out[4] = _descale(tmp10 + tmp11, dc_shift), _descale(tmp10 - tmp11, dc_shift)
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = _descale(z1 + tmp13 * _F0765, out_shift)
    out[6] = _descale(z1 - tmp12 * _F1847, out_shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, out_shift)
    out[5] = _descale(tmp5 + z2 + z4, out_shift)
    out[3] = _descale(tmp6 + z2 + z3, out_shift)
    out[1] = _descale(tmp7 + z1 + z4, out_shift)
    return out


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(..., 8, 8) level-shifted samples -> coefficients scaled up by 8."""
    rows = np.stack(_fdct_1d([blocks[..., k] for k in range(8)],
                             _CONST_BITS - _PASS1_BITS, -_PASS1_BITS), axis=-1)
    return np.stack(_fdct_1d([rows[..., k, :] for k in range(8)],
                             _CONST_BITS + _PASS1_BITS, _PASS1_BITS), axis=-2)


def _quantize(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """jcdctmgr.c: the division by ``q << 3``, rounded half away from zero,
    as libjpeg-turbo computes it: ``(|x| + c) * fq >> r`` with the
    reciprocal, correction and shift of its ``compute_reciprocal``."""
    d = qtable << 3
    b = np.floor(np.log2(d)).astype(np.int64)
    r = 16 + b
    fq, fr = (1 << r) // d, (1 << r) % d
    c = d // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > d // 2, fq + 1, fq))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= d // 2), c + 1, c)
    q = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -q, q)


def _idct_1d(d: list, out_shift: int) -> list:
    """One pass of jidctint.c's ``jpeg_idct_islow`` on eight arrays."""
    z1 = (d[2] + d[6]) * _F0541
    tmp2 = z1 - d[6] * _F1847
    tmp3 = z1 + d[2] * _F0765
    tmp0 = (d[0] + d[4]) << _CONST_BITS
    tmp1 = (d[0] - d[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [_descale(v, out_shift) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


# jdmaster.c's post-IDCT range limit, indexed by ``value & 1023``: value +
# 128 clamped to [0, 255] for values in [-512, 511].
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384, np.int64),
                              np.arange(0, 128)]).astype(np.int64)


def _idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(..., 8, 8) quantised coefficients -> (..., 8, 8) samples 0-255."""
    deq = coef * qtable
    cols = np.stack(_idct_1d([deq[..., k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS),
                    axis=-2)
    rows = np.stack(_idct_1d([cols[..., k] for k in range(8)],
                             _CONST_BITS + _PASS1_BITS + 3), axis=-1)
    return _IDCT_LIMIT[rows & 1023]


def _upsample_h2v2_fancy(plane: np.ndarray) -> np.ndarray:
    """jdsample.c's ``h2v2_fancy_upsample``: 9/16, 3/16, 3/16, 1/16 of the
    nearest samples, the edges replicated. (..., h, w) -> (..., 2h, 2w)."""
    up = np.concatenate([plane[..., :1, :], plane[..., :-1, :]], axis=-2)
    down = np.concatenate([plane[..., 1:, :], plane[..., -1:, :]], axis=-2)
    # Output rows 2i (the row above is the further one) and 2i + 1.
    colsum = np.stack([3 * plane + up, 3 * plane + down], axis=-2)
    colsum = colsum.reshape(*plane.shape[:-2], 2 * plane.shape[-2], plane.shape[-1])
    left = np.concatenate([colsum[..., :1], colsum[..., :-1]], axis=-1)
    right = np.concatenate([colsum[..., 1:], colsum[..., -1:]], axis=-1)
    out = np.stack([(3 * colsum + left + 8) >> 4, (3 * colsum + right + 7) >> 4], axis=-1)
    return out.reshape(*colsum.shape[:-1], 2 * colsum.shape[-1])


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ``ycc_rgb_convert``, its tables computed inline."""
    half = 1 << 15
    x_cb, x_cr = cb - 128, cr - 128
    r = y + ((_fix16(1.40200) * x_cr + half) >> 16)
    g = y + ((-_fix16(0.34414) * x_cb + half - _fix16(0.71414) * x_cr) >> 16)
    b = y + ((_fix16(1.77200) * x_cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def jpeg_round_trip(images: np.ndarray, quality: int = 95) -> np.ndarray:
    """What Pillow reads back from ``Image.fromarray(img).save(path, "JPEG",
    quality=quality)``: ``images`` (..., H, W, 3) uint8 RGB -> the decoded
    uint8 RGB of the same shape."""
    images = np.asarray(images)
    if images.dtype != np.uint8 or images.shape[-1] != 3 or images.ndim < 3:
        raise ValueError(f"jpeg_round_trip takes (..., H, W, 3) uint8, not {images.dtype} "
                         f"{images.shape}")
    h, w = images.shape[-3:-1]
    # The encoder replicates the last column of the image out to whole MCUs
    # and its last row to an even count (jcsample.c, jcprepct.c), then the
    # last row of each plane, downsampled or not, to whole blocks.
    pad = [(0, 0)] * (images.ndim - 3) + [(0, h % 2), (0, -w % 16), (0, 0)]
    ycc = np.moveaxis(_rgb_to_ycc(np.pad(images, pad, mode="edge")), -1, 0)
    luma_q, chroma_q = quant_tables(quality)
    planes = [ycc[0], _downsample_h2v2(ycc[1]), _downsample_h2v2(ycc[2])]
    planes = [np.pad(p, [(0, 0)] * (p.ndim - 2) + [(0, -p.shape[-2] % 8), (0, 0)], mode="edge")
              for p in planes]
    decoded = []
    for plane, qtable in zip(planes, (luma_q, chroma_q, chroma_q)):
        coef = _quantize(_fdct_islow(_blocks(plane - 128)), qtable)
        decoded.append(_unblocks(_idct_islow(coef, qtable)))
    # The decoder upsamples the chroma of the image's own extent.
    ch, cw = -(-h // 2), -(-w // 2)
    y = decoded[0][..., :h, :w]
    # jdsample.c upsamples a plane of 2 columns or fewer by replication.
    upsample = (_upsample_h2v2_fancy if cw > 2 else
                lambda p: p.repeat(2, axis=-2).repeat(2, axis=-1))
    cb, cr = (upsample(p[..., :ch, :cw])[..., :h, :w] for p in decoded[1:])
    return _ycc_to_rgb(y, cb, cr)
