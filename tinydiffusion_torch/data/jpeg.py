"""Baseline JPEG in numpy, as Pillow's libjpeg-turbo writes and reads it.

JAX's LAION loader caches each image as ``image.save(path, "JPEG",
quality=95)`` and reads the cache back with Pillow (``tinydiffusion_tpu/
data/laion.py:224-241``). The port has no Pillow. This module computes the
same files and the same pixels with numpy integer arithmetic, the steps of
libjpeg-turbo (the library in Pillow's wheels) at Pillow's defaults:

- encode: the integer RGB to YCbCr tables (``jccolor.c``), 4:2:0 chroma by
  ``h2v2_downsample``'s 2x2 mean with the alternating 1, 2 bias
  (``jcsample.c``), the edge replicated to whole 16x16 MCUs, the ``islow``
  forward DCT (``jfdctint.c``) of the samples less 128, and quantisation by
  the quality-scaled standard tables (``jcparam.c``, quality 95, baseline)
  with libjpeg-turbo's reciprocal multiply (``jcdctmgr.c``);
- decode: dequantisation, the ``islow`` inverse DCT with its range limit
  (``jidctint.c``), the "fancy" triangle upsampling of the chroma with
  replicated edges (``jdsample.c``; replication where the chroma is 2
  columns wide or less) and the integer YCbCr to RGB tables
  (``jdcolor.c``).

``jpeg_round_trip`` goes from the quantised coefficients straight to the
decoder (entropy coding is lossless). ``encode_jpeg`` writes the file
itself, byte for byte what ``Image.fromarray(image).save(f, "JPEG",
quality=q)`` writes: SOI, a JFIF APP0, the two DQT tables, SOF0, the four
standard Huffman tables (``jcparam.c``), one interleaved scan with
``jccoefct.c``'s dummy blocks at the right and bottom MCU edges, byte
stuffing, the last byte filled with ones, and EOI. ``decode_jpeg`` reads any
baseline, extended sequential or progressive Huffman-coded 8-bit file as
``Image.open(f).convert("RGB")`` does: grayscale, YCbCr, Adobe RGB, CMYK or
YCCK; luma sampled 1x1, 2x1, 1x2 or 2x2 against chroma 1x1, each with
libjpeg-turbo's upsampling; any DQT and DHT tables (optimised ones
included); one scan or a scan a component; restart intervals. A progressive
file (``jdphuff.c``: DC and AC first scans, their successive-approximation
refinements, EOB runs) accumulates its coefficients over the scans, which
then go through the same inverse DCT, upsampling and colour path (a complete
file leaves libjpeg-turbo's block smoothing off). Four components are
Adobe's inverted CMYK, or YCCK by the APP14 transform flag, converted to RGB
as Pillow's ``CMYK;I`` raw mode and ``cmyk2rgb`` do. Arithmetic-coded,
lossless and 12-bit files raise ``ValueError`` with the reason, as do
truncated or corrupt ones.
"""

from __future__ import annotations

import functools

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


def _ycc_to_rgb_unclamped(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> list:
    """jdcolor.c's YCbCr-to-RGB sums, its tables computed inline, before
    the range limit."""
    half = 1 << 15
    x_cb, x_cr = cb - 128, cr - 128
    return [y + ((_fix16(1.40200) * x_cr + half) >> 16),
            y + ((-_fix16(0.34414) * x_cb + half - _fix16(0.71414) * x_cr) >> 16),
            y + ((_fix16(1.77200) * x_cb + half) >> 16)]


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ``ycc_rgb_convert``."""
    return np.clip(np.stack(_ycc_to_rgb_unclamped(y, cb, cr), axis=-1), 0, 255).astype(np.uint8)


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


# --- the file format ----------------------------------------------------------

# The natural (row-major) index of each zigzag position (ITU T.81 Figure A.6).
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# jcparam.c's standard Huffman tables (ITU T.81 K.3), by (class, id): class 0
# DC, 1 AC; id 0 luminance, 1 chrominance. Each: the count of codes of each
# length 1-16, and the symbols in code order.
_STD_HUFFMAN = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
             bytes.fromhex("000102030405060708090a0b")),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             bytes.fromhex("000102030405060708090a0b")),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
}


def _huffman_codes(counts, symbols) -> tuple[np.ndarray, np.ndarray]:
    """The canonical codes of a table (``jpeg_make_c_derived_tbl``): each
    symbol's code and code length, 256 each (length 0: not in the table)."""
    code, size = np.zeros(256, np.int64), np.zeros(256, np.int64)
    c = p = 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            code[symbols[p]], size[symbols[p]] = c, length
            c += 1
            p += 1
        c <<= 1
    return code, size


def _category(v: np.ndarray) -> np.ndarray:
    """The bit count of |v| (T.81's SSSS): 0 for 0."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _encoder_scan(image: np.ndarray, quality: int) -> tuple[np.ndarray, np.ndarray]:
    """The quantised blocks of an RGB image in the order libjpeg-turbo's
    interleaved 4:2:0 scan codes them, zigzag order, (6 * MCUs, 64), and the
    component of each block (0 Y, 1 Cb, 2 Cr): per MCU the four Y blocks in
    raster order, then Cb and Cr. Y's blocks past the image's ceil(H / 8) x
    ceil(W / 8) are ``jccoefct.c``'s dummy blocks: AC zero, the DC of the
    block before it in the MCU (the row above's last, for a dummy row)."""
    h, w = image.shape[:2]
    mr, mc = -(-h // 16), -(-w // 16)
    # Columns replicated out to whole MCUs and rows to an even count before
    # the colour conversion and downsampling; each plane's last row then out
    # to whole MCUs (jcsample.c, jcprepct.c), as jpeg_round_trip pads them.
    rgb = np.pad(image, [(0, h % 2), (0, 16 * mc - w), (0, 0)], mode="edge")
    ycc = np.moveaxis(_rgb_to_ycc(rgb), -1, 0)
    planes = [ycc[0]] + [_downsample_h2v2(p) for p in ycc[1:]]
    luma_q, chroma_q = quant_tables(quality)
    scans = []
    for plane, rows, qtable in zip(planes, (16 * mr, 8 * mr, 8 * mr),
                                   (luma_q, chroma_q, chroma_q)):
        plane = np.pad(plane, [(0, rows - plane.shape[0]), (0, 0)], mode="edge")
        coef = _quantize(_fdct_islow(_blocks(plane - 128)), qtable)
        scans.append(coef.reshape(*coef.shape[:2], 64)[..., _ZIGZAG])
    y = scans[0]
    hb, wb = -(-h // 8), -(-w // 8)
    if wb % 2:  # the right column of the last MCUs: dummies after the left block
        y[:, wb] = 0
        y[:, wb, 0] = y[:, wb - 1, 0]
    if hb % 2:  # the bottom row of the last MCU row: dummies after the row above
        y[hb] = 0
        y[hb, :, 0] = np.repeat(y[hb - 1, 1::2, 0], 2)
    y = y.reshape(mr, 2, mc, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mr, mc, 4, 64)
    blocks = np.concatenate([y, scans[1][:, :, None], scans[2][:, :, None]], axis=2)
    return blocks.reshape(-1, 64), np.tile([0, 0, 0, 0, 1, 2], mr * mc)


def _huffman_encode(blocks: np.ndarray, comps: np.ndarray) -> bytes:
    """The entropy-coded segment of ``blocks`` (zigzag order, in scan order)
    with the standard tables (luminance for component 0, chrominance for the
    others): ``jchuff.c``'s DC differences and (run, size) AC symbols with
    ZRL and EOB, the bits packed MSB first, the last byte filled with ones,
    and a 0x00 stuffed after each 0xFF."""
    n = len(blocks)
    table = np.minimum(comps, 1)
    dc_code, dc_size = zip(*(_huffman_codes(*_STD_HUFFMAN[0, t]) for t in (0, 1)))
    ac_code, ac_size = zip(*(_huffman_codes(*_STD_HUFFMAN[1, t]) for t in (0, 1)))
    dc_code, dc_size, ac_code, ac_size = map(np.stack, (dc_code, dc_size, ac_code, ac_size))
    keys, values, lengths = [], [], []

    def tokens(key, tab, sym, code, size, extra, extra_size):
        keys.append(key)
        values.append((code[tab, sym] << extra_size) | extra)
        lengths.append(size[tab, sym] + extra_size)

    # DC: the difference from the previous block of the same component.
    dc = blocks[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comps):
        sel = comps == c
        diff[sel] = np.diff(dc[sel], prepend=0)
    cat = _category(diff)
    bits = np.where(diff < 0, diff + (1 << cat) - 1, diff)
    block = np.arange(n)
    tokens(block * 512, table, cat, dc_code, dc_size, bits, cat)
    # AC: each nonzero coefficient after the run of zeros before it; a ZRL
    # for each 16 zeros of a longer run; EOB after the block's last nonzero
    # unless that is coefficient 63.
    nz = blocks[:, 1:] != 0
    k = np.arange(1, 64)
    last = np.maximum.accumulate(np.where(nz, k, 0), axis=1)
    prev = np.concatenate([np.zeros((n, 1), np.int64), last[:, :-1]], axis=1)
    bi, ki = np.nonzero(nz)
    kk = ki + 1
    run = kk - prev[bi, ki] - 1
    v = blocks[bi, kk]
    cat = _category(v)
    bits = np.where(v < 0, v + (1 << cat) - 1, v)
    for j in range(3):  # runs of 16-63 zeros: up to three ZRLs
        z = run >= 16 * (j + 1)
        zero = np.zeros(z.sum(), np.int64)
        tokens(bi[z] * 512 + kk[z] * 4 + j, table[bi[z]], 0xF0 + zero, ac_code, ac_size, zero,
               zero)
    tokens(bi * 512 + kk * 4 + 3, table[bi], (run % 16) * 16 + cat, ac_code, ac_size, bits, cat)
    eob = np.nonzero(last[:, -1] < 63)[0]
    zero = np.zeros(len(eob), np.int64)
    tokens(eob * 512 + 511, table[eob], zero, ac_code, ac_size, zero, zero)
    order = np.argsort(np.concatenate(keys), kind="stable")
    values = np.concatenate(values)[order]
    lengths = np.concatenate(lengths)[order]
    # The bits, MSB first: token i's bit j is bit (length - 1 - j) of its value.
    ends = np.cumsum(lengths)
    tok = np.repeat(np.arange(len(lengths)), lengths)
    shift = (ends[tok] - 1 - np.arange(ends[-1] if len(ends) else 0)).astype(np.int64)
    stream = ((values[tok] >> shift) & 1).astype(np.uint8)
    stream = np.concatenate([stream, np.ones(-len(stream) % 8, np.uint8)])
    out = np.packbits(stream)
    return np.insert(out, np.nonzero(out == 0xFF)[0] + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """The bytes of ``Image.fromarray(image).save(f, "JPEG", quality=quality)``
    for an (H, W, 3) uint8 RGB ``image``: baseline, 4:2:0, standard Huffman
    tables, no restart markers, as Pillow 12.1 with libjpeg-turbo writes it."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[-1] != 3 or 0 in image.shape:
        raise ValueError(f"encode_jpeg takes an (H, W, 3) uint8 image, not {image.dtype} "
                         f"{image.shape}")
    h, w = image.shape[:2]
    if max(h, w) > 65500:
        raise ValueError(f"a JPEG is at most 65500 pixels a side, not {w}x{h}")
    luma_q, chroma_q = quant_tables(quality)
    header = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tq, qtable in enumerate((luma_q, chroma_q)):
        header.append(_segment(0xDB, bytes([tq]) + bytes(qtable.reshape(64)[_ZIGZAG].tolist())))
    header.append(_segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                           + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for tc, th in ((0, 0), (1, 0), (0, 1), (1, 1)):
        counts, symbols = _STD_HUFFMAN[tc, th]
        header.append(_segment(0xC4, bytes([tc << 4 | th, *counts]) + symbols))
    header.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return b"".join(header) + _huffman_encode(*_encoder_scan(image, quality)) + b"\xff\xd9"


@functools.lru_cache(maxsize=64)
def _decode_lut(tc: int, counts: tuple, symbols: bytes) -> tuple[np.ndarray, ...]:
    """A table of class ``tc`` (0 DC, 1 AC) for each 16-bit window that starts
    with one of its codes: the symbol, the code's length (0: no code starts
    the window), the bits to the next symbol (the code and the extra bits the
    symbol announces) and, for AC, the symbol's advance in its block (run + 1;
    64 for EOB, which ends the block, and for no code)."""
    code, size = _huffman_codes(counts, symbols)
    sym, length = np.zeros(1 << 16, np.int64), np.zeros(1 << 16, np.int64)
    for s in symbols:
        lo = int(code[s]) << (16 - int(size[s]))
        sym[lo:lo + (1 << (16 - int(size[s])))] = s
        length[lo:lo + (1 << (16 - int(size[s])))] = size[s]
    skip = length + (sym if tc == 0 else sym & 15)
    adv = np.where((sym == 0) | (length == 0), 64, (sym >> 4) + 1)
    return sym, length, skip, adv


def _extend(extra: np.ndarray, size: np.ndarray) -> np.ndarray:
    """T.81's EXTEND: ``size`` bits read as a signed coefficient."""
    half = np.left_shift(1, np.maximum(size - 1, 0))
    return np.where(size == 0, 0, np.where(extra < half, extra - 2 * half + 1, extra))


def _entropy_segments(data: bytes, pos: int) -> tuple[list[np.ndarray], int, bool]:
    """The entropy-coded data of the scan that starts at ``pos``: its
    segments between RST markers, unstuffed, and the position of the marker
    that ends it (``len(data)`` and False when the file ends first)."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    ff = np.nonzero(arr[:-1] == 0xFF)[0]
    nxt = arr[ff + 1]
    marks = ff[(nxt != 0) & (nxt != 0xFF)]
    is_rst = (arr[marks + 1] >= 0xD0) & (arr[marks + 1] <= 0xD7)
    stop = np.nonzero(~is_rst)[0]
    end = int(marks[stop[0]]) if len(stop) else len(arr)
    bounds = [0, *[int(m) for m in marks[is_rst] if m < end]]
    segments = []
    for i, start in enumerate(bounds):
        seg = arr[start + (2 if i else 0):bounds[i + 1] if i + 1 < len(bounds) else end]
        while len(seg) and seg[-1] == 0xFF:  # fill bytes before the marker
            seg = seg[:-1]
        ff = np.nonzero(seg[:-1] == 0xFF)[0]
        segments.append(np.delete(seg, ff[seg[ff + 1] == 0] + 1))  # stuffed zeros
    return segments, pos + end, bool(len(stop))


def _decode_segment(seg: np.ndarray, plan: list, n_mcus: int,
                    luts: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Huffman-decode ``n_mcus`` MCUs of one segment. ``plan``: (DC table,
    AC table) of each block of an MCU. Returns each block's DC difference,
    its AC coefficients as (block, zigzag index, value) rows, and each
    block's place in its MCU."""
    nbits = 8 * len(seg)
    size = nbits + 17  # every bit position, 16 bits of zeros past the end, and a sink
    padded = np.concatenate([seg, np.zeros(5, np.uint8)]).astype(np.int64)
    p = np.arange(size)
    i = p >> 3
    window = ((padded[i] << 16 | padded[i + 1] << 8 | padded[i + 2]) >> (8 - (p & 7))) & 0xFFFF
    tables = sorted({t for pair in plan for t in pair})
    # Per table and bit position: the position after the symbol there and its
    # extra bits (past the end: the sink, size - 1); for AC tables packed with
    # the symbol's advance in the block.
    nxt = np.empty((len(tables), size), np.int64)
    adv = np.empty((len(tables), size), np.int64)
    walk_of = {}
    for j, t in enumerate(tables):
        _, _, skip, step = luts[t]
        nxt[j] = np.minimum(p + skip[window], size - 1)
        nxt[j, -1] = size - 1
        if t[0] == 0:
            walk_of[t] = (memoryview(nxt[j]),)
            continue
        adv[j] = step[window]
        walk_of[t] = (memoryview(nxt[j] << 7 | adv[j]),)
    # The sequential walk: one lookup a symbol. Only where each block and its
    # AC symbols start is kept; the symbols are read below, vectorised.
    dc_pos, ac_start = [], []
    dc_add, ac_add = dc_pos.append, ac_start.append
    walk = [(*walk_of[dc], *walk_of[ac]) for dc, ac in plan]
    at = 0
    for _ in range(n_mcus):
        for dc_next, one in walk:
            dc_add(at)
            at = dc_next[at]
            ac_add(at)
            k = 1
            while k < 64:
                v = one[at]
                k += v & 127
                at = v >> 7
    if at > nbits:
        raise ValueError("corrupt or truncated JPEG data: a scan segment ends early")
    # Every block's AC symbols, walked for all blocks at once.
    kinds = np.tile(np.arange(len(plan)), n_mcus)
    ac_t = np.array([tables.index(ac) for _, ac in plan])[kinds]
    cur = np.array(ac_start, np.int64)
    kk = np.ones(len(cur), np.int64)
    found_block, found_pos = [], []
    live = np.arange(len(cur))
    while len(live):
        at_live = cur[live]
        found_block.append(live)
        found_pos.append(at_live)
        kk[live] += adv[ac_t[live], at_live]
        cur[live] = nxt[ac_t[live], at_live]
        live = live[kk[live] < 64]
    order = np.argsort(np.concatenate(found_block), kind="stable")
    ac_pos = np.concatenate(found_pos)[order]
    dc_pos = np.array(dc_pos, np.int64)
    n_blocks = len(dc_pos)
    # DC: the size, then the bits of the difference.
    dc_w = window[dc_pos]
    dsize, dlen = np.empty(n_blocks, np.int64), np.empty(n_blocks, np.int64)
    for dc_table in {dc for dc, _ in plan}:
        sel = np.isin(kinds, [m for m, (dc, _) in enumerate(plan) if dc == dc_table])
        dsize[sel] = luts[dc_table][0][dc_w[sel]]
        dlen[sel] = luts[dc_table][1][dc_w[sel]]
    dc = _extend(window[dc_pos + dlen] >> (16 - dsize), dsize)
    # AC: each symbol's block, its coefficient index after the run, its value.
    block = np.searchsorted(dc_pos, ac_pos, side="right") - 1
    ac_w = window[ac_pos]
    asym, alen = np.empty(len(ac_pos), np.int64), np.empty(len(ac_pos), np.int64)
    for ac_table in {ac for _, ac in plan}:
        sel = ac_t[block] == tables.index(ac_table)
        asym[sel] = luts[ac_table][0][ac_w[sel]]
        alen[sel] = luts[ac_table][1][ac_w[sel]]
    if (dlen == 0).any() or (alen == 0).any():
        raise ValueError("corrupt JPEG data: a bit pattern that is no Huffman code")
    step = np.where(asym == 0, 0, (asym >> 4) + 1)
    csum = np.cumsum(step)
    first = np.searchsorted(block, np.arange(n_blocks))  # each block's first AC symbol
    start = np.concatenate([[0], csum])[first]  # advances before the block
    k = 1 + csum - step - start[block] + (asym >> 4)
    asize = asym & 15
    keep = asize > 0
    if (k[keep] > 63).any():
        raise ValueError("corrupt JPEG data: a coefficient past the block's 64")
    value = _extend(window[ac_pos + alen] >> (16 - asize), asize)
    return dc, np.stack([block[keep], k[keep], value[keep]], axis=1), kinds


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """jdsample.c's upsampling of a downsampled plane by (fh, fv): the fancy
    triangle filters (h2v2 and h2v1 only where the plane is over 2 columns
    wide; else replication)."""
    if (fh, fv) == (1, 1):
        return plane
    if fh == 2 and plane.shape[1] <= 2:  # h2v1_upsample / h2v2_upsample
        return plane.repeat(fv, axis=0).repeat(2, axis=1)
    if (fh, fv) == (2, 2):
        return _upsample_h2v2_fancy(plane)
    if (fh, fv) == (2, 1):  # h2v1_fancy_upsample: 3/4 and 1/4, biases 1, 2
        left = np.concatenate([plane[:, :1], plane[:, :-1]], axis=1)
        right = np.concatenate([plane[:, 1:], plane[:, -1:]], axis=1)
        out = np.stack([(3 * plane + left + 1) >> 2, (3 * plane + right + 2) >> 2], axis=-1)
        return out.reshape(plane.shape[0], 2 * plane.shape[1])
    # h1v2_fancy_upsample: 3/4 and 1/4 of the rows, biases 1, 2
    up = np.concatenate([plane[:1], plane[:-1]], axis=0)
    down = np.concatenate([plane[1:], plane[-1:]], axis=0)
    out = np.stack([(3 * plane + up + 1) >> 2, (3 * plane + down + 2) >> 2], axis=1)
    return out.reshape(2 * plane.shape[0], plane.shape[1])


_UNSUPPORTED_SOF = {0xC3: "lossless", 0xC5: "differential sequential",
                    0xC6: "differential progressive", 0xC7: "differential lossless",
                    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
                    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded",
                    0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded"}


def decode_jpeg(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a baseline, extended-sequential or
    progressive Huffman JPEG, as ``Image.open(f).convert("RGB")`` gives it (Pillow 12.1,
    libjpeg-turbo). Raises ``ValueError`` on any other kind of file, and on
    truncated or corrupt data."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qtables, luts = {}, {}
    frame, restart, adobe, jfif = None, 0, None, False
    latched = {}  # component -> its quantisation table, fixed at its first scan
    pos = 2
    while True:
        while pos + 1 < len(data) and data[pos] == 0xFF and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes
        if pos + 2 > len(data):
            if frame is not None and frame["done"]:
                break  # every block decoded; only the EOI is missing
            raise ValueError("truncated JPEG file")
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG file: no marker at byte {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            raise ValueError("truncated JPEG file")
        length = int.from_bytes(data[pos:pos + 2], "big")
        body = data[pos + 2:pos + length]
        if length < 2 or len(body) < length - 2:
            raise ValueError("truncated JPEG file")
        pos += length
        if marker == 0xDB:
            i = 0
            while i < len(body):
                wide, tq = body[i] >> 4, body[i] & 15
                n = 128 if wide else 64
                raw = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if wide else np.uint8)
                if len(raw) != 64:
                    raise ValueError("corrupt JPEG file: a short DQT table")
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = raw
                qtables[tq] = table.reshape(8, 8)
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = tuple(body[i + 1:i + 17])
                symbols = body[i + 17:i + 17 + sum(counts)]
                if len(counts) != 16 or len(symbols) != sum(counts) or tc > 1:
                    raise ValueError("corrupt JPEG file: a bad DHT table")
                luts[tc, th] = _decode_lut(tc, counts, bytes(symbols))
                i += 17 + sum(counts)
        elif marker == 0xDD:
            restart = int.from_bytes(body[:2], "big")
        elif marker == 0xE0 and body.startswith(b"JFIF\x00"):
            jfif = True
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe = body[11]
        elif marker in _UNSUPPORTED_SOF:
            raise ValueError(f"{_UNSUPPORTED_SOF[marker]} JPEG files are not supported")
        elif marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("corrupt JPEG file: two frames")
            precision, height = body[0], int.from_bytes(body[1:3], "big")
            width, nf = int.from_bytes(body[3:5], "big"), body[5]
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG files are not supported")
            if nf not in (1, 3, 4):
                raise ValueError(f"JPEG files of {nf} components are not supported")
            if height == 0 or width == 0:
                raise ValueError("JPEG files whose height comes in a DNL marker are not supported")
            comps = [(body[6 + 3 * j], body[7 + 3 * j] >> 4, body[7 + 3 * j] & 15, body[8 + 3 * j])
                     for j in range(nf)]
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            if any((hmax // c[1], vmax // c[2]) not in ((1, 1), (2, 1), (1, 2), (2, 2))
                   or hmax % c[1] or vmax % c[2] for c in comps):
                raise ValueError(f"JPEG sampling factors {[c[1:3] for c in comps]} are not "
                                 "supported")
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            frame = {"height": height, "width": width, "comps": comps, "hmax": hmax,
                     "vmax": vmax, "mcux": mcux, "mcuy": mcuy, "done": False,
                     "progressive": marker == 0xC2,
                     "coef": [np.zeros((mcuy * c[2], mcux * c[1], 64), np.int64) for c in comps],
                     "seen": [False] * nf}
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG file: a scan before the frame")
            pos = _decode_scan(data, pos, body, frame, luts, qtables, latched, restart)
        # APPn, COM and the rest carry nothing the pixels depend on.
    if frame is None or not all(frame["seen"]):
        raise ValueError("truncated JPEG file: a component was never scanned")
    return _pixels(frame, latched, jfif, adobe)


def _decode_scan(data: bytes, pos: int, body: bytes, frame: dict, luts: dict, qtables: dict,
                 latched: dict, restart: int) -> int:
    """Decode one sequential scan into ``frame["coef"]``; returns the position
    of the marker after its data."""
    ns = body[0]
    ids = [c[0] for c in frame["comps"]]
    members = []
    for j in range(ns):
        cid, tables = body[1 + 2 * j], body[2 + 2 * j]
        if cid not in ids:
            raise ValueError("corrupt JPEG file: a scan of an unknown component")
        members.append((ids.index(cid), tables >> 4, tables & 15))
    ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
    progressive = frame["progressive"]
    if not progressive and (ss, se, ahl) != (0, 63, 0):
        raise ValueError("corrupt JPEG file: a spectral selection in a sequential scan")
    if progressive and (se > 63 or ss > se or (ss == 0) != (se == 0)
                        or (ss > 0 and ns != 1)):
        raise ValueError(f"corrupt JPEG file: a progressive scan of {ss}-{se} over {ns} "
                         "components")
    for ci, td, ta in members:
        # The tables the scan reads: DC for a first DC scan, AC for an AC scan.
        if ((0, td) not in luts and (not progressive or (ss == 0 and ahl >> 4 == 0))
                or (1, ta) not in luts and (not progressive or ss > 0)):
            raise ValueError("corrupt JPEG file: a scan names a Huffman table never defined")
        if ci not in latched:
            tq = frame["comps"][ci][3]
            if tq not in qtables:
                raise ValueError("corrupt JPEG file: a component's DQT table is missing")
            latched[ci] = qtables[tq]
    if progressive:
        return _decode_progressive_scan(data, pos, members, (ss, se, ahl >> 4, ahl & 15),
                                        frame, luts, restart)
    comps = frame["comps"]
    if ns == 1:  # non-interleaved: one block an MCU, the component's own blocks
        ci = members[0][0]
        _, h, v, _ = comps[ci]
        bw = -(-(-(-frame["width"] * h // frame["hmax"])) // 8)
        bh = -(-(-(-frame["height"] * v // frame["vmax"])) // 8)
        n_mcus, plan = bw * bh, [((0, members[0][1]), (1, members[0][2]))]
        where = [(ci, lambda m: (m // bw, m % bw))]
    else:
        n_mcus = frame["mcux"] * frame["mcuy"]
        plan, where = [], []
        for ci, td, ta in members:
            _, h, v, _ = comps[ci]
            for y in range(v):
                for x in range(h):
                    plan.append(((0, td), (1, ta)))
                    where.append((ci, lambda m, y=y, x=x, h=h, v=v: (
                        m // frame["mcux"] * v + y, m % frame["mcux"] * h + x)))
    segments, end, ended = _entropy_segments(data, pos)
    per = restart or n_mcus
    done = 0
    for seg in segments:
        if done >= n_mcus:
            break
        count = min(per, n_mcus - done)
        dc_diff, ac, kinds = _decode_segment(seg, plan, count, luts)
        mcu = done + np.arange(count).repeat(len(plan))
        for kind, (ci, place) in enumerate(where):
            sel = kinds == kind
            rows, cols = place(mcu[sel])
            coef = frame["coef"][ci]
            # DC predictions restart at 0 in each segment, per component.
            same = [k for k, (cj, _) in enumerate(where) if cj == ci]
            comp_blocks = np.isin(kinds, same)
            dc = np.cumsum(dc_diff[comp_blocks])[np.nonzero(sel[comp_blocks])[0]]
            coef[rows, cols, 0] = dc
            mine = sel[ac[:, 0]]
            blk = ac[mine, 0]
            index = np.searchsorted(np.nonzero(sel)[0], blk)
            coef[rows[index], cols[index], ac[mine, 1]] = ac[mine, 2]
        done += count
    if done < n_mcus:
        if ended:
            raise ValueError("corrupt JPEG data: fewer restart segments than MCUs")
        raise ValueError("truncated JPEG file")
    for ci, _, _ in members:
        frame["seen"][ci] = True
    frame["done"] = all(frame["seen"])
    return end


def _scan_blocks(frame: dict, members: list) -> tuple[list, list]:
    """The blocks of a scan in coding order, as (component, flat offset of
    the block's 64 coefficients in ``frame["coef"][component]``), one list an
    MCU: a non-interleaved scan's MCU is one block of the component's own
    grid, an interleaved scan's the h x v blocks of each component in turn."""
    comps, mcux = frame["comps"], frame["mcux"]
    if len(members) == 1:
        ci = members[0][0]
        _, h, v, _ = comps[ci]
        cols = frame["coef"][ci].shape[1]
        bw = -(-(-(-frame["width"] * h // frame["hmax"])) // 8)
        bh = -(-(-(-frame["height"] * v // frame["vmax"])) // 8)
        return [[(ci, (r * cols + c) * 64)] for r in range(bh) for c in range(bw)], [ci]
    mcus = []
    for m in range(mcux * frame["mcuy"]):
        mr, mc, blocks = m // mcux, m % mcux, []
        for ci, _, _ in members:
            _, h, v, _ = comps[ci]
            cols = frame["coef"][ci].shape[1]
            blocks += [(ci, ((mr * v + y) * cols + mc * h + x) * 64)
                       for y in range(v) for x in range(h)]
        mcus.append(blocks)
    return mcus, [ci for ci, _, _ in members]


def _decode_progressive_scan(data: bytes, pos: int, members: list, spectral: tuple,
                             frame: dict, luts: dict, restart: int) -> int:
    """Decode one progressive scan (``jdphuff.c``) into ``frame["coef"]``
    (zigzag order): a DC first scan (the difference's bits shifted up by
    ``al``), a DC refinement (one bit a block), an AC first scan (EOB runs
    of up to 32767 blocks) or an AC refinement (a correction bit for each
    coefficient already nonzero, new coefficients of +-1 << ``al``). Each
    restart segment starts with no EOB run and DC predictions of 0. Returns
    the position of the marker after the scan's data."""
    ss, se, ah, al = spectral
    mcus, scanned = _scan_blocks(frame, members)
    flat = {ci: frame["coef"][ci].reshape(-1).tolist() for ci in scanned}
    dc_lut = {ci: [x.tolist() for x in luts[0, td][:2]] for ci, td, _ in members
              if ss == 0 and ah == 0}
    ac_lut = [x.tolist() for x in luts[1, members[0][2]][:2]] if ss > 0 else None
    p1, m1 = 1 << al, -1 << al
    segments, end, ended = _entropy_segments(data, pos)
    per = restart or len(mcus)
    done = 0
    for seg in segments:
        if done >= len(mcus):
            break
        nbits = 8 * len(seg)
        padded = np.concatenate([seg, np.zeros(5, np.uint8)]).astype(np.int64)
        at = np.arange(nbits + 17)
        i = at >> 3
        win = (((padded[i] << 16 | padded[i + 1] << 8 | padded[i + 2]) >> (8 - (at & 7)))
               & 0xFFFF).tolist()
        p, eobrun, pred = 0, 0, dict.fromkeys(scanned, 0)
        try:
            for mcu in mcus[done:done + per]:
                for ci, off in mcu:
                    coef = flat[ci]
                    if ss == 0 and ah == 0:  # DC first
                        sym, length = dc_lut[ci]
                        w = win[p]
                        s, n = sym[w], length[w]
                        if n == 0:
                            raise ValueError("corrupt JPEG data: a bit pattern that is no "
                                             "Huffman code")
                        p += n
                        diff = 0
                        if s:
                            diff = win[p] >> (16 - s)
                            p += s
                            if diff < 1 << (s - 1):
                                diff -= (1 << s) - 1
                        pred[ci] += diff
                        coef[off] = pred[ci] << al
                    elif ss == 0:  # DC refinement
                        if win[p] >> 15:
                            coef[off] |= p1
                        p += 1
                    elif ah == 0:  # AC first
                        if eobrun:
                            eobrun -= 1
                            continue
                        sym, length = ac_lut
                        k = ss
                        while k <= se:
                            w = win[p]
                            rs, n = sym[w], length[w]
                            if n == 0:
                                raise ValueError("corrupt JPEG data: a bit pattern that is no "
                                                 "Huffman code")
                            p += n
                            r, s = rs >> 4, rs & 15
                            if s:
                                k += r
                                v = win[p] >> (16 - s)
                                p += s
                                if v < 1 << (s - 1):
                                    v -= (1 << s) - 1
                                if k > 63:
                                    raise ValueError("corrupt JPEG data: a coefficient past "
                                                     "the block's 64")
                                coef[off + k] = v << al
                                k += 1
                            elif r == 15:
                                k += 16
                            else:
                                eobrun = 1 << r
                                if r:
                                    eobrun += win[p] >> (16 - r)
                                    p += r
                                eobrun -= 1
                                break
                    else:  # AC refinement
                        k = ss
                        if not eobrun:
                            sym, length = ac_lut
                            while k <= se:
                                w = win[p]
                                rs, n = sym[w], length[w]
                                if n == 0:
                                    raise ValueError("corrupt JPEG data: a bit pattern that is "
                                                     "no Huffman code")
                                p += n
                                r, s = rs >> 4, rs & 15
                                if s:
                                    s = p1 if win[p] >> 15 else m1
                                    p += 1
                                elif r != 15:
                                    eobrun = 1 << r
                                    if r:
                                        eobrun += win[p] >> (16 - r)
                                        p += r
                                    break
                                # Past the coefficients already nonzero (a
                                # correction bit each) and r zeros.
                                while k <= se:
                                    c = coef[off + k]
                                    if c:
                                        if win[p] >> 15 and not c & p1:
                                            coef[off + k] = c + (p1 if c >= 0 else m1)
                                        p += 1
                                    else:
                                        r -= 1
                                        if r < 0:
                                            break
                                    k += 1
                                if s:
                                    if k > 63:
                                        raise ValueError("corrupt JPEG data: a coefficient "
                                                         "past the block's 64")
                                    coef[off + k] = s
                                k += 1
                        if eobrun:
                            while k <= se:
                                c = coef[off + k]
                                if c:
                                    if win[p] >> 15 and not c & p1:
                                        coef[off + k] = c + (p1 if c >= 0 else m1)
                                    p += 1
                                k += 1
                            eobrun -= 1
        except IndexError:
            p = len(win)
        if p > nbits:
            raise ValueError("corrupt or truncated JPEG data: a scan segment ends early")
        done += min(per, len(mcus) - done)
    if done < len(mcus):
        if ended:
            raise ValueError("corrupt JPEG data: fewer restart segments than MCUs")
        raise ValueError("truncated JPEG file")
    for ci in scanned:
        frame["coef"][ci][...] = np.array(flat[ci], np.int64).reshape(frame["coef"][ci].shape)
        frame["seen"][ci] = True
    frame["done"] = all(frame["seen"])
    return end


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's ``cmyk2rgb`` of inverted (Adobe) CMYK, as ``CMYK;I`` reads it:
    each of C, M, Y and K is ``255 - sample``, then ``nk - c * nk / 255``
    with ``nk = 255 - k`` and Pillow's rounded ``MULDIV255``."""
    c, m, y, k = (255 - cmyk[..., i].astype(np.int64) for i in range(4))
    nk = 255 - k

    def muldiv255(a, b):
        t = a * b + 128
        return ((t >> 8) + t) >> 8

    return np.clip(np.stack([nk - muldiv255(v, nk) for v in (c, m, y)], axis=-1),
                   0, 255).astype(np.uint8)


def _pixels(frame: dict, latched: dict, jfif: bool, adobe) -> np.ndarray:
    """The inverse DCT, upsampling and colour conversion of a decoded frame."""
    height, width = frame["height"], frame["width"]
    planes = []
    for ci, (cid, h, v, _) in enumerate(frame["comps"]):
        coef = frame["coef"][ci]
        natural = np.zeros_like(coef)
        natural[..., _ZIGZAG] = coef
        samples = _unblocks(_idct_islow(natural.reshape(*coef.shape[:2], 8, 8), latched[ci]))
        ph = -(-height * v // frame["vmax"])
        pw = -(-width * h // frame["hmax"])
        plane = _upsample(samples[:ph, :pw], frame["hmax"] // h, frame["vmax"] // v)
        planes.append(plane[:height, :width])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=-1).astype(np.uint8)
    if len(planes) == 4:
        # jdapimin.c: four components are CMYK, or YCCK where Adobe's
        # transform flag says 2 (jdcolor.c's ycck_cmyk_convert: 255 less the
        # YCbCr-to-RGB sums, clamped; K as it is).
        if adobe == 2:
            rgb = _ycc_to_rgb_unclamped(*planes[:3])
            planes = [np.clip(255 - v, 0, 255) for v in rgb] + [planes[3]]
        return _cmyk_to_rgb(np.stack(planes, axis=-1))
    ids = tuple(c[0] for c in frame["comps"])
    # jdapimin.c's default_decompress_parms: JFIF means YCbCr; else Adobe's
    # transform flag; else component ids 'R', 'G', 'B' mean RGB.
    rgb = (not jfif) and (adobe == 0 if adobe is not None else ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)
