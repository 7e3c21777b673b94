"""JPEG as Pillow's libjpeg-turbo writes and reads it: the encoder in numpy, the decoder in C.

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
as Pillow's ``CMYK;I`` raw mode and ``cmyk2rgb`` do. Arithmetic-coded
files (SOF9 sequential, SOF10 progressive; ``jdarith.c``: T.81 Annex D's QM
decoder, the DC and AC statistics bins, DAC's conditioning, statistics reset
at each restart) decode to the same coefficients, then the same pixels;
Pillow hands libjpeg a file in 64 KiB blocks and libjpeg's arithmetic
decoder cannot wait for the next block, so a scan that reads across one
raises ``ValueError`` as Pillow raises. 8-bit lossless files (SOF3; T.81
Annex H as libjpeg-turbo 3's ``jdlhuff.c``, ``jddiffct.c`` and
``jdlossls.c`` read it: Huffman-coded differences of categories 0-16,
predictors 1-7, the point transform, prediction reset at each restart
interval of whole MCU rows) decode to their samples, replicated up by
whole sampling factors, with libjpeg-turbo's colour rules for lossless
files: grey, RGB or CMYK, and no YCbCr (refused, as Pillow refuses it).
Arithmetic-coded lossless (SOF11), hierarchical and 12-bit files raise
``ValueError`` with the reason, as do truncated files and the corrupt ones
libjpeg-turbo refuses.

Damaged data reads as Pillow's libjpeg-turbo 3.1 recovers from it with a
warning Pillow never shows. The source is read as libjpeg reads it: a run
of 0xFF bytes and a zero is one 0xFF data byte, any other byte after them
a marker, after which the decoders read zero bits. A bad Huffman code is
17 bits and symbol 0; a zero run past a block's 64th coefficient lands on
it; DC predictions wrap as an ``int`` and coefficients as 16-bit
``JCOEF``s. An interval whose bits run out finishes the MCU in hand from
zeros and leaves the rest of the interval as it was (a lossless scan: the
rest of its MCU row, then zero differences and the prediction restarted).
An arithmetic scan's bad code stops its interval. At each restart the
expected RSTn is taken, or another marker dealt with by
jpeg_resync_to_restart's rules (``_resync``). Markers after a scan are
read by jdmarker.c's rules (``_marker_segment``); an EOI before the last
scan of a DCT file leaves what it has (components never scanned grey), and
a progressive file cut so gets libjpeg's block smoothing (``_smoothed``).
The IDCT is libjpeg-turbo's SIMD one in Pillow's x86-64 wheels, whose
16-bit lanes show on out-of-range coefficients (``_idct_islow``).

``decode_jpeg`` parses the markers here and decodes each scan (Huffman:
``tdt_jpeg_scan``; arithmetic: ``tdt_jpeg_arith_scan``; lossless:
``tdt_jpeg_lossless_scan``, its colour in numpy), the inverse DCT, the
upsampling and the colour in C (``data/csrc/jpeg.c``), step for step what
``decode_jpeg_reference`` does in Python and numpy.
"""

from __future__ import annotations

import functools

import numpy as np

from tinydiffusion_torch.data import native as _native

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


def _w16(x):
    """A store into a 16-bit lane (libjpeg's JCOEF, a SIMD word): two's complement wrap."""
    return ((x + 32768) & 0xFFFF) - 32768


def _w32(x):
    """A 32-bit lane's wrap (a SIMD doubleword)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _idct_pass(d: list, shift: int) -> list:
    """One pass of libjpeg-turbo's SIMD islow IDCT (``jidctint-avx2.asm``,
    ``-sse2``: jidctint.c's sums regrouped into pairs of 16-bit products,
    ``pmaddwd``) on eight arrays of 16-bit words: in0 + in4, in0 - in4, in7 +
    in3 and in5 + in1 are 16-bit sums, every other sum 32-bit, and each
    output, descaled by ``shift``, is saturated to 16 bits."""
    in0, in1, in2, in3, in4, in5, in6, in7 = d
    tmp3 = _w32(in2 * (_F0541 + _F0765) + in6 * _F0541)
    tmp2 = _w32(in2 * _F0541 + in6 * (_F0541 - _F1847))
    tmp0, tmp1 = _w16(in0 + in4) << _CONST_BITS, _w16(in0 - in4) << _CONST_BITS
    t10, t13, t11, t12 = _w32(tmp0 + tmp3), _w32(tmp0 - tmp3), _w32(tmp1 + tmp2), _w32(tmp1 - tmp2)
    z3, z4 = _w16(in7 + in3), _w16(in5 + in1)
    z3, z4 = (_w32(z3 * (_F1175 - _F1961) + z4 * _F1175),
              _w32(z3 * _F1175 + z4 * (_F1175 - _F0390)))
    o0 = _w32(_w32(in7 * (_F0298 - _F0899) - in1 * _F0899) + z3)
    o3 = _w32(_w32(-in7 * _F0899 + in1 * (_F1501 - _F0899)) + z4)
    o1 = _w32(_w32(in5 * (_F2053 - _F2562) - in3 * _F2562) + z4)
    o2 = _w32(_w32(-in5 * _F2562 + in3 * (_F3072 - _F2562)) + z3)
    return [np.clip(_w32(_w32(v) + (1 << (shift - 1))) >> shift, -32768, 32767) for v in (
        t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3)]


def _idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(..., 8, 8) quantised coefficients -> (..., 8, 8) samples 0-255, as
    Pillow's libjpeg-turbo computes them on x86-64: its SIMD islow IDCT,
    which on a valid file gives jidctint.c's samples. Where coefficients are
    out of range (damaged data) its 16-bit lanes show: the dequantisation
    is a 16-bit product, a block whose rows 1-7 are zero takes pass 1's
    shortcut (the DC products shifted left by 2 in 16 bits), each pass
    saturates its outputs to 16 bits, and the range limit clamps."""
    coef = _w16(coef)
    d = _w16(coef * qtable)
    cols = np.stack(_idct_pass([d[..., k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS),
                    axis=-2)
    dc_only = ~(coef[..., 1:, :] != 0).any(axis=(-2, -1))
    cols = np.where(dc_only[..., None, None], _w16(d[..., :1, :] << _PASS1_BITS), cols)
    rows = np.stack(_idct_pass([cols[..., k] for k in range(8)], _CONST_BITS + _PASS1_BITS + 3),
                    axis=-1)
    return np.clip(rows, -128, 127) + 128


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


# jdhuff.c's answer to a bit pattern that no code of the table starts: it
# reads bits up to jpeg_huff_decode's sentinel length, 17, and decodes
# symbol 0 ("fake a zero"; a DC difference of 0, an AC end of block).
BAD_CODE = 17 << 8


@functools.lru_cache(maxsize=64)
def _packed_lut(counts: tuple, symbols: bytes) -> np.ndarray:
    """For each 16-bit window, the code that starts it as ``length << 8 |
    symbol``, uint16 (``BAD_CODE`` where none does): the table both the C
    decoder and the plain one read."""
    table = np.full(1 << 16, BAD_CODE, np.uint16)
    c = p = 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            lo = c << (16 - length)
            table[lo:lo + (1 << (16 - length))] = length << 8 | symbols[p]
            c += 1
            p += 1
        c <<= 1
    return table


def _check_table(counts: tuple, symbols: bytes, dc_max: int | None) -> None:
    """jdhuff.c's jpeg_make_d_derived_tbl, run on each table a scan reads:
    no code may be all ones, and a DC table (``dc_max`` given) holds no
    symbol over ``dc_max`` (15; 16 in a lossless scan)."""
    code = 0
    for length, count in enumerate(counts, start=1):
        code += count
        if code >= 1 << length:
            raise ValueError("corrupt JPEG file: a bad DHT table (its codes overflow)")
        code <<= 1
    if dc_max is not None and max(symbols, default=0) > dc_max:
        raise ValueError(f"corrupt JPEG file: a bad DHT table (a DC symbol over {dc_max})")


@functools.lru_cache(maxsize=64)
def _decode_lut(tc: int, counts: tuple, symbols: bytes) -> tuple[np.ndarray, ...]:
    """A table of class ``tc`` (0 DC, 1 AC) for each 16-bit window: the
    symbol, the code's length (17 for no code), the bits to the next symbol
    (the code and the extra bits the symbol announces) and, for AC, the
    symbol's advance in its block (run + 1; 64 for an end of block: size 0
    and a run other than 15)."""
    packed = _packed_lut(counts, symbols).astype(np.int64)
    sym, length = packed & 255, packed >> 8
    skip = length + (sym if tc == 0 else sym & 15)
    adv = np.where((sym & 15 == 0) & (sym != 0xF0), 64, (sym >> 4) + 1)
    return sym, length, skip, adv


def _extend(extra: np.ndarray, size: np.ndarray) -> np.ndarray:
    """T.81's EXTEND: ``size`` bits read as a signed coefficient."""
    half = np.left_shift(1, np.maximum(size - 1, 0))
    return np.where(size == 0, 0, np.where(extra < half, extra - 2 * half + 1, extra))


_RST = range(0xD0, 0xD8)


def _scan_data(data: bytes, pos: int, reach: bool = False) -> tuple[list, list]:
    """The entropy-coded data from ``pos`` as libjpeg's source reads it
    (jdhuff.c's jpeg_fill_bit_buffer, jdarith.c's get_byte, jdmarker.c's
    next_marker): a run of 0xFF bytes and a zero is one 0xFF data byte; a
    run of 0xFF bytes and any other byte is a marker. Returns the chunks of
    data between markers, unstuffed, and the marker that ends each, as
    (code, where its 0xFF run starts, where it ends), or None where the file
    ends first. It stops at the first marker no resync passes (one from
    SOF0 up that is no RSTn: jpeg_resync_to_restart). With ``reach`` each
    chunk is (bytes, where libjpeg stands in the file after each byte)."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    ff = arr == 0xFF
    last = np.nonzero(ff[:-1] & ~ff[1:])[0]  # the last 0xFF of each run with a byte after
    mark_at = last[arr[last + 1] != 0]
    codes = arr[mark_at + 1]
    final = np.nonzero((codes >= 0xC0) & ((codes < 0xD0) | (codes > 0xD7)))[0]
    if len(final):
        mark_at, codes = mark_at[:final[0] + 1], codes[:final[0] + 1]
    run_start = np.nonzero(ff & ~np.concatenate([[False], ff[:-1]]))[0]
    starts = run_start[np.searchsorted(run_start, mark_at, "right") - 1]
    markers = [(int(c), int(b), int(m) + 2) for c, b, m in zip(codes, starts, mark_at)]
    bounds = [0] + [m[2] for m in markers]
    ends = [m[1] for m in markers]
    if not len(final):  # the file ends inside the last chunk
        tail = len(arr)
        while tail > bounds[-1] and arr[tail - 1] == 0xFF:
            tail -= 1
        ends.append(tail)
        markers.append(None)
    chunks = []
    for first, end in zip(bounds, ends):
        seg = arr[first:end]
        prev_ff = np.concatenate([[False], seg[:-1] == 0xFF])
        keep = ~(prev_ff & ((seg == 0xFF) | (seg == 0)))
        if not reach:
            chunks.append(seg[keep])
            continue
        # After a kept 0xFF libjpeg stands past the zero that ends its run.
        idx = np.nonzero(keep)[0]
        other = np.nonzero(seg != 0xFF)[0]
        after = np.where(seg[idx] == 0xFF,
                         other[np.minimum(np.searchsorted(other, idx), len(other) - 1)]
                         if len(other) else idx, idx) + 1
        chunks.append((seg[keep], pos + first + after))
    return chunks, [None if m is None else (m[0], pos + m[1], pos + m[2]) for m in markers]


def _resync(markers: list, n_intervals: int) -> tuple[list, int]:
    """Which chunk each restart interval of a scan reads, as libjpeg's
    read_restart_marker and jpeg_resync_to_restart decide at each restart:
    the expected RSTn is taken; so is a marker the decoder should not see
    (another RSTn, or one before the last two or past the next two);
    a marker below SOF0, or an RSTn one or two behind, is skipped with the
    data after it; any other marker (a non-RST from SOF0 up, or one of the
    next two RSTn) is left for the next restart, and the interval reads no
    data (-1). Returns each interval's chunk and the marker that stands
    after the scan (its index; ``len(markers) - 1`` may be None: the file
    ends) and the last marker a restart read (-1: none). The file ending
    where a marker is needed is the truncation Pillow refuses."""
    plan, at, expected, read = [0], 0, 0, -1
    for _ in range(1, n_intervals):
        while True:
            read = at
            if markers[at] is None:
                raise ValueError("truncated JPEG file")
            code = markers[at][0]
            if code == 0xD0 + expected:
                action = 1
            elif code < 0xC0:
                action = 2
            elif code not in _RST or code in (0xD0 + (expected + 1) % 8, 0xD0 + (expected + 2) % 8):
                action = 3
            elif code in (0xD0 + (expected - 1) % 8, 0xD0 + (expected - 2) % 8):
                action = 2
            else:
                action = 1
            if action != 2:
                break
            at += 1
        expected = (expected + 1) % 8
        if action == 1:
            at += 1
            plan.append(at)
        else:
            plan.append(-1)
    return plan, at, read


# A span's flags (spans: each restart interval's data in the scan's buffer).
SPAN_FRESH, SPAN_OPEN = 1, 2


def _scan_spans(data: bytes, pos: int, n_intervals: int, reach: bool = False) -> dict:
    """A scan's restart intervals as the decoders read them: ``buf`` (the
    chunks they read, one after another) and ``spans`` (n_intervals x 3
    int64: start and end in ``buf``, flags: ``SPAN_FRESH`` where the marker
    before the interval was taken, which clears jdhuff.c's
    insufficient_data, ``SPAN_OPEN`` where the file ends after the data,
    where reading past it is truncation), ``end`` (where the marker after
    the scan starts, ``len(data)`` at the file's end) and, with ``reach``,
    each interval's chunk as ``_scan_data`` gives it (None: no data), the
    marker after it, and the end of the last marker a restart read."""
    chunks, markers = _scan_data(data, pos, reach)
    plan, at, read = _resync(markers, n_intervals)
    used = sorted({c for c in plan if c >= 0})
    pieces = [chunks[c][0] if reach else chunks[c] for c in used]
    starts = np.cumsum([0] + [len(x) for x in pieces]).astype(np.int64)
    where = {c: i for i, c in enumerate(used)}
    spans = np.zeros((n_intervals, 3), np.int64)
    for i, c in enumerate(plan):
        if c >= 0:
            spans[i] = (starts[where[c]], starts[where[c] + 1],
                        SPAN_FRESH | (SPAN_OPEN if markers[c] is None else 0))
        else:
            spans[i] = (starts[-1], starts[-1], 0)
    scan = {"buf": np.concatenate(pieces) if pieces else np.zeros(1, np.uint8), "spans": spans,
            "end": len(data) if markers[at] is None else markers[at][1]}
    if reach:
        scan["reach"] = [chunks[c] if c >= 0 else None for c in plan]
        scan["restart_end"] = markers[read][2] if read >= 0 else 0
        scan["markers"] = [markers[c] if c >= 0 else None for c in plan]
    return scan


def _segments(scan: dict) -> list:
    """Each restart interval's bytes and flags, from ``_scan_spans``."""
    return [(scan["buf"][a:b], flags) for a, b, flags in scan["spans"].tolist()]


def _decode_segment(seg: np.ndarray, plan: list, n_mcus: int,
                    luts: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, bool]:
    """Huffman-decode up to ``n_mcus`` MCUs of one restart interval's data,
    read with zero bits past its end as libjpeg reads them once it meets a
    marker. ``plan``: (DC table, AC table) of each block of an MCU. The MCU
    whose bits run past the end is decoded in full (from those zeros); the
    MCUs after it are not (jdhuff.c's insufficient_data). Returns each
    decoded block's DC difference, its AC coefficients as (block, zigzag
    index, value) rows (a run past the 64th lands on the 64th: libjpeg's
    jpeg_natural_order is padded with 63s), each block's place in its MCU,
    the MCUs decoded and whether the bits ran out."""
    nbits = 8 * len(seg)
    past = nbits + 1  # every position past the end reads zeros: one sink
    size = nbits + 2
    padded = np.concatenate([seg, np.zeros(5, np.uint8)]).astype(np.int64)
    p = np.arange(size)
    i = p >> 3
    window = ((padded[i] << 16 | padded[i + 1] << 8 | padded[i + 2]) >> (8 - (p & 7))) & 0xFFFF
    window[nbits:] = 0
    tables = sorted({t for pair in plan for t in pair})
    # Per table and bit position: the position after the symbol there and its
    # extra bits; for AC tables packed with the symbol's advance in the block.
    nxt = np.empty((len(tables), size), np.int64)
    adv = np.empty((len(tables), size), np.int64)
    walk_of = {}
    for j, t in enumerate(tables):
        _, _, skip, step = luts[t]
        nxt[j] = np.where(p + skip[window] > nbits, past, p + skip[window])
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
    at = decoded = 0
    while decoded < n_mcus and at <= nbits:
        for dc_next, one in walk:
            dc_add(at)
            at = dc_next[at]
            ac_add(at)
            k = 1
            while k < 64:
                v = one[at]
                k += v & 127
                at = v >> 7
        decoded += 1
    n_blocks = len(dc_pos)
    # Every block's AC symbols, walked for all blocks at once.
    kinds = np.tile(np.arange(len(plan)), decoded)
    ac_t = np.array([tables.index(ac) for _, ac in plan])[kinds]
    cur = np.array(ac_start, np.int64)
    kk = np.ones(len(cur), np.int64)
    found_block, found_pos = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    live = np.arange(len(cur))
    while len(live):
        at_live = cur[live]
        found_block.append(live)
        found_pos.append(at_live)
        kk[live] += adv[ac_t[live], at_live]
        cur[live] = nxt[ac_t[live], at_live]
        live = live[kk[live] < 64]
    found_block = np.concatenate(found_block)
    order = np.argsort(found_block, kind="stable")
    ac_pos = np.concatenate(found_pos)[order]
    block = found_block[order]
    dc_pos = np.array(dc_pos, np.int64)
    # DC: the size, then the bits of the difference.
    dc_w = window[dc_pos]
    dsize, dlen = np.empty(n_blocks, np.int64), np.empty(n_blocks, np.int64)
    for dc_table in {dc for dc, _ in plan}:
        sel = np.isin(kinds, [m for m, (dc, _) in enumerate(plan) if dc == dc_table])
        dsize[sel] = luts[dc_table][0][dc_w[sel]]
        dlen[sel] = luts[dc_table][1][dc_w[sel]]
    dc = _extend(window[np.minimum(dc_pos + dlen, past)] >> (16 - dsize), dsize)
    # AC: each symbol's block, its coefficient index after the run, its value.
    ac_w = window[ac_pos]
    asym, alen = np.empty(len(ac_pos), np.int64), np.empty(len(ac_pos), np.int64)
    for ac_table in {ac for _, ac in plan}:
        sel = ac_t[block] == tables.index(ac_table)
        asym[sel] = luts[ac_table][0][ac_w[sel]]
        alen[sel] = luts[ac_table][1][ac_w[sel]]
    eob = (asym & 15 == 0) & (asym != 0xF0)
    step = np.where(eob, 0, (asym >> 4) + 1)
    csum = np.cumsum(step)
    first = np.searchsorted(block, np.arange(n_blocks))  # each block's first AC symbol
    start = np.concatenate([[0], csum])[first]  # advances before the block
    k = 1 + csum - step - start[block] + (asym >> 4)
    asize = asym & 15
    keep = asize > 0
    value = _extend(window[np.minimum(ac_pos + alen, past)] >> (16 - asize), asize)
    return (dc, np.stack([block[keep], np.minimum(k[keep], 63), value[keep]], axis=1), kinds,
            decoded, at > nbits)


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


# The frames read: baseline, extended sequential and progressive, Huffman
# (SOF0-2) or arithmetic-coded (SOF9, SOF10), and Huffman-coded lossless (SOF3).
_SOF = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA)
_PROGRESSIVE_SOF, _ARITHMETIC_SOF, _LOSSLESS_SOF = (0xC2, 0xCA), (0xC9, 0xCA), (0xC3,)
# libjpeg-turbo 3 reads no arithmetic-coded lossless file (Pillow refuses one).
_UNSUPPORTED_SOF = {0xC5: "differential sequential",
                    0xC6: "differential progressive", 0xC7: "differential lossless",
                    0xCB: "arithmetic-coded lossless",
                    0xCD: "arithmetic-coded differential sequential",
                    0xCE: "arithmetic-coded differential progressive",
                    0xCF: "arithmetic-coded differential lossless"}


def decode_jpeg(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a baseline, extended-sequential or
    progressive JPEG, Huffman or arithmetic-coded, or an 8-bit lossless one, as
    ``Image.open(f).convert("RGB")`` gives it (Pillow 12.1, libjpeg-turbo).
    Raises ``ValueError`` on any other kind of file, on truncated or corrupt
    data, and where Pillow refuses an arithmetic-coded scan that crosses one
    of its 64 KiB reads (``_check_pillow_blocks``). The entropy-coded scans
    and the pixels are decoded by the C library (``data/csrc/jpeg.c``, built
    at the first call)."""
    return _decode(data, native=True, in_blocks=True)


def decode_jpeg_reference(data: bytes) -> np.ndarray:
    """The plain version of ``decode_jpeg``: the same file, its scans and
    pixels decoded in Python and numpy. The tests and ``chip_smoke.py`` hold
    the C library to it."""
    return _decode(data, native=False, in_blocks=True)


def decode_jpeg_as(data: bytes, color: str, native: bool = True) -> np.ndarray:
    """``decode_jpeg`` (``native``) or ``decode_jpeg_reference`` of a stream
    whose colour transform its container gives (a JPEG-in-TIFF strip's
    photometric): ``color`` is ``"grey"``, ``"rgb"`` (the components as they
    are, libjpeg's ``JCS_UNKNOWN``) or ``"ycc"`` (YCbCr to RGB), in place of
    libjpeg's guess from the markers."""
    if color not in ("grey", "rgb", "ycc"):
        raise ValueError(f"unknown JPEG colour transform {color!r}")
    return _decode(data, native, color)


def frame_header(data: bytes) -> tuple[int, int, list[tuple[int, int, int]]]:
    """The frame of a JPEG stream, read from its first SOF marker segment:
    ``(height, width, [(component id, h, v), ...])``. Raises ``ValueError``
    where there is none."""
    pos = 2 if data[:2] == b"\xff\xd8" else None
    while pos is not None and pos + 4 <= len(data) and data[pos] == 0xFF:
        marker, length = data[pos + 1], int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xFF:
            pos += 1
            continue
        if marker in _SOF or marker in _UNSUPPORTED_SOF:
            body = data[pos + 4:pos + 2 + length]
            if length < 8 or len(body) < 6 + 3 * body[5]:
                break
            comps = [(body[6 + 3 * j], body[7 + 3 * j] >> 4, body[7 + 3 * j] & 15)
                     for j in range(body[5])]
            return int.from_bytes(body[1:3], "big"), int.from_bytes(body[3:5], "big"), comps
        if marker in (0xD9, 0xDA) or length < 2:
            break
        pos += 2 + length
    raise ValueError("corrupt JPEG file: no frame header")


def _decode(data: bytes, native: bool, color: str | None = None,
            in_blocks: bool = False) -> np.ndarray:
    """``in_blocks``: the file as Pillow's JPEG plugin reads it, in 64 KiB
    blocks (``_check_pillow_blocks``), not a stream libtiff holds whole."""
    try:
        return _decode_markers(bytes(data), native, color, in_blocks)
    except (IndexError, ZeroDivisionError) as e:  # a marker segment shorter than it says
        raise ValueError(f"corrupt JPEG file: {e!r}") from e


def _next_marker(data: bytes, pos: int) -> int:
    """jdmarker.c's next_marker: where the next marker's 0xFF starts from
    ``pos`` on, past any other bytes and 0xFF 0x00 pairs (``len(data)``:
    none before the file ends)."""
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            return len(data)
        end = pos
        while end < len(data) and data[end] == 0xFF:
            end += 1
        if end == len(data):
            return len(data)
        if data[end]:
            return end - 1
        pos = end + 1


# The markers libjpeg's read_markers knows; any other is JERR_UNKNOWN_MARKER.
_KNOWN = {*_SOF, *_UNSUPPORTED_SOF, 0xC4, 0xC8, 0xCC, 0xD8, 0xD9, 0xDA, 0xDB, 0xDC, 0xDD, 0xFE,
          0x01, *range(0xD0, 0xD8), *range(0xE0, 0xF0)}


class _Suspend(Exception):
    """The file ends where libjpeg reads on: its data source suspends."""


class _Reader:
    """Bytes of a marker segment as jdmarker.c reads them, one at a time:
    ``_Suspend`` where the file ends first."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise _Suspend
        self.pos += 1
        return self.data[self.pos - 1]

    def two(self) -> int:
        return self.byte() << 8 | self.byte()

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise _Suspend
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _decode_markers(data: bytes, native: bool, color: str | None = None,
                    in_blocks: bool = False) -> np.ndarray:
    """The markers as libjpeg's read_markers takes them (Pillow's JPEG
    plugin reads those before the first scan too), each scan decoded as it
    comes. Where the file ends early: before the first scan and in a
    multi-scan file Pillow refuses it (libjpeg suspends; Pillow has no more
    data); after a one-pass file's scan every pixel is out, and Pillow
    keeps the image. A stream libtiff holds (not ``in_blocks``) ends in an
    EOI of libtiff's own."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    state = {"qtables": {}, "tables": {}, "frame": None, "restart": 0, "adobe": None,
             "jfif": False, "latched": {},  # component -> its table, fixed at its first scan
             # DAC's conditioning: L and U of each DC table, Kx of each AC table.
             "dac": tuple([d] * 16 for d in ARITH_DEFAULTS)}
    pos = 2
    while True:
        frame = state["frame"]
        try:
            pos = _marker_segment(data, pos, state, native, in_blocks)
        except _Suspend:
            if frame is not None and frame["scans_read"] and (frame["one_pass"] or not in_blocks):
                break
            raise ValueError("truncated JPEG file") from None
        if pos is None:
            break
    frame = state["frame"]
    if frame is None or not frame["scans_read"]:
        raise ValueError("truncated JPEG file: no scan")
    if frame["lossless"] and not all(frame["seen"]):
        # libjpeg-turbo refuses a lossless file whose EOI comes before a
        # component's scan; a DCT file decodes that component as 0s.
        raise ValueError("truncated JPEG file: a component was never scanned")
    if color is not None and len(frame["comps"]) != (1 if color == "grey" else 3):
        raise ValueError(f"a {color} JPEG stream of {len(frame['comps'])} components")
    if frame["lossless"]:
        return _lossless_pixels(frame, state["jfif"], state["adobe"], color)
    return _pixels(frame, state["latched"], state["jfif"], state["adobe"], native, color)


def _marker_segment(data: bytes, pos: int, state: dict, native: bool,
                    in_blocks: bool) -> int | None:
    """Read the marker at or after ``pos`` and its segment (a scan too);
    returns where the next marker search starts, None at EOI."""
    # Pillow's JPEG plugin (up to the first scan) and libjpeg both pass over
    # bytes that are no marker.
    pos = _next_marker(data, pos)
    if pos + 2 > len(data):
        raise _Suspend
    marker = data[pos + 1]
    frame = state["frame"]
    scanned = frame is not None and frame["scans_read"]
    if marker not in _KNOWN or (marker == 0x01 and not scanned):
        raise ValueError(f"corrupt JPEG file: marker 0xFF{marker:02X}")
    if marker == 0xD8:
        raise ValueError("corrupt JPEG file: a second SOI marker")
    if marker == 0xD9:
        return None
    read = _Reader(data, pos + 2)
    if 0xD0 <= marker <= 0xD7 or marker == 0x01:
        return read.pos
    qtables, tables, kx = state["qtables"], state["tables"], state["dac"][2]
    lower, upper = state["dac"][:2]
    if marker == 0xDB:  # jdmarker.c's get_dqt
        length = read.two() - 2
        while length > 0:
            n = read.byte()
            wide, tq = n >> 4, n & 15
            if tq >= 4:
                raise ValueError(f"corrupt JPEG file: DQT table {tq}")
            raw = np.frombuffer(read.take(128 if wide else 64), ">u2" if wide else np.uint8)
            table = np.zeros(64, np.int64)
            table[_ZIGZAG] = raw
            qtables[tq] = table.reshape(8, 8)
            length -= 129 if wide else 65
        if length:
            raise ValueError("corrupt JPEG file: a DQT segment of the wrong length")
        return read.pos
    if marker == 0xC4:  # get_dht
        length = read.two() - 2
        while length > 16:
            index = read.byte()
            counts = tuple(read.byte() for _ in range(16))
            length -= 17
            if sum(counts) > 256 or sum(counts) > length:
                raise ValueError("corrupt JPEG file: a bad DHT table")
            symbols = read.take(sum(counts))
            length -= sum(counts)
            tc, th = (1, index - 0x10) if index & 0x10 else (0, index)
            if th >= 4:
                raise ValueError(f"corrupt JPEG file: DHT table {index:#04x}")
            tables[tc, th] = (counts, bytes(symbols))
        if length:
            raise ValueError("corrupt JPEG file: a DHT segment of the wrong length")
        return read.pos
    if marker == 0xDD:  # get_dri
        if read.two() != 4:
            raise ValueError("corrupt JPEG file: a DRI segment of the wrong length")
        state["restart"] = read.two()
        return read.pos
    if marker == 0xCC:  # get_dac
        length = read.two() - 2
        while length > 0:
            index, value = read.byte(), read.byte()
            length -= 2
            if index >= 32:
                raise ValueError(f"corrupt JPEG file: DAC table {index}")
            if index >= 16:
                kx[index - 16] = value
            elif value & 15 > value >> 4:
                raise ValueError(f"corrupt JPEG file: DAC L > U ({value:#04x})")
            else:
                lower[index], upper[index] = value & 15, value >> 4
        if length:
            raise ValueError("corrupt JPEG file: a DAC segment of odd length")
        return read.pos
    if marker in (*range(0xE0, 0xF0), 0xFE, 0xDC):  # APPn, COM, DNL: skipped
        length = read.two() - 2
        body = data[read.pos:read.pos + max(length, 0)]
        if marker == 0xE0 and body.startswith(b"JFIF\x00") and not scanned:
            state["jfif"] = True  # libjpeg picks the colour transform at the first scan
        if marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12 and not scanned:
            state["adobe"] = body[11]
        read.take(max(length, 0))
        return read.pos
    if marker in _SOF or marker in _UNSUPPORTED_SOF or marker == 0xC8:
        if marker == 0xC8:
            raise ValueError("corrupt JPEG file: a JPG marker")
        if frame is not None:  # get_sof checks before it reads
            raise ValueError("corrupt JPEG file: two frames")
        body = read.take(read.two() - 2)
        return _frame_marker(marker, body, state, read.pos)
    # SOS: get_sos's checks as it reads, then the scan
    if frame is None:
        raise ValueError("corrupt JPEG file: a scan before the frame")
    start, length, ns = read.pos + 2, read.two(), read.byte()
    if length != 2 * ns + 6 or not 1 <= ns <= 4:
        raise ValueError("corrupt JPEG file: an SOS segment of the wrong length")
    taken = []
    for _ in range(ns):
        cid = read.byte()
        read.byte()
        free = [ci for ci, c in enumerate(frame["comps"]) if c[0] == cid and ci not in taken]
        if not free:
            raise ValueError("corrupt JPEG file: a scan of an unknown component")
        taken.append(free[0])
    read.take(3)
    body = data[start:read.pos]
    if scanned and frame["one_pass"]:
        # jdinput.c: a file whose first scan holds every component
        # sequentially is read in one pass (JERR_EOI_EXPECTED).
        raise ValueError("corrupt JPEG file: a scan after a one-pass file's scan")
    conditioning = tuple(tuple(t) for t in state["dac"])
    pos = _decode_scan(data, read.pos, body, frame, tables, qtables, state["latched"],
                       state["restart"], native, conditioning, in_blocks)
    frame["one_pass"] = frame["one_pass"] or (
        not frame["scans_read"] and all(frame["seen"]) and not frame["progressive"])
    frame["scans_read"] += 1
    return pos


def _frame_marker(marker: int, body: bytes, state: dict, pos: int) -> int:
    """An SOF segment's frame into ``state["frame"]``; returns ``pos``."""
    if marker in _UNSUPPORTED_SOF:
        raise ValueError(f"{_UNSUPPORTED_SOF[marker]} JPEG files are not supported")
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
    if any(not 1 <= c[1] <= 4 or not 1 <= c[2] <= 4 for c in comps):
        raise ValueError(f"corrupt JPEG file: sampling factors {[c[1:3] for c in comps]}")
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    if marker in _LOSSLESS_SOF:
        state["frame"] = _lossless_frame(height, width, comps)
        return pos
    if any((hmax // c[1], vmax // c[2]) not in ((1, 1), (2, 1), (1, 2), (2, 2))
           or hmax % c[1] or vmax % c[2] for c in comps):
        raise ValueError(f"JPEG sampling factors {[c[1:3] for c in comps]} are not supported")
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    # Every component's blocks in one buffer, zigzag order.
    shapes = [(mcuy * c[2], mcux * c[1], 64) for c in comps]
    bases = np.cumsum([0] + [int(np.prod(shape)) for shape in shapes])
    coef = np.zeros(int(bases[-1]), np.int64)
    state["frame"] = {
        "height": height, "width": width, "comps": comps, "hmax": hmax, "vmax": vmax,
        "mcux": mcux, "mcuy": mcuy, "imcu_rows": mcuy, "scans_read": 0, "one_pass": False,
        "progressive": marker in _PROGRESSIVE_SOF, "arithmetic": marker in _ARITHMETIC_SOF,
        "coef_all": coef, "coef_base": [int(b) for b in bases[:-1]],
        "coef": [coef[b:b + int(np.prod(shape))].reshape(shape) for b, shape in zip(bases, shapes)],
        "seen": [False] * nf, "lossless": False,
        # jdphuff.c's progression bookkeeping, which block smoothing reads.
        "scans": 0, "coef_bits": np.full((nf, 64), -1, np.int64),
        "prev_bits": np.zeros((nf, 64), np.int64), "last_good_row": mcuy - 1}
    return pos


def _decode_scan(data: bytes, pos: int, body: bytes, frame: dict, tables: dict, qtables: dict,
                 latched: dict, restart: int, native: bool, conditioning: tuple,
                 in_blocks: bool = False) -> int:
    """Decode one scan into ``frame["coef"]`` (in C when ``native``); returns
    the position of the marker after its data. ``tables``: (class, id) ->
    (counts, symbols) of each Huffman table defined so far; ``conditioning``:
    the arithmetic coder's DAC values in force."""
    ns = body[0]
    ids = [c[0] for c in frame["comps"]]
    members = []
    for j in range(ns):
        cid, selectors = body[1 + 2 * j], body[2 + 2 * j]
        if cid not in ids:
            raise ValueError("corrupt JPEG file: a scan of an unknown component")
        members.append((ids.index(cid), selectors >> 4, selectors & 15))
    ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
    if ns > 1 and sum(frame["comps"][ci][1] * frame["comps"][ci][2] for ci, _, _ in members) > 10:
        # jdinput.c's per_scan_setup: at most 10 blocks an MCU (JERR_BAD_MCU_SIZE).
        raise ValueError("corrupt JPEG file: an interleaved scan of over 10 blocks an MCU")
    if frame["lossless"]:
        return _decode_lossless_scan(data, pos, members, (ss, se, ahl >> 4, ahl & 15), frame,
                                     tables, restart, native)
    progressive = frame["progressive"]
    if not progressive and (ss, se, ahl) != (0, 63, 0):
        raise ValueError("corrupt JPEG file: a spectral selection in a sequential scan")
    if progressive and (se > 63 or ss > se or (ss == 0) != (se == 0)
                        or (ss > 0 and ns != 1)):
        raise ValueError(f"corrupt JPEG file: a progressive scan of {ss}-{se} over {ns} "
                         "components")
    arithmetic = frame["arithmetic"]
    if progressive and ((ahl >> 4 and ahl & 15 != (ahl >> 4) - 1) or ahl & 15 > 13):
        # jdphuff.c's and jdarith.c's start_pass: a refinement's Al is its Ah
        # less one, Al <= 13.
        raise ValueError(f"corrupt JPEG file: a progressive scan with Ah {ahl >> 4}, Al "
                         f"{ahl & 15}")
    if not progressive and not arithmetic:
        # jdhuff.c fills table slots 0 and 1 that no DHT defined with the
        # standard tables (Motion JPEG's); jdphuff.c does not.
        for key in ((0, 0), (0, 1), (1, 0), (1, 1)):
            tables.setdefault(key, _STD_HUFFMAN[key])
    for ci, td, ta in members:
        # The Huffman tables the scan reads: DC for a first DC scan, AC for an
        # AC scan (an arithmetic scan's conditioning tables all have defaults).
        dc_read = not progressive or (ss == 0 and ahl >> 4 == 0)
        ac_read = not progressive or ss > 0
        if not arithmetic and (
                (0, td) not in tables and dc_read or (1, ta) not in tables and ac_read):
            raise ValueError("corrupt JPEG file: a scan names a Huffman table never defined")
        if not arithmetic and dc_read:
            _check_table(*tables[0, td], dc_max=15)
        if not arithmetic and ac_read:
            _check_table(*tables[1, ta], dc_max=None)
        if ci not in latched:
            tq = frame["comps"][ci][3]
            if tq not in qtables:
                raise ValueError("corrupt JPEG file: a component's DQT table is missing")
            latched[ci] = qtables[tq]
    spectral = (ss, se, ahl >> 4, ahl & 15)
    if progressive:
        _progression(frame, members, spectral)
    if arithmetic:
        scan = _scan_spans(data, pos, _intervals(frame, members, restart), reach=True)
        decode = _native_arith_scan if native else _decode_arith_scan
        fetched = decode(scan, members, spectral, frame, conditioning, restart)
        if in_blocks:
            _check_pillow_blocks(pos, scan, fetched)
        frame["last_good_row"] = frame["imcu_rows"] - 1  # jdarith.c never runs short
        frame["scan_end"] = scan["end"]
    elif native:
        _native_scan(data, pos, members, spectral, frame, tables, restart)
    elif progressive:
        luts = {key: _decode_lut(key[0], *table) for key, table in tables.items()}
        _decode_progressive_scan(data, pos, members, spectral, frame, luts, restart)
    else:
        _decode_sequential_scan(data, pos, members, frame, tables, restart)
    for ci, _, _ in members:
        frame["seen"][ci] = True
    return frame["scan_end"]


def _blocks_of(frame: dict, ci: int) -> tuple[int, int]:
    """Component ``ci``'s blocks across and down that hold image samples
    (a non-interleaved scan's MCUs)."""
    _, h, v, _ = frame["comps"][ci]
    return (-(-(-(-frame["width"] * h // frame["hmax"])) // 8),
            -(-(-(-frame["height"] * v // frame["vmax"])) // 8))


def _intervals(frame: dict, members: list, restart: int) -> int:
    """The restart intervals of a scan (one without a restart interval)."""
    if len(members) == 1:  # one block an MCU, the component's own grid
        across, down = _blocks_of(frame, members[0][0])
        n_mcus = across * down
    else:
        n_mcus = frame["mcux"] * frame["mcuy"]
    return -(-n_mcus // restart) if restart else 1


def _progression(frame: dict, members: list, spectral: tuple) -> None:
    """jdphuff.c's start_pass bookkeeping, which block smoothing reads: each
    component's coef_bits (the low bits still unknown of each coefficient,
    -1 never scanned) and, for coefficients 1-9, their values when the
    component's last scan started (0 in the file's first scan)."""
    ss, se, _, al = spectral
    for ci, _, _ in members:
        bits, prev = frame["coef_bits"][ci], frame["prev_bits"][ci]
        span = slice(min(ss, 1), max(se, 9) + 1)
        prev[span] = bits[span] if frame["scans"] else 0
        bits[ss:se + 1] = al
    frame["scans"] += 1


def _mcu_row(frame: dict, members: list, mcu: int) -> int:
    """The iMCU row (a row of the frame's MCUs) of a scan's MCU ``mcu``."""
    if len(members) > 1:
        return mcu // frame["mcux"]
    ci = members[0][0]
    return mcu // _blocks_of(frame, ci)[0] // frame["comps"][ci][2]


def _decode_sequential_scan(data: bytes, pos: int, members: list, frame: dict, tables: dict,
                            restart: int) -> None:
    """The plain version of a sequential Huffman scan (``tdt_jpeg_scan``):
    each restart interval's MCUs from its data (``_decode_segment``); once
    an interval's bits run out, its later MCUs stay as they are."""
    luts = {key: _decode_lut(key[0], *table) for key, table in tables.items()}
    comps = frame["comps"]
    if len(members) == 1:  # non-interleaved: one block an MCU, the component's own blocks
        ci = members[0][0]
        bw, bh = _blocks_of(frame, ci)
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
    per = restart or n_mcus
    scan = _scan_spans(data, pos, -(-n_mcus // per))
    done, short = 0, False
    for seg, flags in _segments(scan):
        count = min(per, n_mcus - done)
        short = short and not flags & SPAN_FRESH
        if not short:
            dc_diff, ac, kinds, decoded, short = _decode_segment(seg, plan, count, luts)
            if short and flags & SPAN_OPEN:
                raise ValueError("truncated JPEG file")
            mcu = done + np.arange(decoded).repeat(len(plan))
            for kind, (ci, place) in enumerate(where):
                sel = kinds == kind
                rows, cols = place(mcu[sel])
                coef = frame["coef"][ci]
                # DC predictions restart at 0 in each interval, per component.
                same = [k for k, (cj, _) in enumerate(where) if cj == ci]
                comp_blocks = np.isin(kinds, same)
                dc = np.cumsum(dc_diff[comp_blocks])[np.nonzero(sel[comp_blocks])[0]]
                coef[rows, cols, 0] = _w16(dc)
                mine = sel[ac[:, 0]]
                blk = ac[mine, 0]
                index = np.searchsorted(np.nonzero(sel)[0], blk)
                coef[rows[index], cols[index], ac[mine, 1]] = ac[mine, 2]
        done += count
    frame["scan_end"] = scan["end"]


_SCAN_ERRORS = {_native.ERR_TRUNCATED: "truncated JPEG file",
                _native.ERR_CODE: "corrupt JPEG data: a lossless difference of over 16 bits"}


def _scan_geometry(frame: dict, members: list, spectral: tuple, restart: int,
                   slots: list) -> np.ndarray:
    """``tdt_jpeg_scan``'s and ``tdt_jpeg_arith_scan``'s geom of a scan:
    its MCUs, then each member's component, place and tables (``slots``:
    a (DC, AC) pair a member, -1 for a table the scan does not read)."""
    comps = frame["comps"]
    if len(members) == 1:  # one block an MCU, the component's own grid
        ci = members[0][0]
        across, down = _blocks_of(frame, ci)
        n_mcus, shape = across * down, {ci: (1, 1)}
    else:
        across, n_mcus = frame["mcux"], frame["mcux"] * frame["mcuy"]
        shape = {ci: (comps[ci][1], comps[ci][2]) for ci, _, _ in members}
    geom = [n_mcus, restart or n_mcus, len(members), across, int(frame["progressive"]),
            *spectral]
    for (ci, _, _), pair in zip(members, slots):
        geom += [ci, frame["coef_base"][ci], frame["coef"][ci].shape[1], *shape[ci], *pair]
    return np.asarray(geom, np.int64)


def _native_scan(data: bytes, pos: int, members: list, spectral: tuple, frame: dict,
                 tables: dict, restart: int) -> None:
    """One scan through the C library's ``tdt_jpeg_scan``: what
    ``_decode_progressive_scan`` and ``_decode_sequential_scan`` compute,
    into the same ``frame["coef"]``."""
    ss, se, ah, al = spectral
    progressive = frame["progressive"]
    # The tables each kind of scan reads; a progressive DC scan reads a
    # component's table from its last member, as the plain version does.
    last_dc = {ci: td for ci, td, _ in members}
    keys, slots = [], []
    for ci, td, ta in members:
        dc = (0, last_dc[ci] if progressive else td) if not progressive or (
            ss == 0 and ah == 0) else None
        ac = (1, ta) if not progressive or ss > 0 else None
        pair = []
        for key in (dc, ac):
            if key is not None and key not in keys:
                keys.append(key)
            pair.append(-1 if key is None else keys.index(key))
        slots.append(pair)
    geom = _scan_geometry(frame, members, spectral, restart, slots)
    luts = (np.stack([_packed_lut(*tables[key]) for key in keys]) if keys
            else np.zeros((1, 1 << 16), np.uint16))
    scan = _scan_spans(data, pos, -(-int(geom[0]) // int(geom[1])))
    buf, spans = scan["buf"], scan["spans"]
    coef = frame["coef_all"]
    last_good = np.zeros(1, np.int64)
    rc = _native.library().tdt_jpeg_scan(
        _native.ptr(buf), len(buf), _native.ptr(spans), len(spans), _native.ptr(luts), len(keys),
        _native.ptr(geom), len(geom), _native.ptr(coef), len(coef), _native.ptr(last_good))
    _native.check(rc, "JPEG", _SCAN_ERRORS)
    frame["last_good_row"] = _mcu_row(frame, members, int(last_good[0]))
    frame["scan_end"] = scan["end"]


def _scan_blocks(frame: dict, members: list) -> tuple[list, list]:
    """The blocks of a scan in coding order, as (component, flat offset of
    the block's 64 coefficients in ``frame["coef"][component]``), one list an
    MCU: a non-interleaved scan's MCU is one block of the component's own
    grid, an interleaved scan's the h x v blocks of each component in turn."""
    comps, mcux = frame["comps"], frame["mcux"]
    if len(members) == 1:
        ci = members[0][0]
        cols = frame["coef"][ci].shape[1]
        bw, bh = _blocks_of(frame, ci)
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


def _windows(seg: np.ndarray) -> list:
    """The 16 bits from each bit position of ``seg`` on, zeros past its end,
    as a list: one entry per position to one past the end, then enough
    zeros for what a decoder reads between two of its clamps to that
    position (a symbol, its extra bits and a refinement's correction bits)."""
    nbits = 8 * len(seg)
    padded = np.concatenate([seg, np.zeros(5, np.uint8)]).astype(np.int64)
    at = np.arange(nbits + 1)
    i = at >> 3
    win = ((padded[i] << 16 | padded[i + 1] << 8 | padded[i + 2]) >> (8 - (at & 7))) & 0xFFFF
    return win.tolist() + [0] * 256


def _decode_progressive_scan(data: bytes, pos: int, members: list, spectral: tuple,
                             frame: dict, luts: dict, restart: int) -> None:
    """Decode one progressive scan (``jdphuff.c``) into ``frame["coef"]``
    (zigzag order): a DC first scan (the difference's bits shifted up by
    ``al``), a DC refinement (one bit a block), an AC first scan (EOB runs
    of up to 32767 blocks) or an AC refinement (a correction bit for each
    coefficient already nonzero, new coefficients of +-1 << ``al``). Each
    restart interval starts with no EOB run and DC predictions of 0. Damaged
    data reads as libjpeg reads it: a bad code is symbol 0, a run past the
    block lands on its last coefficient, values are stored as 16-bit
    JCOEFs, and an interval whose bits run out finishes the MCU in hand from
    zero bits and leaves its later MCUs as they are."""
    ss, se, ah, al = spectral
    mcus, scanned = _scan_blocks(frame, members)
    flat = {ci: frame["coef"][ci].reshape(-1).tolist() for ci in scanned}
    dc_lut = {ci: [x.tolist() for x in luts[0, td][:2]] for ci, td, _ in members
              if ss == 0 and ah == 0}
    ac_lut = [x.tolist() for x in luts[1, members[0][2]][:2]] if ss > 0 else None
    p1, m1 = 1 << al, -1 << al
    per = restart or len(mcus)
    scan = _scan_spans(data, pos, -(-len(mcus) // per))
    short, last_good = False, 0
    for s, (seg, flags) in enumerate(_segments(scan)):
        short = short and not flags & SPAN_FRESH
        if short:
            continue
        nbits = 8 * len(seg)
        past = nbits + 1
        win = _windows(seg)
        p, eobrun, pred = 0, 0, dict.fromkeys(scanned, 0)
        for m in range(s * per, min((s + 1) * per, len(mcus))):
            if p > nbits:
                break
            last_good = m
            for ci, off in mcus[m]:
                coef = flat[ci]
                if p > nbits:
                    p = past
                if ss == 0 and ah == 0:  # DC first
                    sym, length = dc_lut[ci]
                    w = win[p]
                    s_, n = sym[w], length[w]
                    p += n
                    diff = 0
                    if s_:
                        diff = win[p] >> (16 - s_)
                        p += s_
                        if diff < 1 << (s_ - 1):
                            diff -= (1 << s_) - 1
                    pred[ci] += diff
                    coef[off] = _w16(pred[ci] << al)
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
                        if p > nbits:
                            p = past
                        w = win[p]
                        rs, n = sym[w], length[w]
                        p += n
                        r, s_ = rs >> 4, rs & 15
                        if s_:
                            k += r
                            v = win[p] >> (16 - s_)
                            p += s_
                            if v < 1 << (s_ - 1):
                                v -= (1 << s_) - 1
                            coef[off + min(k, 63)] = _w16(v << al)
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
                            if p > nbits:
                                p = past
                            w = win[p]
                            rs, n = sym[w], length[w]
                            p += n
                            r, s_ = rs >> 4, rs & 15
                            if s_:
                                s_ = p1 if win[p] >> 15 else m1
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
                                        coef[off + k] = _w16(c + (p1 if c >= 0 else m1))
                                    p += 1
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if s_:
                                coef[off + min(k, 63)] = s_
                            k += 1
                    if eobrun:
                        if p > nbits:
                            p = past
                        while k <= se:
                            c = coef[off + k]
                            if c:
                                if win[p] >> 15 and not c & p1:
                                    coef[off + k] = _w16(c + (p1 if c >= 0 else m1))
                                p += 1
                            k += 1
                        eobrun -= 1
        short = p > nbits
        if short and flags & SPAN_OPEN:
            raise ValueError("truncated JPEG file")
    for ci in scanned:
        frame["coef"][ci][...] = np.array(flat[ci], np.int64).reshape(frame["coef"][ci].shape)
    frame["last_good_row"] = _mcu_row(frame, members, last_good)
    frame["scan_end"] = scan["end"]


# --- arithmetic coding: T.81 Annex D's QM decoder, F.1.4.4 and G.1.3 (jdarith.c) ----

# Table D.2 (jaricom.c's jpeg_aritab): each state's Qe, its next state after
# an LPS and after an MPS, and whether an LPS switches the MPS sense. State
# 113 is T.851's fixed estimate of 0.5, which codes the signs of AC values and
# the refinement bits of DC and new AC coefficients.
_ARITH_STATES = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
)
# A statistics bin holds its state in bits 0-6 and the MPS in bit 7; an
# LPS's next state carries the switch in bit 7, as jaricom.c packs them.
_QE = tuple(s[0] for s in _ARITH_STATES)
_NEXT_LPS = tuple(s[1] | s[3] << 7 for s in _ARITH_STATES)
_NEXT_MPS = tuple(s[2] for s in _ARITH_STATES)
ARITH_FIXED_STATE = 113
# Statistics bins a DC and an AC conditioning table (jdarith.c), and DAC's
# defaults (L, U for DC; Kx for AC).
_DC_BINS, _AC_BINS = 64, 256
ARITH_DEFAULTS = (0, 1, 5)


class _ArithDecoder:
    """jdarith.c's ``arith_decode`` over one restart segment (unstuffed): the
    C and A registers and the bit counter CT, two bytes read first. Past the
    segment's end it reads zeros, as libjpeg does once it meets the marker
    that ends the segment; where the file itself ends there (``open_end``)
    a read past it is the truncation libjpeg cannot suspend over."""

    def __init__(self, seg: np.ndarray, open_end: bool):
        self.seg, self.n, self.pos, self.open_end = seg.tolist(), len(seg), 0, open_end
        self.c, self.a, self.ct = 0, 0, -16

    def __call__(self, stats: list, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:  # renormalization and data input, D.2.6
            ct -= 1
            if ct < 0:
                if self.pos < self.n:
                    byte = self.seg[self.pos]
                elif self.open_end:
                    raise ValueError("truncated JPEG file")
                else:
                    byte = 0
                self.pos += 1
                c = c << 8 | byte
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:  # the two first bytes read
                        a = 0x8000
            a <<= 1
        sv = stats[i]
        qe = _QE[sv & 127]
        a -= qe
        temp = a << ct
        if c >= temp:  # D.2.4 and D.2.5, with the conditional exchanges
            c -= temp
            if a < qe:
                stats[i] = (sv & 128) ^ _NEXT_MPS[sv & 127]
            else:
                stats[i] = (sv & 128) ^ _NEXT_LPS[sv & 127]
                sv ^= 128
            a = qe
        elif a < 0x8000:
            if a < qe:
                stats[i] = (sv & 128) ^ _NEXT_LPS[sv & 127]
                sv ^= 128
            else:
                stats[i] = (sv & 128) ^ _NEXT_MPS[sv & 127]
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


class _ArithStop(Exception):
    """jdarith.c's JWRN_ARITH_BAD_CODE (a magnitude past 15 bits, or a
    coefficient past the band): a warning, after which the decoder does
    nothing until the next restart (its ``ct = -1``)."""


def _arith_dc(dec, stats: list, context: list, j: int, lower: int, upper: int) -> int:
    """A DC difference (F.1.4.4.1, Figures F.19 and F.21-F.24), from the bins
    of ``stats`` at the member's conditioning ``context[j]``, which it then
    sets by the difference's size against ``(1 << L) >> 1`` and ``(1 << U) >> 1``."""
    st = context[j]
    if not dec(stats, st):
        context[j] = 0
        return 0
    sign = dec(stats, st + 1)
    st += 2 + sign
    m = dec(stats, st)
    if m:
        st = 20
        while dec(stats, st):
            m <<= 1
            if m == 0x8000:
                raise _ArithStop
            st += 1
    context[j] = 0 if m < (1 << lower) >> 1 else (12 if m > (1 << upper) >> 1 else 4) + 4 * sign
    v = m
    st += 14
    m >>= 1
    while m:
        if dec(stats, st):
            v |= m
        m >>= 1
    return -(v + 1) if sign else v + 1


def _arith_ac(dec, stats: list, fixed: list, st: int, k: int, kx: int) -> int:
    """An AC value (F.1.4.4.2, Figures F.21-F.24) whose nonzero decision was
    read at bin ``st``: the sign at the fixed estimate, the magnitude's
    category from ``st + 2`` and then bin 189 (k <= Kx) or 217, its bits."""
    sign = dec(fixed, 0)
    st += 2
    m = dec(stats, st)
    if m and dec(stats, st):
        m <<= 1
        st = 189 if k <= kx else 217
        while dec(stats, st):
            m <<= 1
            if m == 0x8000:
                raise _ArithStop
            st += 1
    v = m
    st += 14
    m >>= 1
    while m:
        if dec(stats, st):
            v |= m
        m >>= 1
    return -(v + 1) if sign else v + 1


def _decode_arith_scan(scan: dict, members: list, spectral: tuple, frame: dict,
                       conditioning: tuple, restart: int) -> list[int]:
    """Decode one arithmetic-coded scan (``jdarith.c``) from its restart
    intervals (``_scan_spans``) into ``frame["coef"]`` (zigzag order):
    sequential (DC and AC of each block), or one of the four progressive
    kinds (DC first, DC refinement, AC first, AC refinement). Each scan and
    each restart segment starts with zeroed statistics of the tables it
    reads, DC predictions and conditioning of 0 and two fresh bytes in the
    decoder. ``conditioning``: the DAC values, (L of each of the 16 DC
    tables, U of each, Kx of each AC table). A bad code (``_ArithStop``)
    ends its interval's decoding. Returns the bytes each interval's decoder
    asked for (past its length: it read the marker)."""
    ss, _, ah, _ = spectral
    progressive = frame["progressive"]
    mcus, scanned = _scan_blocks(frame, members)
    flat = {ci: frame["coef"][ci].reshape(-1).tolist() for ci in scanned}
    slot = {ci: j for j, (ci, _, _) in enumerate(members)}
    dc_of = {ci: td for ci, td, _ in members}
    ac_of = {ci: ta for ci, _, ta in members}
    reads_dc = not progressive or (ss == 0 and ah == 0)
    reads_ac = not progressive or ss > 0
    per = restart or len(mcus)
    fetched = []
    for s, (seg, flags) in enumerate(_segments(scan)):
        dec = _ArithDecoder(seg, bool(flags & SPAN_OPEN))
        dc_stats = {dc_of[ci]: [0] * _DC_BINS for ci in scanned} if reads_dc else {}
        ac_stats = {ac_of[ci]: [0] * _AC_BINS for ci in scanned} if reads_ac else {}
        fixed = [ARITH_FIXED_STATE]
        last_dc, context = [0] * len(members), [0] * len(members)
        try:
            _arith_interval(dec, mcus[s * per:(s + 1) * per], flat, slot, dc_of, ac_of,
                            dc_stats, ac_stats, fixed, last_dc, context, spectral,
                            progressive, conditioning)
        except _ArithStop:
            pass
        fetched.append(dec.pos)
    for ci in scanned:
        frame["coef"][ci][...] = np.array(flat[ci], np.int64).reshape(frame["coef"][ci].shape)
    return fetched


def _arith_interval(dec, mcus: list, flat: dict, slot: dict, dc_of: dict, ac_of: dict,
                    dc_stats: dict, ac_stats: dict, fixed: list, last_dc: list, context: list,
                    spectral: tuple, progressive: bool, conditioning: tuple) -> None:
    """The MCUs of one arithmetic-coded restart interval."""
    ss, se, ah, al = spectral
    lower, upper, kx = conditioning
    p1, m1 = 1 << al, -1 << al
    for mcu in mcus:
        for ci, off in mcu:
            coef, j = flat[ci], slot[ci]
            if not progressive or (ss == 0 and ah == 0):
                td = dc_of[ci]
                diff = _arith_dc(dec, dc_stats[td], context, j, lower[td], upper[td])
                last_dc[j] = (last_dc[j] + diff) & 0xFFFF
                coef[off] = _w16(last_dc[j] << al)
                if progressive:
                    continue
                stats, k = ac_stats[ac_of[ci]], 0
                while k < 63:
                    st = 3 * k
                    if dec(stats, st):
                        break
                    while True:
                        k += 1
                        if dec(stats, st + 1):
                            break
                        st += 3
                        if k >= 63:
                            raise _ArithStop
                    coef[off + k] = _w16(_arith_ac(dec, stats, fixed, st, k,
                                                      kx[ac_of[ci]]))
            elif ss == 0:  # DC refinement: the next bit of each DC value
                if dec(fixed, 0):
                    coef[off] |= p1
            elif ah == 0:  # AC first
                stats, k = ac_stats[ac_of[ci]], ss
                while k <= se:
                    st = 3 * (k - 1)
                    if dec(stats, st):
                        break
                    while not dec(stats, st + 1):
                        st += 3
                        k += 1
                        if k > se:
                            raise _ArithStop
                    coef[off + k] = _w16(
                        _arith_ac(dec, stats, fixed, st, k, kx[ac_of[ci]]) << al)
                    k += 1
            else:  # AC refinement: past the previous stage's last nonzero, EOB decisions
                stats, k, kex = ac_stats[ac_of[ci]], ss, se
                while kex > 0 and not coef[off + kex]:
                    kex -= 1
                while k <= se:
                    st = 3 * (k - 1)
                    if k > kex and dec(stats, st):
                        break
                    while True:
                        c = coef[off + k]
                        if c:  # a correction bit
                            if dec(stats, st + 2):
                                coef[off + k] = _w16(c + (m1 if c < 0 else p1))
                            break
                        if dec(stats, st + 1):  # newly nonzero
                            coef[off + k] = m1 if dec(fixed, 0) else p1
                            break
                        st += 3
                        k += 1
                        if k > se:
                            raise _ArithStop
                    k += 1


def _native_arith_scan(scan: dict, members: list, spectral: tuple, frame: dict,
                       conditioning: tuple, restart: int) -> list[int]:
    """One arithmetic-coded scan through the C library's
    ``tdt_jpeg_arith_scan``: what ``_decode_arith_scan`` computes, into the
    same ``frame["coef"]``, and the same bytes asked of each interval."""
    ss, _, ah, _ = spectral
    progressive = frame["progressive"]
    reads_dc = not progressive or (ss == 0 and ah == 0)
    reads_ac = not progressive or ss > 0
    slots = [(td if reads_dc else -1, ta if reads_ac else -1) for _, td, ta in members]
    geom = _scan_geometry(frame, members, spectral, restart, slots)
    buf, spans = scan["buf"], scan["spans"]
    cond = np.asarray([v for table in conditioning for v in table], np.int64)
    fetched = np.zeros(len(spans), np.int64)
    coef = frame["coef_all"]
    rc = _native.library().tdt_jpeg_arith_scan(
        _native.ptr(buf), len(buf), _native.ptr(spans), len(spans), _native.ptr(cond),
        _native.ptr(geom), len(geom), _native.ptr(coef), len(coef), _native.ptr(fetched))
    _native.check(rc, "JPEG", {_native.ERR_TRUNCATED: "truncated JPEG file"})
    return [int(n) for n in fetched]


# Pillow's ImageFile.MAXBLOCK: ``load()`` hands the JPEG decoder the file in
# blocks of this many bytes, a block more each time libjpeg suspends.
PILLOW_BLOCK = 65536


def _check_pillow_blocks(pos: int, scan: dict, fetched: list[int]) -> None:
    """Refuse an arithmetic-coded scan that Pillow refuses: libjpeg's
    arithmetic decoder cannot suspend for more data (``jdarith.c``'s
    ``get_byte``: JERR_CANT_SUSPEND), so a scan that reads past the end of
    the blocks Pillow has handed over when it starts fails with "broken data
    stream". The marker reader suspends: at a scan whose data starts at
    ``pos`` the blocks reach ``pos`` rounded up to a whole block. The scan
    reads each marker its restarts take or pass (``scan["restart_end"]``)
    and its last interval's bytes as far as its decoder asked (``fetched``;
    past them, the marker after them)."""
    blocks_end = max(PILLOW_BLOCK, -(-pos // PILLOW_BLOCK) * PILLOW_BLOCK)
    read_to = max(pos, scan["restart_end"])
    chunk, marker, n = scan["reach"][-1], scan["markers"][-1], fetched[-1]
    if chunk is not None and n > len(chunk[1]) and marker is not None:
        read_to = max(read_to, marker[2])
    elif chunk is not None and n:
        read_to = max(read_to, int(chunk[1][min(n, len(chunk[1])) - 1]))
    if read_to > blocks_end:
        raise ValueError(f"an arithmetic-coded JPEG scan that reads across byte {blocks_end}: "
                         "Pillow hands libjpeg the file in 64 KiB blocks, and the arithmetic "
                         "decoder cannot wait for the next one (Pillow refuses the file)")


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


_MODES = ("grey", "ycc", "rgb", "cmyk", "ycck")  # jpeg.c's colour modes, in order


def _color_mode(frame: dict, jfif: bool, adobe) -> str:
    """How the components become RGB. jdapimin.c's default_decompress_parms:
    one component is grey; four are CMYK, or YCCK where Adobe's transform
    flag says 2; three are YCbCr where JFIF says so, else by Adobe's flag,
    else RGB where the component ids are 'R', 'G', 'B'."""
    n = len(frame["comps"])
    if n == 1:
        return "grey"
    if n == 4:
        return "ycck" if adobe == 2 else "cmyk"
    ids = tuple(c[0] for c in frame["comps"])
    rgb = (not jfif) and (adobe == 0 if adobe is not None else ids == (82, 71, 66))
    return "rgb" if rgb else "ycc"


# jdcoefct.c's block smoothing: the natural position of zigzag coefficients
# 1-9, which it estimates from the DC values of the 5 x 5 blocks around.
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)
_K = np.array
# Each estimate's kernel over those DC values (rows up two to down two,
# columns left two to right two): with some AC data known (K.8 of T.81 on a
# 5 x 5 window), then with none (it also re-estimates the DC).
_SMOOTH_KERNELS = {
    False: [_K([[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-7, 50, 0, -50, 7], [0] * 5, [0] * 5]),
            _K([[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0] * 5, [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]]),
            _K([[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0],
                [0, 0, -1, 0, 0]]),
            _K([[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5, [1, -10, 0, 10, -1],
                [0, 1, 0, -1, 0]]),
            _K([[0] * 5, [0] * 5, [-1, 13, -24, 13, -1], [0] * 5, [0] * 5])],
    True: [_K([[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3],
               [-1, -1, 0, 1, 1]]),
           _K([[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0] * 5, [1, -13, -38, -13, 1],
               [1, 3, 3, 3, 1]]),
           _K([[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0],
               [0, 0, 1, 0, 0]]),
           _K([[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0] * 5, [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]]),
           _K([[0] * 5, [0, 2, -5, 2, 0], [1, 7, -14, 7, 1], [0, 2, -5, 2, 0], [0] * 5]),
           _K([[0] * 5, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], [0] * 5]),
           _K([[0] * 5, [0, 1, -3, 1, 0], [0] * 5, [0, -1, 3, -1, 0], [0] * 5]),
           _K([[0] * 5, [0, 1, 0, -1, 0], [0, -3, 0, 3, 0], [0, 1, 0, -1, 0], [0] * 5]),
           _K([[0] * 5, [0, 1, 2, 1, 0], [0] * 5, [0, -1, -2, -1, 0], [0] * 5]),
           _K([[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8],
               [-6, 6, 42, 6, -6], [-2, -6, -8, -6, -2]])],
}


def _smoothing(frame: dict, latched: dict) -> tuple | None:
    """jdcoefct.c's smoothing_ok: libjpeg smooths a progressive file's blocks
    when every component has its quantisation table and DC data, the table's
    DC and first 9 AC values are nonzero, and some coefficient 1-9 is still
    inexact (the file ended before its last scans). Returns each
    component's coef_bits for coefficients 0-9 and their values when its last
    scan started (-1 where the file has one scan), else None."""
    if not frame["progressive"]:
        return None
    bits = frame["coef_bits"][:, :10]
    for ci in range(len(frame["comps"])):
        if ci not in latched or bits[ci, 0] < 0:
            return None
        if not latched[ci].reshape(64)[[0, *_SMOOTH_POS]].all():
            return None
    if not bits[:, 1:].any():
        return None
    prev = frame["prev_bits"][:, :10] if frame["scans"] > 1 else np.full_like(bits, -1)
    return bits, prev


def _smoothed(frame: dict, latched: dict, latches: tuple) -> np.ndarray:
    """The coefficients libjpeg's decompress_smooth_data hands its IDCT: in
    each block, each coefficient 1-9 that is 0 and not exact estimated from
    the DC values around (``_SMOOTH_KERNELS``; rounded, and kept below
    1 << its coef_bits where those are over 0), and where no AC data is known
    at all, the DC too. Rows of iMCU rows past the last one its last scan
    decoded whole read the coef_bits from before that scan."""
    coef_all = frame["coef_all"].copy()
    rows_i = frame["imcu_rows"]
    for ci, (_, h, v, _) in enumerate(frame["comps"]):
        coef = coef_all[frame["coef_base"][ci]:][:frame["coef"][ci].size].reshape(
            frame["coef"][ci].shape)
        wb, hb = _blocks_of(frame, ci)
        dc = coef[..., 0].copy()
        r = np.arange(hb)
        imcu, br = r // v, r % v
        block_rows = np.where(imcu < rows_i - 1, v, hb % v or v)
        ibr, ibrs = imcu * block_rows + br, block_rows * rows_i
        up1 = np.where(ibr > 0, r - 1, r)
        up2 = np.where(ibr > 1, r - 2, up1)
        dn1 = np.where(ibr < ibrs - 1, r + 1, r)
        dn2 = np.where(ibr < ibrs - 2, r + 2, dn1)
        c = np.arange(wb)
        near_cols = [np.clip(c + d, 0, wb - 1) for d in range(-2, 3)]
        window = np.stack([np.stack([dc[rr][:, cc] for cc in near_cols], -1)
                           for rr in (up2, up1, r, dn1, dn2)], -2)  # (hb, wb, 5, 5)
        q = latched[ci].reshape(64).astype(np.int64)
        cur, prev = latches[0][ci], latches[1][ci]
        stale = (imcu > frame["last_good_row"])[:, None]
        for rows_bits, sel in ((cur, ~stale), (prev, stale)):
            change_dc = bool((rows_bits[1:] == -1).all())
            for j, kernel in enumerate(_SMOOTH_KERNELS[change_dc]):
                zz = j + 1 if j < 9 else 0
                pos = _SMOOTH_POS[j] if j < 9 else 0
                al = int(rows_bits[zz]) if zz else 0
                if zz and al == 0:
                    continue
                num = q[0] * (window * kernel).sum(axis=(-2, -1))
                qk = q[pos]
                pred = ((qk << 7) + np.abs(num)) // (qk << 8)
                if al > 0:
                    pred = np.minimum(pred, (1 << al) - 1)
                pred = np.where(num >= 0, pred, -pred)
                block = coef[:hb, :wb, zz]
                apply = sel & (block == 0) if zz else np.broadcast_to(sel, block.shape)
                coef[:hb, :wb, zz] = np.where(apply, _w16(pred), block)
    return coef_all


def _pixels(frame: dict, latched: dict, jfif: bool, adobe, native: bool,
            color: str | None = None) -> np.ndarray:
    """The inverse DCT, upsampling and colour conversion (``color``, else
    ``_color_mode``'s) of a decoded frame (in C, ``tdt_jpeg_pixels``, when
    ``native``), block smoothing first where libjpeg smooths (``_smoothing``).
    A component the file never scanned has no table latched, and libjpeg's
    IDCT multiplies it by zeros."""
    height, width = frame["height"], frame["width"]
    mode = color or _color_mode(frame, jfif, adobe)
    zero = np.zeros((8, 8), np.int64)
    latched = {ci: latched.get(ci, zero) for ci in range(len(frame["comps"]))}
    latches = _smoothing(frame, latched)
    coef_all = frame["coef_all"] if latches is None else _smoothed(frame, latched, latches)
    if native:
        geom = [height, width, frame["hmax"], frame["vmax"], len(frame["comps"]),
                _MODES.index(mode)]
        for ci, (_, h, v, _) in enumerate(frame["comps"]):
            geom += [frame["coef_base"][ci], *frame["coef"][ci].shape[:2], h, v]
        geom = np.asarray(geom, np.int64)
        qtables = np.stack([latched[ci].reshape(64) for ci in range(len(frame["comps"]))])
        qtables = np.ascontiguousarray(qtables, np.int64)
        rgb = np.empty((height, width, 3), np.uint8)
        _native.check(_native.library().tdt_jpeg_pixels(
            _native.ptr(coef_all), len(coef_all), _native.ptr(qtables), _native.ptr(geom),
            len(geom), _native.ptr(rgb), rgb.size), "JPEG")
        return rgb
    planes = []
    for ci, (cid, h, v, _) in enumerate(frame["comps"]):
        base = frame["coef_base"][ci]
        coef = coef_all[base:base + frame["coef"][ci].size].reshape(frame["coef"][ci].shape)
        natural = np.zeros_like(coef)
        natural[..., _ZIGZAG] = coef
        samples = _unblocks(_idct_islow(natural.reshape(*coef.shape[:2], 8, 8), latched[ci]))
        ph = -(-height * v // frame["vmax"])
        pw = -(-width * h // frame["hmax"])
        plane = _upsample(samples[:ph, :pw], frame["hmax"] // h, frame["vmax"] // v)
        planes.append(plane[:height, :width])
    if mode == "grey":
        return np.repeat(planes[0][..., None], 3, axis=-1).astype(np.uint8)
    if mode in ("cmyk", "ycck"):
        # jdcolor.c's ycck_cmyk_convert: 255 less the YCbCr-to-RGB sums,
        # clamped; K as it is.
        if mode == "ycck":
            rgb = _ycc_to_rgb_unclamped(*planes[:3])
            planes = [np.clip(255 - v, 0, 255) for v in rgb] + [planes[3]]
        return _cmyk_to_rgb(np.stack(planes, axis=-1))
    if mode == "rgb":
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


# --- lossless (SOF3: T.81 Annex H, as libjpeg-turbo 3 reads it) ----------------------


def _lossless_frame(height: int, width: int, comps: list) -> dict:
    """A lossless frame: each component's undifferenced samples in one int64
    buffer, a plane of (MCU rows x v) x (MCUs a row x h) samples each (an
    MCU is hmax x vmax pixels; a "block" is one sample). Sampling factors
    must divide the largest (libjpeg-turbo upsamples by whole factors)."""
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    if any(hmax % c[1] or vmax % c[2] for c in comps):
        raise ValueError(f"lossless JPEG sampling factors {[c[1:3] for c in comps]} are not "
                         "supported (libjpeg-turbo: fractional sampling)")
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    shapes = [(mcuy * c[2], mcux * c[1]) for c in comps]
    bases = np.cumsum([0] + [r * c for r, c in shapes])
    planes = np.zeros(int(bases[-1]), np.int64)
    return {"height": height, "width": width, "comps": comps, "hmax": hmax, "vmax": vmax,
            "mcux": mcux, "mcuy": mcuy, "scans_read": 0, "one_pass": False, "progressive": False,
            "arithmetic": False, "lossless": True, "plane_all": planes,
            "plane_base": [int(b) for b in bases[:-1]],
            "planes": [planes[b:b + r * c].reshape(r, c) for b, (r, c) in zip(bases, shapes)],
            "pt": [0] * len(comps), "seen": [False] * len(comps)}


def _lossless_geometry(frame: dict, members: list, spectral: tuple, restart: int,
                       slots: list) -> np.ndarray:
    """``tdt_jpeg_lossless_scan``'s geom of a scan (``slots``: each member's
    table index): a one-component scan is one sample an MCU over the
    component's own grid, its iMCU row v MCU rows; an interleaved one h x v
    samples a member, its iMCU row one MCU row."""
    ss, _, _, al = spectral
    comps = frame["comps"]
    sides = {ci: (-(-frame["width"] * comps[ci][1] // frame["hmax"]),
                  -(-frame["height"] * comps[ci][2] // frame["vmax"])) for ci, _, _ in members}
    if len(members) == 1:
        ci = members[0][0]
        mcux, n_mcus, shape = sides[ci][0], sides[ci][0] * sides[ci][1], {ci: (1, 1)}
        band = comps[ci][2]
    else:
        mcux, n_mcus = frame["mcux"], frame["mcux"] * frame["mcuy"]
        shape = {ci: comps[ci][1:3] for ci, _, _ in members}
        band = 1
    if restart % mcux:
        raise ValueError(f"a lossless JPEG restart interval of {restart} MCUs, not whole rows "
                         f"of {mcux} MCUs (libjpeg-turbo refuses it)")
    geom = [n_mcus, restart or n_mcus, len(members), mcux, ss, 1 << (7 - al), band]
    for (ci, _, _), slot in zip(members, slots):
        geom += [frame["plane_base"][ci], frame["planes"][ci].shape[1], *sides[ci], *shape[ci],
                 slot, comps[ci][2]]
    return np.asarray(geom, np.int64)


def _decode_lossless_scan(data: bytes, pos: int, members: list, spectral: tuple, frame: dict,
                          tables: dict, restart: int, native: bool) -> int:
    """One lossless scan into ``frame["planes"]`` (in C when ``native``,
    ``tdt_jpeg_lossless_scan``; else ``_lossless_reference``); returns the
    position of the marker after its data."""
    ss, se, ah, al = spectral
    if not 1 <= ss <= 7 or se != 0 or ah != 0 or al >= 8:
        raise ValueError(f"corrupt lossless JPEG file: a scan of predictor {ss}, Se {se}, Ah {ah}, "
                         f"Al {al}")
    keys = []
    for _, td, _ in members:
        if (0, td) not in tables:
            raise ValueError("corrupt JPEG file: a scan names a Huffman table never defined")
        _check_table(*tables[0, td], dc_max=16)
        if (0, td) not in keys:
            keys.append((0, td))
    slots = [keys.index((0, td)) for _, td, _ in members]
    geom = _lossless_geometry(frame, members, spectral, restart, slots)
    scan = _scan_spans(data, pos, -(-int(geom[0]) // int(geom[1])))
    buf, spans = scan["buf"], scan["spans"]
    if native:
        luts = np.stack([_packed_lut(*tables[key]) for key in keys])
        planes = frame["plane_all"]
        rc = _native.library().tdt_jpeg_lossless_scan(
            _native.ptr(buf), len(buf), _native.ptr(spans), len(spans), _native.ptr(luts),
            len(keys), _native.ptr(geom), len(geom), _native.ptr(planes), len(planes))
    else:
        rc = _lossless_reference(buf, spans, geom, [tables[key] for key in keys],
                                 frame["plane_all"])
    _native.check(rc, "JPEG", _SCAN_ERRORS)
    for ci, _, _ in members:
        frame["pt"][ci] = al
        frame["seen"][ci] = True
    return scan["end"]


def _lossless_reference(buf: np.ndarray, spans: np.ndarray, geom: np.ndarray, tables: list,
                        planes: np.ndarray) -> int:
    """The plain version of ``tdt_jpeg_lossless_scan`` (see data/csrc/jpeg.c),
    with its return codes: each MCU row's differences read a symbol at a
    time from a table of every 16-bit window, then undifferenced row by
    row."""
    g = [int(v) for v in geom]
    n_mcus, per, n_members, mcux, predictor, initial, band = g[:7]
    members = [g[7 + 8 * j:15 + 8 * j] for j in range(n_members)]
    luts = [_decode_lut(0, *table)[:2] for table in tables]
    mcu_rows = -(-n_mcus // mcux)
    diffs = [[0] * (mcu_rows * m[5] * mcux * m[4]) for m in members]
    resets, short = {0}, False  # the iMCU rows whose first rows restart the prediction
    for s, (a, b, flags) in enumerate(spans.tolist()):
        seg = buf[a:b]
        short = short and not flags & SPAN_FRESH
        nbits = 8 * len(seg)
        win = _windows(seg)
        pos = 0
        first = s * per // mcux
        resets.add(first // band)  # jddiffct.c's process_restart: the predictor too
        for row in range(first, min((s + 1) * per // mcux, mcu_rows)):
            if short:  # jdlhuff.c: zero differences, and the predictor reset
                resets.add(row // band)
                continue
            for mc in range(mcux):
                for m, diff in zip(members, diffs):
                    h, v, (sym, length) = m[4], m[5], luts[m[6]]
                    cols = mcux * h
                    for y in range(v):
                        at = (row * v + y) * cols + mc * h
                        for x in range(h):
                            if pos > nbits:
                                pos = nbits + 1
                            w = win[pos]
                            sv, n = sym[w], length[w]
                            pos += n
                            if sv == 16:
                                d = 32768
                            elif sv:
                                e = win[pos] >> (16 - sv)
                                d = e if e >= 1 << (sv - 1) else e - (1 << sv) + 1
                                pos += sv
                            else:
                                d = 0
                            diff[at + x] = d
            short = pos > nbits
            if short and flags & SPAN_OPEN:
                return _native.ERR_TRUNCATED
    for (base, stride, width, rows, h, v, _, vs), diff in zip(members, diffs):
        cols = mcux * h
        prev = None
        for r in range(rows):
            d = diff[r * cols:r * cols + width]
            out = [0] * width
            if r % vs == 0 and r // vs in resets:
                ra = initial
                for c in range(width):
                    out[c] = ra = (d[c] + ra) & 0xFFFF
            else:
                rb = prev[0]
                out[0] = ra = (d[0] + rb) & 0xFFFF
                for c in range(1, width):
                    rc, rb = rb, prev[c]
                    pred = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                            rb + ((ra - rc) >> 1), (ra + rb) >> 1)[predictor - 1]
                    out[c] = ra = (d[c] + pred) & 0xFFFF
            planes[base + r * stride:base + r * stride + width] = out
            prev = out
    return 0


def _lossless_pixels(frame: dict, jfif: bool, adobe, color: str | None) -> np.ndarray:
    """The RGB of a lossless frame: each component's samples shifted back by
    its point transform and kept to 8 bits (libjpeg-turbo's scaler), its
    planes replicated up to the image (lossless files get no fancy
    upsampling), and libjpeg-turbo's colour rules for lossless files, which
    convert no colour: 1 component is grey, 3 are RGB (JFIF or an Adobe
    transform flag other than 0 would ask YCbCr, and are refused, as Pillow
    refuses them), 4 are Pillow's inverted CMYK (YCCK refused)."""
    height, width, comps = frame["height"], frame["width"], frame["comps"]
    n = len(comps)
    if color is not None:
        mode = color
    elif n == 1:
        mode = "grey"
    elif n == 3:
        mode = "ycc" if jfif or adobe not in (None, 0) else "rgb"
    else:
        mode = "ycck" if adobe == 2 else "cmyk"
    if mode in ("ycc", "ycck"):
        raise ValueError(f"a lossless JPEG whose markers ask a {mode.upper()} to RGB conversion: "
                         "libjpeg-turbo converts no colour of a lossless file (Pillow refuses it)")
    planes = []
    for ci, (_, h, v, _) in enumerate(comps):
        cw = -(-width * h // frame["hmax"])
        ch = -(-height * v // frame["vmax"])
        samples = ((frame["planes"][ci][:ch, :cw] << frame["pt"][ci]) & 0xFF).astype(np.uint8)
        samples = samples.repeat(frame["vmax"] // v, axis=0).repeat(frame["hmax"] // h, axis=1)
        planes.append(samples[:height, :width])
    if mode == "grey":
        return np.repeat(planes[0][..., None], 3, axis=-1)
    if mode == "cmyk":
        return _cmyk_to_rgb(np.stack(planes, axis=-1))
    return np.stack(planes, axis=-1)
