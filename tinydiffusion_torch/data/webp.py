"""WebP decode, as ``Image.open(f).convert("RGB")`` gives it.

JAX's LAION loader reads every web image with Pillow, whose WebP reader is
libwebp's animation decoder (``WebPAnimDecoder``, RGBA). The port reads WebP
here, with libwebp's integer arithmetic:

- the RIFF container: a simple ``VP8 `` or ``VP8L`` file, or ``VP8X`` with
  its canvas, where an ``ALPH`` chunk's alpha is dropped (``convert("RGB")``)
  and an animation is read at its first frame, placed at its offset on a
  canvas of zeros (the first frame is a key frame: no blending);
- VP8L, lossless (``vp8l_dec.c``): prefix codes read LSB first (simple and
  normal codes, code-length codes and their repeats), meta prefix codes by
  tiles, LZ77 copies with the 120-entry distance map, the colour cache, and
  the four transforms undone in reverse order (predictor with its 14 modes,
  cross colour, subtract green, colour indexing with packed pixels);
- VP8, lossy, one key frame (``vp8_dec.c``, ``tree_dec.c``, ``quant_dec.c``,
  ``frame_dec.c``, ``dsp/dec.c``): the boolean decoder as libwebp reads it
  (``VP8GetBit``, and ``VP8GetSigned``'s fixed one-bit shift), segments,
  the coefficient probabilities and their updates, the intra modes (16x16,
  4x4 with their context probabilities, chroma), the tokens with their
  contexts, dequantisation, the Walsh-Hadamard and inverse DCT transforms,
  the predictions from unfiltered neighbours (127 above the frame, 129 to
  its left), then the simple or normal loop filter macroblock by macroblock,
  and the RGB of libwebp's default output: the "fancy" chroma upsampling
  (``upsampling.c``) and its 14-bit YUV to RGB (``yuv.h``).

The constant tables are RFC 6386's (sections 9.6, 13.4, 13.5 and 14.1) and
RFC 9649's distance map. Truncated or corrupt files raise ``ValueError``.

``decode_webp`` reads the container here and decodes each frame in C
(``data/csrc/vp8.c``, ``vp8l.c``), step for step what
``decode_webp_reference`` does in Python and numpy.
"""

from __future__ import annotations

import numpy as np

from tinydiffusion_torch.data import native as _native

_DC_TABLE = [
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
]
_AC_TABLE = [
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
]
_COEF_UPDATE = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffff"
    "dff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefeffffffffffffffff"
    "fdfffffffffffffffffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfeffffffffffffffff"
    "fbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffff"
    "dffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefeffffffffffffffff"
    "fdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffff"
    "ecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffff"
    "fffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffffffffffff"
    "f6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdffffffffffffffff"
    "fdfffefefffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcffffffffffffffffff"
    "f9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
_COEF_DEFAULT = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080"
    "bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a808080"
    "4e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080"
    "cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae18080808080"
    "5081d3ffc2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080"
    "b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb8080808080"
    "7c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff808080"
    "2d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080"
    "ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080"
    "452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080"
    "375dff8080808080808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80"
    "a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80"
    "184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080"
    "a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caffdb808080"
    "2a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
_BMODE_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150a"
    "ad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d"
    "102486b7598962656aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a6"
    "31179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5"
    "bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab"
    "3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e"
    "5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b"
    "1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206"
    "df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a"
    "2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab013911054766"
    "3935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a66"
    "66d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db78016"
    "1a1183f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b76927480"
    "5538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151"
    "bc4020291475978e1415a370130c3dc380300418")
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c58454b343c035759131d"
    "565a232d444c555b333d68026769121e666a222e545c434d656b323e78017779535d111f646c424e767a212f"
    "757b313f636d525e00747c414f1020626e30737d515f40727e616f50717f6070")


def _u24(data: bytes, pos: int) -> int:
    return int.from_bytes(data[pos:pos + 3], "little")


def _chunks(data: bytes, start: int, end: int):
    """(fourcc, body) of each RIFF chunk in ``data[start:end]`` (bodies padded
    to an even length)."""
    pos = start
    while pos + 8 <= end:
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        body = data[pos + 8:pos + 8 + size]
        if len(body) < size:
            raise ValueError("truncated WebP file")
        yield data[pos:pos + 4], body
        pos += 8 + size + (size & 1)


def decode_webp(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a WebP file (its first frame), as Pillow
    12.1's ``Image.open(f).convert("RGB")`` gives it; each VP8 or VP8L frame
    decoded by the C library (``data/csrc/vp8.c``, ``vp8l.c``, built at the
    first call)."""
    return _decode(data, native=True)


def decode_webp_reference(data: bytes) -> np.ndarray:
    """The plain version of ``decode_webp``: its frames decoded in Python and
    numpy. The tests and ``chip_smoke.py`` hold the C library to it."""
    return _decode(data, native=False)


def _decode(data: bytes, native: bool) -> np.ndarray:
    try:
        return _decode_container(bytes(data), native)
    except IndexError as e:  # a bit stream read past its end
        raise ValueError("truncated WebP file") from e


def _decode_container(data: bytes, native: bool) -> np.ndarray:
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    end = min(len(data), 8 + int.from_bytes(data[4:8], "little"))
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise ValueError("truncated WebP file")
    kind, body = chunks[0]
    if kind in (b"VP8 ", b"VP8L"):
        return _decode_frame(kind, body, native)
    if kind != b"VP8X" or len(body) < 10:
        raise ValueError(f"corrupt WebP file: a first chunk {kind!r}")
    width, height = _u24(body, 4) + 1, _u24(body, 7) + 1
    canvas = np.zeros((height, width, 3), np.uint8)
    for kind, sub in chunks[1:]:
        if kind in (b"VP8 ", b"VP8L"):  # a still image: the whole canvas
            frame = _decode_frame(kind, sub, native)
            if frame.shape[:2] != (height, width):
                raise ValueError("corrupt WebP file: the image is not the canvas's size")
            return frame
        if kind == b"ANMF" and len(sub) >= 16:  # the first frame of an animation
            x0, y0 = 2 * _u24(sub, 0), 2 * _u24(sub, 3)
            w, h = _u24(sub, 6) + 1, _u24(sub, 9) + 1
            for inner, frame_data in _chunks(sub, 16, len(sub)):
                if inner in (b"VP8 ", b"VP8L"):
                    frame = _decode_frame(inner, frame_data, native)
                    if frame.shape[:2] != (h, w) or x0 + w > width or y0 + h > height:
                        raise ValueError("corrupt WebP file: a frame outside the canvas")
                    canvas[y0:y0 + h, x0:x0 + w] = frame
                    return canvas
            raise ValueError("corrupt WebP file: a frame without an image")
    raise ValueError("corrupt WebP file: no image")


def _native_frame(kind: bytes, body: bytes) -> np.ndarray:
    """A VP8L or VP8 frame through ``tdt_vp8l_decode`` or ``tdt_vp8_decode``:
    the RGB allocated here from the header's size."""
    if kind == b"VP8L":
        if len(body) < 5 or body[0] != 0x2F:
            raise ValueError("corrupt WebP (VP8L) data: no signature")
        bits = int.from_bytes(body[1:5], "little")
        width, height = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
        fn, fmt = _native.library().tdt_vp8l_decode, "WebP (VP8L)"
    else:
        if len(body) < 10:
            raise ValueError("truncated WebP (VP8) data")
        width = int.from_bytes(body[6:8], "little") & 0x3FFF
        height = int.from_bytes(body[8:10], "little") & 0x3FFF
        fn, fmt = _native.library().tdt_vp8_decode, "WebP (VP8)"
    src = np.frombuffer(body, np.uint8)
    rgb = np.empty((max(height, 1), max(width, 1), 3), np.uint8)
    _native.check(fn(_native.ptr(src), len(body), _native.ptr(rgb), width, height), fmt)
    return rgb


def _decode_frame(kind: bytes, body: bytes, native: bool) -> np.ndarray:
    if native:
        return _native_frame(kind, body)
    if kind == b"VP8L":
        argb = _vp8l_decode(body)
        return np.stack([(argb >> 16) & 255, (argb >> 8) & 255, argb & 255],
                        axis=-1).astype(np.uint8)
    return _vp8_decode(body)


# --- VP8L, lossless --------------------------------------------------------------

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_MAX_CACHE_BITS = 11


class _LosslessBits:
    """The VP8L bit stream, least-significant bit first: ``win[i]`` holds the
    64 bits from byte i, so any read of up to 56 bits is one lookup."""

    def __init__(self, data: bytes):
        raw = np.frombuffer(data + bytes(16), np.uint8).astype(np.uint64)
        n = len(data) + 1
        win = np.zeros(n, np.uint64)
        for k in range(8):
            win |= raw[k:n + k] << np.uint64(8 * k)
        self.win = win.tolist()
        self.nbits = 8 * len(data)
        self.pos = 0

    def read(self, n: int) -> int:
        p = self.pos
        if p + n > self.nbits:
            raise ValueError("truncated WebP (VP8L) data")
        self.pos = p + n
        return (self.win[p >> 3] >> (p & 7)) & ((1 << n) - 1)


def _prefix_table(lengths: list) -> tuple[list, int]:
    """A lookup table of a canonical prefix code, indexed by its next ``bits``
    stream bits (the code's first bit lowest): ``symbol << 4 | length``. A
    code of one symbol reads no bits. Raises on codes that are not complete."""
    lengths = np.asarray(lengths, np.int64)
    used = np.nonzero(lengths)[0]
    if len(used) == 0:
        raise ValueError("corrupt WebP (VP8L) data: an empty prefix code")
    if len(used) == 1:
        return [int(used[0]) << 4], 0
    bits = int(lengths.max())
    if (np.ldexp(1.0, -lengths[used])).sum() != 1.0:
        raise ValueError("corrupt WebP (VP8L) data: an incomplete prefix code")
    table = np.zeros(1 << bits, np.int64)
    code = 0
    for length in range(1, bits + 1):
        syms = np.nonzero(lengths == length)[0]
        codes = code + np.arange(len(syms))
        code = (code + len(syms)) << 1
        rev = np.zeros(len(syms), np.int64)
        for b in range(length):
            rev |= ((codes >> b) & 1) << (length - 1 - b)
        idx = rev[:, None] + (np.arange(1 << (bits - length)) << length)[None, :]
        table[idx] = (syms << 4 | length)[:, None]
    return table.tolist(), bits


def _read_symbol(br: _LosslessBits, code: tuple) -> int:
    table, bits = code
    p = br.pos
    v = table[(br.win[p >> 3] >> (p & 7)) & ((1 << bits) - 1)]
    br.pos = p + (v & 15)
    if br.pos > br.nbits:
        raise ValueError("truncated WebP (VP8L) data")
    return v >> 4


def _read_code(br: _LosslessBits, alphabet: int) -> tuple:
    """One prefix code (``ReadHuffmanCode``): simple (one or two symbols of
    length 1) or normal (code lengths coded by a code-length code)."""
    lengths = [0] * alphabet
    if br.read(1):
        count = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        symbols = [first] + ([br.read(8)] if count == 2 else [])
        for s in symbols:
            if s >= alphabet:
                raise ValueError("corrupt WebP (VP8L) data: a symbol past the alphabet")
            lengths[s] = 1
        return _prefix_table(lengths)
    cl_lengths = [0] * 19
    for i in range(br.read(4) + 4):
        cl_lengths[_CODE_LENGTH_ORDER[i]] = br.read(3)
    cl_code = _prefix_table(cl_lengths)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError("corrupt WebP (VP8L) data: too many code lengths")
    else:
        max_symbol = alphabet
    symbol, prev = 0, 8
    while symbol < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        length = _read_symbol(br, cl_code)
        if length < 16:
            lengths[symbol] = length
            symbol += 1
            if length:
                prev = length
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[length - 16]
        repeat = br.read(extra) + offset
        if symbol + repeat > alphabet:
            raise ValueError("corrupt WebP (VP8L) data: a code-length repeat past the end")
        lengths[symbol:symbol + repeat] = [prev if length == 16 else 0] * repeat
        symbol += repeat
    return _prefix_table(lengths)


def _sub_size(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _copy_length(br: _LosslessBits, symbol: int) -> int:
    """A length or distance prefix symbol and its extra bits."""
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _entropy_image(br: _LosslessBits, width: int, height: int, top: bool) -> list:
    """One entropy-coded image (``DecodeImageStream`` after its transforms):
    its colour cache, its prefix codes (by tiles of a meta image when ``top``)
    and its ARGB pixels, a flat list."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= _MAX_CACHE_BITS:
            raise ValueError(f"corrupt WebP (VP8L) data: {cache_bits} colour cache bits")
    meta, meta_bits, meta_width = None, 0, 1
    if top and br.read(1):
        meta_bits = br.read(3) + 2
        meta_width = _sub_size(width, meta_bits)
        meta = [(p >> 8) & 0xFFFF
                for p in _entropy_image(br, meta_width, _sub_size(height, meta_bits), False)]
    n_groups = max(meta) + 1 if meta else 1
    green_size = 280 + ((1 << cache_bits) if cache_bits else 0)
    groups = [tuple(_read_code(br, size) for size in (green_size, 256, 256, 256, 40))
              for _ in range(n_groups)]
    total = width * height
    out = [0] * total
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cached = 0
    i = x = y = 0
    win, nbits = br.win, br.nbits
    while i < total:
        group = groups[meta[(y >> meta_bits) * meta_width + (x >> meta_bits)] if meta else 0]
        (gt, gb), (rt, rb), (bt, bb), (at, ab), dist_code = group
        p = br.pos
        v = gt[(win[p >> 3] >> (p & 7)) & ((1 << gb) - 1)]
        p += v & 15
        code = v >> 4
        if code < 256:
            v = rt[(win[p >> 3] >> (p & 7)) & ((1 << rb) - 1)]
            p += v & 15
            red = v >> 4
            v = bt[(win[p >> 3] >> (p & 7)) & ((1 << bb) - 1)]
            p += v & 15
            blue = v >> 4
            v = at[(win[p >> 3] >> (p & 7)) & ((1 << ab) - 1)]
            p += v & 15
            out[i] = (v >> 4) << 24 | red << 16 | code << 8 | blue
            br.pos = p
            i += 1
            x += 1
            if x == width:
                x, y = 0, y + 1
        elif code < 280:
            br.pos = p
            length = _copy_length(br, code - 256)
            plane = _copy_length(br, _read_symbol(br, dist_code))
            if plane > 120:
                dist = plane - 120
            else:
                c = _CODE_TO_PLANE[plane - 1]
                dist = max(1, (c >> 4) * width + 8 - (c & 15))
            if dist > i or i + length > total:
                raise ValueError("corrupt WebP (VP8L) data: a copy outside the image")
            if dist >= length:
                out[i:i + length] = out[i - dist:i - dist + length]
            else:
                for k in range(i, i + length):
                    out[k] = out[k - dist]
            i += length
            x += length
            y += x // width
            x %= width
        else:
            br.pos = p
            if cache is None or code - 280 >= len(cache):
                raise ValueError("corrupt WebP (VP8L) data: a colour cache code without a cache")
            for k in range(cached, i):
                cache[((0x1E35A7BD * out[k]) & 0xFFFFFFFF) >> shift] = out[k]
            cached = i
            out[i] = cache[code - 280]
            i += 1
            x += 1
            if x == width:
                x, y = 0, y + 1
        if br.pos > nbits:
            raise ValueError("truncated WebP (VP8L) data")
        if cache is not None and i - cached > 4096:
            for k in range(cached, i):
                cache[((0x1E35A7BD * out[k]) & 0xFFFFFFFF) >> shift] = out[k]
            cached = i
    return out


def _add(a: int, b: int) -> int:
    """Per-channel sum of two ARGB pixels, mod 256."""
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (
        ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clamp_add_sub_full(a: int, b: int, c: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        v = ((a >> s) & 255) + ((b >> s) & 255) - ((c >> s) & 255)
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _clamp_add_sub_half(a: int, b: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        ca, cb = (a >> s) & 255, (b >> s) & 255
        v = ca + int((ca - cb) / 2)  # C's division: toward zero
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _select(top: int, left: int, top_left: int) -> int:
    d = 0
    for s in (24, 16, 8, 0):
        t, l, c = (top >> s) & 255, (left >> s) & 255, (top_left >> s) & 255
        d += abs(l - c) - abs(t - c)
    return top if d <= 0 else left


def _predict(mode: int, left: int, top: int, top_right: int, top_left: int) -> int:
    if mode == 0:
        return 0xFF000000
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return top_right
    if mode == 4:
        return top_left
    if mode == 5:
        return _avg(_avg(left, top_right), top)
    if mode == 6:
        return _avg(left, top_left)
    if mode == 7:
        return _avg(left, top)
    if mode == 8:
        return _avg(top_left, top)
    if mode == 9:
        return _avg(top, top_right)
    if mode == 10:
        return _avg(_avg(left, top_left), _avg(top, top_right))
    if mode == 11:
        return _select(top, left, top_left)
    if mode == 12:
        return _clamp_add_sub_full(left, top, top_left)
    return _clamp_add_sub_half(_avg(left, top), top_left)


def _inverse_predictor(pixels: list, width: int, height: int, bits: int, modes: list) -> list:
    tiles = _sub_size(width, bits)
    out = pixels
    for x in range(width):  # the first row: black, then the left pixel
        out[x] = _add(out[x], 0xFF000000 if x == 0 else out[x - 1])
    for y in range(1, height):
        row, up = y * width, (y - 1) * width
        out[row] = _add(out[row], out[up])
        tile_row = (y >> bits) * tiles
        for x in range(1, width):
            mode = (modes[tile_row + (x >> bits)] >> 8) & 15
            # The last column's top-right is the first pixel of this row.
            pred = _predict(mode, out[row + x - 1], out[up + x], out[up + x + 1],
                            out[up + x - 1])
            out[row + x] = _add(out[row + x], pred)
    return out


def _inverse_cross_color(argb: np.ndarray, width: int, height: int, bits: int,
                         codes: list) -> np.ndarray:
    codes = np.asarray(codes, np.int64).reshape(_sub_size(height, bits), _sub_size(width, bits))
    codes = codes.repeat(1 << bits, 0).repeat(1 << bits, 1)[:height, :width]

    def signed(v):
        return ((v & 255) ^ 128) - 128

    g2r, g2b, r2b = signed(codes), signed(codes >> 8), signed(codes >> 16)
    green = signed(argb >> 8)
    red = ((argb >> 16) + ((g2r * green) >> 5)) & 255
    blue = (argb + ((g2b * green) >> 5) + ((r2b * signed(red)) >> 5)) & 255
    return (argb & 0xFF00FF00) | red << 16 | blue


def _vp8l_decode(data: bytes) -> np.ndarray:
    """The (H, W) ARGB of a VP8L bitstream, int64."""
    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError("corrupt WebP (VP8L) data: no signature")
    br = _LosslessBits(data)
    br.read(8)
    width, height = br.read(14) + 1, br.read(14) + 1
    br.read(1)  # alpha is used: dropped
    if br.read(3) != 0:
        raise ValueError("corrupt WebP (VP8L) data: an unknown version")
    transforms, seen, xsize = [], set(), width
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise ValueError("corrupt WebP (VP8L) data: a transform given twice")
        seen.add(kind)
        if kind in (0, 1):  # predictor, cross colour: a tile image
            bits = br.read(3) + 2
            sub = _entropy_image(br, _sub_size(xsize, bits), _sub_size(height, bits), False)
            transforms.append((kind, xsize, bits, sub))
        elif kind == 2:
            transforms.append((kind, xsize, 0, None))
        else:  # colour indexing: a palette, the pixels packed 2, 4 or 8 to one
            n = br.read(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            palette = _entropy_image(br, n, 1, False)
            for k in range(1, n):
                palette[k] = _add(palette[k], palette[k - 1])
            transforms.append((kind, xsize, bits, palette))
            xsize = _sub_size(xsize, bits)
    pixels = _entropy_image(br, xsize, height, True)
    for kind, size, bits, sub in reversed(transforms):
        if kind == 0:
            pixels = _inverse_predictor(pixels, size, height, bits, sub)
        elif kind == 1:
            argb = np.asarray(pixels, np.int64).reshape(height, size)
            pixels = _inverse_cross_color(argb, size, height, bits, sub).reshape(-1).tolist()
        elif kind == 2:
            argb = np.asarray(pixels, np.int64)
            green = (argb >> 8) & 255
            red = ((argb >> 16) + green) & 255
            blue = (argb + green) & 255
            pixels = ((argb & 0xFF00FF00) | red << 16 | blue).tolist()
        else:
            table = np.zeros(256, np.int64)
            table[:len(sub)] = np.asarray(sub[:256], np.int64)
            packed = (np.asarray(pixels, np.int64).reshape(height, -1) >> 8) & 255
            per = 1 << bits
            depth = 8 >> bits
            index = (packed[:, :, None] >> (depth * np.arange(per))) & ((1 << depth) - 1)
            pixels = table[index.reshape(height, -1)[:, :size]].reshape(-1).tolist()
    return np.asarray(pixels, np.int64).reshape(height, width)


# --- VP8, lossy -------------------------------------------------------------------

# Coefficient bands by position (the 17th for the position past the last),
# the zigzag order, and the large-value categories' probabilities.
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_CAT_PROBAS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
               (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# The 4x4 intra mode tree (libwebp's mode numbers: DC, TM, VE, HE, RD, VR,
# LD, VL, HD, HU): a positive entry is the next node, else minus the mode.
_BMODE_TREE = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
_DC, _TM, _VE, _HE = 0, 1, 2, 3


class _BoolDecoder:
    """libwebp's ``VP8BitReader``: ``rng`` is the range less 1, ``value``
    holds ``bits`` + 8 unread bits; past the data it reads one zero byte."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.value, self.bits, self.rng, self.eof = 0, -8, 254, False
        self.load()

    def load(self) -> None:
        while self.bits < 0:
            if self.pos < len(self.data):
                self.value = self.value << 8 | self.data[self.pos]
                self.pos += 1
                self.bits += 8
            elif not self.eof:
                self.value <<= 8
                self.bits += 8
                self.eof = True
            else:
                self.bits = 0

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self.load()
        rng, pos = self.rng, self.bits
        split = (rng * prob) >> 8
        if (self.value >> pos) > split:
            rng -= split
            self.value -= (split + 1) << pos
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 8 - rng.bit_length()
        self.bits -= shift
        self.rng = (rng << shift) - 1
        return bit

    def signed(self, v: int) -> int:
        """``VP8GetSigned``: one bit of probability 1/2, its shift fixed at 1."""
        if self.bits < 0:
            self.load()
        pos = self.bits
        split = self.rng >> 1
        self.bits -= 1
        if (self.value >> pos) > split:
            self.rng = (self.rng - 1) | 1
            self.value -= (split + 1) << pos
            return -v
        self.rng |= 1
        return v

    def value_bits(self, n: int) -> int:
        v = 0
        for k in range(n - 1, -1, -1):
            v |= self.bit(0x80) << k
        return v

    def signed_value(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v


def _wrap16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


def _coefficients(br: _BoolDecoder, probas: list, ctx: int, dq: tuple, n: int,
                  out: list, base: int) -> int:
    """``GetCoeffs``: the tokens of one block from position ``n``, each
    dequantised into ``out[base + zigzag]``; returns the position after the
    last nonzero one (``n`` when the block ends at once)."""
    p = probas[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = probas[n][0]
        if not br.bit(p[2]):
            v = 1
            ctx_next = 1
        else:
            if not br.bit(p[3]):
                v = 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
            elif not br.bit(p[6]):
                if not br.bit(p[7]):
                    v = 5 + br.bit(159)
                else:
                    v = 7 + 2 * br.bit(165)
                    v += br.bit(145)
            else:
                bit1 = br.bit(p[8])
                cat = 2 * bit1 + br.bit(p[9 + bit1])
                v = 0
                for prob in _CAT_PROBAS[cat]:
                    v += v + br.bit(prob)
                v += 3 + (8 << cat)
            ctx_next = 2
        out[base + _ZIGZAG[n]] = _wrap16(br.signed(v) * dq[n > 0])
        n += 1
        if n < 16:
            p = probas[n][ctx_next]
        # At n == 16 the loop ends: the block is full.
    return 16


def _transform(coef: np.ndarray) -> np.ndarray:
    """``TransformOne`` on (N, 16) blocks: the (N, 4, 4) residuals (the
    transform's output >> 3)."""
    c = coef.reshape(-1, 4, 4).astype(np.int64)

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    # Vertical pass over each column: rows 0 and 2 even, 1 and 3 odd.
    a, b = c[:, 0] + c[:, 2], c[:, 0] - c[:, 2]
    cc, d = mul2(c[:, 1]) - mul1(c[:, 3]), mul1(c[:, 1]) + mul2(c[:, 3])
    tmp = np.stack([a + d, b + cc, b - cc, a - d], axis=1)  # tmp[:, r, col]
    dc = tmp[..., 0] + 4
    a, b = dc + tmp[..., 2], dc - tmp[..., 2]
    cc, d = mul2(tmp[..., 1]) - mul1(tmp[..., 3]), mul1(tmp[..., 1]) + mul2(tmp[..., 3])
    return np.stack([a + d, b + cc, b - cc, a - d], axis=-1) >> 3


def _wht(dc: list) -> list:
    """``TransformWHT``: the 16 luma DCs from the Y2 block's coefficients."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        out[4 * i], out[4 * i + 1] = (a0 + a1) >> 3, (a3 + a2) >> 3
        out[4 * i + 2], out[4 * i + 3] = (a0 - a1) >> 3, (a3 - a2) >> 3
    return [_wrap16(v) for v in out]


def _avg3(a: int, b: int, c: int) -> int:
    return (a + 2 * b + c + 2) >> 2


def _avg2(a: int, b: int) -> int:
    return (a + b + 1) >> 1


def _predict4(mode: int, top: list, left: list, tl: int) -> list:
    """A 4x4 intra prediction (``dsp/dec.c``), row-major 16 values, from the
    8 pixels above (4 and the 4 above-right), the 4 to the left and the one
    above-left."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == _DC:
        return [(sum(top[:4]) + sum(left) + 4) >> 3] * 16
    if mode == _TM:
        return [min(255, max(0, top[x] + left[y] - X)) for y in range(4) for x in range(4)]
    if mode == _VE:
        return [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)] * 4
    if mode == _HE:
        rows = (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))
        return [v for v in rows for _ in range(4)]
    out = [0] * 16

    def put(v, *xy):
        for x, y in xy:
            out[4 * y + x] = v

    if mode == 4:  # RD
        put(_avg3(J, K, L), (0, 3))
        put(_avg3(I, J, K), (1, 3), (0, 2))
        put(_avg3(X, I, J), (2, 3), (1, 2), (0, 1))
        put(_avg3(A, X, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(_avg3(B, A, X), (3, 2), (2, 1), (1, 0))
        put(_avg3(C, B, A), (3, 1), (2, 0))
        put(_avg3(D, C, B), (3, 0))
    elif mode == 5:  # VR
        put(_avg2(X, A), (0, 0), (1, 2))
        put(_avg2(A, B), (1, 0), (2, 2))
        put(_avg2(B, C), (2, 0), (3, 2))
        put(_avg2(C, D), (3, 0))
        put(_avg3(K, J, I), (0, 3))
        put(_avg3(J, I, X), (0, 2))
        put(_avg3(I, X, A), (0, 1), (1, 3))
        put(_avg3(X, A, B), (1, 1), (2, 3))
        put(_avg3(A, B, C), (2, 1), (3, 3))
        put(_avg3(B, C, D), (3, 1))
    elif mode == 6:  # LD
        put(_avg3(A, B, C), (0, 0))
        put(_avg3(B, C, D), (1, 0), (0, 1))
        put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(_avg3(F, G, H), (3, 2), (2, 3))
        put(_avg3(G, H, H), (3, 3))
    elif mode == 7:  # VL
        put(_avg2(A, B), (0, 0))
        put(_avg2(B, C), (1, 0), (0, 2))
        put(_avg2(C, D), (2, 0), (1, 2))
        put(_avg2(D, E), (3, 0), (2, 2))
        put(_avg3(A, B, C), (0, 1))
        put(_avg3(B, C, D), (1, 1), (0, 3))
        put(_avg3(C, D, E), (2, 1), (1, 3))
        put(_avg3(D, E, F), (3, 1), (2, 3))
        put(_avg3(E, F, G), (3, 2))
        put(_avg3(F, G, H), (3, 3))
    elif mode == 8:  # HD
        put(_avg2(I, X), (0, 0), (2, 1))
        put(_avg2(J, I), (0, 1), (2, 2))
        put(_avg2(K, J), (0, 2), (2, 3))
        put(_avg2(L, K), (0, 3))
        put(_avg3(A, B, C), (3, 0))
        put(_avg3(X, A, B), (2, 0))
        put(_avg3(I, X, A), (1, 0), (3, 1))
        put(_avg3(J, I, X), (1, 1), (3, 2))
        put(_avg3(K, J, I), (1, 2), (3, 3))
        put(_avg3(L, K, J), (1, 3))
    else:  # HU
        put(_avg2(I, J), (0, 0))
        put(_avg2(J, K), (2, 0), (0, 1))
        put(_avg2(K, L), (2, 1), (0, 2))
        put(_avg3(I, J, K), (1, 0))
        put(_avg3(J, K, L), (3, 0), (1, 1))
        put(_avg3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    return out


def _predict_block(mode: int, plane: np.ndarray, y: int, x: int, size: int,
                   mb_x: int, mb_y: int) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma prediction at (y, x) of a plane padded by
    one row of 127 above and one column of 129 to the left (the frame's
    borders; the corner 127): DC (from what exists of top and left), VE, HE
    or TM."""
    top = plane[y - 1, x:x + size].astype(np.int64)
    left = plane[y:y + size, x - 1].astype(np.int64)
    if mode == _DC:
        shift = size.bit_length() - 1  # 4 for 16, 3 for 8
        if mb_x and mb_y:
            v = (top.sum() + left.sum() + size) >> (shift + 1)
        elif mb_y:  # no left
            v = (top.sum() + (size >> 1)) >> shift
        elif mb_x:  # no top
            v = (left.sum() + (size >> 1)) >> shift
        else:
            v = 128
        return np.full((size, size), v, np.int64)
    if mode == _VE:
        return np.broadcast_to(top, (size, size))
    if mode == _HE:
        return np.broadcast_to(left[:, None], (size, size))
    return np.clip(top[None, :] + left[:, None] - int(plane[y - 1, x - 1]), 0, 255)


def _filter_lines(pix: np.ndarray, thresh: int, ithresh: int, hev_thresh: int, inner: bool,
                  simple: bool) -> None:
    """The loop filter across one edge, in place: ``pix`` (lines, 8) int64
    holds p3, p2, p1, p0, q0, q1, q2, q3 of each line (``dsp/dec.c``: the
    simple filter's ``DoFilter2``; the normal filter's ``DoFilter2`` where
    the edge variance is high, else ``DoFilter6`` on macroblock edges and
    ``DoFilter4`` on inner ones)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (pix[:, k] for k in range(8))
    thresh2 = 2 * thresh + 1
    on = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= thresh2
    if not simple:
        for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
            on &= np.abs(a - b) <= ithresh
    if not on.any():
        return
    hev = (np.abs(p1 - p0) > hev_thresh) | (np.abs(q1 - q0) > hev_thresh)
    two = on & hev if not simple else on
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
    new = pix.copy()
    new[two, 3] = np.clip(p0 + a2, 0, 255)[two]
    new[two, 4] = np.clip(q0 - a1, 0, 255)[two]
    if not simple:
        rest = on & ~hev
        if inner:  # DoFilter4
            a = 3 * (q0 - p0)
            a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
            a3 = (a1 + 1) >> 1
            for k, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1), (5, q1 - a3)):
                new[rest, k] = np.clip(v, 0, 255)[rest]
        else:  # DoFilter6
            a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
            a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
            for k, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0 - a1), (5, q1 - a2),
                         (6, q2 - a3)):
                new[rest, k] = np.clip(v, 0, 255)[rest]
    pix[...] = new


def _filter_plane(plane: np.ndarray, y: int, x: int, size: int, left: bool, top: bool,
                  inner: bool, edges: tuple, limit: int, ilevel: int, hev: int,
                  simple: bool) -> None:
    """One macroblock's edges of one plane (``DoFilter``): the left edge and
    the inner vertical ones, then the top edge and the inner horizontal ones.
    ``edges``: the inner edges' offsets (4, 8, 12 for luma; 4 for chroma)."""
    block = slice(y, y + size)
    for horizontal in (False, True):
        todo = ([(0, limit + 4, False)] if (top if horizontal else left) else []) + (
            [(e, limit, True) for e in edges] if inner else [])
        for offset, thresh, is_inner in todo:
            if horizontal:
                view = plane[y + offset - 4:y + offset + 4, x:x + size].T
            else:
                view = plane[block, x + offset - 4:x + offset + 4]
            pix = view.astype(np.int64)
            _filter_lines(pix, thresh, ilevel, hev, is_inner, simple)
            view[...] = pix


def _upsample_rows(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's fancy upsampling and ``VP8YUVToRGB``: (H, W) luma, (ceil(H/2),
    ceil(W/2)) chroma -> (H, W, 3) uint8. Each luma row blends its nearer
    chroma row 3:1 with the farther one (the first row, and an even
    picture's last, with itself); along the row, ``UPSAMPLE_FUNC``'s
    diagonal sums."""
    h, w = y.shape
    rows = np.arange(h)
    near = rows // 2
    far = np.where(rows == 0, 0, np.where(rows % 2 == 1, rows // 2 + 1, rows // 2 - 1))
    far = np.minimum(far, u.shape[0] - 1)

    def horizontal(c):
        n, f = c[near].astype(np.int64), c[far].astype(np.int64)
        out = np.empty((h, w), np.int64)
        out[:, 0] = (3 * n[:, 0] + f[:, 0] + 2) >> 2
        last = (w - 1) >> 1
        if last >= 1:
            tl, t, l, cur = n[:, :last], n[:, 1:last + 1], f[:, :last], f[:, 1:last + 1]
            avg = tl + t + l + cur + 8
            diag_12 = (avg + 2 * (t + l)) >> 3
            diag_03 = (avg + 2 * (tl + cur)) >> 3
            out[:, 1:2 * last:2] = (diag_12 + tl) >> 1
            out[:, 2:2 * last + 1:2] = (diag_03 + t) >> 1
        if w % 2 == 0:
            out[:, w - 1] = (3 * n[:, last] + f[:, last] + 2) >> 2
        return out

    uu, vv = horizontal(u), horizontal(v)
    yy = (y.astype(np.int64) * 19077) >> 8

    def clip8(c):
        return np.where((c & ~16383) == 0, c >> 6, np.where(c < 0, 0, 255))

    r = clip8(yy + ((vv * 26149) >> 8) - 14234)
    g = clip8(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708)
    b = clip8(yy + ((uu * 33050) >> 8) - 17685)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def _band_probas(flat: list) -> list:
    """(type, position) -> the 3 contexts' 11 probabilities of its band."""
    bands = [[[flat[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c) * 11 + 11]
               for c in range(3)] for b in range(8)] for t in range(4)]
    return [[bands[t][_BANDS[n]] for n in range(17)] for t in range(4)]


def _vp8_decode(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 RGB of a VP8 key frame."""
    if len(data) < 10:
        raise ValueError("truncated WebP (VP8) data")
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1:
        raise ValueError("corrupt WebP (VP8) data: not a shown key frame")
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("corrupt WebP (VP8) data: no start code")
    width, height = (int.from_bytes(data[6:8], "little") & 0x3FFF,
                     int.from_bytes(data[8:10], "little") & 0x3FFF)
    part0 = bits >> 5
    if width == 0 or height == 0 or 10 + part0 > len(data):
        raise ValueError("corrupt or truncated WebP (VP8) data")
    br = _BoolDecoder(data[10:10 + part0])
    br.value_bits(2)  # colour space, clamping type
    # Segments.
    use_segment = br.value_bits(1)
    update_map, absolute, quantizer, strength, seg_probs = 0, 1, [0] * 4, [0] * 4, [255] * 3
    if use_segment:
        update_map = br.value_bits(1)
        if br.value_bits(1):
            absolute = br.value_bits(1)
            quantizer = [br.signed_value(7) if br.value_bits(1) else 0 for _ in range(4)]
            strength = [br.signed_value(6) if br.value_bits(1) else 0 for _ in range(4)]
        if update_map:
            seg_probs = [br.value_bits(8) if br.value_bits(1) else 255 for _ in range(3)]
    # The loop filter.
    simple, level, sharpness = br.value_bits(1), br.value_bits(6), br.value_bits(3)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    use_delta = br.value_bits(1)
    if use_delta and br.value_bits(1):
        ref_delta = [br.signed_value(6) if br.value_bits(1) else d for d in ref_delta]
        mode_delta = [br.signed_value(6) if br.value_bits(1) else d for d in mode_delta]
    filter_type = 0 if level == 0 else 1 if simple else 2
    # The token partitions.
    last = (1 << br.value_bits(2)) - 1
    rest = data[10 + part0:]
    if len(rest) < 3 * last:
        raise ValueError("truncated WebP (VP8) data: the partition sizes")
    sizes, start, left = rest[:3 * last], 3 * last, len(rest) - 3 * last
    parts = []
    for k in range(last):
        size = min(_u24(sizes, 3 * k), left)
        parts.append(_BoolDecoder(rest[start:start + size]))
        start, left = start + size, left - size
    parts.append(_BoolDecoder(rest[start:]))
    # Dequantisation by segment.
    base_q = br.value_bits(7)
    dq_y1_dc, dq_y2_dc, dq_y2_ac, dq_uv_dc, dq_uv_ac = (
        br.signed_value(4) if br.value_bits(1) else 0 for _ in range(5))
    quant = []
    for s in range(4):
        if not use_segment and s:
            quant.append(quant[0])
            continue
        q = (quantizer[s] + (0 if absolute else base_q)) if use_segment else base_q

        def clip(v, m):
            return 0 if v < 0 else m if v > m else v

        y2_ac = max(8, (_AC_TABLE[clip(q + dq_y2_ac, 127)] * 101581) >> 16)
        quant.append(((_DC_TABLE[clip(q + dq_y1_dc, 127)], _AC_TABLE[clip(q, 127)]),
                      (_DC_TABLE[clip(q + dq_y2_dc, 127)] * 2, y2_ac),
                      (_DC_TABLE[clip(q + dq_uv_dc, 117)], _AC_TABLE[clip(q + dq_uv_ac, 127)])))
    br.value_bits(1)  # refresh entropy probabilities: ignored, as libwebp does
    flat = [br.value_bits(8) if br.bit(_COEF_UPDATE[i]) else _COEF_DEFAULT[i]
            for i in range(4 * 8 * 3 * 11)]
    probas = _band_probas(flat)
    skip_prob = br.value_bits(8) if br.value_bits(1) else None
    # Filter strengths by (segment, 4x4 mode): (limit, interior limit, hev).
    strengths = {}
    for s in range(4):
        base = ((strength[s] + (0 if absolute else level)) if use_segment else level)
        for i4 in (0, 1):
            lv = base + ((ref_delta[0] + (mode_delta[0] if i4 else 0)) if use_delta else 0)
            lv = min(63, max(0, lv))
            if lv == 0:
                strengths[s, i4] = None
                continue
            il = lv
            if sharpness:
                il >>= 2 if sharpness > 4 else 1
                il = min(il, 9 - sharpness)
            il = max(il, 1)
            strengths[s, i4] = (2 * lv + il, il, 2 if lv >= 40 else 1 if lv >= 15 else 0)

    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    # Planes padded by one row above (127) and a column to the left (129),
    # luma 4 columns wider for the top-right pixels of the last macroblock.
    Y = np.zeros((16 * mb_h + 1, 16 * mb_w + 5), np.int64)
    U = np.zeros((8 * mb_h + 1, 8 * mb_w + 1), np.int64)
    V = np.zeros_like(U)
    for P in (Y, U, V):
        P[:, 0] = 129
        P[0, :] = 127
    intra_top = [0] * (4 * mb_w)
    nz_top = [[0] * 9 for _ in range(mb_w)]  # 4 luma, 2 U, 2 V, Y2 (index 8)
    mbs = []
    for mb_y in range(mb_h):
        token_br = parts[mb_y & last]
        intra_left = [0] * 4
        nz_left = [0] * 9
        for mb_x in range(mb_w):
            segment = 0
            if update_map:
                segment = (br.bit(seg_probs[1]) if not br.bit(seg_probs[0])
                           else br.bit(seg_probs[2]) + 2)
            skip = br.bit(skip_prob) if skip_prob is not None else 0
            i4 = not br.bit(145)
            if not i4:
                ymode = ((_TM if br.bit(128) else _HE) if br.bit(156) else
                         (_VE if br.bit(163) else _DC))
                modes = [ymode]
                intra_top[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
                intra_left = [ymode] * 4
            else:
                modes = [0] * 16
                for by in range(4):
                    ymode = intra_left[by]
                    for bx in range(4):
                        prob = _BMODE_PROBA[(intra_top[4 * mb_x + bx] * 10 + ymode) * 9:]
                        i = _BMODE_TREE[br.bit(prob[0])]
                        while i > 0:
                            i = _BMODE_TREE[2 * i + br.bit(prob[i])]
                        ymode = -i
                        intra_top[4 * mb_x + bx] = ymode
                        modes[4 * by + bx] = ymode
                    intra_left[by] = ymode
            uvmode = (_DC if not br.bit(142) else _VE if not br.bit(114) else
                      _TM if br.bit(183) else _HE)
            # The residuals.
            coef = [0] * 384
            top_nz = nz_top[mb_x]
            nonzero = False
            if skip:
                top_nz[:8] = nz_left[:8] = [0] * 8
                if not i4:
                    top_nz[8] = nz_left[8] = 0
            else:
                y1, y2, uv = quant[segment]
                if not i4:
                    dc = [0] * 16
                    nz = _coefficients(token_br, probas[1], top_nz[8] + nz_left[8], y2, 0, dc, 0)
                    top_nz[8] = nz_left[8] = int(nz > 0)
                    for k, v in enumerate(_wht(dc)):
                        coef[16 * k] = v
                    first, ac = 1, probas[0]
                else:
                    first, ac = 0, probas[3]
                for by in range(4):
                    for bx in range(4):
                        base = 16 * (4 * by + bx)
                        nz = _coefficients(token_br, ac, nz_left[by] + top_nz[bx], y1, first,
                                           coef, base)
                        top_nz[bx] = nz_left[by] = int(nz > first)
                        nonzero |= nz > 1 or coef[base] != 0
                for ch in (0, 1):
                    for by in range(2):
                        for bx in range(2):
                            base = 256 + 64 * ch + 16 * (2 * by + bx)
                            nz = _coefficients(token_br, probas[2],
                                               nz_left[4 + 2 * ch + by] + top_nz[4 + 2 * ch + bx],
                                               uv, 0, coef, base)
                            top_nz[4 + 2 * ch + bx] = nz_left[4 + 2 * ch + by] = int(nz > 0)
                            nonzero |= nz > 1 or coef[base] != 0
            mbs.append((segment, i4, modes, uvmode, coef, i4 or nonzero))
    if br.eof or any(part.eof for part in parts):
        raise ValueError("truncated WebP (VP8) data")
    # Residuals of every block, then the predictions in decoding order.
    residuals = _transform(np.array([mb[4] for mb in mbs], np.int64).reshape(-1, 16))
    residuals = residuals.reshape(len(mbs), 24, 4, 4)
    for index, (segment, i4, modes, uvmode, _, _) in enumerate(mbs):
        mb_y, mb_x = divmod(index, mb_w)
        y0, x0 = 16 * mb_y + 1, 16 * mb_x + 1
        res = residuals[index]
        if i4:
            if mb_y == 0:
                top_right = [127] * 4
            elif mb_x == mb_w - 1:
                top_right = [int(Y[y0 - 1, x0 + 15])] * 4
            else:
                top_right = Y[y0 - 1, x0 + 16:x0 + 20].tolist()
            for n in range(16):
                by, bx = divmod(n, 4)
                y, x = y0 + 4 * by, x0 + 4 * bx
                above = Y[y - 1, x - 1:x + 8].tolist()
                top = above[1:5] + (top_right if bx == 3 else above[5:9])
                pred = _predict4(modes[n], top, Y[y:y + 4, x - 1].tolist(), above[0])
                Y[y:y + 4, x:x + 4] = np.clip(np.array(pred).reshape(4, 4) + res[n], 0, 255)
        else:
            pred = _predict_block(modes[0], Y, y0, x0, 16, mb_x, mb_y)
            block = res[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
            Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + block, 0, 255)
        c0, c1 = 8 * mb_y + 1, 8 * mb_x + 1
        for k, P in enumerate((U, V)):
            pred = _predict_block(uvmode, P, c0, c1, 8, mb_x, mb_y)
            block = res[16 + 4 * k:20 + 4 * k].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3)
            P[c0:c0 + 8, c1:c1 + 8] = np.clip(pred + block.reshape(8, 8), 0, 255)
    # The loop filter, macroblock by macroblock.
    Y, U, V = Y[1:, 1:16 * mb_w + 1], U[1:, 1:], V[1:, 1:]
    if filter_type:
        for index, (segment, i4, _, _, _, inner) in enumerate(mbs):
            fs = strengths[segment, int(i4)]
            if fs is None:
                continue
            mb_y, mb_x = divmod(index, mb_w)
            limit, ilevel, hev = fs
            args = (mb_x > 0, mb_y > 0, inner)
            _filter_plane(Y, 16 * mb_y, 16 * mb_x, 16, *args, (4, 8, 12), limit, ilevel, hev,
                          filter_type == 1)
            if filter_type == 2:
                for P in (U, V):
                    _filter_plane(P, 8 * mb_y, 8 * mb_x, 8, *args, (4,), limit, ilevel, hev,
                                  False)
    ch, cw = (height + 1) // 2, (width + 1) // 2
    return _upsample_rows(Y[:height, :width], U[:ch, :cw], V[:ch, :cw])
