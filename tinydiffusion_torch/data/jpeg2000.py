"""JPEG 2000 decode (JP2 files and raw J2K codestreams), as
``Image.open(f).convert("RGB")`` gives it.

JAX's LAION loader reads every web image with Pillow, which decodes JPEG
2000 with OpenJPEG tile by tile and unpacks each tile into its image mode
(``Jpeg2KDecode.c``). ``decode_jpeg2000`` does the same: Python reads the
JP2 boxes (Pillow's mode from ``ihdr``, the colour space from ``colr``) and
the codestream's marker segments (SIZ, COD/COC, QCD/QCC and RGN in the main
and tile-part headers, the tile-parts of each tile joined), and the C in
``data/csrc/jpeg2000.c`` decodes each tile as OpenJPEG 2.5 does: packets in
any of the five progression orders, over precincts and code-blocks; EBCOT's
MQ decoder and coding passes; the 5/3 and 9/7 wavelets (the 9/7 and the ICT
in float32, in OpenJPEG's order of operations); the DC shift and the clamp.
Each tile is then unpacked as Pillow's ``j2ku_*`` unpackers do (the
component's precision shifted to 8 or 16 bits, with their rounding and
wrap), and the mode converted to RGB as ``convert("RGB")`` does (``I;16``
clamped at 255, ``LA`` and ``RGBA`` their colour channels, ``CMYK`` through
Pillow's ``cmyk2rgb``).

Pillow writes JPEG 2000 in the modes L, LA, RGB, RGBA, I;16, CMYK and
YCbCr, and those are read. A JP2 whose colour space is sYCC (enumerated 18,
what Pillow writes for YCbCr) is read as RGB or RGBA through Pillow's own
YCbCr to RGB (``j2ku_sycc_rgb``, ``j2ku_sycca_rgba``: ``data/ycbcr.py``).
Refused with ``ValueError``, named: palettes (``pclr``), e-sYCC (24) and
other colour spaces Pillow's unpackers do not pair with the mode,
subsampled components, precisions over 16 bits, progression changes
(POC), packed packet headers (PPM, PPT), the code-block styles BYPASS and
VSC, and High Throughput codestreams. Truncated or corrupt files raise
``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from tinydiffusion_torch.data import native
from tinydiffusion_torch.data.jpeg import _cmyk_to_rgb
from tinydiffusion_torch.data.tiff import MAX_PIXELS  # Pillow's decompression-bomb limit
from tinydiffusion_torch.data.ycbcr import pillow_ycbcr_to_rgb

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"

# jpeg2000.c's parameter table: the tile's fields, then C_FIELDS a component.
P_HEADER = 16
MAX_RES = 33
MAX_BANDS = 3 * (MAX_RES - 1) + 1
C_PPX = 11
C_PPY = C_PPX + MAX_RES
C_EXPN = C_PPY + MAX_RES
C_MANT = C_EXPN + MAX_BANDS
C_FIELDS = C_MANT + MAX_BANDS
# OpenJPEG's color_space for a JP2 colr box's enumerated colour space.
_COLOURS = {16: "srgb", 17: "gray", 18: "sycc", 24: "eycc", 12: "cmyk"}
# Pillow's unpackers this module has: (mode, colour space, components).
_UNPACKERS = {("L", "gray", 1), ("I;16", "gray", 1), ("LA", "gray", 2), ("RGB", "srgb", 3),
              ("RGB", "srgb", 4), ("RGBA", "srgb", 4), ("CMYK", "cmyk", 4), ("RGB", "sycc", 3),
              ("RGB", "sycc", 4), ("RGBA", "sycc", 4)}
_STYLES = {0x01: "BYPASS (selective arithmetic coding bypass)",
           0x08: "VSC (vertically causal context)", 0x40: "HT (High Throughput)"}


def _u16(data: bytes, at: int) -> int:
    if at + 2 > len(data):
        raise ValueError("truncated JPEG 2000 file")
    return struct.unpack_from(">H", data, at)[0]


# --- the JP2 boxes ------------------------------------------------------------------


def _boxes(data: bytes, start: int, end: int):
    """(type, content start, content end) of each box in ``data[start:end]``."""
    pos = start
    while pos + 8 <= end:
        length, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if length == 1:
            if pos + 16 > end:
                raise ValueError("truncated JP2 box")
            length, head = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif length == 0:
            length = end - pos
        if length < head or pos + length > end:
            raise ValueError("corrupt JP2 file: a box past the end of its container")
        yield kind, pos + head, pos + length
        pos += length


def _jp2(data: bytes) -> tuple[str, str | None, tuple[int, int], bytes]:
    """Pillow's mode and size (``_parse_jp2_header``), OpenJPEG's colour space
    and the codestream of a JP2 file."""
    header = codestream = None
    for kind, start, end in _boxes(data, 0, len(data)):
        if kind == b"jp2h" and header is None:
            header = (start, end)
        elif kind == b"jp2c":
            codestream = data[start:end]
            break
    if header is None or codestream is None:
        raise ValueError("corrupt JP2 file: no header box or no codestream")
    mode = size = colour = None
    nc = 0
    for kind, start, end in _boxes(data, *header):
        if kind == b"ihdr":
            if end - start < 14:
                raise ValueError("corrupt JP2 file: a short ihdr box")
            height, width, nc, bpc = struct.unpack_from(">IIHB", data, start)
            size = (width, height)
            mode = {1: "I;16" if (bpc & 0x7F) > 8 else "L", 2: "LA", 3: "RGB",
                    4: "RGBA"}.get(nc)
        elif kind == b"colr" and end - start >= 7 and colour is None:
            meth = data[start]
            colour = _COLOURS.get(struct.unpack_from(">I", data, start + 3)[0], "unknown") if (
                meth == 1) else "unknown"
            if nc == 4 and meth == 1 and colour == "cmyk":
                mode = "CMYK"
        elif kind == b"pclr" and mode in ("L", "LA"):
            raise ValueError("JPEG 2000 palettes (a JP2 pclr box) are not supported")
    if mode is None or size is None:
        raise ValueError("corrupt JP2 file: malformed JP2 header")
    return mode, colour, size, codestream


# --- the codestream ---------------------------------------------------------------


def _coding(seg: bytes, at: int, explicit: bool) -> dict:
    """SPcod/SPcoc from ``at``: decomposition levels, code-block size and
    style, the wavelet, and the precinct sizes (``explicit``: listed)."""
    if at + 5 > len(seg):
        raise ValueError("corrupt JPEG 2000 codestream: a short COD or COC segment")
    levels, xcb, ycb, style, wavelet = seg[at:at + 5]
    if levels > 32 or xcb > 8 or ycb > 8 or xcb + ycb > 8 or wavelet > 1:
        raise ValueError("corrupt JPEG 2000 codestream: coding parameters out of range")
    for bit, name in _STYLES.items():
        if style & bit:
            raise ValueError(f"the JPEG 2000 code-block style {name} is not supported")
    if style & 0x80:
        raise ValueError("corrupt JPEG 2000 codestream: a code-block style out of range")
    if explicit:
        if at + 6 + levels > len(seg):
            raise ValueError("corrupt JPEG 2000 codestream: missing precinct sizes")
        precincts = [(b & 15, b >> 4) for b in seg[at + 5:at + 6 + levels]]
    else:
        precincts = [(15, 15)] * (levels + 1)
    return {"numres": levels + 1, "xcb": xcb + 2, "ycb": ycb + 2, "cblksty": style,
            "qmfbid": wavelet, "precincts": precincts}


def _quantization(seg: bytes, at: int) -> dict:
    """SQcd/SPqcd from ``at``: guard bits and each band's (exponent, mantissa)
    (derived from the LL band's for scalar derived quantization)."""
    if at >= len(seg):
        raise ValueError("corrupt JPEG 2000 codestream: a short QCD or QCC segment")
    style, body = seg[at] & 0x1F, seg[at + 1:]
    if style == 0:
        steps = [(b >> 3, 0) for b in body]
    elif style in (1, 2):
        values = [struct.unpack_from(">H", body, 2 * i)[0] for i in range(len(body) // 2)]
        steps = [(v >> 11, v & 0x7FF) for v in values]
        if style == 1:
            if not steps:
                raise ValueError("corrupt JPEG 2000 codestream: a short QCD segment")
            expn, mant = steps[0]
            steps = [steps[0]] + [(max(expn - (b - 1) // 3, 0), mant) for b in range(1, MAX_BANDS)]
    else:
        raise ValueError(f"corrupt JPEG 2000 codestream: quantization style {style}")
    steps = (steps + [(0, 0)] * MAX_BANDS)[:MAX_BANDS]
    return {"numgbits": seg[at] >> 5, "steps": steps}


def _component_index(seg: bytes, ncomps: int) -> tuple[int, int]:
    """A COC, QCC or RGN segment's component and where its body starts."""
    if ncomps < 257:
        return seg[0], 1
    return struct.unpack_from(">H", seg, 0)[0], 2


class _Header:
    """The coding parameters of the main header or a tile-part header."""

    def __init__(self):
        self.cod = None  # (Scod, progression, layers, mct, coding)
        self.coc: dict[int, dict] = {}
        self.qcd = None
        self.qcc: dict[int, dict] = {}
        self.rgn: dict[int, int] = {}

    def read(self, marker: int, seg: bytes, ncomps: int) -> None:
        try:
            if marker == 0xFF52:  # COD
                scod, prog, layers, mct = seg[0], seg[1], struct.unpack_from(">H", seg, 2)[0], seg[4]
                if mct == 2:
                    raise ValueError("JPEG 2000 custom component transforms (Part 2) are not "
                                     "supported")
                if prog > 4 or layers == 0 or mct > 2:
                    raise ValueError("corrupt JPEG 2000 codestream: COD parameters out of range")
                self.cod = (scod, prog, layers, mct, _coding(seg, 5, bool(scod & 1)))
            elif marker == 0xFF53:  # COC
                c, at = _component_index(seg, ncomps)
                self.coc[c] = _coding(seg, at + 1, bool(seg[at] & 1))
            elif marker == 0xFF5C:  # QCD
                self.qcd = _quantization(seg, 0)
            elif marker == 0xFF5D:  # QCC
                c, at = _component_index(seg, ncomps)
                self.qcc[c] = _quantization(seg, at)
            elif marker == 0xFF5E:  # RGN
                c, at = _component_index(seg, ncomps)
                if seg[at] != 0:
                    raise ValueError("corrupt JPEG 2000 codestream: an RGN style other than 0")
                self.rgn[c] = seg[at + 1]
            elif marker == 0xFF5F:
                raise ValueError("JPEG 2000 progression order changes (POC) are not supported")
            elif marker in (0xFF60, 0xFF61):
                raise ValueError("JPEG 2000 packed packet headers (PPM, PPT) are not supported")
            elif marker in (0xFF50, 0xFF59):
                raise ValueError("High Throughput JPEG 2000 (Part 15) is not supported")
        except (IndexError, struct.error):
            raise ValueError("corrupt JPEG 2000 codestream: a short marker segment") from None


def _siz(seg: bytes) -> dict:
    if len(seg) < 36:
        raise ValueError("corrupt JPEG 2000 codestream: a short SIZ segment")
    _, xsiz, ysiz, xo, yo, xt, yt, xto, yto, ncomps = struct.unpack_from(">HIIIIIIIIH", seg, 0)
    if ncomps < 1 or len(seg) < 36 + 3 * ncomps:
        raise ValueError("corrupt JPEG 2000 codestream: SIZ components")
    if not (xo < xsiz and yo < ysiz and xt > 0 and yt > 0 and xto <= xo and yto <= yo
            and xto + xt > xo and yto + yt > yo):
        raise ValueError("corrupt JPEG 2000 codestream: SIZ geometry")
    comps = []
    for c in range(ncomps):
        ssiz, dx, dy = seg[36 + 3 * c:39 + 3 * c]
        comps.append({"prec": (ssiz & 0x7F) + 1, "sgnd": ssiz >> 7, "dx": dx, "dy": dy})
        if not 1 <= comps[-1]["prec"] <= 16:
            raise ValueError(f"JPEG 2000 components of {comps[-1]['prec']} bits are not supported")
        if dx != 1 or dy != 1:
            raise ValueError("subsampled JPEG 2000 components are not supported")
    across, down = -(-(xsiz - xto) // xt), -(-(ysiz - yto) // yt)
    if across * down > 65535:
        raise ValueError("corrupt JPEG 2000 codestream: more than 65535 tiles")
    if (xsiz - xo) * (ysiz - yo) > MAX_PIXELS:
        raise ValueError(f"JPEG 2000 image too large: {xsiz - xo}x{ysiz - yo} pixels")
    return {"x": (xo, xsiz), "y": (yo, ysiz), "tile": (xt, yt), "tile_origin": (xto, yto),
            "across": across, "down": down, "comps": comps}


def _segments(cs: bytes, pos: int):
    """(marker, segment body, position after it) of each marker segment from
    ``pos`` up to and including the next SOT, SOD or EOC (whose body is
    empty, SOT's excepted)."""
    while True:
        marker = _u16(cs, pos)
        if marker in (0xFF93, 0xFFD9):
            yield marker, b"", pos + 2
            return
        if marker >> 8 != 0xFF:
            raise ValueError("corrupt JPEG 2000 codestream: a marker expected")
        length = _u16(cs, pos + 2)
        if length < 2 or pos + 2 + length > len(cs):
            raise ValueError("truncated JPEG 2000 codestream")
        yield marker, cs[pos + 4:pos + 2 + length], pos + 2 + length
        if marker == 0xFF90:
            return
        pos += 2 + length


def _parse(cs: bytes) -> tuple[dict, _Header, dict]:
    """SIZ, the main header and each tile's (header, packet data)."""
    if cs[:4] != J2K_SIGNATURE:
        raise ValueError("corrupt JPEG 2000 codestream: no SOC and SIZ")
    length = _u16(cs, 4)
    siz = _siz(cs[6:4 + length])
    ncomps = len(siz["comps"])
    main = _Header()
    pos = 4 + length
    tiles: dict[int, list] = {}
    while True:
        for marker, seg, after in _segments(cs, pos):
            if marker == 0xFFD9:
                if main.cod is None or main.qcd is None and not main.qcc:
                    raise ValueError("corrupt JPEG 2000 codestream: no COD or QCD")
                return siz, main, tiles
            if marker == 0xFF90:
                break
            if marker == 0xFF93:
                raise ValueError("corrupt JPEG 2000 codestream: SOD outside a tile-part")
            main.read(marker, seg, ncomps)
        else:
            raise ValueError("truncated JPEG 2000 codestream")
        # A tile-part: SOT, its header, SOD and its data.
        start = pos = after - 2 - len(seg) - 2
        if len(seg) < 8:
            raise ValueError("corrupt JPEG 2000 codestream: a short SOT segment")
        index, psot, part, _ = struct.unpack_from(">HIBB", seg, 0)
        if index >= siz["across"] * siz["down"]:
            raise ValueError(f"corrupt JPEG 2000 codestream: tile {index} out of range")
        if psot == 0:
            psot = len(cs) - start - (2 if cs[-2:] == b"\xff\xd9" else 0)
        end = start + psot
        if end > len(cs) or psot < 14:
            raise ValueError("truncated JPEG 2000 codestream: a tile-part past the end")
        header = tiles.setdefault(index, [_Header(), []])
        pos = after
        for marker, tseg, after in _segments(cs, pos):
            if marker == 0xFF93:
                break
            if marker in (0xFF90, 0xFFD9):
                raise ValueError("corrupt JPEG 2000 codestream: a tile-part without SOD")
            if part == 0:
                header[0].read(marker, tseg, ncomps)
            elif marker in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D):
                raise ValueError("corrupt JPEG 2000 codestream: coding markers after the first "
                                 "tile-part")
        if after > end:
            raise ValueError("corrupt JPEG 2000 codestream: a tile-part header past its end")
        header[1].append(cs[after:end])
        pos = end


def _tile_params(siz: dict, main: _Header, tile: _Header, index: int) -> np.ndarray:
    """jpeg2000.c's parameter table for tile ``index``."""
    ncomps = len(siz["comps"])
    cod = tile.cod or main.cod
    if cod is None:
        raise ValueError("corrupt JPEG 2000 codestream: no COD")
    scod, prog, layers, mct, _ = cod
    params = np.zeros(P_HEADER + ncomps * C_FIELDS, np.int64)
    (xt, yt), (xto, yto) = siz["tile"], siz["tile_origin"]
    p, q = index % siz["across"], index // siz["across"]
    tx0, tx1 = max(xto + p * xt, siz["x"][0]), min(xto + (p + 1) * xt, siz["x"][1])
    ty0, ty1 = max(yto + q * yt, siz["y"][0]), min(yto + (q + 1) * yt, siz["y"][1])
    params[:9] = (ncomps, layers, prog, scod, mct, tx0, ty0, tx1, ty1)
    for c, comp in enumerate(siz["comps"]):
        coding = tile.coc.get(c) or (tile.cod[4] if tile.cod else None) or main.coc.get(c) or (
            main.cod[4])
        quant = tile.qcc.get(c) or tile.qcd or main.qcc.get(c) or main.qcd
        if quant is None:
            raise ValueError("corrupt JPEG 2000 codestream: no QCD")
        roi = tile.rgn.get(c, main.rgn.get(c, 0))
        at = P_HEADER + c * C_FIELDS
        params[at:at + 11] = (comp["dx"], comp["dy"], comp["prec"], comp["sgnd"],
                              coding["numres"], coding["xcb"], coding["ycb"], coding["cblksty"],
                              coding["qmfbid"], quant["numgbits"], roi)
        for r, (ppx, ppy) in enumerate(coding["precincts"]):
            params[at + C_PPX + r], params[at + C_PPY + r] = ppx, ppy
        for b, (expn, mant) in enumerate(quant["steps"]):
            params[at + C_EXPN + b], params[at + C_MANT + b] = expn, mant
    return params


def _decode_tile(data: bytes, params: np.ndarray) -> list[np.ndarray]:
    """Each component of one tile, (h, w) int32 (``tdt_j2k_tile``)."""
    tx0, ty0, tx1, ty1 = (int(v) for v in params[5:9])
    ncomps = int(params[0])
    shape = (ty1 - ty0, tx1 - tx0)
    out = np.empty(ncomps * shape[0] * shape[1], np.int32)
    src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    native.check(native.library().tdt_j2k_tile(native.ptr(src), len(data), native.ptr(params),
                                               len(params), native.ptr(out), len(out)),
                 "JPEG 2000", {native.ERR_CORRUPT: "corrupt JPEG 2000 data: coding parameters "
                               "or code-block data out of range"})
    return list(out.reshape(ncomps, *shape))


def _to_bits(v: np.ndarray, comp: dict, bits: int) -> np.ndarray:
    """Pillow's ``j2ku_shift(offset + word, shift)`` of one component's
    samples to ``bits`` (8 or 16), wrapping as its UINT8 or UINT16 store."""
    prec = comp["prec"]
    word = v.astype(np.int64) & (0xFF if prec <= 8 else 0xFFFF)
    shift = bits - prec
    offset = (1 << (prec - 1)) if comp["sgnd"] else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
        out = (offset + word) >> -shift
    else:
        out = (offset + word) << shift
    return out & ((1 << bits) - 1)


def decode_jpeg2000(data: bytes) -> np.ndarray:
    """A JP2 file's or J2K codestream's (H, W, 3) uint8 RGB, as Pillow's
    ``convert("RGB")`` gives it."""
    if data[:12] == JP2_SIGNATURE:
        mode, colour, size, cs = _jp2(data)
    elif data[:4] == J2K_SIGNATURE:
        mode, colour, size, cs = None, None, None, data
    else:
        raise ValueError("not a JPEG 2000 file")
    siz, main, tiles = _parse(cs)
    comps = siz["comps"]
    ncomps = len(comps)
    if size is None:  # a raw codestream: Pillow's _parse_codestream
        size = (siz["x"][1] - siz["x"][0], siz["y"][1] - siz["y"][0])
        mode = {1: "I;16" if comps[0]["prec"] > 8 else "L", 2: "LA", 3: "RGB",
                4: "RGBA"}.get(ncomps)
        if mode is None:
            raise ValueError(f"a JPEG 2000 codestream of {ncomps} components")
    if colour is None:  # unspecified: Pillow's guess
        colour = "gray" if ncomps <= 2 else "srgb"
    if (mode, colour, ncomps) not in _UNPACKERS:
        raise ValueError(f"JPEG 2000 in mode {mode} with a {colour} colour space and {ncomps} "
                         "components is not supported")
    width, height = size
    if width * height > MAX_PIXELS:
        raise ValueError(f"JPEG 2000 image too large: {width}x{height} pixels")
    bits = 16 if mode == "I;16" else 8
    planes = np.zeros((min(ncomps, 4), height, width), np.uint16)
    for index in sorted(tiles):
        header, parts = tiles[index]
        params = _tile_params(siz, main, header, index)
        x0, y0 = int(params[5]) - siz["x"][0], int(params[6]) - siz["y"][0]
        x1, y1 = int(params[7]) - siz["x"][0], int(params[8]) - siz["y"][0]
        if x1 > width or y1 > height:
            raise ValueError("corrupt JPEG 2000 file: a tile outside the image")
        for c, plane in enumerate(_decode_tile(b"".join(parts), params)[:4]):
            planes[c, y0:y1, x0:x1] = _to_bits(plane, comps[c], bits)
    if mode == "I;16":
        grey = np.minimum(planes[0], 255)
        return np.repeat(grey.astype(np.uint8)[..., None], 3, axis=-1)
    if mode in ("L", "LA"):
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=-1)
    if mode == "CMYK":
        return _cmyk_to_rgb(255 - np.moveaxis(planes, 0, -1).astype(np.int64))
    if colour == "sycc":  # j2ku_sycc_rgb / j2ku_sycca_rgba: Pillow's YCbCr to RGB
        return pillow_ycbcr_to_rgb(*planes[:3])
    return np.ascontiguousarray(np.moveaxis(planes[:3], 0, -1).astype(np.uint8))
