"""Which format a file is, picked as Pillow 12.1's ``Image.open`` picks it.

JAX's LAION loader decodes every record with ``Image.open(f).convert("RGB")``.
``Image.open`` does not look at a file's first bytes once: it walks its
plugins in the order of ``Image.ID`` (the six of ``Image.preinit`` first,
then those ``Image.init`` imports, in the order of ``PIL._plugins``), asks
each one's ``_accept`` test about the first 16 bytes (a plugin without one
takes every file), and runs the ``_open`` of the first that accepts. Where
that ``_open`` raises ``SyntaxError`` (or one of the exceptions ``ImageFile``
turns into one: ``IndexError``, ``TypeError``, ``KeyError``, ``EOFError``,
``struct.error``; or the header leaves the mode empty or a side 0 or less),
the walk goes on with the next plugin; any other exception, or a size over
twice ``MAX_IMAGE_PIXELS``, refuses the file. A file no plugin opens is
"cannot identify image file".

``PLUGINS`` is that order, as data of the port's own: each row the format's
name, a copy of its ``_accept`` test (None: the plugin has none), the port's
open step (``Header`` or ``NotThisFormat``; ``data/header.py``) and its
decoder, or None where the port does not read the format. ``identify``
walks it and names the format Pillow's ``im.format`` would give;
``data/laion.py::decode_image`` decodes by that name. A format the port
does not read is refused by name once its ``_accept`` passes; of the five
plugins without an accept test that come before TGA (IM, IMT, IPTC, PCD and
SPIDER), the port keeps the checks by which their ``_open`` turns a file
away, since every TGA walks through them, and GBR's, whose accept test
takes a QOI of width 1 or 2.

Known gap: a file that such a refused format's ``_accept`` takes, whose
``_open`` fails, and which a later plugin reads (say an MSP file whose
damaged header fails MSP's ``_open``) is refused here where Pillow reads it. The
open steps of JPEG (marker walk, sample precision, component count), PNG,
GIF, WebP, TIFF and JPEG 2000 check less than Pillow's ``_open`` does; what
they let through their decoders refuse, and no later plugin would read it.
"""

from __future__ import annotations

import dataclasses
import re
import struct
from typing import Callable

import numpy as np

from tinydiffusion_torch.data import bmp, gif, ico, jpeg, jpeg2000, netpbm, pcx, png, qoi, tga
from tinydiffusion_torch.data import tiff, webp
from tinydiffusion_torch.data.header import Header, NotThisFormat, open_as

# Pillow's Image.MAX_IMAGE_PIXELS; over twice it, Image.open raises.
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3


@dataclasses.dataclass(frozen=True)
class Plugin:
    """A row of ``PLUGINS``: ``accept`` None takes every file; ``open`` None
    checks nothing past the accept test; ``decode`` None: the port does not
    read the format."""

    name: str
    accept: Callable[[bytes], bool] | None
    open: Callable[[bytes], Header] | None = None
    decode: Callable[[bytes, Header | None], np.ndarray] | None = None


def _starts(*magic: bytes) -> Callable[[bytes], bool]:
    return lambda prefix: prefix.startswith(magic)


def _i16le(prefix: bytes, at: int = 0) -> int:
    return struct.unpack_from("<H", prefix, at)[0]


def _i32le(prefix: bytes, at: int = 0) -> int:
    return struct.unpack_from("<I", prefix, at)[0]


def _i32be(prefix: bytes, at: int = 0) -> int:
    return struct.unpack_from(">I", prefix, at)[0]


# --- the open steps of the formats the port decodes but does not split -----


def _open_jpeg(data: bytes) -> Header:
    """``JpegImageFile._open``'s marker walk up to the first scan: the last
    frame header's size and component count (8-bit samples and 1, 3 or 4
    components, else the walk goes on; a 12-bit file is nobody's)."""
    if data[:3] != b"\xff\xd8\xff":
        raise NotThisFormat("not a JPEG file")
    pos, s = 3, b"\xff"
    mode, size = "", (0, 0)
    while True:
        i = s[0]
        if i != 0xFF:
            s, pos = data[pos:pos + 1], pos + 1
            continue
        s, pos = s + data[pos:pos + 1], pos + 1
        i = struct.unpack(">H", s)[0]
        if i == 0xFFFF:  # fill bytes
            s = b"\xff"
        elif 0xFFC0 <= i <= 0xFFFE and i not in (0xFFC8, *range(0xFFD0, 0xFFDA), *range(0xFFF0,
                                                                                     0xFFFE)):
            n = struct.unpack(">H", data[pos:pos + 2])[0] - 2
            body = data[pos + 2:pos + 2 + max(n, 0)]
            if len(body) < n:
                raise ValueError("truncated JPEG file: a marker segment")
            pos += 2 + max(n, 0)
            if i in (*range(0xFFC0, 0xFFC4), *range(0xFFC5, 0xFFC8), *range(0xFFC9, 0xFFCC),
                     *range(0xFFCD, 0xFFD0), 0xFFDE):
                size = struct.unpack_from(">HH", body, 1)[::-1]
                if body[0] != 8:
                    raise NotThisFormat(f"{body[0]}-bit JPEG files are not supported "
                                        "(Pillow: cannot handle them)")
                mode = {1: "L", 3: "RGB", 4: "CMYK"}.get(body[5], "")
                if not mode:
                    raise NotThisFormat(f"JPEG files of {body[5]} components are not "
                                        "supported")
            elif i == 0xFFDB:
                while body:
                    step = 1 + (64 if body[0] < 16 else 128)
                    if len(body) < step:
                        raise NotThisFormat("corrupt JPEG file: a short DQT table")
                    body = body[step:]
            if i == 0xFFDA:
                return Header(mode, size)
            s, pos = data[pos:pos + 1], pos + 1
        elif 0xFFC0 <= i or i == 0xFF00:  # a marker without a segment, or a stuffed 0xFF
            s, pos = data[pos:pos + 1], pos + 1
        else:
            raise NotThisFormat("corrupt JPEG file: no marker found")


def _open_png(data: bytes) -> Header:
    if data[:8] != png.SIGNATURE:
        raise NotThisFormat("not a PNG file")
    length = struct.unpack_from(">I", data, 8)[0]
    size = struct.unpack_from(">II", data, 16) if data[12:16] == b"IHDR" and length >= 8 else None
    return Header("RGB", size)


def _open_gif(data: bytes) -> Header:
    if data[:6] not in gif.SIGNATURES:
        raise NotThisFormat("not a GIF file")
    return Header("RGB", struct.unpack_from("<HH", data[:13], 6))


def _open_gbr(data: bytes) -> Header:
    """``GbrImageFile._open``: a GIMP brush's header (version 1 or 2, a
    depth of 1 or 4, the magic of version 2). Its accept test takes many
    files of other formats (a QOI of width 1 or 2), which its _open then
    passes on."""
    header_size, version = _i32be(data, 0), _i32be(data, 4)
    if header_size < 20 or version not in (1, 2):
        raise NotThisFormat("not a GIMP brush")
    width, height, depth = struct.unpack_from(">III", data, 8)
    if width == 0 or height == 0 or depth not in (1, 4):
        raise NotThisFormat("not a GIMP brush")
    if version == 2 and data[20:24] != b"GIMP":
        raise NotThisFormat("not a GIMP brush, bad magic number")
    if version == 2:
        _i32be(data, 24)  # the spacing
    return Header("L" if depth == 1 else "RGBA", (width, height))


def _unsplit(decode: Callable[[bytes], np.ndarray]) -> Callable[[bytes, Header], np.ndarray]:
    return lambda data, header: decode(data)


# --- the plugins without an accept test before TGA: the checks of their _open --


def _open_im(data: bytes) -> Header:
    """``ImImageFile._open``: a text header of ``Key: value`` lines of at
    most 100 bytes, one of them a known key, then a 0x1A byte."""
    if b"\n" not in data[:100]:
        raise NotThisFormat("not an IM file")
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    tags = {"Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
            "Name", "Scale (x,y)", "Image size (x*y)", "Image type"}
    pos, n, s = 0, 0, b""
    while True:
        s, pos = data[pos:pos + 1], pos + 1
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            raise NotThisFormat("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = re.match(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$", s)
        if not m:
            raise NotThisFormat("not an IM file: a header line that is no field")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            v = tuple(_number(x) for x in v.replace("*", ",").split(","))
            v = v[0] if len(v) == 1 else v
        info[k] = v
        n += k in tags
    if not n:
        raise NotThisFormat("not an IM file")
    size = info["Image size (x*y)"]
    while s and not s.startswith(b"\x1a"):
        s, pos = data[pos:pos + 1], pos + 1
    if not s:
        raise NotThisFormat("not an IM file: truncated")
    if "Lut" in info:
        data[pos + 767]  # Pillow reads a 768-byte palette: IndexError where it is short
    (0, 0) + size  # noqa: B018  (the tile: TypeError where the size is one number)
    return Header(str(info["Image type"]), tuple(size))


def _number(s: str) -> float:
    try:
        return int(s)
    except ValueError:
        return float(s)


def _open_imt(data: bytes) -> Header:
    """``ImtImageFile._open``: ``key value`` lines up to a form feed; it
    opens only where they set a width, a height and ``pixel n8``."""
    buffer, pos = data[:100], min(100, len(data))
    if b"\n" not in buffer:
        raise NotThisFormat("not an IM Tools file")
    width = height = 0
    mode = ""
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s, pos = data[pos:pos + 1], min(pos + 1, len(data))
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += data[pos:pos + 100]
            pos = min(pos + 100, len(data))
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = re.match(rb"([a-z]*) ([^ \r\n]*)", s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            width = int(v)
        elif k == b"height":
            height = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    return Header(mode, (width, height))


def _open_iptc(data: bytes) -> Header:
    """``IptcImageFile._open``: 0x1C-tagged fields up to tag (8, 10), the
    mode from tag (3, 60), the size from (3, 20) and (3, 30), a known
    compression in (3, 120)."""
    info, pos = {}, 0
    while True:
        s = data[pos:pos + 5]
        pos += len(s)
        if not s.strip(b"\x00"):
            tag = None
            break
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise NotThisFormat("not an IPTC/NAA file")
        size = s[3]
        if size > 132:
            raise ValueError("corrupt IPTC/NAA file: a field length over 132")
        if size == 128:
            size = 0
        elif size > 128:
            extra = data[pos:pos + size - 128]
            pos += len(extra)
            size = _i32be((b"\0\0\0\0" + extra)[-4:])
        else:
            size = struct.unpack_from(">H", s, 3)[0]
        if tag == (8, 10):
            break
        value = data[pos:pos + size] if size else None
        pos = min(pos + size, len(data))
        if tag in info:
            info[tag] = (info[tag] if isinstance(info[tag], list) else [info[tag]]) + [value]
        else:
            info[tag] = value
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode = ""
    if layers == 1 and not component:
        mode = "L"
    else:
        mode = "RGB" if layers == 3 and component else "CMYK" if layers == 4 and component else ""
        if (3, 65) in info:
            info[(3, 65)][0] - 1  # noqa: B018  (Pillow reads the band)
    size = tuple(_i32be((b"\0\0\0\0" + info[key])[-4:]) for key in ((3, 20), (3, 30)))
    if _i32be((b"\0\0\0\0" + info.get((3, 120), b"\xff" * 4))[-4:]) not in (1, 5):
        raise ValueError("an IPTC/NAA image of unknown compression")
    return Header(mode, size)


def _open_pcd(data: bytes) -> Header:
    """``PcdImageFile._open``: ``PCD_`` at byte 2048."""
    s = data[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise NotThisFormat("not a PCD file")
    return Header("RGB", (512, 768) if s[1538] & 3 in (1, 3) else (768, 512))


def _spider_header(t: tuple) -> int:
    """``SpiderImagePlugin.isSpiderHeader``."""
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        try:
            if h[i] - int(h[i]) != 0:
                return 0
        except (ValueError, OverflowError):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labbyt = int(h[22])
    return labbyt if labbyt == int(h[13]) * int(h[23]) else 0


def _open_spider(data: bytes) -> Header:
    """``SpiderImageFile._open``: 27 floats, big- then little-endian, that
    look like a SPIDER header of a 2D image."""
    f = data[:108]
    if len(f) < 108:
        raise NotThisFormat("not a SPIDER file")
    t = struct.unpack(">27f", f)
    if not _spider_header(t):
        t = struct.unpack("<27f", f)
        if not _spider_header(t):
            raise NotThisFormat("not a SPIDER file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise NotThisFormat("not a SPIDER 2D image")
    size, stack, number = (int(h[12]), int(h[2])), int(h[24]), int(h[27])
    if stack > 0 and number == 0:
        int(h[26])  # the stack's image count
    elif stack != 0 or number != 0:
        if stack == 0 and number > 0:
            raise ValueError("a SPIDER image inside a stack (Pillow cannot open it)")
        raise NotThisFormat("inconsistent SPIDER stack header values")
    return Header("F", size)


# --- the order of Image.ID -------------------------------------------------------

_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                  b"II\x2b\x00")
PLUGINS = (
    # Image.preinit's: BmpImagePlugin (BMP, DIB), GIF, JPEG, PPM, PNG.
    Plugin("BMP", _starts(b"BM"), bmp.open_bmp, bmp.decode_bmp),
    Plugin("DIB", bmp.dib_accept, bmp.open_dib, bmp.decode_dib),
    Plugin("GIF", _starts(*gif.SIGNATURES), _open_gif, _unsplit(gif.decode_gif)),
    Plugin("JPEG", _starts(b"\xff\xd8\xff"), _open_jpeg, _unsplit(jpeg.decode_jpeg)),
    Plugin("PPM", netpbm.accept, netpbm.open_ppm, netpbm.decode_ppm),
    Plugin("PNG", _starts(png.SIGNATURE), _open_png, _unsplit(png.decode_png)),
    # Image.init's, in the order of PIL._plugins.
    Plugin("AVIF", lambda p: p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1",
                                                                b"msf1")),
    Plugin("BLP", _starts(b"BLP1", b"BLP2")),
    Plugin("BUFR", _starts(b"BUFR", b"ZCZC")),
    Plugin("CUR", _starts(ico.SIGNATURES[1]), ico.open_cur, ico.decode_ico),
    Plugin("PCX", pcx.accept, pcx.open_pcx, pcx.decode_pcx),
    Plugin("DCX", lambda p: len(p) >= 4 and _i32le(p) == 0x3ADE68B1),
    Plugin("DDS", _starts(b"DDS ")),
    Plugin("EPS", lambda p: p.startswith(b"%!PS") or (len(p) >= 4 and _i32le(p) == 0xC6D3D0C5)),
    Plugin("FITS", _starts(b"SIMPLE")),
    Plugin("FLI", lambda p: len(p) >= 16 and _i16le(p, 4) in (0xAF11, 0xAF12)
           and _i16le(p, 14) in (0, 3)),
    Plugin("FTEX", _starts(b"FTEX")),
    Plugin("GBR", lambda p: len(p) >= 8 and _i32be(p) >= 20 and _i32be(p, 4) in (1, 2),
           _open_gbr),
    Plugin("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1),
    Plugin("HDF5", _starts(b"\x89HDF\r\n\x1a\n")),
    Plugin("JPEG2000", _starts(jpeg2000.J2K_SIGNATURE, jpeg2000.JP2_SIGNATURE), None,
           _unsplit(jpeg2000.decode_jpeg2000)),
    Plugin("ICNS", _starts(b"icns")),
    Plugin("ICO", _starts(ico.SIGNATURES[0]), ico.open_ico, ico.decode_ico),
    Plugin("IM", None, _open_im),
    Plugin("IMT", None, _open_imt),
    Plugin("IPTC", None, _open_iptc),
    Plugin("MCIDAS", _starts(b"\x00\x00\x00\x00\x00\x00\x00\x04")),
    Plugin("MPEG", _starts(b"\x00\x00\x01\xb3")),
    Plugin("TIFF", _starts(*_TIFF_PREFIXES), None, _unsplit(tiff.decode_tiff)),
    Plugin("MSP", _starts(b"DanM", b"LinS")),
    Plugin("PCD", None, _open_pcd),
    Plugin("PIXAR", _starts(b"\x80\xe8\x00\x00")),
    Plugin("PSD", _starts(b"8BPS")),
    Plugin("QOI", _starts(qoi.SIGNATURE), qoi.open_qoi, qoi.decode_qoi),
    Plugin("SGI", lambda p: len(p) >= 2 and struct.unpack_from(">H", p)[0] == 474),
    Plugin("SPIDER", None, _open_spider),
    Plugin("SUN", lambda p: len(p) >= 4 and _i32be(p) == 0x59A66A95),
    Plugin("TGA", None, tga.open_tga, tga.decode_tga),
    Plugin("WEBP", lambda p: p.startswith(b"RIFF") and p[8:12] == b"WEBP"
           and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L"), None, _unsplit(webp.decode_webp)),
    Plugin("WMF", _starts(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00")),
    Plugin("XBM", lambda p: p.lstrip().startswith(b"#define")),
    Plugin("XPM", _starts(b"/* XPM */")),
    Plugin("XVTHUMB", _starts(b"P7 332")),
)
# What the port reads, for the refusals' text.
READ = ("JPEG (Huffman or arithmetic-coded, lossless too)", "PNG", "GIF", "BMP", "DIB", "WebP",
        "TIFF (YCbCr too)", "ICO", "CUR", "JPEG 2000 (sYCC too)", "TGA",
        "Netpbm (PBM, PGM, PPM, PFM)", "QOI")


def open_image(data: bytes) -> tuple[Plugin, Header | None]:
    """The plugin ``Image.open`` would open ``data`` with, and its header.
    Raises ``ValueError`` where Pillow raises: "cannot identify image file"
    where every plugin passes the file by (with each one's reason)."""
    data = bytes(data)
    prefix, passed = data[:16], []
    for plugin in PLUGINS:
        try:
            if plugin.accept is not None and not plugin.accept(prefix):
                continue
        except struct.error:
            continue
        if plugin.open is None:
            return plugin, None
        try:
            header = open_as(plugin.open, data)
        except NotThisFormat as e:
            passed.append(f"{plugin.name}: {e}")
            continue
        except ValueError:
            raise
        except Exception as e:  # what else Pillow's _open raises refuses the file
            raise ValueError(f"a {plugin.name} header Pillow refuses: {e!r}") from e
        if header.size is not None and max(1, header.size[0]) * max(1, header.size[1]) > (
                2 * MAX_IMAGE_PIXELS):
            raise ValueError(f"a {plugin.name} image of {header.size[0]}x{header.size[1]} "
                             "pixels: over Pillow's decompression bomb limit")
        return plugin, header
    raise ValueError(f"cannot identify image file (the port reads {', '.join(READ)}; "
                     f"{'; '.join(passed) or 'no plugin took it'})")


def identify(data: bytes) -> str:
    """The format Pillow 12.1's ``Image.open(f).format`` gives ``data``
    (``ValueError`` where ``Image.open`` raises)."""
    return open_image(data)[0].name


def decode(data: bytes) -> np.ndarray:
    """``data``'s (H, W, 3) uint8 RGB, decoded as the format ``identify``
    names; ``ValueError`` for a format the port does not read."""
    data = bytes(data)
    plugin, header = open_image(data)
    if plugin.decode is None:
        raise ValueError(f"cannot read {plugin.name} image files (Pillow opens this file as "
                         f"{plugin.name}; the port reads {', '.join(READ)})")
    return plugin.decode(data, header)

