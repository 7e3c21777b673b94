"""TGA, DIB, Netpbm and QOI in the LAION loader, against Pillow 12.1, on the CPU.

JAX's loader reads every record with ``Image.open(f).convert("RGB")``, so a
record in any of these formats trains there. The port reads them in
``data/tga.py``, ``data/bmp.py`` (``decode_dib``), ``data/netpbm.py`` and
``data/qoi.py``; TGA's run-length packets and QOI's ops run in C
(``data/csrc/raster.c``). Held here:

- each format's RGB byte-equal to Pillow's, and its refusals where Pillow
  refuses: TGA in every mode of the plugin's ``MODES`` (colour-mapped with
  16- and 24-bit maps and a first index, 1-bit, grey, grey + alpha, 15/16-,
  24- and 32-bit), raw and run-length, every origin and the horizontal flip,
  an ID field, packets that cross rows, short files; DIB in each bit depth
  and header Pillow reads; Netpbm P1-P6 raw and plain at every kind of
  maxval, comments, ``Pf`` both ways round, Pillow's own magic numbers, PAM
  and ``PF`` refused; QOI RGB and RGBA and every op;
- the C bodies byte-equal to their plain versions, and a fuzz subprocess
  (``tests/torch_decode_fuzz_worker.py``) that requires the C to refuse
  exactly what the plain body refuses;
- the committed fixtures rebuilt byte for byte, and their digests in
  ``tests/fixtures/laion_loader_pillow.json`` (``chip_smoke.py``'s
  ``laion_loader`` holds them on the card's host).
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import io
import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_decoders import _image, write_bmp
from tinydiffusion_torch.data import bmp, laion, netpbm, qoi, tga

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
SHAPE = (45, 61)


def _pillow(data: bytes) -> np.ndarray | None:
    """Pillow's RGB, or None where it refuses the file."""
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # noqa: BLE001  (any refusal of Pillow's)
        return None


def _saved(image: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **kw)
    return buf.getvalue()


def _same(data: bytes, *decoders) -> None:
    """Each decoder (``decode_image`` first) gives Pillow's bytes, or
    refuses where Pillow refuses."""
    want = _pillow(data)
    for decode in (laion.decode_image, *decoders):
        if want is None:
            with pytest.raises(ValueError):
                decode(data)
        else:
            got = decode(data)
            assert got.dtype == np.uint8 and got.shape == want.shape, decode
            np.testing.assert_array_equal(got, want)


def smooth_image(size: int) -> np.ndarray:
    """A smooth synthetic RGB image, which the lossless and run-length coders
    shrink: quantised gradients and a disc."""
    yy, xx = np.mgrid[0:size, 0:size]
    r = np.hypot(yy - 0.4 * size, xx - 0.55 * size) / size
    return np.stack([xx * 255 // (size - 1) // 8 * 8, yy * 255 // (size - 1) // 8 * 8,
                     np.clip(255 - r * 400, 0, 255).astype(np.int64) // 16 * 16],
                    -1).astype(np.uint8)


# --- TGA ---------------------------------------------------------------------------


def write_tga(width: int, height: int, imagetype: int, depth: int, body: bytes, *,
              cmap: tuple | None = None, flags: int = 0, id_field: bytes = b"") -> bytes:
    """A TGA file: ``cmap`` (first index, entries, entry bits, raw entries)."""
    first, length, bits, raw = cmap or (0, 0, 0, b"")
    return (bytes([len(id_field), 1 if cmap else 0, imagetype])
            + struct.pack("<HHBHHHHBB", first, length, bits, 0, 0, width, height, depth, flags)
            + id_field + raw + body)


def rle_packets(pixels: np.ndarray, depth: int, max_run: int = 128,
                across_rows: bool = True) -> bytes:
    """Run-length packets of (rows, width, depth // 8) pixel bytes: runs of
    equal pixels, literals between them (literal packets run across rows
    where ``across_rows``; runs never do)."""
    px = pixels.reshape(pixels.shape[0], -1, max(depth // 8, 1))
    out, literal = bytearray(), []

    def flush():
        while literal:
            chunk, literal[:] = literal[:max_run], literal[max_run:]
            out.append(len(chunk) - 1)
            out.extend(b"".join(chunk))

    for row in px:
        x = 0
        while x < len(row):
            n = 1
            while x + n < len(row) and n < max_run and np.array_equal(row[x + n], row[x]):
                n += 1
            if n > 1:
                flush()
                out.append(0x80 | (n - 1))
                out.extend(row[x].tobytes())
            else:
                literal.append(row[x].tobytes())
            x += n
        if not across_rows:
            flush()
    flush()
    return bytes(out)


def _tga_images() -> dict:
    base = Image.fromarray(_image(SHAPE, 40))
    return {"1": base.convert("1"), "L": base.convert("L"), "LA": base.convert("LA"),
            "P": base.quantize(60), "RGB": base, "RGBA": base.convert("RGBA")}


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("flags", [0x00, 0x10, 0x20, 0x30])
def test_pillows_tga_in_each_mode_and_origin_equals_pillow(mode, rle, flags):
    """Pillow's TGA of each mode, raw and run-length (a run-length 1-bit
    file, which Pillow refuses, refused too), its descriptor's origin bits
    set to each of the four origins, the alpha bits kept."""
    data = bytearray(_saved(_tga_images()[mode], "TGA", rle=rle, id_section=b"an ID"))
    data[17] = data[17] & 0x0F | flags
    _same(bytes(data), tga.decode_tga, tga.decode_tga_reference)


def _bgr15(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint16) >> 3 for i in range(3))
    return (alpha.astype(np.uint16) << 15 | r << 10 | g << 5 | b).astype("<u2")


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("flags", [0x00, 0x20, 0x30])
def test_15_and_16_bit_tga_equals_pillow(rle, flags):
    h, w = SHAPE
    px = _bgr15(_image(SHAPE, 41), _image(SHAPE, 42)[..., 0] > 127).view(np.uint8).reshape(h, -1)
    body = rle_packets(px, 16) if rle else px.tobytes()
    _same(write_tga(w, h, 10 if rle else 2, 16, body, flags=flags), tga.decode_tga,
          tga.decode_tga_reference)


@pytest.mark.parametrize("bits", [16, 24, 32])
@pytest.mark.parametrize("first", [0, 3, 200])
def test_colour_maps_equal_pillow(bits, first):
    """A colour-mapped image whose map holds 56 entries from index
    ``first`` on (black before them and past them; past 256 entries, and a
    32-bit map, refused as Pillow refuses them), raw and run-length; the
    same map on grey, 1-bit and true-colour images."""
    h, w = SHAPE
    rng = np.random.default_rng(bits + first)
    rgb = rng.integers(0, 256, (56, 3), dtype=np.uint8)
    entries = {16: _bgr15(rgb, np.ones(56, bool)).tobytes(), 24: rgb[:, ::-1].tobytes(),
               32: np.concatenate([rgb[:, ::-1], rgb[:, :1]], 1).tobytes()}[bits]
    cmap = (first, 56, bits, entries)
    index = rng.integers(0, 256, SHAPE, dtype=np.uint8)
    for imagetype, depth, body in ((1, 8, index.tobytes()), (9, 8, rle_packets(index, 8)),
                                   (3, 8, index.tobytes()), (11, 8, rle_packets(index, 8)),
                                   (3, 1, np.packbits(index > 127, axis=1).tobytes()),
                                   (2, 24, _image(SHAPE, 43).tobytes())):
        _same(write_tga(w, h, imagetype, depth, body, cmap=cmap), tga.decode_tga,
              tga.decode_tga_reference)


def test_packets_across_rows_and_short_files_equal_pillow():
    """Literal packets that run on into the next rows (and past the last
    one) are read; a run across its row's end is refused (Pillow: buffer
    overrun); a type-depth pair outside ``MODES``, a colour-mapped type
    without a map, short files and a truncated map refused; bytes past the
    image ignored."""
    h, w = SHAPE
    grey = _image(SHAPE, 44)[..., 0]
    across = rle_packets(grey, 8, across_rows=True)
    assert len(across) != len(rle_packets(grey, 8, across_rows=False))
    cases = [write_tga(w, h, 11, 8, across), write_tga(w, h, 11, 8, across + b"\x05junk"),
             write_tga(3, 3, 11, 8, bytes([0x80, 9, 0x05, 1, 2, 3, 4, 5, 6, 0x81, 7])),
             write_tga(3, 2, 11, 8, bytes([0x80, 9, 0x82, 5, 0x81, 1])),
             write_tga(2, 2, 11, 8, bytes([0x81, 7, 0x05, 9, 8, 7, 6, 5, 4])),
             write_tga(2, 2, 11, 8, bytes([0x81, 7, 0x82, 9])),
             write_tga(2, 2, 11, 8, bytes([0x81, 7, 0x05, 9, 8])),
             write_tga(2, 2, 3, 8, bytes([1, 2, 3])), write_tga(2, 2, 3, 8, bytes(5)),
             write_tga(2, 2, 2, 8, bytes(4)), write_tga(2, 2, 3, 24, bytes(12)),
             write_tga(2, 2, 1, 8, bytes(4)), write_tga(2, 2, 9, 8, bytes([0x83, 1])),
             write_tga(2, 2, 1, 16, bytes(8), cmap=(0, 2, 24, bytes(6))),
             write_tga(2, 2, 1, 8, bytes(4), cmap=(0, 4, 24, bytes(5))),
             write_tga(2, 2, 1, 8, bytes(4), cmap=(250, 7, 24, bytes(21))),
             write_tga(2, 2, 1, 8, bytes(4), cmap=(249, 7, 24, bytes(21)))]
    for data in cases:
        _same(data, tga.decode_tga, tga.decode_tga_reference)
    full = _saved(_tga_images()["RGB"], "TGA", rle=True)
    for cut in (18, 30, len(full) // 2, len(full) - 1):
        _same(full[:cut], tga.decode_tga, tga.decode_tga_reference)


def test_tga_rle_in_c_equals_the_plain_loop():
    """``tdt_tga_rle`` against ``_rle_reference`` on seeded packet streams
    of each pixel size, cut at every length of the first 40 bytes."""
    rng = np.random.default_rng(45)
    for depth in (1, 2, 3, 4):
        px = rng.integers(0, 4, (7, 9 * depth), dtype=np.uint8)
        stream = rle_packets(px, 8 * depth, max_run=rng.integers(2, 9))
        for n in [*range(40), len(stream)]:
            results = []
            for rle in (tga._rle_native, tga._rle_reference):
                try:
                    results.append(rle(stream[:n], depth, 9 * depth, 7).tobytes())
                except ValueError as e:
                    results.append(str(e))
            assert results[0] == results[1], (depth, n)


# --- DIB ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pillows_dib_equals_pillow(mode):
    image = {"1": lambda b: b.convert("1"), "L": lambda b: b.convert("L"),
             "P": lambda b: b.quantize(30), "RGB": lambda b: b,
             "RGBA": lambda b: b.convert("RGBA")}[mode](Image.fromarray(_image(SHAPE, 46)))
    data = _saved(image, "DIB")
    assert data[:4] == b"\x28\x00\x00\x00"
    _same(data, bmp.decode_dib)


def test_dib_variants_equal_pillow():
    """BMPs of each depth, header (core, 40 with masks after it, 56) and
    compression without their 14-byte file header: Pillow's DIB reads them
    from the header on, the pixels right after the header, masks and
    palette. A truncated header, a header size past the file, and one Pillow
    does not know, as Pillow takes them."""
    h, w = SHAPE
    rng = np.random.default_rng(47)
    files = []
    for bits in (1, 4, 8):
        palette = rng.integers(0, 256, (1 << bits, 3), dtype=np.uint8)
        per = 8 // bits
        idx = rng.integers(0, 1 << bits, (h, w))
        padded = np.pad(idx, [(0, 0), (0, -w % per)]).reshape(h, -1, per)
        rows = (padded << (bits * np.arange(per - 1, -1, -1))).sum(-1).astype(np.uint8)
        stride = ((w * bits + 31) >> 3) & ~3
        body = np.pad(rows, [(0, 0), (0, stride - rows.shape[1])]).tobytes()
        files += [write_bmp(w, h, bits, body, palette), write_bmp(w, h, bits, body, palette,
                                                                 header=12)]
    px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    files.append(write_bmp(w, h, 32, px.tobytes(), compression=3, header=56,
                           masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)))
    values = rng.integers(0, 65536, SHAPE).astype("<u2")
    stride = ((w * 16 + 31) >> 3) & ~3
    body16 = b"".join(np.pad(values[y].view(np.uint8), (0, stride - 2 * w)).tobytes()
                      for y in range(h))
    files.append(write_bmp(w, h, 16, body16, compression=3, masks=(0xF800, 0x7E0, 0x1F, 0)))
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    rle8 = bytes([3, 5, 0, 3, 1, 2, 3, 0, 0, 2, 7, 0, 4, 9, 8, 7, 6, 0, 0, 1])
    files.append(write_bmp(7, 5, 8, rle8, palette, compression=1, top_down=True))
    for data in files:
        dib = data[14:]
        _same(dib, bmp.decode_dib)
    dib = files[-2][14:]
    for data in (dib[:3], dib[:30], dib[:52], b"\x28\x00\x00\x00" + bytes(10),
                 b"\x7c\x00\x00\x00" + dib[4:60], b"\x0c\x00\x00\x00\x00\x00"):
        _same(data)


# --- Netpbm ------------------------------------------------------------------------


def plain_pnm(magic: bytes, samples: np.ndarray, maxval: int | None, *, comments: bool = False,
              packed: bool = False) -> bytes:
    """A plain (ASCII) PBM, PGM or PPM: ``packed`` PBM digits without
    whitespace; ``comments`` in the header and the data."""
    h, w = samples.shape[:2]
    head = magic + (b" # a comment\n" if comments else b"\n") + b"%d %d\n" % (w, h)
    if maxval is not None:
        head += b"%d\n" % maxval
    rows = []
    for row in samples.reshape(h, -1):
        text = (b"" if packed else b" ").join(b"%d" % v for v in row)
        rows.append(text + (b" # row\n" if comments else b"\n"))
    return head + b"".join(rows)


def _pnm_cases() -> dict:
    h, w = SHAPE
    rgb = _image(SHAPE, 48)
    grey, bits = rgb[..., 0], rgb[..., 1] > 127
    rng = np.random.default_rng(49)
    wide = rng.integers(0, 65536, SHAPE)
    cases = {
        "P1": plain_pnm(b"P1", bits.astype(int), None),
        "P1_packed": plain_pnm(b"P1", bits.astype(int), None, packed=True, comments=True),
        "P2_255": plain_pnm(b"P2", grey, 255, comments=True),
        "P2_15": plain_pnm(b"P2", grey >> 4, 15),
        "P2_1000": plain_pnm(b"P2", grey.astype(int) * 3, 1000),
        "P2_65535": plain_pnm(b"P2", wide, 65535),
        "P3_100": plain_pnm(b"P3", rgb.astype(int) * 100 // 255, 100, comments=True),
        "P3_255": plain_pnm(b"P3", rgb, 255),
        "P3_over": plain_pnm(b"P3", rgb, 200),
        "P4": b"P4\n%d %d\n" % (w, h) + np.packbits(bits, axis=1).tobytes(),
        "P5_255": b"P5 %d %d 255\n" % (w, h) + grey.tobytes(),
        "P5_100": b"P5\n# c\n%d %d\n100\n" % (w, h) + (grey // 2).tobytes(),
        "P5_1000": b"P5 %d %d 1000\n" % (w, h) + (grey.astype(">u2") * 4).tobytes(),
        "P5_65535": b"P5 %d %d 65535\n" % (w, h) + wide.astype(">u2").tobytes(),
        "P5_300": b"P5 %d %d 300\n" % (w, h) + wide.astype(">u2").tobytes(),
        "P6_255": b"P6 %d %d 255\n" % (w, h) + rgb.tobytes(),
        "P6_63": b"P6 %d %d 63\n" % (w, h) + (rgb >> 2).tobytes(),
        "P6_65535": b"P6 %d %d 65535\n" % (w, h) + (rgb.astype(">u2") * 257).tobytes(),
        "P6_4000": b"P6 %d %d 4000\n" % (w, h) + (rgb.astype(">u2") * 17).tobytes(),
        "Pf_le": b"Pf\n%d %d\n-1.0\n" % (w, h) + (wide.astype("<f4") / 200 - 20).tobytes(),
        "Pf_be": b"Pf %d %d 2.5\n" % (w, h) + np.where(
            wide % 7 == 0, np.nan, wide / 100.0).astype(">f4").tobytes(),
        "P0CMYK": b"P0CMYK %d %d 255\n" % (w, h) + np.dstack([rgb, grey]).tobytes(),
        "PyRGBA": b"PyRGBA %d %d 255\n" % (w, h) + np.dstack([rgb, grey]).tobytes(),
        "PyCMYK": b"PyCMYK %d %d 255\n" % (w, h) + np.dstack([rgb, grey]).tobytes(),
        "PyP": b"PyP %d %d 255\n" % (w, h) + grey.tobytes(),
        # Not Pillow's, or refused by it.
        "P7": b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n" % (w, h)
              + rgb.tobytes(),
        "PF": b"PF %d %d -1.0\n" % (w, h) + rgb.astype("<f4").tobytes(),
        "maxval_0": b"P5 %d %d 0\n" % (w, h) + grey.tobytes(),
        "maxval_65536": b"P5 %d %d 65536\n" % (w, h) + grey.tobytes(),
        "scale_0": b"Pf %d %d 0.0\n" % (w, h) + grey.astype("<f4").tobytes(),
        "width_0": b"P5 0 %d 255\n" % h + grey.tobytes(),
        "width_-1": b"P5 -1 %d 255\n" % h + grey.tobytes(),
        "token_11": b"P5 000000000061 %d 255\n" % h + grey.tobytes(),
        "P2_float": b"P2 2 1 255\n1 2.0\n",
        "P1_bad": b"P1 3 1\n1 0 2\n",
        "P2_negative": b"P2 2 1 255\n1 -2\n",
        "P2_short": b"P2 2 2 255\n1 2 3",
        "ends_in_header": b"P6 61",
        "comment_to_end": b"P5 2 1 255 # no newline",
    }
    return cases


@pytest.mark.parametrize("name", sorted(_pnm_cases()))
def test_netpbm_equals_pillow(name):
    data = _pnm_cases()[name]
    _same(data, netpbm.decode_ppm if _pillow(data) is not None else laion.decode_image)
    for cut in (len(data) // 3, len(data) - 1):
        _same(data[:cut])


@pytest.mark.parametrize("mode", ["1", "L", "I", "RGB"])
def test_pillows_netpbm_equals_pillow(mode):
    base = Image.fromarray(_image(SHAPE, 50))
    image = {"1": base.convert("1"), "L": base.convert("L"),
             "I": Image.fromarray(np.random.default_rng(51).integers(0, 65536, SHAPE)
                                  .astype(np.int32)), "RGB": base}[mode]
    _same(_saved(image, "PPM"), netpbm.decode_ppm)


# --- QOI ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("shape", [(1, 1), SHAPE, (64, 80)])
def test_pillows_qoi_equals_pillow(mode, shape):
    """Pillow's QOI (every op: runs of the smooth image, index, diff and luma
    ops of the noisy one, RGBA ops where alpha moves)."""
    rgb = np.concatenate([smooth_image(max(shape))[:shape[0], :shape[1] // 2],
                          _image(shape, 52)[:, shape[1] // 2:]], axis=1)
    alpha = (np.arange(np.prod(shape)).reshape(shape) // 7 % 3 * 100).astype(np.uint8)
    image = Image.fromarray(np.dstack([rgb, alpha]) if mode == "RGBA" else rgb)
    _same(_saved(image, "QOI"), qoi.decode_qoi, qoi.decode_qoi_reference)


def _qoi(width: int, height: int, channels: int, ops: bytes) -> bytes:
    return b"qoif" + struct.pack(">II", width, height) + bytes([channels, 0]) + ops


def test_qoi_ops_and_short_files_equal_pillow():
    """Ops Pillow's writer never emits: an index of a slot never written
    (0, 0, 0, 0), RGBA ops in an RGB image (their alpha in the hash), a run
    past the last pixel, a channel count of neither 3 nor 4; files cut inside
    an op and inside the header; an empty image (Pillow: not this format)."""
    cases = [_qoi(3, 1, 3, bytes([0x05, 0xFF, 1, 2, 3, 4, 0x3F])),
             _qoi(2, 2, 3, bytes([0xFE, 9, 9, 9, 0xC0 | 10])),
             _qoi(2, 2, 4, bytes([0xFF, 9, 9, 9, 0, 0x40 | 0x3F, 0x80 | 0x3F, 0x8F, 0x00])),
             _qoi(2, 1, 7, bytes([0xFE, 1, 2, 3, 0x2A])),
             _qoi(2, 1, 3, bytes([0xFE, 1, 2])), _qoi(2, 1, 3, bytes([0x80])),
             _qoi(2, 1, 3, b""), _qoi(0, 1, 3, bytes([0xFE, 1, 2, 3])),
             b"qoif" + bytes(6), b"qoif" + bytes(8)]
    for data in cases:
        _same(data, qoi.decode_qoi, qoi.decode_qoi_reference)
    full = _saved(Image.fromarray(_image(SHAPE, 53)), "QOI")
    for cut in range(12, len(full), 997):
        _same(full[:cut], qoi.decode_qoi, qoi.decode_qoi_reference)


# --- fuzz, fixtures ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["laion_loader_rgba_rle.tga", "laion_loader_15_mirrored.tga",
                                  "laion_loader_rgba.qoi", "laion_loader.dib",
                                  "laion_loader_plain.ppm"])
def test_corrupt_files_are_refused_alike_by_both_decoders(name, tmp_path):
    """Seeded truncations and replaced bytes (``torch_decode_fuzz_worker``,
    a subprocess: a crash fails this test): the C refuses exactly the
    mutants the plain body refuses and otherwise gives its bytes."""
    path = tmp_path / name
    path.write_bytes((FIXTURES / name).read_bytes())
    proc = subprocess.run([sys.executable, "-m", "tests.torch_decode_fuzz_worker", str(path),
                           "26", "200"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _fixture_bytes(name: str) -> bytes:
    """The committed fixture ``name`` as this module writes it."""
    h, w = SHAPE
    rgb = _image(SHAPE, 60)
    base = Image.fromarray(rgb)
    big = smooth_image(512)
    cmap_rgb = np.random.default_rng(61).integers(0, 256, (40, 3), dtype=np.uint8)
    index = (_image(SHAPE, 62)[..., 0] % 40 + 3).astype(np.uint8)
    px15 = _bgr15(rgb, rgb[..., 0] > 100).view(np.uint8).reshape(h, -1)
    return {
        "laion_loader_p.tga": lambda: _saved(base.quantize(50), "TGA"),
        "laion_loader_p_rle.tga": lambda: _saved(base.quantize(50), "TGA", rle=True),
        "laion_loader_l_rle.tga": lambda: _saved(base.convert("L"), "TGA", rle=True,
                                                 orientation=1),
        "laion_loader_la.tga": lambda: _saved(base.convert("LA"), "TGA"),
        "laion_loader_1.tga": lambda: _saved(base.convert("1"), "TGA"),
        # An uncompressed true-colour TGA starts as a cursor does.
        "laion_loader_rgb.tga": lambda: _saved(base, "TGA"),
        "laion_loader_rgba_rle.tga": lambda: _saved(base.convert("RGBA"), "TGA", rle=True),
        "laion_loader_15_mirrored.tga": lambda: write_tga(
            w, h, 10, 16, rle_packets(px15, 16), flags=0x30, id_field=b"15-bit, mirrored"),
        "laion_loader_cmap16.tga": lambda: write_tga(
            w, h, 1, 8, index.tobytes(),
            cmap=(3, 40, 16, _bgr15(cmap_rgb, np.ones(40, bool)).tobytes())),
        "laion_loader_512_rle.tga": lambda: _saved(Image.fromarray(big), "TGA", rle=True),
        "laion_loader.dib": lambda: _saved(base, "DIB"),
        "laion_loader_p.dib": lambda: _saved(base.quantize(20), "DIB"),
        "laion_loader.pbm": lambda: _saved(base.convert("1"), "PPM"),
        "laion_loader.pgm": lambda: _saved(base.convert("L"), "PPM"),
        "laion_loader_16.pgm": lambda: _saved(Image.fromarray(
            (rgb[..., 0].astype(np.int32) * 257 // 2)), "PPM"),
        "laion_loader.ppm": lambda: _saved(base, "PPM"),
        "laion_loader_plain.pbm": lambda: plain_pnm(b"P1", (rgb[..., 1] > 127).astype(int),
                                                    None, packed=True),
        "laion_loader_plain.pgm": lambda: plain_pnm(b"P2", rgb[..., 2].astype(int) * 4, 1020,
                                                    comments=True),
        "laion_loader_plain.ppm": lambda: plain_pnm(b"P3", rgb.astype(int) * 100 // 255, 100),
        "laion_loader.pfm": lambda: b"Pf\n%d %d\n-1.0\n" % (w, h) + (
            rgb[..., 0].astype("<f4") * 1.5 - 40).tobytes(),
        "laion_loader_rgb.qoi": lambda: _saved(base, "QOI"),
        "laion_loader_rgba.qoi": lambda: _saved(base.convert("RGBA"), "QOI"),
        "laion_loader_512.qoi": lambda: _saved(Image.fromarray(big), "QOI"),
    }[name]()


FIXTURE_NAMES = ("laion_loader_p.tga", "laion_loader_p_rle.tga", "laion_loader_l_rle.tga",
                 "laion_loader_la.tga", "laion_loader_1.tga", "laion_loader_rgb.tga",
                 "laion_loader_rgba_rle.tga", "laion_loader_15_mirrored.tga",
                 "laion_loader_cmap16.tga", "laion_loader_512_rle.tga", "laion_loader.dib",
                 "laion_loader_p.dib", "laion_loader.pbm", "laion_loader.pgm",
                 "laion_loader_16.pgm", "laion_loader.ppm", "laion_loader_plain.pbm",
                 "laion_loader_plain.pgm", "laion_loader_plain.ppm", "laion_loader.pfm",
                 "laion_loader_rgb.qoi", "laion_loader_rgba.qoi", "laion_loader_512.qoi")
_REFERENCES = {".tga": tga.decode_tga_reference, ".qoi": qoi.decode_qoi_reference,
               ".dib": bmp.decode_dib}


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_committed_fixture_is_rebuilt_and_decodes_as_pillow(name):
    data = (FIXTURES / name).read_bytes()
    assert data == _fixture_bytes(name)
    _same(data, _REFERENCES.get(Path(name).suffix, netpbm.decode_ppm))


def test_fixtures_are_in_the_cards_digest_table():
    digests = json.loads((FIXTURES / "laion_loader_pillow.json").read_text())
    assert set(FIXTURE_NAMES) <= set(digests)
