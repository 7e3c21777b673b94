"""YCbCr JPEG 2000 and YCbCr TIFF in the LAION loader, against Pillow 12.1.

Pillow converts YCbCr to RGB in two ways, and ``data/ycbcr.py`` has both:

- its own ``ImagingConvertYCbCr2RGB``, for a JP2 whose colour space is sYCC
  (what Pillow writes for a ``YCbCr`` image): held to Pillow's ``convert``
  on all 2**24 (Y, Cb, Cr) triples, then ``data/jpeg2000.py`` on
  Pillow-written YCbCr JP2s (reversible, irreversible, tiled, with layers)
  and on RGB and RGBA JP2s whose ``colr`` box says sYCC; e-sYCC refused, as
  Pillow refuses it;
- libtiff's ``TIFFYCbCrtoRGB`` behind its RGBA interface, for a YCbCr TIFF
  that is not JPEG: all 2**24 triples in one LZW TIFF Pillow writes, then
  random images through the small writer here (Pillow writes only 1 x 1
  subsampling): every subsampling of (1, 2, 4)**2 (the seven Pillow reads
  equal to it, the other two refused by both), strips and tiles at odd
  sizes, LZW, Deflate and PackBits, the horizontal predictor, several
  ``ReferenceBlackWhite`` and ``YCbCrCoefficients`` values; Pillow's own
  YCbCr TIFFs; the refusals (uncompressed, alpha, 16 bits, one sample,
  planar 2) by both.

``decode_tiff`` (C LZW and PackBits) and ``decode_tiff_reference`` agree
byte for byte, seeded corruptions are refused alike, and the committed
fixtures are rebuilt here (their digests in ``laion_loader_pillow.json``,
which ``chip_smoke.py``'s laion_loader phase holds on the card).
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import io
import json
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_decoders import _image
from tests.test_torch_tiff_ico import lzw_encode, packbits_encode, write_tiff
from tinydiffusion_torch.data import laion, tiff
from tinydiffusion_torch.data.ycbcr import LibtiffYCbCr, pillow_ycbcr_to_rgb

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
NONE, LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS = 1, 5, 8, 32946, 32773


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _saved(image: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **kw)
    return buf.getvalue()


def _all_triples() -> np.ndarray:
    """Every (Y, Cb, Cr) once, as a 4096 x 4096 x 3 uint8 image."""
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(
        4096, 4096, 3)


def _ycc(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3), dtype=np.uint8)


def _assert_pillows(data: bytes) -> None:
    """``decode_image`` equals Pillow, and the plain TIFF decoder too."""
    want = _pillow(data)
    got = laion.decode_image(data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if data[:4] in tiff.SIGNATURES:
        np.testing.assert_array_equal(tiff.decode_tiff_reference(data), want)


def _both_refuse(data: bytes) -> None:
    with pytest.raises(OSError):
        _pillow(data)
    with pytest.raises(ValueError):
        laion.decode_image(data)
    if data[:4] in tiff.SIGNATURES:
        with pytest.raises(ValueError):
            tiff.decode_tiff_reference(data)


# --- Pillow's YCbCr to RGB and sYCC JPEG 2000 ------------------------------------


def test_pillow_ycbcr_to_rgb_equals_convert_on_every_triple():
    triples = _all_triples()
    want = np.asarray(Image.frombytes("YCbCr", (4096, 4096), triples.tobytes()).convert("RGB"))
    for top in range(0, 4096, 512):
        rows = triples[top:top + 512]
        np.testing.assert_array_equal(pillow_ycbcr_to_rgb(*np.moveaxis(rows, -1, 0)),
                                      want[top:top + 512])


def _ycbcr_image(shape=(45, 61), seed: int = 21) -> Image.Image:
    return Image.fromarray(_image(shape, seed)).convert("YCbCr")


JP2_OPTIONS = {
    "reversible": {},
    "irreversible": {"irreversible": True},
    "tiles": {"tile_size": (24, 32), "tile_offset": (1, 2), "offset": (3, 5)},
    "layers": {"quality_layers": [40, 10, 2], "quality_mode": "rates", "progression": "LRCP"},
    "irreversible_tiles_layers": {"irreversible": True, "tile_size": (16, 16),
                                  "quality_layers": [30, 45], "quality_mode": "dB",
                                  "progression": "RPCL"},
    "codestream": {"no_jp2": True},
}


@pytest.mark.parametrize("options", sorted(JP2_OPTIONS))
@pytest.mark.parametrize("shape", [(45, 61), (7, 5), (1, 1), (64, 33)])
def test_pillow_ycbcr_jp2_equals_pillow(options, shape):
    """Pillow writes a YCbCr image as a JP2 of colour space sYCC (a raw
    codestream has none: Pillow reads it as RGB), and reads it back through
    its own YCbCr to RGB."""
    data = _saved(_ycbcr_image(shape, sum(shape)), "JPEG2000", **JP2_OPTIONS[options])
    if not JP2_OPTIONS[options].get("no_jp2"):
        at = data.index(b"colr")
        assert int.from_bytes(data[at + 7:at + 11], "big") == 18
    _assert_pillows(data)


def _colour(data: bytes, enumerated: int, components: int | None = None) -> bytes:
    """A JP2 with its ``colr`` box's enumerated colour space replaced, and
    its ``ihdr`` component count where given."""
    out = bytearray(data)
    at = out.index(b"colr")
    out[at + 7:at + 11] = enumerated.to_bytes(4, "big")
    if components is not None:
        at = out.index(b"ihdr")
        out[at + 12:at + 14] = components.to_bytes(2, "big")
    return bytes(out)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("irreversible", [False, True])
def test_sycc_patched_jp2_equals_pillow_and_esycc_is_refused(mode, irreversible):
    """An RGB or RGBA JP2 whose ``colr`` box says sYCC (18) is read through
    ``j2ku_sycc_rgb`` / ``j2ku_sycca_rgba``, and an RGBA codestream under
    an ``ihdr`` of three components as RGB through ``j2ku_sycc_rgb``; e-sYCC
    (24) has no unpacker, and both refuse it."""
    image = Image.fromarray(_image((45, 61), 7)).convert(mode)
    data = _saved(image, "JPEG2000", irreversible=irreversible)
    _assert_pillows(_colour(data, 18))
    if mode == "RGBA":
        _assert_pillows(_colour(data, 18, components=3))
    _both_refuse(_colour(data, 24))
    _both_refuse(_colour(_saved(_ycbcr_image(), "JPEG2000"), 24))


# --- libtiff's YCbCr to RGB and YCbCr TIFF ----------------------------------------


def test_libtiff_ycbcr_equals_pillow_on_every_triple_in_one_tiff():
    """All 2**24 triples at 1 x 1 subsampling in one LZW TIFF Pillow
    writes: libtiff's tables at the default ``ReferenceBlackWhite``, which
    differ from Pillow's own conversion in about a third of the values."""
    triples = _all_triples()
    data = _saved(Image.frombytes("YCbCr", (4096, 4096), triples.tobytes()), "TIFF",
                  compression="tiff_lzw")
    want = _pillow(data)
    np.testing.assert_array_equal(laion.decode_image(data), want)
    own = np.asarray(Image.frombytes("YCbCr", (4096, 4096), triples.tobytes()).convert("RGB"))
    assert 0.25 < (own != want).mean() < 0.4


def pack_blocks(ycc: np.ndarray, h: int, v: int, rng) -> bytes:
    """A strip's or tile's YCbCr samples as TIFF packs them: each h x v
    block's Y samples row by row, then its Cb and Cr (its top-left pixel's
    here); blocks past the edge padded with random samples."""
    rows, cols, _ = ycc.shape
    down, across = -(-rows // v), -(-cols // h)
    pad = rng.integers(0, 256, (down * v, across * h, 3), dtype=np.uint8)
    pad[:rows, :cols] = ycc
    y = pad[..., 0].reshape(down, v, across, h).transpose(0, 2, 1, 3).reshape(down, across, v * h)
    return np.concatenate([y, pad[::v, ::h, 1:]], axis=-1).tobytes()


def _rationals(values) -> list[int]:
    return [int(x) for pair in values for x in pair]


def write_ycbcr_tiff(ycc: np.ndarray, sampling=(2, 2), compression=LZW, *, tile=None,
                     rows_per_strip=None, predictor=1, luma=None, reference=None,
                     big_endian=False, subsampling_field=True, seed=0, samples=3, bits=8,
                     planar=1, extra=()) -> bytes:
    """A YCbCr TIFF (photometric 6) of ``ycc`` (H, W, 3 uint8) in strips or
    ``tile`` (w, h) tiles, each packed at ``sampling`` (h, v) and compressed;
    ``luma`` and ``reference`` as (numerator, denominator) pairs for
    ``YCbCrCoefficients`` and ``ReferenceBlackWhite``. The predictor tag is
    written as given; the data is not differenced (the test reads back what
    libtiff makes of it). ``samples``, ``bits``, ``planar`` and ``extra``
    only go into the header, for the refusals."""
    rng = np.random.default_rng(seed)
    order = ">" if big_endian else "<"
    height, width, _ = ycc.shape
    tw, th = tile if tile else (width, rows_per_strip or height)
    chunks = []
    for top in range(0, height, th):
        for left in range(0, width, tw) if tile else [0]:
            block = ycc[top:top + th, left:left + tw]
            if tile:
                full = rng.integers(0, 256, (th, tw, 3), dtype=np.uint8)
                full[:block.shape[0], :block.shape[1]] = block
                block = full
            raw = pack_blocks(block, *sampling, rng)
            chunks.append({NONE: lambda b: b, LZW: lzw_encode, DEFLATE: zlib.compress,
                           ADOBE_DEFLATE: zlib.compress, PACKBITS: packbits_encode}[compression](raw))
    fields = {256: (4, [width]), 257: (4, [height]), 258: (3, [bits] * samples),
              259: (3, [compression]), 262: (3, [6]), 277: (3, [samples]), 284: (3, [planar]),
              317: (3, [predictor])}
    if subsampling_field:
        fields[530] = (3, list(sampling))
    if luma is not None:
        fields[529] = (5, _rationals(luma))
    if reference is not None:
        fields[532] = (5, _rationals(reference))
    if extra:
        fields[338] = (3, list(extra))
    fields.update({322: (3, [tw]), 323: (3, [th])} if tile else {278: (4, [th])})
    body = bytearray(8)
    offsets = []
    for chunk in chunks:
        offsets.append(len(body))
        body += chunk + b"\0" * (len(chunk) % 2)
    fields[324 if tile else 273] = (4, offsets)
    fields[325 if tile else 279] = (4, [len(c) for c in chunks])
    codes = {3: "H", 4: "I", 5: "I"}
    blobs = {}
    for tag, (kind, values) in sorted(fields.items()):
        packed = np.asarray(values, order + codes[kind]).tobytes()
        if len(packed) > 4:
            blobs[tag] = len(body)
            body += packed
    ifd = len(body)
    body += np.asarray([len(fields)], order + "H").tobytes()
    for tag, (kind, values) in sorted(fields.items()):
        packed = np.asarray(values, order + codes[kind]).tobytes()
        value = (np.asarray([blobs[tag]], order + "I").tobytes() if tag in blobs
                 else packed.ljust(4, b"\0"))
        count = len(values) // 2 if kind == 5 else len(values)
        body += np.asarray([tag, kind], order + "H").tobytes()
        body += np.asarray([count], order + "I").tobytes() + value
    body += bytes(4)
    body[:8] = (b"MM\0*" if big_endian else b"II*\0") + np.asarray([ifd], order + "I").tobytes()
    return bytes(body)


SAMPLINGS = [(h, v) for h in (1, 2, 4) for v in (1, 2, 4)]
# libtiff's RGBA interface has a put function for these (tif_getimage.c).
READ = {(4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)}
LAYOUTS = {"strips_8": {"rows_per_strip": 8}, "strips_3": {"rows_per_strip": 3},
           "tiles_16": {"tile": (16, 16)}, "tiles_32x16": {"tile": (32, 16)}}
# Odd sizes: 4 x 4 blocks an odd count a row (libtiff reads such a strip
# short), tiles clipped by 1 to 15 columns, a last strip of one row.
SHAPES = [(45, 61), (37, 65), (9, 67), (33, 17), (20, 81), (3, 8), (1, 1)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_written_ycbcr_tiff_equals_pillow(sampling, layout):
    """Every (1, 2, 4)**2 subsampling: the seven libtiff reads equal
    Pillow's pixels, across the odd sizes, each compression, with and
    without the predictor; the other two are refused by both."""
    rng = np.random.default_rng(sum(sampling) * 7 + len(layout))
    compressions = (LZW, DEFLATE, PACKBITS, ADOBE_DEFLATE)
    for i, shape in enumerate(SHAPES):
        ycc = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        data = write_ycbcr_tiff(ycc, sampling, compressions[i % 4], predictor=1 + i % 2,
                                seed=i, **LAYOUTS[layout])
        if sampling in READ:
            _assert_pillows(data)
        else:
            _both_refuse(data)


REFERENCES = {
    "studio": [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)],
    "fractions": [(1, 3), (510, 2), (257, 2), (511, 2), (100, 1), (200, 1)],
    "degenerate": [(0, 1), (0, 1), (128, 1), (128, 1), (128, 1), (128, 1)],
    "wide": [(0, 1), (4095, 1), (0, 1), (65535, 2), (7, 1), (3000, 7)],
}
LUMAS = {"rec709": [(2126, 10000), (7152, 10000), (722, 10000)],
         "odd": [(1, 3), (1, 3), (1, 3)], "zero_red": [(0, 1), (1, 1), (0, 1)]}


@pytest.mark.parametrize("reference", sorted(REFERENCES) + [None])
@pytest.mark.parametrize("luma", sorted(LUMAS) + [None])
def test_ycbcr_fields_equal_pillow(reference, luma):
    """``TIFFYCbCrToRGBInit``'s float32 tables from the rationals: studio
    swing, fractions, a zero span, wide ranges; Rec. 709 and odd
    coefficients; at 2 x 1 in strips and 1 x 1 in tiles."""
    ycc = _ycc((29, 37), 5)
    fields = {"reference": None if reference is None else REFERENCES[reference],
              "luma": None if luma is None else LUMAS[luma]}
    _assert_pillows(write_ycbcr_tiff(ycc, (2, 1), rows_per_strip=6, **fields))
    _assert_pillows(write_ycbcr_tiff(ycc, (1, 1), DEFLATE, tile=(16, 32), big_endian=True,
                                     **fields))


def test_libtiff_tables_against_the_defaults_and_refusals():
    """The default tables are those of the default fields; a zero green
    coefficient is refused, as ``initYCbCrConversion`` refuses it."""
    default = LibtiffYCbCr()
    given = LibtiffYCbCr((0.299, 0.587, 0.114), (0, 255, 128, 255, 128, 255))
    for name in ("y", "cr_r", "cb_b", "cr_g", "cb_g"):
        np.testing.assert_array_equal(getattr(default, name), getattr(given, name))
    with pytest.raises(ValueError, match="YCbCrCoefficients"):
        LibtiffYCbCr((0.3, 0.0, 0.1))
    data = write_ycbcr_tiff(_ycc((8, 8), 1), (1, 1), luma=[(1, 3), (0, 1), (1, 3)])
    with pytest.raises(ValueError, match="YCbCrCoefficients"):
        laion.decode_image(data)


@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
                                         "packbits"])
def test_pillow_ycbcr_tiff_equals_pillow(compression):
    """Pillow's own YCbCr TIFFs (1 x 1, ``ReferenceBlackWhite`` written)."""
    for shape in ((45, 61), (1, 1), (300, 7)):
        _assert_pillows(_saved(_ycbcr_image(shape, shape[1]), "TIFF", compression=compression))


def test_ycbcr_tiffs_pillow_refuses_are_refused():
    """Uncompressed YCbCr (Pillow reads it raw as RGBX and finds it
    truncated), an alpha sample, 16-bit samples, one sample: no ``OPEN_INFO``
    key, or libtiff refuses; the port too."""
    ycc = _ycc((16, 16), 3)
    _both_refuse(_saved(_ycbcr_image((16, 16)), "TIFF"))
    _both_refuse(write_ycbcr_tiff(ycc, (1, 1), NONE))
    for header in ({"samples": 4, "extra": (2,)}, {"bits": 16}, {"samples": 1}):
        _both_refuse(write_ycbcr_tiff(ycc, (1, 1), **header))


def _with_subsampling(data: bytes, sampling) -> bytes:
    """A little-endian TIFF with a ``YCbCrSubsampling`` field added (its
    IFD rewritten at the end)."""
    at = int.from_bytes(data[4:8], "little")
    n = int.from_bytes(data[at:at + 2], "little")
    entries = [data[at + 2 + 12 * i:at + 14 + 12 * i] for i in range(n)]
    entries.append(np.asarray([530, 3], "<u2").tobytes() + np.asarray([2], "<u4").tobytes()
                   + np.asarray(sampling, "<u2").tobytes())
    entries.sort(key=lambda e: int.from_bytes(e[:2], "little"))
    body = bytearray(data) + b"\0" * (len(data) % 2)
    ifd = len(body)
    body += np.asarray([len(entries)], "<u2").tobytes() + b"".join(entries) + bytes(4)
    body[4:8] = np.asarray([ifd], "<u4").tobytes()
    return bytes(body)


@pytest.mark.parametrize("compression", [LZW, DEFLATE, PACKBITS])
def test_ycbcr_in_planes_and_the_predictor_equal_pillow(compression):
    """YCbCr in three planes (planar configuration 2): libtiff converts
    them at 1 x 1 subsampling and refuses them at any other, as the port
    does; the horizontal predictor where libtiff's codec takes one (LZW,
    Deflate), and for RGB and grey too: with PackBits or no compression the
    field is ignored, by libtiff and by Pillow's raw reader."""
    ycc = _ycc((13, 21), 4)
    for predictor in (1, 2):
        for layout in ({"rows_per_strip": 4}, {"tile": (16, 16)}):
            planes = write_tiff(ycc, 6, compression=compression, predictor=predictor,
                                planar=2, **layout)
            _assert_pillows(_with_subsampling(planes, (1, 1)))
            _both_refuse(_with_subsampling(planes, (2, 1)))
            _both_refuse(planes)  # no field: 2 x 2
    if compression == PACKBITS:
        for ignored in (NONE, PACKBITS):
            for samples, photometric in ((ycc, 2), (ycc[..., :1], 1)):
                _assert_pillows(write_tiff(samples, photometric, compression=ignored,
                                           predictor=2, rows_per_strip=4))


# --- the committed fixtures and corruptions ---------------------------------------


def _fixture_bytes(name: str) -> bytes:
    """The committed fixture ``name`` as this file rebuilds it."""
    image = _ycbcr_image((45, 61), 21)
    ycc = np.asarray(image)
    big = Image.fromarray(laion.synthesize_image(9, 512)[0]).convert("YCbCr")
    return {
        "laion_loader_ycbcr.jp2": lambda: _saved(image, "JPEG2000"),
        "laion_loader_ycbcr_tiles_layers.jp2": lambda: _saved(
            image, "JPEG2000", **JP2_OPTIONS["irreversible_tiles_layers"]),
        "laion_loader_sycc_rgba.jp2": lambda: _colour(_saved(
            image.convert("RGB").convert("RGBA"), "JPEG2000", irreversible=True), 18),
        "laion_loader_ycbcr_lzw.tif": lambda: _saved(image, "TIFF", compression="tiff_lzw"),
        "laion_loader_ycbcr_22_tiles.tif": lambda: write_ycbcr_tiff(
            ycc, (2, 2), DEFLATE, tile=(32, 16), predictor=2,
            reference=REFERENCES["studio"]),
        "laion_loader_ycbcr_42_packbits.tif": lambda: write_ycbcr_tiff(
            ycc, (4, 2), PACKBITS, rows_per_strip=6, luma=LUMAS["rec709"]),
        # Web images' size, for the decoders' rates (the card's laion_loader).
        "laion_loader_512_ycbcr.jp2": lambda: _saved(big, "JPEG2000", irreversible=True,
                                                     quality_layers=[12],
                                                     quality_mode="rates"),
        "laion_loader_512_ycbcr.tif": lambda: write_ycbcr_tiff(
            np.asarray(big), (2, 2), DEFLATE, rows_per_strip=16),
    }[name]()


FIXTURE_NAMES = ("laion_loader_ycbcr.jp2", "laion_loader_ycbcr_tiles_layers.jp2",
                 "laion_loader_sycc_rgba.jp2", "laion_loader_ycbcr_lzw.tif",
                 "laion_loader_ycbcr_22_tiles.tif", "laion_loader_ycbcr_42_packbits.tif",
                 "laion_loader_512_ycbcr.jp2", "laion_loader_512_ycbcr.tif")


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_committed_fixture_is_rebuilt_and_decodes_as_pillow(name):
    data = (FIXTURES / name).read_bytes()
    assert data == _fixture_bytes(name)
    _assert_pillows(data)


def test_fixtures_are_in_the_cards_digest_table():
    digests = json.loads((FIXTURES / "laion_loader_pillow.json").read_text())
    assert set(FIXTURE_NAMES) <= set(digests)


@pytest.mark.parametrize("name", ["laion_loader_ycbcr_22_tiles.tif",
                                  "laion_loader_ycbcr_42_packbits.tif",
                                  "laion_loader_ycbcr.jp2"])
def test_corrupt_ycbcr_files_are_refused_alike_by_both_decoders(name):
    """Seeded truncations and replaced bytes (a subprocess: a crash fails
    the test): the C decoders refuse exactly what the plain ones refuse, and
    a JPEG 2000 mutant raises ``ValueError`` or decodes."""
    proc = subprocess.run([sys.executable, "-m", "tests.torch_decode_fuzz_worker",
                           str(FIXTURES / name), "31", "60"], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
