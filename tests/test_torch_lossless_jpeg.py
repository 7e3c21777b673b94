"""8-bit lossless JPEG (SOF3) in the LAION loader, against Pillow 12.1, on the CPU.

Pillow writes no lossless JPEG, but its libjpeg-turbo 3 reads them, so JAX's
loader trains on such a record. ``tests/test_torch_arith_jpeg.py::
lossless_jpeg`` writes them as T.81 Annex H codes them; the port decodes
them in ``data/jpeg.py`` (plain: ``_lossless_reference``) and in C
(``data/csrc/jpeg.c::tdt_jpeg_lossless_scan``). Held here:

- Pillow's pixels from both, for every predictor and point transform, grey
  and three components, interleaved or a scan a component, restart
  intervals, sampling factors (replicated up: lossless files get no fancy
  upsampling), CMYK, a Huffman table with every category (16 included);
- what libjpeg-turbo refuses, refused by name: a restart interval that is
  not whole MCU rows, JFIF or an Adobe transform that asks YCbCr (it
  converts no colour of a lossless file), YCCK, fractional sampling, 12-
  and 16-bit samples (Pillow's plugin: "cannot identify"), a scan of a bad
  predictor, arithmetic coding (SOF11);
- a fuzz subprocess: the C refuses exactly the mutants the plain body
  refuses;
- the committed fixtures rebuilt byte for byte, their digests in
  ``tests/fixtures/laion_loader_pillow.json``.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_arith_jpeg import lossless_jpeg
from tests.test_torch_decoders import _image
from tests.test_torch_raster import smooth_image
from tinydiffusion_torch.data import jpeg, laion

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
SHAPE = (45, 61)
# A table of every difference category, 16 included (0 in one bit).
ALL_CATEGORIES = ((1, 0, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 2), bytes(range(17)))


def _pillow(data: bytes) -> np.ndarray | None:
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # noqa: BLE001  (any refusal of Pillow's)
        return None


def _same(data: bytes, refused: str | None = None) -> None:
    """``decode_image`` (C) and ``decode_jpeg_reference`` give Pillow's
    bytes, or both refuse (with ``refused`` in the reason) where Pillow
    refuses."""
    want = _pillow(data)
    for decode in (laion.decode_image, jpeg.decode_jpeg_reference):
        if want is None:
            with pytest.raises(ValueError, match=refused):
                decode(data)
        else:
            assert refused is None
            np.testing.assert_array_equal(decode(data), want)


def _planes(seed: int, n: int = 3, shape=SHAPE) -> list:
    rgb = _image(shape, seed)
    return [rgb[..., i % 3] ^ (np.uint8(85) * (i // 3)) for i in range(n)]


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("pt", [0, 1, 4])
def test_every_predictor_and_point_transform_equals_pillow(predictor, pt):
    """Grey and RGB (no marker: libjpeg-turbo takes 3 lossless components
    as RGB), interleaved and a scan a component, with a restart every two
    MCU rows (prediction reset there)."""
    grey = _planes(predictor)[0]
    _same(lossless_jpeg(grey, predictor=predictor, pt=pt))
    assert np.array_equal(_pillow(lossless_jpeg(grey, predictor=predictor))[..., 0], grey)
    planes = _planes(10 + predictor)
    for interleaved in (True, False):
        _same(lossless_jpeg(planes, predictor=predictor, pt=pt, restart=2 * SHAPE[1],
                            interleaved=interleaved))


@pytest.mark.parametrize("marker", ["", "jfif", "adobe0", "adobe1"])
@pytest.mark.parametrize("ids", [(1, 2, 3), (82, 71, 66), (5, 6, 7)])
def test_three_components_follow_libjpeg_turbos_colour_rules(marker, ids):
    """RGB without a marker or under Adobe's transform 0, whatever the
    component ids; JFIF and Adobe's transform 1 ask YCbCr, which
    libjpeg-turbo does not convert in a lossless file: refused."""
    data = lossless_jpeg(_planes(20), marker=marker, ids=list(ids), predictor=5)
    _same(data, "lossless JPEG whose markers ask a YCC" if marker in ("jfif", "adobe1") else None)


@pytest.mark.parametrize("sampling", [[(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)],
                                      [(1, 2), (1, 1), (1, 1)], [(1, 1), (2, 2), (1, 1)],
                                      [(4, 1), (2, 1), (1, 1)], [(3, 1), (1, 1), (1, 1)],
                                      [(2, 2), (2, 2), (2, 2)]])
@pytest.mark.parametrize("interleaved", [True, False])
def test_sampling_factors_are_replicated_up_as_pillow(sampling, interleaved):
    """Each component at its share of the image, replicated up; an
    interleaved scan of over 10 samples an MCU refused (libjpeg's limit)."""
    h, w = SHAPE
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    rgb = _image(SHAPE, 21)
    planes = [rgb[:-(-h * v // vmax), :-(-w * hh // hmax), i] for i, (hh, v) in
              enumerate(sampling)]
    _same(lossless_jpeg(planes, sampling=sampling, interleaved=interleaved, predictor=7,
                        restart=(-(-w // hmax)) * 3 if interleaved else 0, size=SHAPE))


def test_refusals_equal_pillows():
    """Fractional sampling, a restart interval that is not whole MCU rows
    (in an interleaved scan, and in the scan of a narrower component),
    YCCK, 12- and 16-bit samples, arithmetic coding (SOF11), a bad
    predictor, Pt past the precision: refused where Pillow refuses."""
    rgb = _image(SHAPE, 22)
    h, w = SHAPE
    _same(lossless_jpeg([rgb[..., 0], rgb[:23, :21, 1], rgb[:23, :21, 2]],
                        sampling=[(3, 2), (2, 1), (1, 1)]), "fractional sampling")
    _same(lossless_jpeg(_planes(23), restart=w + 1), "restart interval")
    _same(lossless_jpeg([rgb[..., 0], rgb[:23, :31, 1], rgb[:23, :31, 2]],
                        sampling=[(2, 2), (1, 1), (1, 1)], interleaved=False, restart=2 * w),
          "restart interval")
    cmyk = _planes(24, 4)
    _same(lossless_jpeg(cmyk, marker="adobe0", predictor=3))
    _same(lossless_jpeg(cmyk, predictor=3))
    ycck = lossless_jpeg(cmyk, marker="adobe1").replace(
        b"Adobe\x00\x64\x00\x00\x00\x00\x01", b"Adobe\x00\x64\x00\x00\x00\x00\x02")
    _same(ycck, "YCCK")
    grey = lossless_jpeg(rgb[..., 0])
    sof = grey.index(b"\xff\xc3")
    for bits in (12, 16):
        _same(grey[:sof + 4] + bytes([bits]) + grey[sof + 5:], f"{bits}-bit")
    _same(grey[:sof + 1] + b"\xcb" + grey[sof + 2:], "arithmetic-coded lossless")
    sos = grey.index(b"\xff\xda")
    for ss, al in ((0, 0), (8, 0), (1, 8)):
        bad = bytearray(grey)
        bad[sos + 7], bad[sos + 9] = ss, al
        _same(bytes(bad), "lossless JPEG file: a scan")


def test_every_category_and_truncations_equal_in_both():
    """A table of every category, 16 included (a difference of 32768, which
    no 8-bit image needs: the C and the plain body read it alike); cut
    files refused alike."""
    data = lossless_jpeg(_planes(25), table=ALL_CATEGORIES, predictor=6, restart=SHAPE[1])
    _same(data)
    scan = data.index(b"\xff\xda") + 14
    code, size = jpeg._huffman_codes(*ALL_CATEGORIES)
    assert int(size[16]) == 16
    sixteen = int(code[16]).to_bytes(2, "big").replace(b"\xff", b"\xff\x00")
    forced = data[:scan] + sixteen * 3 + data[scan:]  # three differences of 32768 first
    for variant in (forced, data[:scan + 40], data[:len(data) // 2]):
        results = []
        for decode in (laion.decode_image, jpeg.decode_jpeg_reference):
            try:
                results.append(decode(variant).tobytes())
            except ValueError as e:
                results.append(type(e))
        assert results[0] == results[1]


def test_corrupt_files_are_refused_alike_by_both_decoders(tmp_path):
    """Seeded truncations and replaced bytes (``torch_decode_fuzz_worker``,
    a subprocess: a crash fails this test)."""
    for name in ("laion_loader_lossless.jpg", "laion_loader_lossless_420.jpg"):
        path = tmp_path / name
        path.write_bytes((FIXTURES / name).read_bytes())
        proc = subprocess.run([sys.executable, "-m", "tests.torch_decode_fuzz_worker", str(path),
                               "27", "160"], cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr


def _fixture_bytes(name: str) -> bytes:
    """The committed fixture ``name`` as this module writes it."""
    rgb = _image(SHAPE, 70)
    h, w = SHAPE
    big = smooth_image(512)
    return {
        "laion_loader_lossless.jpg": lambda: lossless_jpeg(
            [rgb[..., i] for i in range(3)], predictor=6, restart=2 * w, table=ALL_CATEGORIES),
        "laion_loader_lossless_grey.jpg": lambda: lossless_jpeg(rgb[..., 1], predictor=7, pt=2),
        "laion_loader_lossless_420.jpg": lambda: lossless_jpeg(
            [rgb[..., 0], rgb[:23, :31, 1], rgb[:23, :31, 2]], sampling=[(2, 2), (1, 1), (1, 1)],
            interleaved=False, predictor=4, marker="adobe0"),
        # A web image's size, its differences in few bits.
        "laion_loader_512_lossless.jpg": lambda: lossless_jpeg(
            [big[..., i] for i in range(3)], predictor=1, table=ALL_CATEGORIES),
    }[name]()


FIXTURE_NAMES = ("laion_loader_lossless.jpg", "laion_loader_lossless_grey.jpg",
                 "laion_loader_lossless_420.jpg", "laion_loader_512_lossless.jpg")


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_committed_fixture_is_rebuilt_and_decodes_as_pillow(name):
    data = (FIXTURES / name).read_bytes()
    assert data == _fixture_bytes(name)
    _same(data)


def test_fixtures_are_in_the_cards_digest_table():
    digests = json.loads((FIXTURES / "laion_loader_pillow.json").read_text())
    assert set(FIXTURE_NAMES) <= set(digests)
