"""JPEG 2000 in the port's LAION loader, against Pillow 12.1 byte for byte, on the CPU.

JAX's loader reads every record with ``Image.open(f).convert("RGB")``, and
Pillow reads JPEG 2000 (OpenJPEG); the port's ``data/laion.py::decode_image``
reads it with ``data/jpeg2000.py`` and the C in ``data/csrc/jpeg2000.c``.
There is no plain Python body to hold the C against, so every file here is
held to Pillow's pixels: the committed fixtures (JP2 and raw J2K; reversible
5/3 and irreversible 9/7 with and without the component transform; every
progression order; precincts, tiles with offsets, code-block sizes, quality
layers; the modes L, LA, RGB, RGBA, I;16 and CMYK), which
``tests/fixtures/laion_loader_pillow.json`` holds on the card's host without
Pillow, and files written here over a grid of Pillow's options and sizes.
Both signatures dispatch through ``decode_image``; what Pillow reads and the
port refuses is refused by name; truncated and mutated streams raise
``ValueError`` and never crash (a subprocess,
``tests/torch_decode_fuzz_worker.py``).
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

from tests.test_torch_decoders import _image
from tinydiffusion_torch.data import jpeg2000, laion

FIXTURES = Path(__file__).parent / "fixtures"
REPO = Path(__file__).resolve().parents[1]
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def _saved(image: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _assert_pillows(data: bytes) -> None:
    want = _pillow(data)
    got = laion.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _grey16(image: np.ndarray) -> Image.Image:
    """A 16-bit grey image with values past 255 (``I;16``)."""
    grey = np.asarray(Image.fromarray(image).convert("L"), np.uint16)
    return Image.frombuffer("I;16", grey.shape[::-1], (grey * 3 + 40).tobytes(), "raw", "I;16", 0, 1)


def _fixture_bytes(name: str) -> bytes:
    """The committed fixture ``name`` as this file rebuilds it."""
    image = Image.fromarray(_image((45, 61), 15))
    return {
        "laion_loader_rgb.jp2": lambda: _saved(image),
        "laion_loader_irreversible_mct.jp2": lambda: _saved(
            image, irreversible=True, mct=1, quality_layers=[30, 40], quality_mode="dB"),
        "laion_loader_rpcl_precincts.j2k": lambda: _saved(
            image, no_jp2=True, progression="RPCL", precinct_size=(32, 32),
            codeblock_size=(16, 16)),
        "laion_loader_pcrl_tiles.jp2": lambda: _saved(
            image, progression="PCRL", tile_size=(24, 32), tile_offset=(1, 2), offset=(3, 5),
            quality_layers=[20, 5], quality_mode="rates"),
        "laion_loader_cprl_layers.jp2": lambda: _saved(
            image, progression="CPRL", irreversible=True, quality_layers=[40, 20, 8],
            quality_mode="rates", num_resolutions=4),
        "laion_loader_rlcp.jp2": lambda: _saved(
            image, progression="RLCP", num_resolutions=3, codeblock_size=(8, 32)),
        "laion_loader_grey.jp2": lambda: _saved(image.convert("L"), irreversible=True),
        "laion_loader_la.jp2": lambda: _saved(image.convert("LA")),
        "laion_loader_rgba.jp2": lambda: _saved(image.convert("RGBA"), irreversible=True),
        "laion_loader_grey16.jp2": lambda: _saved(_grey16(np.asarray(image))),
        "laion_loader_cmyk.jp2": lambda: _saved(image.convert("CMYK")),
        # A web image's size, for the decoder's rate (the card's laion_loader).
        "laion_loader_512.jp2": lambda: _saved(
            Image.fromarray(_image((512, 512), 14)), irreversible=True, quality_layers=[12],
            quality_mode="rates"),
    }[name]()


JP2_FIXTURES = ("laion_loader_rgb.jp2", "laion_loader_irreversible_mct.jp2",
                "laion_loader_rpcl_precincts.j2k", "laion_loader_pcrl_tiles.jp2",
                "laion_loader_cprl_layers.jp2", "laion_loader_rlcp.jp2", "laion_loader_grey.jp2",
                "laion_loader_la.jp2", "laion_loader_rgba.jp2", "laion_loader_grey16.jp2",
                "laion_loader_cmyk.jp2", "laion_loader_512.jp2")


@pytest.mark.parametrize("name", JP2_FIXTURES)
def test_committed_fixture_is_rebuilt_and_decodes_as_pillow(name):
    """Each fixture is what this file writes with Pillow, and the port's
    decode equals Pillow's ``convert("RGB")``, byte for byte."""
    data = (FIXTURES / name).read_bytes()
    assert data == _fixture_bytes(name)
    _assert_pillows(data)


def test_fixtures_are_in_the_cards_digest_table():
    """The card's ``laion_loader`` phase decodes every fixture of
    ``laion_loader_pillow.json`` to its Pillow digest: the JPEG 2000 ones are
    there (``tests/test_torch_laion_loader.py`` ties the digests to Pillow)."""
    digests = json.loads((FIXTURES / "laion_loader_pillow.json").read_text())
    assert set(JP2_FIXTURES) <= set(digests)


@pytest.mark.parametrize("progression", PROGRESSIONS)
@pytest.mark.parametrize("options", [
    {}, {"irreversible": True, "mct": 1}, {"precinct_size": (64, 32), "codeblock_size": (8, 8)},
    {"tile_size": (20, 28), "tile_offset": (3, 1), "offset": (5, 4)},
    {"quality_layers": [50, 25, 10], "quality_mode": "rates", "irreversible": True},
    {"quality_layers": [25, 35, 45], "quality_mode": "dB"}], ids=lambda o: "-".join(o) or "plain")
def test_progressions_and_options_equal_pillow(progression, options):
    """Every progression order with precincts, tiles at offsets (odd tile and
    image origins: the wavelets' odd-start case), quality layers and both
    wavelets, at an odd size."""
    _assert_pillows(_saved(Image.fromarray(_image((53, 67), 16)), progression=progression,
                           **options))


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (2, 3), (5, 5), (33, 65), (130, 3)])
@pytest.mark.parametrize("irreversible", [False, True])
def test_small_and_thin_images_equal_pillow(shape, irreversible):
    """Images of one row, one column and a few pixels: resolutions with empty
    bands and signals of length one and two."""
    _assert_pillows(_saved(Image.fromarray(_image(shape, 17)), irreversible=irreversible))


@pytest.mark.parametrize("mode", ["L", "LA", "RGBA", "I;16", "CMYK"])
@pytest.mark.parametrize("options", [{}, {"irreversible": True}, {"signed": True},
                                     {"no_jp2": True}], ids=lambda o: "-".join(o) or "plain")
def test_modes_equal_pillow(mode, options):
    """Each mode Pillow writes, as a JP2 file and as a raw codestream (whose
    mode Pillow takes from the component count), signed too: Pillow's
    unpackers' shifts and its ``I;16``, ``LA`` and ``CMYK`` conversions."""
    image = _image((29, 41), 18)
    source = _grey16(image) if mode == "I;16" else Image.fromarray(image).convert(mode)
    _assert_pillows(_saved(source, **options))


@pytest.mark.parametrize("options", [{"num_resolutions": 1}, {"num_resolutions": 7},
                                     {"codeblock_size": (4, 1024)}, {"codeblock_size": (1024, 4)},
                                     {"cinema_mode": "cinema2k-24"}, {"plt": True},
                                     {"comment": "a comment"}], ids=str)
def test_coding_options_equal_pillow(options):
    """No wavelet, six levels (the last a few samples wide), tall and wide
    code-blocks, Pillow's digital-cinema profile (9/7, CPRL, explicit
    precincts), PLT markers and a comment."""
    _assert_pillows(_saved(Image.fromarray(_image((70, 91), 19)), **options))


def test_decode_image_dispatches_both_signatures():
    """``decode_image`` reads a JP2 file by its signature box and a raw
    codestream by SOC + SIZ; the refusal of an unknown format names JPEG
    2000 among what the port reads."""
    image = Image.fromarray(_image((21, 30), 20))
    jp2, j2k = _saved(image), _saved(image, no_jp2=True)
    assert jp2[:12] == jpeg2000.JP2_SIGNATURE and j2k[:4] == jpeg2000.J2K_SIGNATURE
    for data in (jp2, j2k):
        np.testing.assert_array_equal(laion.decode_image(data), np.asarray(image))
    with pytest.raises(ValueError, match="JPEG 2000"):
        laion.decode_image(b"\x00\x01\x02\x03" * 8)


def test_what_the_port_refuses_it_names():
    """Pillow reads a YCbCr JPEG 2000 (an sYCC colour space) through its own
    YCbCr conversion, which the port does not carry: refused by name, as are
    the BYPASS code-block style and a progression order change (POC)."""
    ycc = _saved(Image.fromarray(_image((21, 30), 21)).convert("YCbCr"))
    assert Image.open(io.BytesIO(ycc)).convert("RGB").size == (30, 21)
    with pytest.raises(ValueError, match="sycc colour space"):
        laion.decode_image(ycc)
    j2k = bytearray(_saved(Image.fromarray(_image((21, 30), 21)), no_jp2=True))
    cod = j2k.find(b"\xff\x52")
    j2k[cod + 4 + 8] |= 0x01  # SPcod's code-block style: BYPASS
    with pytest.raises(ValueError, match="BYPASS"):
        laion.decode_image(bytes(j2k))
    poc = bytes(j2k[:cod]) + b"\xff\x5f\x00\x09\x00\x00\x00\x01\x03\x01\x00" + bytes(j2k[cod:])
    with pytest.raises(ValueError, match="POC"):
        laion.decode_image(poc)


def test_truncated_files_raise_value_error():
    """Every truncation of a JP2 file and of a codestream raises
    ``ValueError`` (Pillow's OpenJPEG, strict, refuses them too)."""
    for data in (_saved(Image.fromarray(_image((17, 23), 22))),
                 _saved(Image.fromarray(_image((17, 23), 22)), no_jp2=True, irreversible=True)):
        for n in range(0, len(data) - 1, max(1, len(data) // 97)):
            with pytest.raises(ValueError):
                laion.decode_image(data[:n])


FUZZ = {
    "fuzz_rgb.jp2": {},
    "fuzz_rpcl.j2k": {"no_jp2": True, "progression": "RPCL", "precinct_size": (16, 16),
                      "codeblock_size": (16, 16), "irreversible": True, "mct": 1},
    "fuzz_layers_tiles.jp2": {"tile_size": (16, 24), "quality_layers": [30, 10],
                              "quality_mode": "rates", "progression": "CPRL"},
}
FUZZ_MUTANTS = 160


@pytest.mark.parametrize("name", sorted(FUZZ))
def test_mutated_streams_raise_value_error_or_decode(name, tmp_path):
    """Seeded truncations and replaced bytes in a subprocess (a crash fails
    the test instead of the worker): each mutant raises ``ValueError`` or
    decodes; some do each."""
    path = tmp_path / name
    path.write_bytes(_saved(Image.fromarray(_image((37, 45), 23)), **FUZZ[name]))
    seed = sorted(FUZZ).index(name) + 100
    proc = subprocess.run([sys.executable, "-m", "tests.torch_decode_fuzz_worker", str(path),
                           str(seed), str(FUZZ_MUTANTS)], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, (proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["mutants"] == FUZZ_MUTANTS and summary["disagreement"] is None
    assert 0 < summary["refused"]["c"] < FUZZ_MUTANTS
