"""PCX (``data/pcx.py``, ``data/csrc/raster.c::tdt_pcx_rle``) against Pillow 12.1.

The LAION loader reads ZSoft's Paintbrush format as Pillow's
``PcxImagePlugin`` does. Held here, with Pillow as the oracle:

- every mode Pillow writes (``1``, ``L``, ``P``, RGB), at widths that pad
  the stride or not: ``decode_pcx`` (C), ``decode_pcx_reference`` and
  ``decode_image`` give Pillow's ``convert("RGB")`` bytes, or refuse where
  Pillow refuses;
- the 2- and 4-bit palettes Pillow reads but does not write, built here,
  with the header's stride even or not;
- the ``_open`` checks: a short header or an empty bounding box passes the
  file on to the next plugin (``identify`` names what ``Image.open``
  names), a mode Pillow does not read refuses it;
- a run past the end of its line and data that ends early refuse the file
  in both decoders, as Pillow refuses it;
- seeded mutants in a subprocess (``tests/torch_decode_fuzz_worker.py``):
  C and plain refuse alike, else give the same bytes.
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

from tests.test_torch_decoders import _image
from tinydiffusion_torch.data import identify, laion, pcx
from tinydiffusion_torch.data.header import open_as

REPO = Path(__file__).resolve().parents[1]
DECODERS = (pcx.decode_pcx, pcx.decode_pcx_reference, laion.decode_image)


def _pillow(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # noqa: BLE001  (Pillow refuses the file)
        return None


def _same(data: bytes, what: str) -> bool:
    """Every port decoder against Pillow; True where Pillow reads the file."""
    want = _pillow(data)
    for decode in DECODERS:
        if want is None:
            with pytest.raises(ValueError):
                decode(data)
        else:
            got = decode(data)
            assert got.dtype == np.uint8 and got.shape == want.shape, (what, decode.__name__)
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {decode.__name__}")
    return want is not None


def _saved(image: Image.Image) -> bytes:
    out = io.BytesIO()
    image.save(out, "PCX")
    return out.getvalue()


def _modes(array: np.ndarray) -> dict:
    image = Image.fromarray(array)
    return {"1": image.convert("1"), "L": image.convert("L"),
            "P": image.quantize(200), "RGB": image}


@pytest.mark.parametrize("width", [1, 2, 3, 8, 17, 29, 30, 61])
def test_every_mode_pillow_writes_equals_pillow(width):
    array = _image((23, 61), 40)[:, :width]
    read = 0
    for mode, image in _modes(array).items():
        data = _saved(image)
        assert identify.identify(data) == "PCX"
        read += _same(data, f"{mode} {width}")
    assert read >= 3  # Pillow refuses some of its own 1-bit files; the port too


def _rle(lines: np.ndarray) -> bytes:
    """PCX packets of ``lines`` (rows of bytes), runs cut at each line's end."""
    out = bytearray()
    for row in lines:
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and row[j] == row[i] and j - i < 63:
                j += 1
            if j - i > 1 or row[i] >= 0xC0:
                out += bytes([0xC0 | (j - i), row[i]])
            else:
                out.append(row[i])
            i = j
    return bytes(out)


def _header(width: int, height: int, bits: int, planes: int, stride: int, version: int = 5,
            palette: bytes = bytes(48)) -> bytes:
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 3, 5, 3 + width - 1, 5 + height - 1,
                       72, 72)
    return head + palette + bytes([0, planes]) + struct.pack("<HH", stride, 1) + bytes(58)


@pytest.mark.parametrize("planes", [2, 4])
@pytest.mark.parametrize("width", [5, 16, 21, 40])
def test_bit_plane_palettes_equal_pillow(planes, width):
    """``P;2L`` and ``P;4L``: bit planes of ``(width + 7) // 8`` bytes, the
    header's 16-colour palette; with the stride the header gives even or
    not (Pillow reads the planes at its own offsets either way)."""
    rng = np.random.default_rng(width * planes)
    palette = rng.integers(0, 256, 48).astype(np.uint8).tobytes()
    height = 9
    for extra in (0, 1):
        claimed = (width + 7) // 8 + extra
        stride = (width + 7) // 8 + extra * ((width + 7) // 8 % 2)  # Pillow's own
        lines = rng.integers(0, 256, (height, planes * stride)).astype(np.uint8)
        lines[:, :stride] = 0x0F  # runs as well as literals
        data = _header(width, height, 1, planes, claimed, 3, palette) + _rle(lines)
        assert _same(data, f"P;{planes}L {width} {claimed}")


def pcx_fixtures() -> dict:
    """The committed PCX fixtures as this file builds them: 1-bit, a 4-bit
    palette (bit planes, built here), 8-bit ``L`` and ``P``, RGB, and a 512²
    RGB (a 64² image scaled up by 8, so that its runs pack)."""
    image = Image.fromarray(_image((45, 61), 12))
    modes = _modes(np.asarray(image))
    index = np.asarray(image.quantize(16))
    palette = bytes(image.quantize(16).getpalette()[:48])
    planes = np.concatenate([np.packbits((index >> k) & 1, axis=1) for k in range(4)], axis=1)
    big = Image.fromarray(_image((64, 64), 14)).resize((512, 512), Image.NEAREST)
    return {
        "laion_loader_1.pcx": lambda: _saved(modes["1"]),
        "laion_loader_p4.pcx": lambda: _header(61, 45, 1, 4, 8, 3, palette) + _rle(planes),
        "laion_loader_l.pcx": lambda: _saved(modes["L"]),
        "laion_loader_p.pcx": lambda: _saved(modes["P"]),
        "laion_loader_rgb.pcx": lambda: _saved(modes["RGB"]),
        "laion_loader_512.pcx": lambda: _saved(big),
    }


@pytest.mark.parametrize("name", sorted(pcx_fixtures()))
def test_committed_pcx_fixture_is_rebuilt_and_equals_pillow(name):
    """Each PCX fixture the card's ``laion_loader`` phase decodes is what
    this file builds, it decodes to Pillow's pixels (C = plain), and its
    digest is in ``laion_loader_pillow.json``."""
    data = (REPO / "tests" / "fixtures" / name).read_bytes()
    assert data == pcx_fixtures()[name]()
    assert _same(data, name)
    digests = json.loads((REPO / "tests" / "fixtures" / "laion_loader_pillow.json").read_text())
    assert name in digests


def test_open_failures_pass_the_file_on_and_bad_modes_refuse():
    rgb = _saved(Image.fromarray(_image((12, 10), 41)))
    empty = bytearray(rgb)
    empty[4:6] = struct.pack("<H", 20)  # xmin past xmax: "bad PCX image size"
    for data in (rgb[:40], bytes(empty)):
        with pytest.raises(identify.NotThisFormat):
            open_as(pcx.open_pcx, data)
        try:
            want = Image.open(io.BytesIO(data)).format
        except Exception:  # noqa: BLE001
            want = None
        try:
            got = identify.identify(data)
        except ValueError:
            got = None
        assert got == want
    bad_mode = bytearray(rgb)
    bad_mode[3] = 4  # 4 bits, 3 planes: "unknown PCX mode", an OSError in Pillow
    with pytest.raises(OSError, match="unknown PCX mode"):
        Image.open(io.BytesIO(bytes(bad_mode)))
    with pytest.raises(ValueError, match="unknown PCX mode"):
        laion.decode_image(bytes(bad_mode))


def test_a_run_past_its_line_and_a_short_file_refuse():
    width, height = 10, 4
    lines = np.full((height, width), 7, np.uint8)
    good = _header(width, height, 8, 1, width) + _rle(lines)
    assert _same(good, "good")
    overrun = _header(width, height, 8, 1, width) + bytes([0xC0 | 12, 7]) + _rle(lines)
    assert not _same(overrun, "overrun")
    assert not _same(good[:-1], "short")


def test_grey_and_palette_tails_equal_pillow():
    """8-bit files: no palette tail (``L``), the grey ramp (``L``), another
    palette (``P``)."""
    array = np.asarray(Image.fromarray(_image((11, 13), 42)).convert("L"))
    body = _header(13, 11, 8, 1, 14) + _rle(np.pad(array, ((0, 0), (0, 1))))
    ramp = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
    other = bytes(np.arange(768, dtype=np.int64) * 7 % 256)
    for tail in (b"", b"\x0c" + ramp, b"\x0c" + other, b"\x0b" + other):
        assert _same(body + tail, f"tail {tail[:2]!r}")


@pytest.mark.parametrize("mode", ["P", "RGB"])
def test_corrupt_pcx_files_give_the_plain_bytes_or_refuse_alike(mode, tmp_path):
    """Seeded truncations and replaced bytes through the fuzz worker, in a
    subprocess: C and plain agree on every mutant, and both branches ran."""
    path = tmp_path / f"{mode}.pcx"
    path.write_bytes(_saved(_modes(_image((21, 23), 43))[mode]))
    proc = subprocess.run([sys.executable, "-m", "tests.torch_decode_fuzz_worker", str(path),
                           "7", "120"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["mutants"] == 120 and summary["disagreement"] is None
    assert 0 < summary["refused"]["c"] < 120
