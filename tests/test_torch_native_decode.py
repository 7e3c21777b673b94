"""The LAION loader's C decoders (``data/csrc/``) against Pillow 12.1 and the
plain versions, on the CPU.

``decode_image`` decodes JPEG (baseline and progressive scans, the inverse
DCT and colour), WebP (VP8 and VP8L) and GIF's LZW in a C library that the
host compiler builds at the first decode (``ops/_build.py``, ``DECODERS``).
Held here:

- byte for byte Pillow's ``convert("RGB")`` and the plain versions
  (``decode_jpeg_reference``, ``decode_webp_reference``,
  ``decode_gif_reference``) on every committed loader fixture and on 512²
  files Pillow writes here (baseline JPEG at 4:2:0 and 4:4:4, progressive,
  restart intervals, lossy and lossless WebP, GIF);
- seeded truncations and replaced bytes of each format, in a subprocess
  (``tests/torch_decode_fuzz_worker.py``) so that a crash fails the test:
  each mutant refused with ``ValueError`` exactly where the plain version
  refuses it, else the plain version's bytes;
- four threads decoding at once get the serial bytes;
- ``chip_decode_ab.py``'s worker times every 512² fixture with this tree's
  loader;
- the ctypes table against the C sources, the build (its path, a second
  build loading the first, no build at import, ``RuntimeError`` without a
  compiler or on a compile error) and the refused kinds of JPEG.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses
import io
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tinydiffusion_torch.data import gif, jpeg, laion, webp
from tinydiffusion_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
LOADER_FIXTURES = sorted(p.name for p in FIXTURES.glob("laion_loader_*")
                         if p.suffix in (".jpg", ".png", ".gif", ".bmp", ".webp"))


def _photo(size: int, seed: int) -> np.ndarray:
    """A 512²-like web image: smooth shading, edges, a textured block and
    noise, so every coding tool of each format is met."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:size, :size] / size
    image = np.stack([128 + 100 * np.sin(6 * x + 2 * y), 128 + 90 * np.cos(5 * y - x),
                      255 * ((x - 0.5) ** 2 + (y - 0.5) ** 2 < 0.1)], -1)
    block = slice(size // 3, size // 2)
    image[block, block] = rng.integers(0, 256, (size // 2 - size // 3,) * 2 + (3,))
    image += rng.normal(0, 6, image.shape)
    return np.clip(image, 0, 255).astype(np.uint8)


def _saved(array: np.ndarray, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, fmt, **kw)
    return buf.getvalue()


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


_PLAIN = {"jpeg": jpeg.decode_jpeg_reference, "webp": webp.decode_webp_reference,
          "gif": gif.decode_gif_reference}


def _plain(data: bytes) -> np.ndarray:
    if data[:2] == b"\xff\xd8":
        return _PLAIN["jpeg"](data)
    if data[:4] == b"RIFF":
        return _PLAIN["webp"](data)
    if data[:6] in gif.SIGNATURES:
        return _PLAIN["gif"](data)
    return laion.decode_image(data)  # PNG and BMP have no C decoder


_PHOTO = _photo(512, 0)
_WRITTEN = {
    "baseline_420.jpg": lambda: _saved(_PHOTO, "JPEG", quality=85),
    "baseline_444.jpg": lambda: _saved(_PHOTO, "JPEG", quality=90, subsampling=0),
    "progressive.jpg": lambda: _saved(_PHOTO, "JPEG", quality=85, progressive=True),
    "restart.jpg": lambda: _saved(_PHOTO, "JPEG", quality=75, restart_marker_rows=1),
    "restart_blocks.jpg": lambda: _saved(_PHOTO, "JPEG", quality=75, progressive=True,
                                         restart_marker_blocks=3),
    "cache_1024.jpg": lambda: laion.encode_jpeg(np.tile(_PHOTO, (2, 2, 1)), laion.CACHE_QUALITY),
    "lossy.webp": lambda: _saved(_PHOTO, "WEBP", quality=80),
    "lossless.webp": lambda: _saved(_PHOTO, "WEBP", lossless=True),
    "palette.webp": lambda: _saved(np.asarray(Image.fromarray(_PHOTO).quantize(40).convert("RGB")),
                                   "WEBP", lossless=True),
    "photo.gif": lambda: _saved(_PHOTO, "GIF"),
}


@pytest.mark.parametrize("name", LOADER_FIXTURES + sorted(_WRITTEN))
def test_decode_image_equals_pillow_and_the_plain_version(name):
    """``decode_image`` (the C library for JPEG, WebP and GIF) against Pillow
    and the plain version, byte for byte."""
    data = _WRITTEN[name]() if name in _WRITTEN else (FIXTURES / name).read_bytes()
    got = laion.decode_image(data)
    want = _pillow(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_plain(data), got)


def _fuzz_sources() -> dict:
    small = _photo(48, 1)[:45, :37]
    grey = np.asarray(Image.fromarray(small).convert("L"))
    cmyk = io.BytesIO()
    Image.fromarray(small).convert("CMYK").save(cmyk, "JPEG", quality=80, progressive=True)
    return {
        "baseline.jpg": _saved(small, "JPEG", quality=80),
        "progressive.jpg": _saved(small, "JPEG", quality=80, progressive=True, subsampling=1),
        "restart.jpg": _saved(small, "JPEG", quality=60, restart_marker_blocks=2),
        "grey_progressive.jpg": _saved(grey, "JPEG", quality=70, progressive=True),
        "cmyk.jpg": cmyk.getvalue(),
        "lossy.webp": _saved(small, "WEBP", quality=60),
        "lossy_simple_filter.webp": _saved(small, "WEBP", quality=30, method=0),
        "lossless.webp": _saved(small, "WEBP", lossless=True),
        "palette.webp": _saved(np.asarray(Image.fromarray(small).quantize(6).convert("RGB")),
                               "WEBP", lossless=True),
        "photo.gif": _saved(small, "GIF"),
        "interlaced.gif": _saved(grey, "GIF", interlace=True),
    }


FUZZ = sorted(_fuzz_sources())
FUZZ_MUTANTS = 160


@pytest.mark.parametrize("name", FUZZ)
def test_corrupt_files_raise_value_error_or_give_the_plain_bytes(name, tmp_path):
    """Seeded truncations and replaced bytes, in a subprocess (a crash is a
    failure here, not a lost worker): ``ValueError`` where the plain version
    raises it, else the plain version's bytes."""
    path = tmp_path / name
    path.write_bytes(_fuzz_sources()[name])
    seed = FUZZ.index(name)
    proc = subprocess.run([sys.executable, "-m", "tests.torch_decode_fuzz_worker", str(path),
                           str(seed), str(FUZZ_MUTANTS)], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, (proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["mutants"] == FUZZ_MUTANTS and summary["disagreement"] is None
    # Some mutants decode and some are refused: both branches ran.
    assert 0 < summary["refused"]["c"] < FUZZ_MUTANTS


def test_four_threads_decode_at_once():
    """The C library keeps no state between calls: four threads decoding the
    512² files at once get what one thread gets."""
    files = [_WRITTEN[n]() for n in ("progressive.jpg", "lossy.webp", "lossless.webp",
                                     "photo.gif", "baseline_420.jpg")]
    serial = [laion.decode_image(d) for d in files]
    jobs = files * 4
    with ThreadPoolExecutor(max_workers=4) as pool:
        results = list(pool.map(laion.decode_image, jobs))
    for i, got in enumerate(results):
        np.testing.assert_array_equal(got, serial[i % len(files)])


def test_the_decode_ab_worker_times_every_512_fixture(monkeypatch):
    """``chip_decode_ab.measure`` on this tree: each 512² loader fixture
    decodes (none refused) and gets a median and a least time."""
    monkeypatch.setattr(sys, "path", [str(REPO), *sys.path])  # measure() adds the tree too
    import chip_decode_ab

    monkeypatch.setattr(chip_decode_ab, "REPEATS", 2)
    times = chip_decode_ab.measure(str(REPO))["s"]
    names = {p.name for p in (REPO / "tests" / "fixtures").glob("laion_loader_512*")} - {
        "laion_loader_pillow.json"}
    assert set(times) == names and len(names) >= 11
    for name, t in times.items():
        assert t is not None and 0 < t["min_s"] <= t["median_s"], name


def test_every_decoder_has_a_ctypes_signature():
    """ctypes passes an undeclared argument as a 32-bit int and cuts a
    pointer: every ``tdt_*`` function in data/csrc/ has its argtypes in
    ``_build.DECODE_SIGNATURES``, one entry per parameter."""
    found = {}
    for src in _build.DECODERS.sources():
        for name, params in re.findall(r"^int (tdt_\w+)\(([^)]*)\)", src.read_text(), re.M):
            found[name] = len(params.split(","))
    assert found and found.keys() == _build.DECODE_SIGNATURES.keys()
    for name, n in found.items():
        assert len(_build.DECODE_SIGNATURES[name]) == n, name


def test_the_build_path_a_cached_build_and_no_build_at_import(tmp_path, monkeypatch):
    """The library lands in ``_build/<hash>/libtdt_decode.so`` with the
    compiler's log; a second ``build`` loads it (0 s); importing the loader
    builds nothing."""
    monkeypatch.setattr(_build, "_BUILD_ROOT", tmp_path)
    first = _build.build(_build.DECODERS)
    assert first.path == tmp_path / _build.DECODERS.digest() / "libtdt_decode.so"
    assert first.path.exists() and first.seconds > 0 and first.compiler
    assert (first.path.parent / "cc.log").exists()
    again = _build.build(_build.DECODERS)
    assert again.path == first.path and again.seconds == 0.0
    code = ("import sys; import tinydiffusion_torch.data.laion; "
            "from tinydiffusion_torch.ops import _build; sys.exit(len(_build._libs))")
    assert subprocess.run([sys.executable, "-c", code], cwd=REPO).returncode == 0


def test_no_compiler_or_a_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: without a C compiler, or when a source does not compile,
    the build raises ``RuntimeError`` (with the compiler's output)."""
    monkeypatch.delenv("CC", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C compiler"):
        _build.find_cc()
    monkeypatch.undo()
    broken = tmp_path / "csrc"
    broken.mkdir()
    (broken / "bad.c").write_text("int tdt_bad(void) { return undeclared; }\n")
    monkeypatch.setattr(_build, "_BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared"):
        _build.build(dataclasses.replace(_build.DECODERS, csrc=broken))


# A DCT file relabelled lossless (SOF3) is refused as a lossless scan of
# predictor 0, which libjpeg-turbo refuses too.
_REFUSED_SOF = {**jpeg._UNSUPPORTED_SOF, 0xC3: "lossless"}


@pytest.mark.parametrize("marker", sorted(_REFUSED_SOF))
def test_both_jpeg_decoders_refuse_the_same_kinds(marker):
    """Arithmetic-coded lossless and differential frames, and a DCT scan
    under a lossless frame: ``ValueError`` with the kind, from the C path
    and the plain one alike."""
    data = bytearray(_saved(_photo(16, 2), "JPEG"))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = marker
    for decode in (jpeg.decode_jpeg, jpeg.decode_jpeg_reference):
        with pytest.raises(ValueError, match=_REFUSED_SOF[marker]):
            decode(bytes(data))
