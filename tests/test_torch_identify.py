"""Which format the LAION loader takes a record for (``data/identify.py``), against Pillow 12.1.

JAX's loader decodes each record with ``Image.open(f).convert("RGB")``,
and ``Image.open`` walks its plugins in order, passing a file on where a
plugin's ``_open`` fails. The port copies that walk. Held here:

- the port's plugin order is the order a fresh Python process's
  ``Image.open`` walks (``Image.preinit``'s six, then ``Image.init``'s), and
  its plugins without an accept test are Pillow's;
- ``identify(data)`` equals ``Image.open(data).format`` (or both raise) on
  every committed loader fixture, on a file in each mode Pillow writes of
  each format of the probe list (QOI, PPM, TGA, PCX, SGI, DIB, IM, SPIDER,
  MSP, XBM, BLP, DDS, ICNS, AVIF), on seeded mutants of their first 32
  bytes and on short garbage; where the port reads the format it names, its
  pixels equal Pillow's (or both refuse). Mutants whose Pillow format comes
  through a failed ``_open`` of a plugin the port refuses on its accept test
  alone are left out, and counted (printed; ``ROADMAP.md`` keeps the gap);
- the TGA that starts as a cursor does (Pillow's CUR ``_open`` raises
  ``TypeError`` on it) decodes as TGA; a file no plugin takes raises
  "cannot identify image file".

Pillow is the oracle here; the port never imports it.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import functools
import io
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_decoders import _image
from tinydiffusion_torch.data import identify

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
ORDER = [p.name for p in identify.PLUGINS]
PROBE_FORMATS = ("QOI", "PPM", "TGA", "PCX", "SGI", "DIB", "IM", "SPIDER", "MSP", "XBM", "BLP",
                 "DDS", "ICNS", "AVIF")
MUTANTS_A_FILE = 12

Image.init()


def test_the_plugin_order_is_a_fresh_image_open_s():
    """A fresh process's walk: ``preinit``'s ``Image.ID``, then what
    ``init`` adds; the plugins registered without an accept test."""
    code = ("from PIL import Image\n"
            "Image.preinit(); first = list(Image.ID); Image.init()\n"
            "print(','.join(first + [i for i in Image.ID if i not in first]))\n"
            "print(','.join(sorted(k for k, (f, a) in Image.OPEN.items() if a is None)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.split("\n")
    assert out[0].split(",") == ORDER
    assert out[1].split(",") == sorted(p.name for p in identify.PLUGINS if p.accept is None)


def _pillow_walk(data: bytes):
    """``Image.open``'s walk over ``ORDER``: (format or None, the plugins
    whose ``_open`` failed on the way, the image or the exception that
    ended the walk, and the plugin that raised it)."""
    prefix, failed = data[:16], []
    for name in ORDER:
        factory, accept = Image.OPEN[name]
        try:
            result = not accept or accept(prefix)
            if isinstance(result, str) or not result:
                continue
        except (SyntaxError, IndexError, TypeError, struct.error):
            continue
        try:
            im = factory(io.BytesIO(data), "")
            Image._decompression_bomb_check(im.size)
            return name, failed, im, None
        except (SyntaxError, IndexError, TypeError, struct.error):
            failed.append(name)
        except Exception as e:  # noqa: BLE001  (any other: Image.open raises it)
            return None, failed, e, name
    return None, failed, None, None


def _saved(image: Image.Image, fmt: str, **kw) -> bytes | None:
    buf = io.BytesIO()
    try:
        image.save(buf, fmt, **kw)
    except (OSError, ValueError, KeyError, TypeError):
        return None  # Pillow writes no such file
    return buf.getvalue()


@functools.cache
def probe_files() -> dict[str, bytes]:
    """A 61x45 file in each mode Pillow writes, for each probe format (TGA
    run-length coded too)."""
    base = Image.fromarray(_image((45, 61), 30))
    images = {"1": base.convert("1"), "L": base.convert("L"), "LA": base.convert("LA"),
              "P": base.quantize(40), "RGB": base, "RGBA": base.convert("RGBA"),
              "I": base.convert("I"), "F": base.convert("F"), "CMYK": base.convert("CMYK")}
    files = {}
    for fmt in PROBE_FORMATS:
        for mode, image in images.items():
            for kw in ({}, {"rle": True}) if fmt == "TGA" else ({},):
                data = _saved(image, fmt, **kw)
                if data is not None and data not in files.values():
                    files[f"{fmt}_{mode}{'_rle' if kw else ''}"] = data
    return files


def mutants(data: bytes, seed: int):
    """Seeded mutants of the first 32 bytes: one to three of them replaced."""
    rng = np.random.default_rng(seed)
    for _ in range(MUTANTS_A_FILE):
        out = bytearray(data)
        for k in rng.choice(min(32, len(data)), int(rng.integers(1, 4)), replace=False):
            out[k] = int(rng.integers(0, 256))
        yield bytes(out)


GARBAGE = (b"", b"\x00", bytes(16), bytes(100), b"<html><body>404 Not Found</body></html>\n",
           b"<!DOCTYPE html>\n<html><head><title>Error</title></head></html>",
           b"Just some text, no image here.\n", b"PK\x03\x04" + bytes(30))


def _refused_on_accept(name: str) -> bool:
    plugin = identify.PLUGINS[ORDER.index(name)]
    return plugin.accept is not None and plugin.open is None and plugin.decode is None


def _check(data: bytes, what: str) -> bool:
    """``identify`` against Pillow's walk, then the pixels where the port
    reads the format; False where the file is left out (see the module's
    docstring)."""
    name, failed, result, raised_in = _pillow_walk(data)
    if any(_refused_on_accept(f) for f in failed):
        return False
    try:
        got = identify.identify(data)
    except ValueError:
        got = None
    if got is not None and got == raised_in and _refused_on_accept(got):
        return True  # refused by name here, by its _open in Pillow: the record fails alike
    assert got == name, (what, got, name, failed, result)
    if name is None or identify.PLUGINS[ORDER.index(name)].decode is None:
        return True
    try:
        want = np.asarray(result.convert("RGB"))
    except Exception:  # noqa: BLE001  (Pillow's load refuses the file)
        want = None
    try:
        pixels = identify.decode(data)
    except ValueError:
        pixels = None
    assert (pixels is None) == (want is None), (what, name, want is None)
    if want is not None:
        assert pixels.shape == want.shape and np.array_equal(pixels, want), (what, name)
    return True


def test_identify_equals_pillow_on_the_fixtures_and_garbage():
    names = sorted(p.name for p in FIXTURES.glob("laion_loader*") if p.suffix != ".json")
    assert len(names) >= 77
    for name in names:
        assert _check((FIXTURES / name).read_bytes(), name)
    for data in GARBAGE:
        assert _check(data, repr(data[:20]))
        with pytest.raises(ValueError, match="cannot identify image file"):
            identify.decode(data)


@pytest.mark.parametrize("fmt", PROBE_FORMATS)
def test_identify_equals_pillow_on_each_mode_and_its_mutants(fmt):
    files = {k: v for k, v in probe_files().items() if k.startswith(fmt + "_")}
    assert files, fmt
    left_out = 0
    for i, (name, data) in enumerate(sorted(files.items())):
        assert _check(data, name)
        for j, mutant in enumerate(mutants(data, 1000 * PROBE_FORMATS.index(fmt) + i)):
            left_out += not _check(mutant, f"{name} mutant {j}")
    print(f"{fmt}: {len(files)} files, {len(files) * MUTANTS_A_FILE} mutants, {left_out} left "
          "out (on Pillow's walk the _open of a plugin the port refuses on its accept failed)")


def test_a_tga_that_starts_as_a_cursor_is_read_as_tga():
    """An uncompressed true-colour TGA starts ``00 00 02 00``, CUR's
    signature; Pillow's CUR ``_open`` finds no entry (``TypeError``) and
    the walk reads it as TGA, and so does the port."""
    data = _saved(Image.fromarray(_image((45, 61), 31)), "TGA")
    assert data[:4] == b"\x00\x00\x02\x00"
    assert identify.identify(data) == Image.open(io.BytesIO(data)).format == "TGA"
    np.testing.assert_array_equal(identify.decode(data),
                                  np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_a_format_the_port_does_not_read_is_refused_by_name():
    data = _saved(Image.fromarray(_image((45, 61), 32)), "PCX")
    assert identify.identify(data) == "PCX"
    with pytest.raises(ValueError, match="cannot read PCX image files"):
        identify.decode(data)
