"""Damaged JPEG scans (``data/jpeg.py``, ``data/csrc/jpeg.c``) against Pillow 12.1's libjpeg-turbo.

A web-scraped JPEG often carries damaged entropy-coded data: a flipped
bit, a file cut short. libjpeg-turbo recovers from it with a warning that
Pillow never shows, so JAX's loader trains on the record; the port must
read the same pixels, or refuse where Pillow refuses. Held here, with
Pillow as the live oracle, through both port decoders (C and plain):

- seeded mutants of six kinds of file (sequential 4:4:4, progressive,
  CMYK, 8-bit lossless, arithmetic-coded with restarts, and a baseline file
  with a restart every three blocks): a bit flipped at a random byte of
  scan data (no 0xFF byte), or the file cut at one with an EOI after it.
  Each mutant Pillow reads equals Pillow's pixels, each it refuses raises
  ``ValueError``; each kind's outcomes are printed;
- crafted scans, one rule each: a bad Huffman code (17 bits, symbol 0), a
  zero run past the 64th coefficient (it lands on the 64th), a scan cut
  inside an MCU (that MCU from zero bits, the rest of the interval left
  as it was), restart markers missing, repeated, out of order or replaced
  by other markers (jpeg_resync_to_restart's rules), an EOI after each scan
  of a progressive file (block smoothing of what the file has), markers
  after a one-pass file's scan, and single blocks of extreme coefficients
  and quantisers (the 16-bit lanes of libjpeg-turbo's SIMD IDCT).
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import collections
import io
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tinydiffusion_torch.data import jpeg

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
MUTANTS_A_KIND = 110
DECODERS = {"c": jpeg.decode_jpeg, "plain": jpeg.decode_jpeg_reference}


def _pillow(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # noqa: BLE001  (Pillow refuses the file)
        return None


def _outcome(data: bytes, what: str) -> str:
    """Both port decoders against Pillow: "equal" or "refused" (by all)."""
    want = _pillow(data)
    for name, decode in DECODERS.items():
        if want is None:
            with pytest.raises(ValueError):
                decode(data)
        else:
            got = decode(data)
            assert got.shape == want.shape, (what, name)
            np.testing.assert_array_equal(got, want, err_msg=f"{what} ({name})")
    return "refused" if want is None else "equal"


def _restarts_file() -> bytes:
    image = Image.open(FIXTURES / "laion_loader_444.jpg").convert("RGB")
    out = io.BytesIO()
    image.save(out, "JPEG", quality=80, restart_marker_blocks=3)
    return out.getvalue()


def _sources() -> dict:
    files = {name: (FIXTURES / f"laion_loader_{name}.jpg").read_bytes()
             for name in ("444", "progressive", "cmyk", "lossless", "arith")}
    files["restarts"] = _restarts_file()
    return files


def scan_bytes(data: bytes) -> np.ndarray:
    """Where each scan's entropy-coded data lies (its RST markers too),
    less its 0xFF bytes."""
    found, pos = [], 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF or data[pos + 1] in (0x00, 0xFF) or 0xD0 <= data[pos + 1] <= 0xD7:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker != 0xDA:
            continue
        while pos + 1 < len(data) and not (
                data[pos] == 0xFF and data[pos + 1] not in (0x00, 0xFF)
                and not 0xD0 <= data[pos + 1] <= 0xD7):
            if data[pos] != 0xFF:
                found.append(pos)
            pos += 1
    return np.asarray(found)


def mutants(data: bytes, count: int, seed: int):
    """Two in three: a bit flipped at a scan byte; one in three: the file
    cut at one, an EOI after it."""
    rng = np.random.default_rng(seed)
    where = scan_bytes(data)
    for i in range(count):
        at = int(where[rng.integers(len(where))])
        if i % 3 == 2:
            yield f"cut at {at}", data[:at] + b"\xff\xd9"
        else:
            bit = int(rng.integers(8))
            out = bytearray(data)
            out[at] ^= 1 << bit
            yield f"bit {bit} of byte {at}", bytes(out)


SOURCES = sorted(_sources())


def _flip(data: bytes, at: int, bit: int) -> bytes:
    out = bytearray(data)
    out[at] ^= 1 << bit
    return bytes(out)


def damaged_fixtures() -> dict:
    """The committed damaged JPEGs, one a rule, as this file builds them: a
    flip that makes a bad code, one that runs a block past its 64th
    coefficient, one whose wild coefficients show the SIMD IDCT's lanes, a
    restart file with an RST code flipped to a marker below SOF0 and cut
    (EOI) inside an interval, and the 512² progressive fixture cut in its
    sixth scan (block smoothing, and iMCU rows past the cut on the previous
    scan's coef_bits)."""
    base = (FIXTURES / "laion_loader_444.jpg").read_bytes()
    big = (FIXTURES / "laion_loader_512_progressive.jpg").read_bytes()
    return {
        "laion_loader_damaged_code.jpg": lambda: _flip(base, 857, 0),
        "laion_loader_damaged_run.jpg": lambda: _flip(base, 690, 6),
        "laion_loader_damaged_idct.jpg": lambda: _flip(base, 808, 1),
        "laion_loader_damaged_restarts.jpg": lambda: _flip(_restarts_file(), 758, 7)[:1100]
        + b"\xff\xd9",
        "laion_loader_512_damaged_progressive.jpg": lambda: big[:100208] + b"\xff\xd9",
    }


@pytest.mark.parametrize("name", sorted(damaged_fixtures()))
def test_committed_damaged_fixture_is_rebuilt_and_reads_as_pillow(name):
    """Each damaged fixture the card's ``laion_loader`` phase decodes is what
    this file builds, both decoders give Pillow's pixels, and its digest is
    in ``laion_loader_pillow.json``."""
    data = (FIXTURES / name).read_bytes()
    assert data == damaged_fixtures()[name]()
    assert _outcome(data, name) == "equal"
    assert name in json.loads((FIXTURES / "laion_loader_pillow.json").read_text())


@pytest.mark.parametrize("kind", SOURCES)
def test_seeded_scan_damage_reads_as_pillow_reads_it(kind):
    data = _sources()[kind]
    tally = collections.Counter(_outcome(m, f"{kind} {what}")
                                for what, m in mutants(data, MUTANTS_A_KIND, SOURCES.index(kind)))
    print(f"{kind}: {MUTANTS_A_KIND} mutants, {dict(tally)} (C and plain as Pillow)")
    assert tally["equal"] > MUTANTS_A_KIND // 2
    assert MUTANTS_A_KIND * len(SOURCES) >= 600


# --- crafted scans ---------------------------------------------------------------------


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


class Bits:
    """A bit string, packed MSB first (the last byte filled with ones) and
    byte-stuffed."""

    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int) -> "Bits":
        self.bits += [(value >> i) & 1 for i in range(n - 1, -1, -1)]
        return self

    def code(self, table, symbol: int) -> "Bits":
        code, size = jpeg._huffman_codes(*table)
        assert size[symbol], symbol
        return self.put(int(code[symbol]), int(size[symbol]))

    def value(self, table, symbol_high: int, v: int) -> "Bits":
        """A symbol (``symbol_high`` << 4 | the size of ``v``) and ``v``'s bits."""
        n = abs(v).bit_length()
        self.code(table, symbol_high << 4 | n)
        return self.put(v if v > 0 else v + (1 << n) - 1, n)

    def data(self) -> bytes:
        bits = self.bits + [1] * (-len(self.bits) % 8)
        return np.packbits(np.asarray(bits, np.uint8)).tobytes().replace(b"\xff", b"\xff\x00")


DC, AC = jpeg._STD_HUFFMAN[0, 0], jpeg._STD_HUFFMAN[1, 0]
DC_ALL = ((0, 0, 0, 0, 16) + (0,) * 11, bytes(range(16)))  # every DC size, 5-bit codes
AC_ALL = ((0,) * 7 + (242,) + (0,) * 8,
          bytes([0x00, 0xF0] + [r << 4 | s for r in range(16) for s in range(1, 16)]))


def grey_file(width: int, height: int, scans, q=None, dc=DC, ac=AC, restart: int = 0,
              sof: int = 0xC0) -> bytes:
    """A grey JPEG of the given scans ((SOS body, data) each), its
    quantiser ``q`` (natural order, 16-bit; all ones by default), its DC
    and AC tables, a restart interval, then EOI."""
    q = np.ones(64, np.int64) if q is None else np.asarray(q).reshape(64)
    dqt = b"\x10" + b"".join(int(v).to_bytes(2, "big") for v in q[jpeg._ZIGZAG])
    out = b"\xff\xd8" + _segment(0xDB, dqt) + _segment(
        sof, bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + b"\x01\x01\x11\x00")
    out += _segment(0xC4, bytes([0x00, *dc[0]]) + dc[1])
    out += _segment(0xC4, bytes([0x10, *ac[0]]) + ac[1])
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    for body, data in scans:
        out += _segment(0xDA, body) + data
    return out + b"\xff\xd9"


SEQUENTIAL = bytes([1, 1, 0x00, 0, 63, 0])


def _render(blocks: list, width: int, height: int) -> np.ndarray:
    """The grey pixels of natural-order coefficient blocks (quantiser 1)."""
    across = -(-width // 8)
    out = np.zeros((-(-height // 8) * 8, across * 8), np.int64)
    for i, block in enumerate(blocks):
        r, c = divmod(i, across)
        out[8 * r:8 * r + 8, 8 * c:8 * c + 8] = jpeg._idct_islow(
            np.asarray(block).reshape(8, 8), np.ones((8, 8), np.int64))
    return np.repeat(out[:height, :width, None], 3, axis=-1).astype(np.uint8)


def _block(dc: int = 0, ac: dict | None = None) -> np.ndarray:
    zigzag = np.zeros(64, np.int64)
    zigzag[0] = dc
    for k, v in (ac or {}).items():
        zigzag[k] = v
    natural = np.zeros(64, np.int64)
    natural[jpeg._ZIGZAG] = zigzag
    return natural


def _expect(data: bytes, blocks: list, width: int, height: int) -> None:
    """Pillow reads the crafted file as ``blocks``, and so do both decoders."""
    want = _render(blocks, width, height)
    np.testing.assert_array_equal(_pillow(data), want)
    assert _outcome(data, "crafted") == "equal"


def test_a_bad_code_reads_17_bits_as_symbol_0():
    """No DC code starts with nine ones: libjpeg reads 17 bits and takes
    symbol 0 (a zero difference), then goes on."""
    for pattern in (0x1FFFF, 0x1FF55):
        bits = Bits().put(pattern, 17).code(AC, 0).value(DC, 0, 5).code(AC, 0)
        _expect(grey_file(16, 8, [(SEQUENTIAL, bits.data())]), [_block(0), _block(5)], 16, 8)


def test_a_run_past_the_block_lands_on_its_last_coefficient():
    """Three ZRLs reach coefficient 49; a run of 15 then lands past 63, and
    libjpeg's padded natural order stores it on 63."""
    for runs, want in (((15, 4),), {63: 4}), (((10, 4), (7, 2)), {59: 4, 63: 2}):
        bits = Bits().value(DC, 0, 0)
        for _ in range(3):
            bits.code(AC, 0xF0)
        for run, v in runs:
            bits.value(AC, run, v)
        bits.value(DC, 0, 3).code(AC, 0)
        _expect(grey_file(16, 8, [(SEQUENTIAL, bits.data())]), [_block(0, want), _block(3)],
                16, 8)


def test_a_scan_cut_inside_an_mcu_finishes_it_from_zero_bits():
    """The data ends inside the first block: the rest of it decodes from
    zero bits (the luminance AC code 00 and a 0: -1 at every coefficient
    left), and the MCUs after it stay zero."""
    bits = (Bits().value(DC, 0, 5).value(AC, 0, 3).value(AC, 0, 3).value(AC, 0, 1)
            .value(AC, 0, 1).value(AC, 0, 2))
    assert len(bits.bits) % 8 == 0
    rest = {k: -1 for k in range(6, 64)}
    _expect(grey_file(24, 8, [(SEQUENTIAL, bits.data())]),
            [_block(5, {1: 3, 2: 3, 3: 1, 4: 1, 5: 2, **rest}), _block(0), _block(0)], 24, 8)


def _restart_scan(dcs: list, markers: list) -> bytes:
    """One block an interval, each its own DC (predictions restart); after
    interval i the marker ``markers[i]`` (None: none)."""
    out = b""
    for i, dc in enumerate(dcs):
        out += Bits().value(DC, 0, dc).code(AC, 0).data()
        if i < len(markers) and markers[i] is not None:
            out += bytes([0xFF, markers[i]])
    return out


@pytest.mark.parametrize("markers", [
    [0xD0, 0xD1, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6],  # as written
    [0xD0, None, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6],  # RST1 missing
    [0xD0, 0xD1, 0xD1, 0xD3, 0xD4, 0xD5, 0xD6],  # RST1 twice
    [0xD0, 0xD3, 0xD2, 0xD1, 0xD4, 0xD5, 0xD6],  # out of order
    [0xD0, 0xD5, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6],  # one far off
    [0xD0, 0xD7, 0xD6, 0xD3, 0xD4, 0xD5, 0xD6],  # behind: skipped
    [0xD0, 0x52, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6],  # below SOF0: skipped
    [0xD0, 0x01, 0xD1, 0xD2, 0xD3, 0xD4, 0xD5],  # TEM, then the rest
    [0xD0, 0xDC, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6],  # DNL: the scan ends there
    [0xD0, 0xFE, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6],  # COM
    [0xD0, 0xD1, 0xD2, None, None, None, None],  # markers gone
])
def test_restart_markers_resync_as_libjpeg(markers):
    """jpeg_resync_to_restart: the expected RSTn is taken, a marker below
    SOF0 or an RSTn one or two behind is skipped, one of the next two RSTn
    or another marker is left for later (the interval reads no data), and
    any other RSTn is taken as if expected."""
    dcs = [10, 20, 30, 40, 50, 60, 70, 80]
    data = grey_file(64, 8, [(SEQUENTIAL, _restart_scan(dcs, markers))], restart=1)
    assert _outcome(data, str(markers)) in ("equal", "refused")


def _progressive_cuts(data: bytes):
    at = data.find(b"\xff\xda", data.find(b"\xff\xda") + 2)
    while at > 0:
        yield data[:at] + b"\xff\xd9"
        at = data.find(b"\xff\xda", at + 2)


@pytest.mark.parametrize("name", ["progressive", "arith_split", "arith_progressive"])
def test_an_eoi_after_each_progressive_scan_smooths_what_the_file_has(name):
    """An EOI after each scan but the last: libjpeg's block smoothing fills
    coefficients 1-9 (and the DC, where no AC data is known) from the DC
    values around each block; with Pillow's pixels."""
    data = (FIXTURES / f"laion_loader_{name}.jpg").read_bytes()
    cuts = list(_progressive_cuts(data))
    assert len(cuts) >= 9
    for i, cut in enumerate(cuts):
        assert _outcome(cut, f"{name} after scan {i + 1}") == "equal"


def test_markers_after_a_one_pass_scan_are_read_as_libjpeg_reads_them():
    """After a one-pass file's scan: garbage, TEM, RSTn, DNL and APPn pass;
    an unknown marker, SOI, a second SOS or SOF refuse the file; one whose
    segment runs past the end is kept (every pixel is out)."""
    data = (FIXTURES / "laion_loader_444.jpg").read_bytes()[:-2]
    sos = data.index(b"\xff\xda")
    tails = [b"\x12\x34\xff\xd9", b"\xff\x01\xff\xd9", b"\xff\xd3\x00\xff\xd9",
             b"\xff\x02\xff\xd9", b"\xff\xf0\x00\x02\xff\xd9", b"\xff\xde\x00\x02\xff\xd9",
             b"\xff\xdc\x00\x04\x00\x48\xff\xd9", b"\xff\xd8\xff\xd9", b"\xff\xe3\xf0\x00abc",
             b"\xff\xc4\x00\x03\x30\xff\xd9", b"\xff\xdd\x00\x05\x00\x00\xff\xd9",
             data[sos:] + b"\xff\xd9", b"\xff\xc0\x00\x11\x08"]
    outcomes = collections.Counter(_outcome(data + tail, repr(tail[:8])) for tail in tails)
    assert outcomes["equal"] >= 5 and outcomes["refused"] >= 5


def _one_block(coef: np.ndarray, q: np.ndarray) -> bytes:
    zigzag = coef.reshape(64)[jpeg._ZIGZAG]
    bits = Bits()
    n = abs(int(zigzag[0])).bit_length()
    bits.code(DC_ALL, n).put(int(zigzag[0]) if zigzag[0] > 0 else int(zigzag[0]) + (1 << n) - 1, n)
    run, last = 0, max([k for k in range(1, 64) if zigzag[k]] or [0])
    for k in range(1, last + 1):
        if not zigzag[k]:
            run += 1
            continue
        while run >= 16:
            bits.code(AC_ALL, 0xF0)
            run -= 16
        bits.value(AC_ALL, run, int(zigzag[k]))
        run = 0
    if last < 63:
        bits.code(AC_ALL, 0)
    return grey_file(8, 8, [(SEQUENTIAL, bits.data())], q=q, dc=DC_ALL, ac=AC_ALL, sof=0xC1)


def test_the_idct_of_wild_coefficients_is_libjpeg_turbos_simd_one():
    """Single blocks of coefficients up to 15 bits and 16-bit quantisers:
    Pillow's bytes, from the SIMD IDCT's 16-bit products, saturations and
    clamp (``_idct_islow``); where rows 1-7 are zero, its DC shortcut."""
    rng = np.random.default_rng(7)
    for trial in range(120):
        coef = np.zeros((8, 8), np.int64)
        for _ in range(rng.integers(1, 12)):
            coef[rng.integers(0, 8 if trial % 4 else 1), rng.integers(0, 8)] = (
                rng.integers(-32767, 32768) >> rng.integers(0, 14))
        q = np.maximum(rng.integers(1, 65536, (8, 8)) >> rng.integers(0, 15, (8, 8)), 1)
        data = _one_block(coef, q)
        want = _pillow(data)
        np.testing.assert_array_equal(want[..., 0], jpeg._idct_islow(coef, q),
                                      err_msg=f"trial {trial}")
        assert _outcome(data, f"block {trial}") == "equal"


def _without_dht(data: bytes) -> bytes:
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    return bytes(out + data[pos:])


@pytest.mark.parametrize("kw", [{}, {"optimize": True}, {"progressive": True}])
def test_a_file_without_huffman_tables_reads_as_libjpeg_reads_it(kw):
    """A sequential scan that names a table no DHT defined reads jdhuff.c's
    standard one (slots 0 and 1, as Motion JPEG needs); a progressive scan
    is refused, as jdphuff.c refuses it."""
    image = Image.open(FIXTURES / "laion_loader_444.jpg").convert("RGB")
    out = io.BytesIO()
    image.save(out, "JPEG", quality=80, **kw)
    want = "refused" if kw.get("progressive") else "equal"
    assert _outcome(_without_dht(out.getvalue()), str(kw)) == want
