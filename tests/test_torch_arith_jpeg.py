"""Arithmetic-coded JPEG (SOF9, SOF10) in the LAION loader, against Pillow 12.1.

Pillow writes no arithmetic-coded JPEG, but its libjpeg-turbo reads them, so
JAX's loader trains on such a record. This module holds a small test-only
arithmetic *encoder* (T.81 Annex D's QM encoder and the F.1.4 and G.1.3
procedures, as libjpeg's ``jcarith.c`` codes them, DAC segments where the
conditioning is not the default) and re-encodes the quantised coefficients
of Pillow-written JPEGs (4:4:4, 4:2:2, 4:2:0, 4:4:0, grey, CMYK) as
sequential and progressive arithmetic files, with restart intervals and
several scan scripts:

- the self-check: Pillow decodes each re-encoded file to exactly the pixels
  of its source file, since the coefficients are the same;
- ``data/jpeg.py``'s plain decoder (``decode_jpeg_reference``) and its C
  decoder (``decode_jpeg``, ``data/csrc/jpeg.c::tdt_jpeg_arith_scan``) give
  Pillow's pixels on each file;
- truncations and flipped bytes: the C decoder refuses exactly what the
  plain one refuses, and gives its bytes otherwise
  (``tests/torch_decode_fuzz_worker.py``, in a subprocess);
- SOF11 (arithmetic lossless) is refused, as is a 12-bit (SOF1, P = 12)
  file, which Pillow refuses too; the lossless (SOF3) files the writer here
  makes (``lossless_jpeg``) decode as Pillow decodes them.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import io
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_decoders import _image
from tinydiffusion_torch.data import jpeg, laion

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
PILLOW_BLOCK = jpeg.PILLOW_BLOCK

# --- the test-only arithmetic encoder (jcarith.c) -----------------------------------

_QE, _NEXT_LPS, _NEXT_MPS = jpeg._QE, jpeg._NEXT_LPS, jpeg._NEXT_MPS


class ArithEncoder:
    """``jcarith.c``'s ``arith_encode`` and ``finish_pass``: the C and A
    registers, the stacked 0xFF bytes (``sc``) and the pending zero bytes
    (``zc``, dropped at the end: the decoder reads zeros past the data)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _flush_stacked(self) -> None:
        """Output the buffered byte and the stacked 0xFF bytes, which can no
        longer overflow."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self.out += b"\x00" * self.zc
            self.zc = 0
            self.out.append(self.buffer)
        if self.sc:
            self.out += b"\x00" * self.zc
            self.zc = 0
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _carry(self) -> None:
        """An overflow into the buffered byte: it goes out plus one, the
        stacked 0xFF bytes become zeros."""
        if self.buffer >= 0:
            self.out += b"\x00" * self.zc
            self.zc = 0
            self.out.append(self.buffer + 1)
            if self.buffer + 1 == 0xFF:
                self.out.append(0)
        self.zc += self.sc
        self.sc = 0

    def encode(self, stats: list, i: int, val: int) -> None:
        sv = stats[i]
        qe = _QE[sv & 127]
        self.a -= qe
        if val != sv >> 7:  # the LPS
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 128) ^ _NEXT_LPS[sv & 127]
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 128) ^ _NEXT_MPS[sv & 127]
        while True:  # renormalization and output, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stacked()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        """D.1.8: the C in the interval with the most trailing zero bits,
        then its bytes, final zeros dropped."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._flush_stacked()
        if self.c & 0x7FFF800:
            self.out += b"\x00" * self.zc
            self.zc = 0
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if not self.c & mask:
                    break
                byte = (self.c >> shift) & 0xFF
                self.out.append(byte)
                if byte == 0xFF:
                    self.out.append(0)
        return bytes(self.out)


def _encode_value(enc: ArithEncoder, stats: list, st: int, v: int, large_bin: int | None
                  ) -> None:
    """F.1.4.4's magnitude category and bits of ``v - 1`` (v >= 1) from bin
    ``st`` (SP or SN for DC, S0 + 2 for AC). ``large_bin``: None for DC (the
    X bins at 20), else AC's 189 or 217."""
    m, v = 0, v - 1
    if v:
        enc.encode(stats, st, 1)
        m, v2 = 1, v
        if large_bin is None:
            st = 20
            v2 >>= 1
            while v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
        else:
            v2 >>= 1
            if v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st = large_bin
                v2 >>= 1
                while v2:
                    enc.encode(stats, st, 1)
                    m <<= 1
                    st += 1
                    v2 >>= 1
    enc.encode(stats, st, 0)
    st += 14
    m >>= 1
    while m:
        enc.encode(stats, st, 1 if m & v else 0)
        m >>= 1


def _encode_dc(enc, stats, context, j, diff, lower, upper) -> None:
    """Figures F.4 and F.6-F.9 for one DC difference, the conditioning after it."""
    st = context[j]
    if diff == 0:
        enc.encode(stats, st, 0)
        context[j] = 0
        return
    enc.encode(stats, st, 1)
    sign = 1 if diff < 0 else 0
    enc.encode(stats, st + 1, sign)
    m = abs(diff) - 1
    category = 0 if m == 0 else 1 << (m.bit_length() - 1)
    context[j] = (0 if category < (1 << lower) >> 1
                  else (12 if category > (1 << upper) >> 1 else 4) + 4 * sign)
    _encode_value(enc, stats, st + 2 + sign, abs(diff), None)


def _encode_ac(enc, stats, fixed, st, k, value, kx) -> None:
    """A nonzero AC value after its nonzero decision at ``st``."""
    enc.encode(fixed, 0, 1 if value < 0 else 0)
    _encode_value(enc, stats, st + 2, abs(value), 189 if k <= kx else 217)


def encode_arith_scan(frame: dict, members: list, spectral: tuple, coef: dict,
                      conditioning: tuple, restart: int) -> bytes:
    """One scan's entropy-coded data, RST markers included: the counterpart
    of ``jpeg._decode_arith_scan``. ``coef``: component -> its final
    coefficients, flat zigzag blocks, as ``jpeg._scan_blocks`` addresses them."""
    ss, se, ah, al = spectral
    lower, upper, kx = conditioning
    progressive = frame["progressive"]
    mcus, _ = jpeg._scan_blocks(frame, members)
    slot = {ci: j for j, (ci, _, _) in enumerate(members)}
    dc_of = {ci: td for ci, td, _ in members}
    ac_of = {ci: ta for ci, _, ta in members}
    out = bytearray()
    per = restart or len(mcus)
    for n, start in enumerate(range(0, len(mcus), per)):
        if n:
            out += bytes([0xFF, 0xD0 + (n - 1) % 8])
        enc = ArithEncoder()
        dc_stats = {td: [0] * 64 for td in dc_of.values()}
        ac_stats = {ta: [0] * 256 for ta in ac_of.values()}
        fixed = [jpeg.ARITH_FIXED_STATE]
        last, context = [0] * len(members), [0] * len(members)
        for mcu in mcus[start:start + per]:
            for ci, off in mcu:
                block, j = coef[ci][off:off + 64], slot[ci]
                if not progressive or (ss == 0 and ah == 0):
                    dc = int(block[0]) >> al
                    td = dc_of[ci]
                    _encode_dc(enc, dc_stats[td], context, j, dc - last[j], lower[td], upper[td])
                    last[j] = dc
                    if progressive:
                        continue
                    stats, ta = ac_stats[ac_of[ci]], ac_of[ci]
                    nonzero = np.nonzero(block[1:])[0]
                    ke = int(nonzero[-1]) + 1 if len(nonzero) else 0
                    k = 0
                    while k < ke:
                        st = 3 * k
                        enc.encode(stats, st, 0)
                        k += 1
                        while block[k] == 0:
                            enc.encode(stats, st + 1, 0)
                            st += 3
                            k += 1
                        enc.encode(stats, st + 1, 1)
                        _encode_ac(enc, stats, fixed, st, k, int(block[k]), kx[ta])
                    if k < 63:
                        enc.encode(stats, 3 * k, 1)
                elif ss == 0:
                    enc.encode(fixed, 0, (int(block[0]) >> al) & 1)
                else:
                    stats, ta = ac_stats[ac_of[ci]], ac_of[ci]
                    # The point transform of AC values: |v| >> al, toward zero.
                    shifted = [0] * 64
                    for k in range(ss, se + 1):
                        v = int(block[k])
                        shifted[k] = (abs(v) >> al) * (1 if v >= 0 else -1)
                    ke = max([k for k in range(ss, se + 1) if shifted[k]], default=0)
                    if ah == 0:
                        k = ss
                        while k <= ke:
                            st = 3 * (k - 1)
                            enc.encode(stats, st, 0)
                            while shifted[k] == 0:
                                enc.encode(stats, st + 1, 0)
                                st += 3
                                k += 1
                            enc.encode(stats, st + 1, 1)
                            _encode_ac(enc, stats, fixed, st, k, shifted[k], kx[ta])
                            k += 1
                    else:
                        before = [(abs(int(block[k])) >> ah) for k in range(64)]
                        kex = max([k for k in range(1, ke + 1) if before[k]], default=0)
                        k = ss
                        while k <= ke:
                            st = 3 * (k - 1)
                            if k > kex:
                                enc.encode(stats, st, 0)
                            while True:
                                v = abs(shifted[k])
                                if v:
                                    if v >> 1:  # a correction bit
                                        enc.encode(stats, st + 2, v & 1)
                                    else:  # newly nonzero
                                        enc.encode(stats, st + 1, 1)
                                        enc.encode(fixed, 0, 1 if shifted[k] < 0 else 0)
                                    break
                                enc.encode(stats, st + 1, 0)
                                st += 3
                                k += 1
                            k += 1
                    if k <= se:
                        enc.encode(stats, 3 * (k - 1), 1)
        out += enc.finish()
    return bytes(out)


# --- re-encoding Pillow's files --------------------------------------------------

# jcparam.c's jpeg_simple_progression, as (components, Ss, Se, Ah, Al).
SIMPLE_YCC = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
              ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
              ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
              ((0,), 1, 63, 1, 0))


def simple_progression(n: int) -> tuple:
    """``jpeg_simple_progression``'s script for ``n`` components."""
    if n == 3:
        return SIMPLE_YCC
    every = tuple(range(n))
    scans = [(every, 0, 0, 0, 1)]
    for ah, al in ((0, 2), (2, 1), (1, 0)):
        if ah == 1:
            scans.append((every, 0, 0, 1, 0))
        bands = ((1, 5), (6, 63)) if ah == 0 else ((1, 63),)
        scans += [((c,), ss, se, ah, al) for ss, se in bands for c in every]
    return tuple(scans)


def sequential(n: int, interleaved: bool = True) -> tuple:
    """One scan of every component, or a scan a component."""
    every = tuple(range(n))
    return ((every, 0, 63, 0, 0),) if interleaved else tuple(((c,), 0, 63, 0, 0) for c in every)


def read_coefficients(data: bytes) -> tuple[dict, dict]:
    """The frame (its quantised coefficients in ``frame["coef"]``) and each
    component's quantisation table, as the port's plain decoder reads a
    Huffman-coded JPEG."""
    captured = {}

    def grab(frame, latched, *args, **kwargs):
        captured.update(frame=frame, latched=latched)
        return np.zeros((frame["height"], frame["width"], 3), np.uint8)

    with mock.patch.object(jpeg, "_pixels", grab):
        jpeg.decode_jpeg_reference(data)
    return captured["frame"], captured["latched"]


def sof_marker(data: bytes) -> int:
    """The frame marker of a JPEG (its first SOFn), walking the segments."""
    pos = 2
    while not 0xC0 <= data[pos + 1] <= 0xCF or data[pos + 1] in (0xC4, 0xC8, 0xCC):
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
    return data[pos + 1]


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def rewrite_arithmetic(source: bytes, scans: tuple, restart: int = 0,
                       conditioning: dict | None = None) -> bytes:
    """``source`` (a Huffman-coded JPEG) with the same frame, quantisation
    tables and coefficients, arithmetic-coded: SOF10 where ``scans`` (as
    ``simple_progression`` gives them) refine or select spectra, else SOF9;
    ``restart`` MCUs an interval; ``conditioning``: DAC values by table
    index (0-15 DC as ``(L, U)``, 16-31 AC as ``Kx``), written only where
    they differ from the defaults. The luma's conditioning tables are 0,
    every other component's 1."""
    frame, _ = read_coefficients(source)
    progressive = any(s[1:] != (0, 63, 0, 0) for s in scans)
    lower, upper, kx = ([d] * 16 for d in jpeg.ARITH_DEFAULTS)
    dac = bytearray()
    for index, value in sorted((conditioning or {}).items()):
        if index < 16:
            lower[index], upper[index] = value
            if value != jpeg.ARITH_DEFAULTS[:2]:
                dac += bytes([index, value[0] | value[1] << 4])
        else:
            kx[index - 16] = value
            if value != jpeg.ARITH_DEFAULTS[2]:
                dac += bytes([index, value])
    target = dict(frame, progressive=progressive)
    coef = {ci: frame["coef"][ci].reshape(-1) for ci in range(len(frame["comps"]))}
    out, pos = bytearray(source[:2]), 2
    while source[pos + 1] not in (0xC0, 0xC1, 0xC2):
        end = pos + 2 + int.from_bytes(source[pos + 2:pos + 4], "big")
        if source[pos + 1] not in (0xC4, 0xDD):  # Huffman tables and restarts go
            out += source[pos:end]
        pos = end
    if dac:
        out += _segment(0xCC, bytes(dac))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    sof_end = pos + 2 + int.from_bytes(source[pos + 2:pos + 4], "big")
    out += bytes([0xFF, 0xCA if progressive else 0xC9]) + source[pos + 2:sof_end]
    ids = [c[0] for c in frame["comps"]]
    for comps, ss, se, ah, al in scans:
        members = [(c, 0 if c == 0 else 1, 0 if c == 0 else 1) for c in comps]
        header = bytes([len(comps)]) + b"".join(bytes([ids[c], td << 4 | ta])
                                               for c, td, ta in members)
        out += _segment(0xDA, header + bytes([ss, se, ah << 4 | al]))
        out += encode_arith_scan(target, members, (ss, se, ah, al), coef,
                                 (lower, upper, kx), restart)
    return bytes(out + b"\xff\xd9")


# --- the sources and the files ---------------------------------------------------


def _saved(image: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def source(kind: str, shape=(45, 61), seed: int = 12) -> bytes:
    """A Pillow-written Huffman JPEG: YCbCr at 4:4:4, 4:2:2, 4:2:0 or 4:4:0
    (a square 4:2:2 file with its SOF0 factors swapped: a whole number of
    MCUs codes as many blocks either way), grey or Adobe CMYK."""
    image = Image.fromarray(_image(shape, seed))
    if kind == "grey":
        return _saved(image.convert("L"), quality=80)
    if kind == "cmyk":
        return _saved(image.convert("CMYK"), quality=80)
    if kind == "440":
        data = bytearray(_saved(Image.fromarray(_image((32, 32), seed)), quality=80,
                                subsampling=1))
        sof = data.index(b"\xff\xc0")
        data[sof + 11] = 0x12
        return bytes(data)
    return _saved(image, quality=80, subsampling={"444": 0, "422": 1, "420": 2}[kind])


# A script of scans that splits everything (components, bands, bits) apart:
# a DC scan a component, AC bands of each component, refinements down to 0.
SPLIT = (((0,), 0, 0, 0, 2), ((1, 2), 0, 0, 0, 2), ((2,), 1, 2, 0, 3), ((0,), 1, 9, 0, 3),
         ((1,), 1, 63, 0, 0), ((0,), 10, 63, 0, 1), ((0, 1, 2), 0, 0, 2, 1), ((2,), 3, 63, 0, 1),
         ((0,), 1, 9, 3, 2), ((0,), 1, 9, 2, 1), ((2,), 1, 2, 3, 2), ((2,), 1, 2, 2, 1),
         ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0))
CONDITIONING = {0: (2, 5), 1: (0, 0), 16: 1, 17: 63}

CASES = {
    "420_sequential": ("420", "sequential", 0, None),
    "420_sequential_restart_dac": ("420", "sequential", 3, CONDITIONING),
    "422_per_component": ("422", "per_component", 0, None),
    "444_progressive": ("444", "progressive", 0, None),
    "420_progressive_restart": ("420", "progressive", 2, None),
    "422_split_dac": ("422", "split", 0, CONDITIONING),
    "440_progressive_dac": ("440", "progressive", 1, CONDITIONING),
    "grey_sequential_restart": ("grey", "sequential", 5, None),
    "grey_progressive_dac": ("grey", "progressive", 0, {0: (0, 15), 16: 20}),
    "cmyk_sequential": ("cmyk", "sequential", 0, None),
    "cmyk_progressive_restart": ("cmyk", "progressive", 4, CONDITIONING),
}


def scans_of(script: str, n: int) -> tuple:
    return {"sequential": sequential(n), "per_component": sequential(n, interleaved=False),
            "progressive": simple_progression(n), "split": SPLIT}[script]


def case_file(name: str) -> tuple[bytes, bytes]:
    """(source, its arithmetic-coded rewrite) of ``CASES[name]``."""
    kind, script, restart, conditioning = CASES[name]
    data = source(kind)
    n = 1 if kind == "grey" else 4 if kind == "cmyk" else 3
    return data, rewrite_arithmetic(data, scans_of(script, n), restart, conditioning)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rewrite_decodes_as_its_source_in_pillow_and_the_port(name):
    """The self-check (Pillow's pixels of the rewrite are its source's:
    the coefficients are the same), then the port's plain and C decoders
    on the rewrite, each equal to Pillow's pixels."""
    data, arith = case_file(name)
    assert sof_marker(arith) == (0xC9 if CASES[name][1] in ("sequential", "per_component")
                                 else 0xCA)
    want = _pillow(arith)
    np.testing.assert_array_equal(want, _pillow(data))
    np.testing.assert_array_equal(jpeg.decode_jpeg_reference(arith), want)
    np.testing.assert_array_equal(laion.decode_image(arith), want)


def test_dac_is_written_only_where_the_conditioning_is_not_the_default():
    """A rewrite at DAC's defaults has no DAC segment; one with other
    values has one, and a DAC that says the defaults decodes the same."""
    data = source("420")
    plain = rewrite_arithmetic(data, sequential(3))
    tuned = rewrite_arithmetic(data, sequential(3), conditioning=CONDITIONING)
    assert b"\xff\xcc" not in plain[:plain.index(b"\xff\xda")]
    assert b"\xff\xcc" in tuned[:tuned.index(b"\xff\xda")]
    sof = plain.index(b"\xff\xc9")
    explicit = plain[:sof] + _segment(0xCC, bytes([0, 0x10, 1, 0x10, 16, 5, 17, 5])) + plain[sof:]
    np.testing.assert_array_equal(laion.decode_image(explicit), _pillow(plain))
    np.testing.assert_array_equal(laion.decode_image(tuned), _pillow(tuned))


def _padded(data: bytes, before: int, total: int) -> bytes:
    """``data`` with COM segments of ``total`` bytes in all put before its
    byte ``before``: every later byte moves by ``total``."""
    pads, left = b"", total
    while left:
        n = min(left, 60000)
        if 0 < left - n < 4:
            n -= 8
        pads += _segment(0xFE, bytes(n - 4))
        left -= n
    return data[:before] + pads + data[before:]


def _scan_spans(data: bytes) -> list[tuple[int, int]]:
    """Each scan's (first byte of its data, first byte of the marker after)."""
    spans, pos = [], 2
    while data[pos + 1] != 0xD9:
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == 0xDA:
            nxt = end
            while not (data[nxt] == 0xFF and data[nxt + 1] not in (0, 0xFF)
                       and not 0xD0 <= data[nxt + 1] <= 0xD7):
                nxt += 1
            spans.append((end, nxt))
            end = nxt
        pos = end
    return spans


@pytest.mark.parametrize("name", ["420_sequential_restart_dac", "444_progressive"])
def test_a_scan_across_pillows_64k_reads_is_refused_as_pillow_refuses(name):
    """Pillow hands libjpeg the file in 64 KiB blocks and the arithmetic
    decoder cannot wait for more: with the file's scans moved by COM
    segments so that byte 65536 falls before, at the start of, inside, at
    the end of and after each scan's data (and its marker), the port and
    its plain version refuse exactly where Pillow does, and else give
    Pillow's pixels."""
    _, arith = case_file(name)
    first = arith.index(b"\xff\xda")
    outcomes = set()
    for start, stop in _scan_spans(arith)[:4]:
        for at in sorted({start - 1, start, start + 1, (start + stop) // 2, stop - 1, stop,
                          stop + 1, stop + 2}):
            moved = _padded(arith, first, PILLOW_BLOCK - at)
            try:
                want = _pillow(moved)
            except OSError:
                want = None
            outcomes.add(want is None)
            for decode in (laion.decode_image, jpeg.decode_jpeg_reference):
                if want is None:
                    with pytest.raises(ValueError, match="64 KiB"):
                        decode(moved)
                else:
                    np.testing.assert_array_equal(decode(moved), want)
    assert outcomes == {True, False}


def test_a_large_arithmetic_file_is_refused_as_pillow_refuses():
    """A 512² noisy progressive file of ~250 KiB: every 64 KiB block
    boundary falls inside a scan, and Pillow refuses it; the port too. The
    same coefficients Huffman-coded decode (no such limit)."""
    data = _saved(Image.fromarray(_image((512, 512), 3)), quality=90)
    arith = rewrite_arithmetic(data, simple_progression(3))
    with pytest.raises(OSError, match="broken data stream"):
        _pillow(arith)
    with pytest.raises(ValueError, match="64 KiB"):
        laion.decode_image(arith)
    np.testing.assert_array_equal(laion.decode_image(data), _pillow(data))



def lossless_jpeg(planes, predictor: int = 1, pt: int = 0, restart: int = 0,
                  sampling=None, marker: str = "", ids=None, interleaved: bool = True,
                  table=None, size=None) -> bytes:
    """An 8-bit lossless JPEG (SOF3), as T.81 Annex H codes it: ``planes``
    a grey image, or one array a component (each at its sampling factors'
    share of the image; the first's shape sets the image's, else ``size``,
    (height, width)), coded as they
    are (no colour transform). Each sample less ``pt`` low bits is predicted
    by ``predictor`` (1-7; the first row from the left, its first sample from
    2^(7 - pt), every first column from above), the prediction reset at each
    of the restart intervals of ``restart`` MCUs; the differences, mod 2^16,
    Huffman-coded with ``table`` ((counts, symbols); the standard luminance
    DC table by default), the samples past a component's edge in an
    interleaved MCU coded as 0. ``sampling``: (h, v) a component (1x1);
    ``marker``: "jfif", "adobe0" or "adobe1" (an Adobe APP14 and its
    transform flag), or none; ``ids``: the component ids (1, 2, ...);
    ``interleaved``: one scan of all components, else a scan each."""
    planes = [np.asarray(p) for p in planes] if isinstance(planes, (list, tuple)) else [planes]
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    height, width = size or (planes[0].shape[0] * vmax // sampling[0][1],
                             planes[0].shape[1] * hmax // sampling[0][0])
    counts, symbols = table or jpeg._STD_HUFFMAN[0, 0]
    code, size = jpeg._huffman_codes(counts, symbols)

    def predict(x, r, c, first):
        if first:
            return (1 << (7 - pt)) if c == 0 else x[r, c - 1]
        if c == 0:
            return x[r - 1, 0]
        ra, rb, rc = x[r, c - 1], x[r - 1, c], x[r - 1, c - 1]
        return (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                (ra + rb) >> 1)[predictor - 1]

    def scan(members):
        one = len(members) == 1
        grids = {ci: (1, 1) if one else sampling[ci] for ci in members}
        if one:
            mcux, mcuy = planes[members[0]].shape[1], planes[members[0]].shape[0]
        else:
            mcux, mcuy = -(-width // hmax), -(-height // vmax)
        x = {ci: (planes[ci].astype(np.int64) >> pt) for ci in members}
        reset_every = restart // mcux if restart else 0
        out, acc, nbits = bytearray(), 0, 0

        def put(value, width_):
            nonlocal acc, nbits
            acc, nbits = acc << width_ | value, nbits + width_
            while nbits >= 8:
                nbits -= 8
                out.append(acc >> nbits & 255)
                if out[-1] == 0xFF:
                    out.append(0)
            acc &= (1 << nbits) - 1

        def flush():
            nonlocal acc, nbits
            if nbits:
                put((1 << (8 - nbits)) - 1, 8 - nbits)

        for m in range(mcux * mcuy):
            if restart and m and m % restart == 0:
                flush()
                out.extend(bytes([0xFF, 0xD0 + (m // restart - 1) % 8]))
            mr, mc = divmod(m, mcux)
            for ci in members:
                h, v = grids[ci]
                for y in range(v):
                    for xx in range(h):
                        r, c = mr * v + y, mc * h + xx
                        plane = x[ci]
                        if r >= plane.shape[0] or c >= plane.shape[1]:
                            diff = 0
                        else:
                            band = r // v
                            first = r == 0 or (r % v == 0 and reset_every
                                               and band % reset_every == 0)
                            diff = (int(plane[r, c]) - int(predict(plane, r, c, first))) % 65536
                            diff = diff - 65536 if diff > 32768 else diff
                        cat = 16 if diff == 32768 else abs(diff).bit_length()
                        put(int(code[cat]), int(size[cat]))
                        if 0 < cat < 16:
                            put(diff if diff >= 0 else diff + (1 << cat) - 1, cat)
        flush()
        header = bytes([len(members)]) + b"".join(bytes([ids[ci], 0]) for ci in members)
        return (_segment(0xDA, header + bytes([predictor, 0, pt])) + bytes(out))

    frame = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([n])
    frame += b"".join(bytes([ids[ci], sampling[ci][0] << 4 | sampling[ci][1], 0])
                      for ci in range(n))
    app = {"": b"", "jfif": _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
           "adobe0": _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00"),
           "adobe1": _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x01")}[marker]
    dri = _segment(0xDD, restart.to_bytes(2, "big")) if restart else b""
    scans = [scan(list(range(n)))] if interleaved else [scan([ci]) for ci in range(n)]
    return (b"\xff\xd8" + app + _segment(0xC3, frame)
            + _segment(0xC4, bytes([0, *counts]) + bytes(symbols)) + dri + b"".join(scans)
            + b"\xff\xd9")


def test_lossless_12_bit_and_arithmetic_lossless_files_are_refused_by_name():
    """SOF11 (arithmetic lossless: libjpeg-turbo reads none, and Pillow
    refuses it, "broken data stream") and a 12-bit extended-sequential file
    (SOF1, P = 12: Pillow's JPEG plugin refuses it too, "cannot identify")
    raise ``ValueError`` by name in both decoders. An 8-bit lossless file
    (SOF3), which Pillow reads (libjpeg-turbo 3), decodes to Pillow's bytes
    in both (``tests/test_torch_lossless_jpeg.py`` holds every kind)."""
    data = source("420")
    sof = data.index(b"\xff\xc0")
    twelve = data[:sof + 1] + b"\xc1" + data[sof + 2:sof + 4] + bytes([12]) + data[sof + 5:]
    with pytest.raises(OSError, match="cannot identify"):
        _pillow(twelve)
    _, arith = case_file("420_sequential")
    sof = arith.index(b"\xff\xc9")
    lossless_arith = arith[:sof + 1] + b"\xcb" + arith[sof + 2:]
    with pytest.raises(OSError, match="broken data stream"):
        _pillow(lossless_arith)
    grey = np.asarray(Image.fromarray(_image((45, 61), 12)).convert("L"))
    lossless = lossless_jpeg(grey)
    np.testing.assert_array_equal(_pillow(lossless)[..., 0], grey)  # Pillow's oracle
    for decode in (laion.decode_image, jpeg.decode_jpeg_reference):
        with pytest.raises(ValueError, match="12-bit"):
            decode(twelve)
        with pytest.raises(ValueError, match="arithmetic-coded lossless"):
            decode(lossless_arith)
        np.testing.assert_array_equal(decode(lossless), _pillow(lossless))


@pytest.mark.parametrize("name", ["420_sequential_restart_dac", "422_split_dac",
                                  "cmyk_progressive_restart"])
def test_corrupt_arithmetic_files_are_refused_alike_by_both_decoders(name, tmp_path):
    """Seeded truncations and flipped bytes (``torch_decode_fuzz_worker``,
    a subprocess: a crash fails this test): the C decoder refuses exactly
    the mutants the plain one refuses and otherwise gives its bytes."""
    path = tmp_path / f"{name}.jpg"
    path.write_bytes(case_file(name)[1])
    proc = subprocess.run([sys.executable, "-m", "tests.torch_decode_fuzz_worker", str(path),
                           "25", "120"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --- the committed fixtures --------------------------------------------------------


def _fixture_bytes(name: str) -> bytes:
    """The committed fixture ``name`` as this file rebuilds it."""
    big = _saved(Image.fromarray(laion.synthesize_image(7, 512)[0]), quality=90)
    return {
        "laion_loader_arith.jpg": lambda: case_file("420_sequential_restart_dac")[1],
        "laion_loader_arith_progressive.jpg": lambda: case_file("420_progressive_restart")[1],
        "laion_loader_arith_split.jpg": lambda: case_file("422_split_dac")[1],
        # A web image's size under Pillow's 64 KiB read (32 KiB), for the
        # C decoder's rate (the card's laion_loader).
        "laion_loader_512_arith_progressive.jpg": lambda: rewrite_arithmetic(
            big, simple_progression(3)),
    }[name]()


FIXTURE_NAMES = ("laion_loader_arith.jpg", "laion_loader_arith_progressive.jpg",
                 "laion_loader_arith_split.jpg", "laion_loader_512_arith_progressive.jpg")


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_committed_fixture_is_rebuilt_and_decodes_as_pillow(name):
    data = (FIXTURES / name).read_bytes()
    assert data == _fixture_bytes(name)
    np.testing.assert_array_equal(laion.decode_image(data), _pillow(data))


def test_fixtures_are_in_the_cards_digest_table():
    digests = json.loads((FIXTURES / "laion_loader_pillow.json").read_text())
    assert set(FIXTURE_NAMES) <= set(digests)
