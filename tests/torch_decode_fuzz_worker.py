"""Seeded corruptions of one image file through the port's C decoders and
their plain versions, in a process of its own.

``tests/test_torch_native_decode.py`` runs it as a subprocess, so that a
crash in the C library fails that test instead of killing a pytest worker:

    python -m tests.torch_decode_fuzz_worker FILE SEED COUNT

Each mutant of ``FILE`` (a truncation at a random length, or one to three
random bytes replaced) must raise ``ValueError`` in ``decode_image`` exactly
where the plain version raises it, and otherwise give the plain version's
bytes. The size fields of the headers are left alone (``size_fields``), so
that no mutant asks the plain version for a huge image; truncations cover
them. Prints one JSON line: the mutants, how many each decoder refused, and
the first disagreement, if any; exits 1 on a disagreement.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from tinydiffusion_torch.data import gif, ico, identify, jpeg, jpeg2000, laion, netpbm, qoi, tga
from tinydiffusion_torch.data import tiff, webp

# The TIFF fields that size the samples' array: width, length, bits per
# sample, samples per pixel, rows per strip, tile width and length.
_TIFF_SIZE_TAGS = (256, 257, 258, 277, 278, 322, 323)


# The plain versions of the C decoders, by the format ``identify`` names.
_PLAIN = {"JPEG": lambda data, header: jpeg.decode_jpeg_reference(data),
          "GIF": lambda data, header: gif.decode_gif_reference(data),
          "WEBP": lambda data, header: webp.decode_webp_reference(data),
          "TIFF": lambda data, header: tiff.decode_tiff_reference(data),
          "TGA": tga.decode_tga_reference, "QOI": qoi.decode_qoi_reference}


def plain(data: bytes) -> np.ndarray:
    """``decode_image`` with the plain versions of the C decoders. A format
    with none (PNG, BMP, DIB, ICO, JPEG 2000, Netpbm) goes through
    ``decode_image`` itself: its mutants must raise ``ValueError`` or
    decode, never crash."""
    plugin, header = identify.open_image(data)
    if plugin.name in _PLAIN:
        return _PLAIN[plugin.name](data, header)
    return laion.decode_image(data)


def size_fields(data: bytes) -> set[int]:
    """The byte offsets of the header fields that give the image's size:
    JPEG's SOF height and width, GIF's screen and first image descriptor,
    a VP8X canvas, VP8's and VP8L's frame sizes, TIFF's size fields (and
    where its IFD is), an icon's entry offsets and its DIBs' sizes, JPEG
    2000's JP2 header size and its SIZ segment, a TGA's, a QOI's and a DIB's
    width and height, a Netpbm file's header."""
    found = set()
    if data[:4] == b"qoif":
        found |= set(range(4, 12))
    elif data[:1] == b"P" and netpbm.accept(data[:2]):
        try:
            found |= set(range(netpbm.open_ppm(data).info["pixels_at"]))
        except ValueError:
            pass
    elif data[:4] in (b"\x28\x00\x00\x00", b"\x0c\x00\x00\x00"):
        found |= set(range(4, 12))
    elif data[1:3] in (b"\x00\x02", b"\x00\x0a", b"\x01\x01", b"\x01\x09", b"\x00\x03",
                       b"\x00\x0b"):  # a TGA: its size fields
        found |= set(range(12, 16))
    if data[:2] == b"\xff\xd8":  # the marker segments up to the frame's
        k = 2
        while k + 9 <= len(data) and data[k] == 0xFF:
            if data[k + 1] in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
                found |= set(range(k + 5, k + 9))
                break
            k += 2 + int.from_bytes(data[k + 2:k + 4], "big")
    elif data[:6] in gif.SIGNATURES:
        found |= set(range(6, 10))
        k = 13 + ((3 << ((data[10] & 7) + 1)) if data[10] & 128 else 0)
        while k < len(data) and data[k] == 0x21:  # extensions: a label, then sub-blocks
            k += 2
            while k < len(data) and data[k]:
                k += 1 + data[k]
            k += 1
        if k < len(data) and data[k] == 0x2C:
            found |= set(range(k + 1, k + 9))
    elif data[:4] in tiff.SIGNATURES:  # the IFD's place, its count and the size fields
        order = "little" if data[:2] == b"II" else "big"
        at = int.from_bytes(data[4:8], order)
        found |= set(range(4, 8)) | {at, at + 1}
        for i in range(int.from_bytes(data[at:at + 2], order)):
            entry = at + 2 + 12 * i
            if int.from_bytes(data[entry:entry + 2], order) in _TIFF_SIZE_TAGS:
                found |= set(range(entry, entry + 12))
    elif data[:12] == jpeg2000.JP2_SIGNATURE or data[:4] == jpeg2000.J2K_SIGNATURE:
        k = data.find(b"ihdr")  # a JP2 header's height and width
        if k >= 0:
            found |= set(range(k + 4, k + 12))
        k = data.find(b"\xff\x51")  # SIZ: the image, tile and component geometry
        if k >= 0:
            found |= set(range(k + 2, k + 2 + int.from_bytes(data[k + 2:k + 4], "big")))
    elif data[:4] in ico.SIGNATURES:  # each entry's offset and its DIB's width and height
        for i in range(int.from_bytes(data[4:6], "little")):
            offset = int.from_bytes(data[18 + 16 * i:22 + 16 * i], "little")
            found |= set(range(18 + 16 * i, 22 + 16 * i)) | set(range(offset + 4, offset + 12))
    else:
        for tag, first, last in ((b"VP8X", 12, 18), (b"VP8 ", 14, 18), (b"VP8L", 9, 13)):
            k = data.find(tag)
            if k >= 0:
                found |= set(range(k + first, k + last))
    return found


def mutants(data: bytes, seed: int, count: int):
    rng = np.random.default_rng(seed)
    fixed = size_fields(data)
    free = np.array([k for k in range(len(data)) if k not in fixed])
    for i in range(count):
        if i % 2 == 0:
            yield f"truncated to {(n := int(rng.integers(0, len(data))))}", data[:n]
        else:
            out = bytearray(data)
            for k in rng.choice(free, int(rng.integers(1, 4)), replace=False):
                out[k] = int(rng.integers(0, 256))
            yield "bytes replaced", bytes(out)


def main(path: str, seed: int, count: int) -> int:
    with open(path, "rb") as f:
        data = f.read()
    refused = {"c": 0, "plain": 0}
    disagreement = None
    for what, mutant in mutants(data, seed, count):
        results = {}
        for name, decode in (("c", laion.decode_image), ("plain", plain)):
            try:
                results[name] = decode(mutant)
            except ValueError:
                results[name] = None
                refused[name] += 1
        c, ref = results["c"], results["plain"]
        same = (c is None and ref is None) or (c is not None and ref is not None
                                               and c.shape == ref.shape and np.array_equal(c, ref))
        if not same and disagreement is None:
            disagreement = {"mutant": what, "c": None if c is None else list(c.shape),
                            "plain": None if ref is None else list(ref.shape)}
    print(json.dumps({"mutants": count, "refused": refused, "disagreement": disagreement}))
    return 1 if disagreement else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
