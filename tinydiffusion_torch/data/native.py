"""The host decoders' C library (``data/csrc/*.c``): loading, pointers, errors.

JAX's loader decodes every record with Pillow, which is C. The port's
counterparts of Pillow's entropy decoders are the C functions in
``data/csrc/``: JPEG's Huffman, arithmetic and lossless scans (``jpeg.c``),
VP8 (``vp8.c``), VP8L (``vp8l.c``), GIF's LZW (``gif.c``), TIFF's LZW and
PackBits (``tiff.c``), JPEG 2000's tiles (``jpeg2000.c``), TGA's run-length
packets and QOI's ops (``raster.c``). ``library()`` builds them with the
host C compiler at the first decode (``ops/_build.py``, ``DECODERS``), never
at import, and loads them with ctypes, which lets go of the GIL for each
call, so ``precache_dataset``'s threads decode at once. A missing compiler
or a failed build raises ``RuntimeError``; there is no fallback. Python
allocates every output from the header's sizes and passes its length; a
negative return code becomes ``ValueError``, the decoders' contract for
corrupt or truncated data.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tinydiffusion_torch.ops import _build

# decode.h's return codes.
ERR_ARGS, ERR_TRUNCATED, ERR_CODE, ERR_RANGE, ERR_SEGMENTS, ERR_CORRUPT, ERR_MEMORY = range(-1, -8,
                                                                                           -1)
_MESSAGES = {
    ERR_ARGS: "sizes the decoder cannot take",
    ERR_TRUNCATED: "the data ends early",
    ERR_CODE: "a bit pattern that is no prefix code",
    ERR_RANGE: "a value outside its bounds",
    ERR_SEGMENTS: "fewer restart segments than MCUs",
    ERR_CORRUPT: "data the format forbids",
    ERR_MEMORY: "out of memory",
}


def library() -> ctypes.CDLL:
    """The decoders' library, built on the first call."""
    return _build.library(_build.DECODERS)


def ptr(array: np.ndarray) -> int:
    """The address of a C-contiguous numpy array's first element."""
    assert array.flags.c_contiguous
    return array.ctypes.data


def check(rc: int, fmt: str, messages: dict | None = None) -> None:
    """``ValueError`` for a negative return code of a ``tdt_*`` call."""
    if rc < 0:
        reason = (messages or {}).get(rc) or f"corrupt or truncated {fmt} data: " + _MESSAGES.get(
            rc, f"error {rc}")
        raise ValueError(reason)
