"""What a format's open step hands its decode step, and how it says a file is not its own.

Pillow splits reading an image in two: a plugin's ``_open`` reads the
header, and ``load()`` decodes the pixels. ``Image.open`` tries its plugins
in turn, and moves on to the next one where an ``_open`` raises
``SyntaxError`` (``ImageFile`` turns ``IndexError``, ``TypeError``,
``KeyError``, ``EOFError`` and ``struct.error`` into one, and raises one
itself where the header leaves the mode empty or a side 0 or less). The
port's formats split their decoders the same way (``data/identify.py``
walks them): an open function returns a ``Header`` or raises
``NotThisFormat``, and every failure of the decode that follows refuses the
record with ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Callable


class NotThisFormat(ValueError):
    """The file is not this format's: Pillow's ``_open`` would raise one of
    the exceptions on which ``Image.open`` tries the next plugin."""


@dataclasses.dataclass(frozen=True)
class Header:
    """An opened file: its mode and size as Pillow's plugin sets them
    (``size`` None where the port's open step does not read it), and what
    the decode step needs of the header."""

    mode: str
    size: tuple[int, int] | None
    info: Any = None


# What ImageFile turns into SyntaxError around a plugin's _open.
FALL_THROUGH = (NotThisFormat, IndexError, TypeError, KeyError, EOFError, struct.error)


def open_as(open_fn: Callable[[bytes], Header], data: bytes) -> Header:
    """``open_fn(data)`` as ``ImageFile.__init__`` runs a plugin's ``_open``:
    the exceptions of ``FALL_THROUGH``, and a header with no mode or a side
    of 0 or less, become ``NotThisFormat``."""
    try:
        header = open_fn(data)
    except FALL_THROUGH as e:
        if isinstance(e, NotThisFormat):
            raise
        raise NotThisFormat(f"{type(e).__name__}: {e}") from e
    if header.size is not None and (not header.mode or header.size[0] <= 0
                                    or header.size[1] <= 0):
        raise NotThisFormat(f"a {header.mode or 'modeless'} image of size {header.size}")
    return header
