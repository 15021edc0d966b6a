"""PNG's container in Python and numpy, for the port's codec (data/
native.py): the chunks, their CRCs (``zlib.crc32``), inflate and deflate
(Python's ``zlib``); the row filters and Adam7 passes are the codec's C++
(``dg_png_unfilter`` in ``native/imgcodec.cpp``).

:func:`decode` gives what libpng gives under the JAX codec's settings
(``native/imgcodec.cpp:101-106``): 16-bit samples keep their high byte
(``png_set_strip_16``), a palette (with or without tRNS) becomes RGB,
1-, 2- and 4-bit gray is scaled to 8 bits, gray becomes RGB, alpha is
dropped, and no gamma is applied.  Where libpng stops with an error it gives
None: a bad signature, a bad CRC on a critical chunk, a truncated file or
image stream, an unknown critical chunk, a header libpng refuses.  An
ancillary chunk with a bad CRC is skipped, as libpng does.
:func:`encode` writes 8-bit RGB with filter 0 and ``zlib.compress``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Callable

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, bit depths allowed)
COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
               4: (2, (8, 16)), 6: (4, (8, 16))}
MAX_SIDE = 1_000_000        # libpng's default user limit on width and height
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

# (raw, width, height, depth, channels, interlace) -> (h, w, channels)
# uint8 samples (16-bit: the high byte; 1/2/4-bit: unpacked), or None
Unfilter = Callable[[bytearray, int, int, int, int, int], "np.ndarray | None"]


def image_bytes(width: int, height: int, depth: int, channels: int,
                interlace: int) -> int:
    """The inflated size of the image: each row of each pass with its
    filter byte (passes that are empty in a small image have no rows)."""
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    total = 0
    for x0, y0, dx, dy in passes:
        pw = (width - x0 + dx - 1) // dx
        ph = (height - y0 + dy - 1) // dy
        if pw > 0 and ph > 0:
            total += ph * (1 + (pw * depth * channels + 7) // 8)
    return total


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature; a chunk whose
    CRC is bad is given with payload None, a truncated one as ("", None),
    which ends the list as the end of the data does."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            yield "", None
            return
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length + 4
        if length > 0x7FFFFFFF or end > len(data) or not kind.isalpha():
            yield "", None
            return
        payload = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[end - 4:end])[0]
        ok = zlib.crc32(kind + payload) == crc
        yield kind.decode("latin-1"), payload if ok else None
        pos = end


def decode(data: bytes, unfilter: Unfilter) -> np.ndarray | None:
    """A PNG file's bytes as RGB uint8 (H, W, 3), or None (see the
    module docstring)."""
    if not data.startswith(SIGNATURE):
        return None
    header = None
    palette = None
    idat: list[bytes] = []
    for kind, payload in _chunks(data):
        if not kind:
            return None         # truncated
        if idat and kind != "IDAT":
            break               # the image data ended
        critical = kind[:1].isupper()
        if payload is None:
            if critical:
                return None
            continue            # an ancillary chunk with a bad CRC
        if header is None:
            if kind != "IHDR" or len(payload) != 13:
                return None
            header = struct.unpack(">IIBBBBB", payload)
            width, height, depth, color, comp, filt, interlace = header
            if (color not in COLOR_TYPES or depth not in COLOR_TYPES[color][1]
                    or comp or filt or interlace > 1
                    or not 0 < width <= MAX_SIDE
                    or not 0 < height <= MAX_SIDE):
                return None
            continue
        if kind == "PLTE":
            if color == 3:
                if palette is not None or len(payload) % 3 or len(payload) > 768:
                    return None
                entries = np.frombuffer(payload, np.uint8).reshape(-1, 3)
                palette = np.zeros((256, 3), np.uint8)
                n = min(len(entries), 1 << depth)
                palette[:n] = entries[:n]
        elif kind == "IDAT":
            if color == 3 and palette is None:
                return None
            idat.append(payload)
        elif kind in ("IHDR", "IEND") or critical:
            return None
    if not idat:
        return None
    channels = COLOR_TYPES[color][0]
    need = image_bytes(width, height, depth, channels, interlace)
    inflate = zlib.decompressobj()
    try:
        raw = inflate.decompress(b"".join(idat))
    except zlib.error:
        return None
    if len(raw) < need or not inflate.eof:
        return None             # the stream ends short, or past the IDATs
    samples = unfilter(bytearray(raw), width, height, depth, channels,
                       interlace)
    if samples is None:
        return None
    if color == 3:
        return palette[samples[..., 0]]
    if color in (0, 4):
        gray = samples[..., 0]
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode(rgb: np.ndarray) -> bytes:
    """An RGB uint8 (H, W, 3) image as a PNG file: 8-bit RGB, not
    interlaced, every row with filter 0, deflated by ``zlib.compress``."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))
