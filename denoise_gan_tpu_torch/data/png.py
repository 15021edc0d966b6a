"""PNG's container in Python and numpy, for the port's codec (data/
native.py): the chunks, their CRCs (``zlib.crc32``), inflate and deflate
(Python's ``zlib``); the row filters and Adam7 passes are the codec's C++
(``dg_png_unfilter`` in ``native/imgcodec.cpp``).

:func:`decode` gives what libpng 1.6 gives under the JAX codec's settings
(``native/imgcodec.cpp:101-106``): 16-bit samples keep their high byte
(``png_set_strip_16``), a palette (with or without tRNS) becomes RGB,
1-, 2- and 4-bit gray is scaled to 8 bits, gray becomes RGB, alpha is
dropped, and no gamma is applied.  It reads the file as libpng's
sequential reader does and stops where it does: the image data is
inflated a row at a time from IDAT pieces of 8192 bytes, and the JAX codec
never calls ``png_read_end``, so nothing after the IDAT in which the
stream ended is read.  None where libpng stops with an error: a bad
signature, a bad CRC on a critical chunk it reads, a file that ends
before the image does, a zlib error while the rows are read, an unknown
critical chunk, a header libpng refuses.  An ancillary chunk with a bad
CRC is skipped; a zlib error after the last row (a bad Adler-32 whose
bytes come in a later piece) and data past the image are benign, as in
libpng.  :func:`encode` writes 8-bit RGB with filter 0 and
``zlib.compress``.
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
IDAT_READ_SIZE = 8192       # libpng's PNG_IDAT_READ_SIZE

# (raw, width, height, depth, channels, interlace) -> (h, w, channels)
# uint8 samples (16-bit: the high byte; 1/2/4-bit: unpacked), or None
Unfilter = Callable[[bytearray, int, int, int, int, int], "np.ndarray | None"]


class _Truncated(Exception):
    """libpng's read callback in the JAX codec: the file ended."""


class _Reader:
    """The file read as libpng reads it: chunk headers, chunk data and
    CRCs, from a position that only moves forward."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = len(SIGNATURE)
        self.crc = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise _Truncated
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        self.crc = zlib.crc32(out, self.crc)
        return out

    def header(self) -> tuple[int, str]:
        """The next chunk's length and type, where its CRC starts; a
        length past 2^31 - 1 or a type not of four letters raises a
        ValueError, as libpng stops there."""
        length = struct.unpack(">I", self.read(4))[0]
        self.crc = 0
        kind = self.read(4)
        if length > 0x7FFFFFFF or not kind.isalpha():
            raise ValueError(kind)
        return length, kind.decode("latin-1")

    def crc_ok(self) -> bool:
        """Read the chunk's CRC and compare it with the bytes read since
        its header."""
        want = self.crc
        return struct.unpack(">I", self.read(4))[0] == want


def _image_data(r: _Reader, idat_size: int, rows: list[int]) -> bytes | None:
    """The inflated rows, read as libpng 1.6's sequential reader reads
    them (pngrutil.c's png_read_IDAT_data, one call a row): the IDATs in
    pieces of IDAT_READ_SIZE bytes, each IDAT's CRC checked when the next
    is needed, and a zlib error fatal.  After the last row the stream is
    given what is left of its pieces (png_read_finish_IDAT): an error there,
    a bad Adler-32 say, is benign, and more data than the image needs is
    too.  The chunks after the one the stream ended in are never read (the
    JAX codec does not call png_read_end).  None where libpng stops."""
    inflate = zlib.decompressobj()
    left = idat_size            # unread bytes of the current IDAT
    pending = b""               # zlib's unconsumed input

    def piece() -> bytes | None:
        nonlocal left
        while left == 0:
            if not r.crc_ok():
                return None     # a critical chunk's CRC
            left, kind = r.header()
            if kind != "IDAT":
                return None     # "Not enough image data"
        n = min(IDAT_READ_SIZE, left)
        left -= n
        return r.read(n)

    out = []
    for n in rows:
        got = 0
        while got < n and not inflate.eof:
            if not pending:
                pending = piece()
                if pending is None:
                    return None
            try:
                row = inflate.decompress(pending, n - got)
            except zlib.error:
                return None
            pending = inflate.unconsumed_tail
            got += len(row)
            out.append(row)
        if got < n:
            return None         # the stream ended before the image
    extra = 0
    while not inflate.eof:
        if not pending:
            pending = piece()
            if pending is None:
                return None
        try:
            extra += len(inflate.decompress(pending))
        except zlib.error:
            break               # benign after the last row
        pending = inflate.unconsumed_tail
        if not extra:
            break
    r.read(left)
    return b"".join(out) if r.crc_ok() else None


def _row_sizes(width: int, height: int, depth: int, channels: int,
               interlace: int) -> list[int]:
    """Each row's inflated size (its filter byte included), pass by pass
    (passes that are empty in a small image have no rows)."""
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = []
    for x0, y0, dx, dy in passes:
        pw = (width - x0 + dx - 1) // dx
        ph = (height - y0 + dy - 1) // dy
        if pw > 0 and ph > 0:
            sizes += [1 + (pw * depth * channels + 7) // 8] * ph
    return sizes


def decode(data: bytes, unfilter: Unfilter) -> np.ndarray | None:
    """A PNG file's bytes as RGB uint8 (H, W, 3), or None (see the
    module docstring)."""
    if not data.startswith(SIGNATURE):
        return None
    r = _Reader(data)
    header = None
    palette = None
    try:
        while True:     # png_read_info: the chunks before the first IDAT
            length, kind = r.header()
            if kind == "IDAT":
                break
            payload = r.read(length)
            critical = kind[:1].isupper()
            if not r.crc_ok():
                if critical:
                    return None
                continue        # an ancillary chunk with a bad CRC
            if header is None:
                if kind != "IHDR" or len(payload) != 13:
                    return None
                header = struct.unpack(">IIBBBBB", payload)
                width, height, depth, color, comp, filt, interlace = header
                if (color not in COLOR_TYPES
                        or depth not in COLOR_TYPES[color][1]
                        or comp or filt or interlace > 1
                        or not 0 < width <= MAX_SIDE
                        or not 0 < height <= MAX_SIDE):
                    return None
                continue
            if kind == "PLTE":
                if color == 3:
                    if (palette is not None or len(payload) % 3
                            or len(payload) > 768):
                        return None
                    entries = np.frombuffer(payload, np.uint8).reshape(-1, 3)
                    palette = np.zeros((256, 3), np.uint8)
                    n = min(len(entries), 1 << depth)
                    palette[:n] = entries[:n]
            elif kind in ("IHDR", "IEND") or critical:
                return None
        if header is None or (color == 3 and palette is None):
            return None
        channels = COLOR_TYPES[color][0]
        raw = _image_data(r, length, _row_sizes(width, height, depth,
                                                channels, interlace))
    except (_Truncated, ValueError):
        return None
    if raw is None:
        return None
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
