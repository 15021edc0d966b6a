"""Uncompressed RGBA AVI, read and written in plain Python (numpy +
``struct``), for the video CLI on a machine without cv2.

The form is the one ``cv2.VideoWriter(path, VideoWriter_fourcc(*"RGBA"),
fps, (w, h))`` writes and ``cv2.VideoCapture`` reads back bit-exact: one
video stream whose ``strh`` handler and ``strf`` compression are
``RGBA``, 32 bits a pixel, one ``00dc`` chunk a frame of top-down R, G, B,
A bytes (A = 255).  Frames go in and come out as BGR uint8 (H, W, 3), as
cv2's do; ``VideoWriter.write_rgba`` takes the RGBA bytes themselves, for
a caller that packs them elsewhere (the video CLI does so on the card).

Files past ``RIFF_BYTES`` continue in OpenDML ``AVIX`` parts: the first
part carries ``idx1``, every part an ``ix00`` index, and ``strl`` an
``indx`` super index.  The reader takes the frames from the ``movi`` lists
themselves (an ``idx1`` lists only the first part's), so it reads both.
The super index has room for ``SUPER_ENTRIES`` parts (256 KiB of header);
a frame that would open one more raises ``ValueError``, and ``release``
still completes the file with the frames written until then.
Any other AVI (a compressed codec, another pixel format, audio) raises
:class:`UnsupportedVideo`.
"""

from __future__ import annotations

import struct
from fractions import Fraction

import numpy as np

FOURCC = b"RGBA"
RIFF_BYTES = 1 << 30          # a part's size before the next AVIX part
SUPER_ENTRIES = 1 << 14       # super index entries reserved in strl (16 TiB)
_KEYFRAME = 0x10              # AVIIF_KEYFRAME
_AVIF = 0x10 | 0x100 | 0x800  # HASINDEX | ISINTERLEAVED | TRUSTCKTYPE


class UnsupportedVideo(ValueError):
    """The file is not an uncompressed RGBA AVI."""


def decode_fourcc(code: int) -> str:
    return "".join(chr(code >> 8 * i & 0xFF) for i in range(4))


def _chunk(fcc: bytes, data: bytes) -> bytes:
    return fcc + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _list(kind: bytes, data: bytes) -> bytes:
    return _chunk(b"LIST", kind + data)


class VideoReader:
    """The frames of an RGBA AVI, in order (``read``) or by index
    (``seek``), as BGR uint8 (H, W, 3) arrays."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        try:
            self._parse()
        except Exception:
            self._f.close()
            raise
        self.pos = 0

    def _parse(self) -> None:
        f = self._f
        f.seek(0, 2)
        end = f.tell()
        f.seek(0)
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:] != b"AVI ":
            raise UnsupportedVideo("not an AVI file")
        self.offsets: list[int] = []
        strh = strf = None
        pos = 0
        while pos + 12 <= end:                       # RIFF 'AVI ' / 'AVIX'
            f.seek(pos)
            fcc, size, kind = struct.unpack("<4sI4s", f.read(12))
            if fcc != b"RIFF":
                break
            for cfcc, cpos, csize in self._chunks(pos + 12, pos + 8 + size):
                if cfcc == b"LIST:hdrl":
                    for sfcc, spos, ssize in self._chunks(cpos, cpos + csize):
                        if sfcc == b"LIST:strl" and strh is None:
                            for tfcc, tpos, tsize in self._chunks(
                                    spos, spos + ssize):
                                f.seek(tpos)
                                if tfcc == b"strh":
                                    strh = f.read(tsize)
                                elif tfcc == b"strf":
                                    strf = f.read(tsize)
                        elif sfcc == b"LIST:strl":
                            raise UnsupportedVideo("more than one stream")
                elif cfcc == b"LIST:movi":
                    self._frames(cpos, cpos + csize)
            pos += 8 + size + (size & 1)
        if strh is None or strf is None or len(strh) < 36 or len(strf) < 20:
            raise UnsupportedVideo("no video stream header")
        kind, handler = strh[:4], strh[4:8]
        scale, rate = struct.unpack("<II", strh[20:28])
        _, width, height, _, bits, comp = struct.unpack("<IiiHHI", strf[:20])
        comp = struct.pack("<I", comp)
        if kind != b"vids" or comp != FOURCC or bits != 32 or height <= 0:
            raise UnsupportedVideo(
                f"stream {kind!r}, compression {comp!r}, {bits} bits: only "
                "uncompressed RGBA (fourcc 'RGBA', 32 bits) is read")
        self.width, self.height = width, height
        self.fps = rate / scale if scale else 0.0
        self.fourcc = int.from_bytes(handler, "little")
        self.frame_bytes = width * height * 4

    def _chunks(self, start: int, stop: int):
        """(fourcc, data offset, size) of the chunks in [start, stop); a
        LIST's fourcc reads ``LIST:<kind>`` and its data starts after the
        kind."""
        f, pos = self._f, start
        while pos + 8 <= stop:
            f.seek(pos)
            fcc, size = struct.unpack("<4sI", f.read(8))
            if fcc == b"LIST":
                yield b"LIST:" + f.read(4), pos + 12, size - 4
            else:
                yield fcc, pos + 8, size
            pos += 8 + size + (size & 1)

    def _frames(self, start: int, stop: int) -> None:
        for fcc, pos, size in self._chunks(start, stop):
            if fcc == b"LIST:rec ":
                self._frames(pos, pos + size)
            elif fcc[2:] in (b"dc", b"db") and fcc[:2] == b"00":
                self.offsets.append(pos)
            elif fcc[2:] == b"wb":
                raise UnsupportedVideo("the file has an audio stream")

    @property
    def frame_count(self) -> int:
        return len(self.offsets)

    def seek(self, index: int) -> None:
        """The next ``read`` returns frame `index`."""
        self.pos = index

    def read(self) -> tuple[bool, np.ndarray | None]:
        """(True, the next BGR frame), or (False, None) past the end."""
        if not 0 <= self.pos < len(self.offsets):
            return False, None
        self._f.seek(self.offsets[self.pos])
        data = self._f.read(self.frame_bytes)
        if len(data) != self.frame_bytes:
            return False, None
        self.pos += 1
        rgba = np.frombuffer(data, np.uint8).reshape(self.height, self.width,
                                                     4)
        return True, np.ascontiguousarray(rgba[..., 2::-1])

    def release(self) -> None:
        self._f.close()


class VideoWriter:
    """Writes BGR uint8 (H, W, 3) frames as an RGBA AVI at `fps` (see the
    module docstring); ``release`` completes the headers and indexes."""

    def __init__(self, path: str, fps: float, size: tuple[int, int],
                 riff_bytes: int = RIFF_BYTES):
        self.width, self.height = size
        self.fps = Fraction(fps or 25.0).limit_denominator(1 << 16)
        self.frame_bytes = self.width * self.height * 4
        self.riff_bytes = riff_bytes
        self._f = open(path, "wb")
        self._parts: list[tuple[int, int, list[int]]] = []
        self._super: list[tuple[int, int, int]] = []
        self._rgba = np.empty((self.height, self.width, 4), np.uint8)
        self._rgba[..., 3] = 255
        self._f.write(struct.pack("<4sI4s", b"RIFF", 0, b"AVI ")
                      + self._headers())
        self._open_part(b"AVI ")

    def _headers(self) -> bytes:
        """The hdrl LIST: avih, strl (strh, strf, indx) and odml (dmlh),
        of a fixed length, so that release() can write it again."""
        frames = sum(len(p[2]) for p in self._parts)
        first = len(self._parts[0][2]) if self._parts else 0
        fps = self.fps
        avih = struct.pack(
            "<14I", round(1e6 / fps),
            min(int(self.frame_bytes * fps), 0xFFFFFFFF), 0, _AVIF,
            first, 0, 1, self.frame_bytes, self.width, self.height, 0, 0, 0,
            0)
        strh = b"vids" + FOURCC + struct.pack(
            "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, fps.denominator, fps.numerator,
            0, frames, self.frame_bytes, 0xFFFFFFFF, 0, 0, 0, self.width,
            self.height)
        strf = struct.pack("<IiiHH4sIiiII", 40, self.width, self.height, 1,
                           32, FOURCC, self.frame_bytes, 0, 0, 0, 0)
        indx = struct.pack("<HBBI4s3I", 4, 0, 0, len(self._super), b"00dc",
                           0, 0, 0)
        indx += b"".join(struct.pack("<QII", *e) for e in self._super)
        indx += b"\0" * (16 * (SUPER_ENTRIES - len(self._super)))
        strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)
                     + _chunk(b"indx", indx))
        odml = _list(b"odml", _chunk(b"dmlh", struct.pack("<I", frames)
                                     + b"\0" * 244))
        return _list(b"hdrl", _chunk(b"avih", avih) + strl + odml)

    def _open_part(self, kind: bytes) -> None:
        """Start a RIFF part (the first, 'AVI ', is already open) and its
        movi LIST; records (RIFF offset, movi offset, frame offsets)."""
        f = self._f
        riff = 0 if kind == b"AVI " else f.tell()
        if kind != b"AVI ":
            f.write(struct.pack("<4sI4s", b"RIFF", 0, kind))
        movi = f.tell()
        f.write(struct.pack("<4sI4s", b"LIST", 0, b"movi"))
        self._parts.append((riff, movi, []))

    def _close_part(self) -> None:
        """Index the open part (ix00, and idx1 in the first) and write its
        sizes."""
        f = self._f
        riff, movi, frames = self._parts[-1]
        base = movi + 8
        entries = b"".join(struct.pack("<II", o + 8 - base, self.frame_bytes)
                           for o in frames)
        ix = struct.pack("<HBBI4sQI", 2, 0, 1, len(frames), b"00dc", base,
                         0) + entries
        self._super.append((f.tell(), 8 + len(ix), len(frames)))
        f.write(_chunk(b"ix00", ix))
        end = f.tell()
        f.seek(movi + 4)
        f.write(struct.pack("<I", end - movi - 8))
        f.seek(end)
        if riff == 0:
            f.write(_chunk(b"idx1", b"".join(
                struct.pack("<4sIII", b"00dc", _KEYFRAME, o - base,
                            self.frame_bytes) for o in frames)))
            end = f.tell()
        f.seek(riff + 4)
        f.write(struct.pack("<I", end - riff - 8))
        f.seek(end)

    def write(self, frame_bgr: np.ndarray) -> None:
        """Append one BGR uint8 (H, W, 3) frame."""
        self._check(frame_bgr, 3)
        self._rgba[..., :3] = frame_bgr[..., ::-1]
        self.write_rgba(self._rgba)

    def write_rgba(self, frame_rgba: np.ndarray) -> None:
        """Append one frame given as its RGBA uint8 (H, W, 4) bytes (A is
        written as given)."""
        self._check(frame_rgba, 4)
        f = self._f
        riff = self._parts[-1][0]
        if f.tell() + 8 + self.frame_bytes - riff > self.riff_bytes and \
                self._parts[-1][2]:
            if len(self._parts) >= SUPER_ENTRIES:
                raise ValueError(
                    f"the AVI is full: its super index holds {SUPER_ENTRIES} "
                    f"parts of {self.riff_bytes} bytes")
            self._close_part()
            self._open_part(b"AVIX")
        self._parts[-1][2].append(f.tell())
        f.write(struct.pack("<4sI", b"00dc", self.frame_bytes))
        f.write(np.ascontiguousarray(frame_rgba).data)

    def _check(self, frame: np.ndarray, channels: int) -> None:
        if frame.shape != (self.height, self.width, channels) or \
                frame.dtype != np.uint8:
            raise ValueError(f"expected a uint8 ({self.height}, "
                             f"{self.width}, {channels}) frame, got "
                             f"{frame.dtype} {frame.shape}")

    def release(self) -> None:
        if self._f.closed:
            return
        self._close_part()
        self._f.seek(12)
        self._f.write(self._headers())
        self._f.close()
