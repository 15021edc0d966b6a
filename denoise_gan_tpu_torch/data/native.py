"""The port's image codec: JPEG and PNG read and written, and libjpeg's
exact encode + decode round trip, from the package's own C++
(``native/imgcodec.cpp``, the standard library only) and Python
(``data/png.py``: PNG's chunks, CRCs, inflate and deflate by ``zlib``).
No libjpeg, libpng, cv2 or PIL: one codec on every machine.  The API is
the JAX package's binding (denoise_gan_tpu/data/native.py), whose libjpeg
and libpng results it gives byte for byte, plus :func:`encode`.

Read: baseline, extended and progressive JPEG, Huffman or arithmetic
coded (gray or YCbCr/RGB, any integral sampling), every PNG colour type and
depth, Adam7 included; a cut or corrupt file as libjpeg or libpng reads it
where they only warn.  Refused (None) where they refuse it too: lossless,
12-bit, CMYK/YCCK and other 2- or 4-component JPEG, files cut in their
headers, a bad CRC on a critical PNG chunk (see the source's header and
data/png.py).

The library is compiled at first use (``g++ -std=c++17 -O3 -shared -fPIC``,
no ``-l`` flag) into the package's ``_build/`` (ignored by git), under a
name that carries the source's hash, through a temporary file renamed into
place, so that processes building at once do not collide.  Where g++ is
missing :func:`available` is False and :data:`build_error` says so; where
g++ fails, the first call raises a RuntimeError with the compiler's
message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from denoise_gan_tpu_torch.data import png

SRC = Path(__file__).resolve().parents[1] / "native" / "imgcodec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
COMPILER = "g++"
FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]
JPEG_SUFFIXES = (".jpg", ".jpeg")
JPEG_SOI = b"\xff\xd8\xff"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
build_error = ""     # why the codec is unavailable (no compiler)


def library_path() -> Path:
    """Where the library of the current source is (or will be) built."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libimgcodec_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the codec unless a library of the same source exists; its
    path.  Raises FileNotFoundError without g++, RuntimeError (the
    compiler's message) where it fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        done = subprocess.run([COMPILER, *FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"the image codec did not build ({SRC}): "
                               f"{done.stderr.strip()}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _tried, build_error
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        if shutil.which(COMPILER) is None and not library_path().exists():
            build_error = f"{COMPILER} not found"
            _tried = True
            return None
        lib = ctypes.CDLL(str(build()))
        lib.dg_decode.restype = ctypes.c_int
        lib.dg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.dg_jpeg_roundtrip.restype = ctypes.c_int
        lib.dg_jpeg_roundtrip.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.dg_jpeg_encode.restype = ctypes.c_int
        lib.dg_jpeg_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t)]
        lib.dg_free.restype = None
        lib.dg_free.argtypes = [ctypes.c_void_p]
        lib.dg_png_unfilter.restype = ctypes.c_int
        lib.dg_png_unfilter.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
        _tried = True
    return _lib


def available() -> bool:
    """Whether the codec is built and loaded (building it at first call)."""
    return _load() is not None


def _unfilter(lib: ctypes.CDLL) -> png.Unfilter:
    def unfilter(raw: bytearray, w: int, h: int, depth: int, channels: int,
                 interlace: int) -> np.ndarray | None:
        buf = np.frombuffer(raw, np.uint8)
        out = np.empty((h, w, channels), np.uint8)
        rc = lib.dg_png_unfilter(buf.ctypes.data, buf.size, w, h, depth,
                                 channels, interlace, out.ctypes.data)
        return out if rc == 0 else None
    return unfilter


def decode(path: str) -> np.ndarray | None:
    """A JPEG or PNG file as RGB uint8 (H, W, 3); None where the codec is
    unavailable, the file is neither, or the codec refuses it."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(png.SIGNATURE):
        return png.decode(data, _unfilter(lib))
    buf, h, w = ctypes.c_void_p(), ctypes.c_int(), ctypes.c_int()
    if lib.dg_decode(data, len(data), ctypes.byref(buf), ctypes.byref(h),
                     ctypes.byref(w)) != 0:
        return None
    try:
        out = np.empty((h.value, w.value, 3), np.uint8)
        ctypes.memmove(out.ctypes.data, buf, out.nbytes)
    finally:
        lib.dg_free(buf)
    return out


def is_jpeg_or_png(path: str) -> bool:
    """Whether the file starts as a JPEG (FF D8 FF) or a PNG does: the
    formats the codec reads, and which no other decoder is given."""
    with open(path, "rb") as f:
        head = f.read(len(png.SIGNATURE))
    return head.startswith(JPEG_SOI) or head == png.SIGNATURE


def _rgb(rgb: np.ndarray) -> np.ndarray:
    """`rgb` as a contiguous (H, W, 3) uint8 array, or a ValueError."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or 0 in rgb.shape:
        raise ValueError(f"an RGB image is (H, W, 3), not {rgb.shape}")
    return rgb


def jpeg_roundtrip_u8(rgb: np.ndarray, quality: int) -> np.ndarray | None:
    """RGB uint8 through libjpeg's encoder at `quality` (jpeg_set_defaults:
    4:2:0) and its decoder, byte for byte; None where the codec is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    rgb = _rgb(rgb)
    h, w = rgb.shape[:2]
    out = np.empty_like(rgb)
    rc = lib.dg_jpeg_roundtrip(rgb.ctypes.data, h, w, int(quality),
                               out.ctypes.data)
    return out if rc == 0 else None


def encode(path: str, rgb_u8: np.ndarray, quality: int = 95) -> None:
    """Write RGB uint8 (H, W, 3) to `path`: ``.png`` lossless (8-bit RGB,
    filter 0, zlib); ``.jpg``/``.jpeg`` the file libjpeg writes at
    jpeg_set_defaults + jpeg_set_quality(quality, TRUE) (4:2:0, baseline,
    the standard Huffman tables, JFIF; at 95, cv2.imwrite's defaults and
    bytes).  Other suffixes raise a ValueError."""
    rgb = _rgb(rgb_u8)
    suffix = Path(path).suffix.lower()
    if suffix == ".png":
        data = png.encode(rgb)
    elif suffix in JPEG_SUFFIXES:
        lib = _load()
        if lib is None:
            raise RuntimeError(f"the image codec is unavailable: "
                               f"{build_error}")
        buf, n = ctypes.c_void_p(), ctypes.c_size_t()
        if lib.dg_jpeg_encode(rgb.ctypes.data, rgb.shape[0], rgb.shape[1],
                              int(quality), ctypes.byref(buf),
                              ctypes.byref(n)) != 0:
            raise ValueError(f"cannot encode a {rgb.shape} image as JPEG")
        try:
            data = ctypes.string_at(buf, n.value)
        finally:
            lib.dg_free(buf)
    else:
        raise ValueError(f"the image codec writes .png, .jpg and .jpeg, "
                         f"not {path}")
    with open(path, "wb") as f:
        f.write(data)
