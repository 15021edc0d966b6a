"""ctypes binding of the native image codec (denoise_gan_tpu/data/
native.py): ``native/imgcodec.cpp``, libjpeg and libpng, decodes JPEG and
PNG files to RGB uint8 and runs an exact libjpeg encode + decode round
trip.

The source is read where the repository keeps it and never written; the
library is compiled at first use with the JAX binding's line (``g++ -O3
-shared -fPIC imgcodec.cpp -ljpeg -lpng``) into the port's ``_build/``
(ignored by git), under a name that carries the source's hash, through a
temporary file renamed into place, so that processes building at once do
not collide.  ``native/libimgcodec.so``, which the JAX binding rebuilds in
place, is not touched.  Where g++, libjpeg or libpng is missing the build
fails once, :func:`available` is False and the callers fall back (data/
pipeline.py::decode_image to cv2, then PIL), as the JAX binding's do;
:data:`build_error` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "imgcodec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O3", "-shared", "-fPIC"]
LIBS = ["-ljpeg", "-lpng"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
build_error = ""     # why the codec is unavailable, once a build failed


def library_path() -> Path:
    """Where the library of the current source is (or will be) built."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(FLAGS + LIBS).encode())
    return BUILD_DIR / f"libimgcodec_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the codec unless a library of the same source exists; its
    path.  Raises (FileNotFoundError, CalledProcessError) where it cannot
    be built."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), *LIBS, "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
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
        try:
            lib = ctypes.CDLL(str(build()))
            lib.dg_decode.restype = ctypes.c_int
            lib.dg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.dg_jpeg_roundtrip.restype = ctypes.c_int
            lib.dg_jpeg_roundtrip.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as exc:
            lines = (getattr(exc, "stderr", None) or str(exc)).splitlines()
            build_error = next((x for x in lines if "error" in x),
                               lines[-1] if lines else "").strip()
        _tried = True
    return _lib


def available() -> bool:
    """Whether the codec is built and loaded (building it at first call)."""
    return _load() is not None


def decode(path: str) -> np.ndarray | None:
    """A JPEG or PNG file as RGB uint8 (H, W, 3); None where the codec is
    unavailable or the file is neither."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.dg_decode(data, len(data), None, ctypes.byref(h),
                     ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.dg_decode(data, len(data), out.ctypes.data, ctypes.byref(h),
                     ctypes.byref(w)) != 0:
        return None
    return out


def jpeg_roundtrip_u8(rgb: np.ndarray, quality: int) -> np.ndarray | None:
    """RGB uint8 through libjpeg's encoder at `quality` and its decoder;
    None where the codec is unavailable or libjpeg refuses."""
    lib = _load()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    out = np.empty_like(rgb)
    rc = lib.dg_jpeg_roundtrip(rgb.ctypes.data, h, w, int(quality),
                               out.ctypes.data)
    return out if rc == 0 else None
