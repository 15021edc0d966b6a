"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package into one shared
library with a plain C interface, at first use, into ``_build/`` beside
this package's sources (ignored by git).  The library's name carries a hash
of the sources and flags, so an edit rebuilds it.  It is loaded with
ctypes; each C entry point returns the launch's ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

DEFAULT_CUDA_HOME = "/usr/local/cuda"

_lib: ctypes.CDLL | None = None
build_log = ""      # ptxas report of the last build made in this process


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then DEFAULT_CUDA_HOME; raises
    RuntimeError when there is none."""
    home = os.environ.get("CUDA_HOME")
    cands = [str(Path(home) / "bin" / "nvcc") if home else None,
             shutil.which("nvcc"), str(Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc")]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found ($CUDA_HOME, $PATH, "
                       f"{DEFAULT_CUDA_HOME}): the CUDA kernels cannot be "
                       "built")


def build_library() -> Path:
    """Compile csrc/*.cu unless a library of the same sources exists."""
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libdgt_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, sources)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    build_log = proc.stdout + proc.stderr
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' library, built if needed, with its argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dgt_tail_u8.argtypes = [vp] * 12 + [f, f] + [i] * 7 + [vp]
        lib.dgt_tail_u8.restype = i
        _lib = lib
    return _lib
