"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package, one process per
source, all started together, and links the objects into one shared library
with a plain C interface, at first use, into ``_build/`` beside this
package's sources (ignored by git).  The library's name carries a hash of the
sources and flags, so an edit rebuilds it.  It is loaded with ctypes; each C
entry point returns the launch's ``cudaGetLastError()``.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the C entry points and their argument types: every tail kernel takes
# (h, out, w1, b1, a1, w2, b2, a2, w3, b3, s1, s2, s3, inv_su1, inv_sr,
#  mode, canvas, n_tiles, nx, core_rows, height, width, bgr, stream)
_TAIL_ARGS = ([ctypes.c_void_p] * 13 + [ctypes.c_float] * 2
              + [ctypes.c_int] * 8 + [ctypes.c_void_p])
# the inverted residual takes (x, out, we, be, wd, bd, wp, bp, n, h, w,
# e_dim, residual, stream)
_MBCONV_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# the probes (probes/): K9's FMA chain takes (x, out, n, iters, c1, c2,
# stream) and its roll + FMA chain (x, out, rows, iters, c1, stream);
# K6's dot chain (wt, y, k, m, iters, int8, stream); K8's product
# (x, w, y, parts, acc, m, k, n, sublane, reps, splits, stream) and
# transpose chain (x, out, rows, cols, iters, c, stream); K10's u8 store
# (res, out, bands, stream); K7's overlap chains (w, y, z, iters, mma, vpu,
# c1, c2, stream); K4's depthwise chain (e, w, d, nch, reps, form, cu,
# stream)
_PROBE_FMA_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int] \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]
_PROBE_ROLL_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
    + [ctypes.c_float, ctypes.c_void_p]
_PROBE_DOT_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
_PROBE_MM_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]
_PROBE_TRANSPOSE_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
    + [ctypes.c_float, ctypes.c_void_p]
_PROBE_U8_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
_PROBE_OVERLAP_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]
_PROBE_DW_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
    + [ctypes.c_float, ctypes.c_void_p]
ENTRY_POINTS = {"dgt_tail": _TAIL_ARGS, "dgt_tail64": _TAIL_ARGS,
                "dgt_mbconv": _MBCONV_ARGS,
                "dgt_probe_fma": _PROBE_FMA_ARGS,
                "dgt_probe_roll_fma": _PROBE_ROLL_ARGS,
                "dgt_probe_dot_chain": _PROBE_DOT_ARGS,
                "dgt_probe_matmul_form": _PROBE_MM_ARGS,
                "dgt_probe_transpose_chain": _PROBE_TRANSPOSE_ARGS,
                "dgt_probe_u8_store": _PROBE_U8_ARGS,
                "dgt_probe_overlap": _PROBE_OVERLAP_ARGS,
                "dgt_probe_dw": _PROBE_DW_ARGS}

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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; their joined output, or RuntimeError with
    the output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode:
            raise RuntimeError(f"{' '.join(cmd)} failed with code "
                               f"{p.returncode}:\n{out}")
    return "".join(outs)


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
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(sources, objs)])
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_log = log
    os.replace(tmp, lib)
    return lib


def sass_functions() -> dict[str, str]:
    """Each kernel's SASS in the built library, by mangled name, from
    cuobjdump beside nvcc; {} where the toolkit has none."""
    tool = Path(find_nvcc()).parent / "cuobjdump"
    if not os.access(tool, os.X_OK):
        return {}
    sass = subprocess.run([str(tool), "-sass", str(build_library())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return dict(block.split("\n", 1)
                for block in sass.split("Function : ")[1:])


def load_library() -> ctypes.CDLL:
    """The kernels' library, built if needed, with its argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _lib = lib
    return _lib
