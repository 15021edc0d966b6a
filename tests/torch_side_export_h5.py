"""The PyTorch half of tests/test_torch_export_h5.py: the port's
``.dgt`` -> Keras ``.h5`` export (denoise_gan_tpu_torch/tools/export_h5.py,
io/keras_h5.py's writer, io/hdf5.py's writer) and the engine profiler
(tools/profile_engine.py).

tests/torch_process.py runs these functions in a child process
(``torch_process("torch_side_export_h5")``).  Arguments and results are
numpy arrays and plain Python values; large arrays come back as sha256
digests of their float32 bytes.  This module imports neither h5py nor
JAX nor TensorFlow, so that the child shows what the port itself imports.
"""

from __future__ import annotations

import contextlib
import io
import sys

from denoise_gan_tpu_torch.io import flax_msgpack, hdf5, keras_h5
from denoise_gan_tpu_torch.io import checkpoint as tck
from denoise_gan_tpu_torch.tools import export_h5, profile_engine
from torch_side_keras_h5 import FOREIGN, tree_digests


def export_all(cases: dict) -> dict:
    """Per name, (dgt, out): export_h5's CLI main on the export; its exit
    code and output line."""
    out = {}
    for name, (dgt, h5) in cases.items():
        with contextlib.redirect_stdout(io.StringIO()) as log:
            rc = export_h5.main(["--dgt", dgt, "--out", h5])
        out[name] = (rc, log.getvalue().strip())
    return out


def read_back(paths: dict) -> dict:
    """Per name, io/checkpoint.py::read_export of the file (a .h5 goes
    through the port's converter): its config and its trees' digests."""
    out = {}
    for name, path in paths.items():
        with contextlib.redirect_stdout(io.StringIO()):
            config, payload = tck.read_export(path)
        trees = flax_msgpack.loads(payload)
        out[name] = (config, tree_digests(trees["params"]),
                     tree_digests(trees["batch_stats"]))
    return out


def refusal(dgt: str, out: str) -> str | None:
    """export_h5's ValueError on the export (None: it wrote the file)."""
    try:
        export_h5.export_h5(dgt, out)
    except ValueError as exc:
        return str(exc)
    return None


def split_names(path: str, n: int) -> dict:
    """io/keras_h5.py's name list writer on `n` long layer names (past
    Keras' 64,512-byte limit: split as Keras splits it), written with
    io/hdf5.py; the port's reading of it (keras_h5.attr_list)."""
    names = [f"layer_{i:05d}_" + "x" * 40 for i in range(n)]
    root = hdf5.NewGroup()
    group = root.create_group("model_weights")
    keras_h5._names_attr(group, "layer_names", names)
    keras_h5._names_attr(group.create_group("g"), "weight_names", [])
    hdf5.write(path, root)
    f = hdf5.File(path)
    return {"names": names, "keys": list(group.attrs),
            "read": keras_h5.attr_list(f["model_weights"].attrs,
                                       "layer_names"),
            "empty": keras_h5.attr_list(f["model_weights/g"].attrs,
                                        "weight_names")}


def parse_trace_text(trace_dir: str, n_frames: int) -> str:
    """What profile_engine.parse_trace prints for the trace."""
    with contextlib.redirect_stdout(io.StringIO()) as log:
        profile_engine.parse_trace(trace_dir, n_frames)
    return log.getvalue()


def profile_cpu(height: int, width: int, n_frames: int) -> dict:
    """profile_engine's main on the CPU (FSRGAN w8a8) at a small frame:
    its exit code, its output, and the JAX, h5py, TensorFlow, flax or
    Keras modules this process then holds."""
    with contextlib.redirect_stdout(io.StringIO()) as log:
        rc = profile_engine.main(["fsrgan", "q8", str(n_frames), "--device",
                                  "cpu"], height=height, width=width)
    return {"rc": rc, "log": log.getvalue(),
            "foreign": sorted(m for m in sys.modules
                              if m.split(".")[0] in FOREIGN)}


def cuda_profile(height: int, width: int, n_frames: int) -> list:
    """On the card: profile_engine.profile of the FSRGAN w8a8 engine (the
    port's weights, seed 0): the trace's (name, ms, count) rows."""
    with contextlib.redirect_stdout(io.StringIO()):
        res = profile_engine.profile("fsrgan", "q8", n_frames,
                                     height=height, width=width)
    return [tuple(r) for r in res["rows"]]
