"""The PyTorch half of tests/test_torch_keras_h5.py: the port's HDF5 reader
(denoise_gan_tpu_torch/io/hdf5.py), its Keras ``.h5`` loading
(io/keras_h5.py, io/checkpoint.py) and the CLIs on a ``.h5``.

tests/torch_process.py runs these functions in a child process
(``torch_process("torch_side_keras_h5")``).  Arguments and results are
numpy arrays and plain Python values; large arrays come back as sha256
digests of their float32 bytes.  This module imports neither h5py nor
JAX, so that the child shows what the port itself imports.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import sys

import numpy as np
import torch

from denoise_gan_tpu_torch.infer import image as timage_cli
from denoise_gan_tpu_torch.io import checkpoint as tck
from denoise_gan_tpu_torch.io import flax_msgpack, hdf5, keras_h5
from denoise_gan_tpu_torch.io.params import to_jax_trees

FOREIGN = ("h5py", "jax", "jaxlib", "flax", "tensorflow", "keras")


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()
                          ).hexdigest()


def tree_digests(tree: dict, prefix: str = "") -> dict[str, tuple]:
    """{path: (shape, digest)} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_digests(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(np.shape(v)), digest(v))
    return out


def portable(value):
    """A value as (type, dtype, shape, bytes) where it is a numpy array or
    scalar of fixed-size elements (the pipe to the parent does not keep a
    big-endian dtype), else as it is."""
    if isinstance(value, (np.ndarray, np.generic)) and \
            value.dtype != object:
        return (type(value).__name__, value.dtype.str, value.shape,
                value.tobytes())
    return value


def read_tree(path: str) -> dict:
    """{path: ("group", attrs) or ("dataset", attrs, array)} of every
    object of the file, read by io/hdf5.py, values ``portable``."""
    out = {}

    def walk(group, prefix):
        attrs = {k: portable(v) for k, v in group.attrs.items()}
        out[prefix or "/"] = ("group", attrs)
        for name in group.keys():
            node, p = group[name], f"{prefix}/{name}"
            if isinstance(node, hdf5.Group):
                walk(node, p)
            else:
                out[p] = ("dataset", {k: portable(v) for k, v in
                                      node.attrs.items()},
                          portable(node[()]))

    walk(hdf5.File(path), "")
    return out


def refusals(paths: list[str]) -> list[str | None]:
    """The ValueError message of opening each file (None: it opened)."""
    out = []
    for p in paths:
        try:
            hdf5.File(p)
            out.append(None)
        except ValueError as exc:
            out.append(str(exc))
    return out


def streams(paths: list[str]) -> dict:
    """Per file: the weight stream's kinds, each array's (shape, digest),
    and infer_family_role's answer (or the error's text)."""
    out = {}
    for p in paths:
        records = keras_h5.h5_weight_stream(p)
        try:
            role = keras_h5.infer_family_role(records)
        except ValueError as exc:
            role = str(exc)
        out[p] = {"kinds": [k for k, _ in records],
                  "arrays": [[(a.shape, digest(a)) for a in arrays]
                             for _, arrays in records],
                  "role": role}
    return out


def read_exports(paths: list[str]) -> dict:
    """Per file: io/checkpoint.py::read_export's config and the digests of
    its payload's trees."""
    out = {}
    for p in paths:
        config, payload = tck.read_export(p)
        trees = flax_msgpack.loads(payload)
        out[p] = (config, tree_digests(trees["params"]),
                  tree_digests(trees["batch_stats"]))
    return out


def load_generators(cases: dict) -> dict:
    """Per file (path -> NHWC input): io/checkpoint.py::load_generator on
    the CPU: its config, the digests of to_jax_trees of the generator, and
    its f32 output on the input."""
    out = {}
    for p, x in cases.items():
        with contextlib.redirect_stdout(io.StringIO()):
            config, model = tck.load_generator(p, device="cpu")
        params, stats = to_jax_trees(model)
        with torch.no_grad():
            y = model(torch.from_numpy(x)).numpy()
        out[p] = (config, tree_digests(params), tree_digests(stats), y)
    return out


def convert_and_infer(h5: str, dgt: str, image_dir: str, out_h5: str,
                      out_dgt: str) -> dict:
    """The converter CLI (``python3 -m denoise_gan_tpu_torch.io.keras_h5``'s
    main) from `h5` to `dgt`, then the image CLI (infer_torch.py's main,
    ``--device cpu``) on `image_dir` with each model; the modules of JAX,
    h5py, TensorFlow, flax or Keras this process then holds."""
    with contextlib.redirect_stdout(io.StringIO()) as log:
        rc = keras_h5.main(["--h5", h5, "--out", dgt])
        for model, out in ((h5, out_h5), (dgt, out_dgt)):
            timage_cli.main(["--model", model, "--device", "cpu",
                             "--image_dir", image_dir, "--output_dir", out])
    return {"rc": rc, "log": log.getvalue(),
            "foreign": sorted(m for m in sys.modules
                              if m.split(".")[0] in FOREIGN)}


def cuda_h5_engines_vs_dgt(h5: str, dgt: str, height: int, width: int,
                           brc: int, frames: list) -> dict:
    """On the card: the FSRGAN kernel engine (w8a8, calibrated on frame 0;
    plain body, then the K3 body) built from the `.h5` and from the port
    converter's `.dgt` of it, on each frame: whether their bytes are
    equal, and each engine's launch counts."""
    from denoise_gan_tpu_torch.infer import kernel_engine as tke
    from denoise_gan_tpu_torch.ops import mbconv, tail
    with contextlib.redirect_stdout(io.StringIO()):
        keras_h5.main(["--h5", h5, "--out", dgt])
    x = [torch.from_numpy(f).cuda() for f in frames]
    out = {}
    for name, path in (("h5", h5), ("dgt", dgt)):
        with contextlib.redirect_stdout(io.StringIO()):
            _, model = tck.load_generator(path)
        plain = tke.build_fsrgan_kernel_engine(model, height, width, brc=brc,
                                               q8_calib_frame=x[0])
        body, tw, k3_brc = tke.prepare_mbconv_fsrgan_engine(
            model, height, width, brc=brc, q8_calib_frame=x[0])
        k3 = tke.build_kernel_engine(body, tw, height, width, brc=k3_brc)
        for engine, key in ((plain, "plain"), (k3, "k3")):
            before = {**tail.launch_counts, **mbconv.launch_counts}
            frames_out = [engine(f).cpu().numpy() for f in x]
            torch.cuda.synchronize()
            after = {**tail.launch_counts, **mbconv.launch_counts}
            out[f"{name}-{key}"] = (frames_out, {
                k: after[k] - before[k] for k in after
                if after[k] != before[k]})
    return {key: {"equal": all(np.array_equal(a, b) for a, b in zip(
        out[f"h5-{key}"][0], out[f"dgt-{key}"][0])),
        "shape": out[f"h5-{key}"][0][0].shape,
        "std": float(out[f"h5-{key}"][0][0].std()),
        "launches": (out[f"h5-{key}"][1], out[f"dgt-{key}"][1])}
        for key in ("plain", "k3")}
