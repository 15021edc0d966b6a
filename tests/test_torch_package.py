"""The PyTorch port stands alone: no module of denoise_gan_tpu_torch, nor
chip_smoke.py, the root launchers of the port's CLIs (*_torch.py) or the
tests' torch-side helpers, imports jax, flax or the JAX package; the
Keras interop and the profiler (io/hdf5.py, io/keras_h5.py,
tools/export_h5.py, tools/profile_engine.py) import neither h5py,
TensorFlow, Keras nor a script of the root tools/; and the package runs
with jax, flax, msgpack, cv2, h5py, TensorFlow and Keras unimportable, as
on the machine with the card: a .dgt export written and read back, and
exported to the reference's .h5 and read back, and the video CLI on an
RGBA AVI through the kernel engine; the trainers' modules and launchers
import there too."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_process import skip_without_torch

skip_without_torch()

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "denoise_gan_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "denoise_gan_tpu")
# the modules that read and write Keras files and profile the engines
INTEROP = [PKG / "io" / "hdf5.py", PKG / "io" / "keras_h5.py",
           PKG / "tools" / "export_h5.py", PKG / "tools" / "profile_engine.py"]
INTEROP_FORBIDDEN = FORBIDDEN + ("h5py", "tensorflow", "keras", "tools") + \
    tuple(sorted(p.stem for p in (REPO / "tools").glob("*.py")))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources():
    """The package, chip_smoke.py, and the test helpers that run the port's
    side of the tests (they must import on a machine without jax)."""
    return sorted(PKG.rglob("*.py")) + sorted(REPO.glob("*_torch.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "torch_process.py",
        REPO / "tests" / "torch_side.py",
        REPO / "tests" / "torch_side_serving.py",
        REPO / "tests" / "torch_side_training.py",
        REPO / "tests" / "torch_side_parallel.py",
        REPO / "tests" / "torch_side_keras_h5.py",
        REPO / "tests" / "torch_side_quality.py",
        REPO / "tests" / "torch_side_export_h5.py",
        REPO / "tests" / "torch_side_codec.py",
        REPO / "tests" / "torch_side_natural.py",
        REPO / "tests" / "codec_seeds.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN and
           not m.startswith("denoise_gan_tpu_torch")]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", INTEROP,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_interop_imports_nothing_foreign(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in INTEROP_FORBIDDEN and
           not m.startswith("denoise_gan_tpu_torch")]
    assert not bad, f"{path} imports {bad}"


def test_package_runs_without_jax(tmp_path):
    """Import every module, run the tail twin on the CPU and load the
    reference's Keras .h5 in a process where ``import jax`` and ``import
    h5py`` fail."""
    code = """
import sys
for name in ("jax", "flax", "jaxlib", "denoise_gan_tpu", "msgpack", "cv2",
             "h5py", "tensorflow", "keras"):
    sys.modules[name] = None
import importlib, pkgutil
import numpy as np
import torch
import denoise_gan_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
for name in ("infer_torch", "infer_video_torch", "unit_test_torch",
             "train_autoencoder_torch", "train_pix2pix_torch",
             "train_srgan_torch", "train_fsrgan_torch"):
    importlib.import_module(name)
from denoise_gan_tpu_torch.models import build_generator
from denoise_gan_tpu_torch.infer.kernel_engine import build_fsrgan_kernel_engine
model = build_generator("fsrgan", device="cpu",
                        generator=torch.Generator().manual_seed(0))
out = build_fsrgan_kernel_engine(model, 20, 30, brc=24)(torch.rand(20, 30, 3))
assert out.shape == (80, 120, 3) and out.dtype == torch.uint8
from denoise_gan_tpu_torch.io import avi
from denoise_gan_tpu_torch.io.checkpoint import export_generator
from denoise_gan_tpu_torch.infer import video
export_generator("m.dgt", "fsrgan", 4, model)
vw = avi.VideoWriter("in.avi", 25, (30, 20))
for i in range(3):
    vw.write(np.full((20, 30, 3), 40 * i, np.uint8))
vw.release()
for score in ("0", "1"):
    r = video.main(["--input_video", "in.avi", "--output_video", "out.avi",
                    "--model", "m.dgt", "--device", "cpu", "--score", score,
                    "--kernel_tail", "1"])
    assert r["frames"] == avi.VideoReader("out.avi").frame_count == 3
from denoise_gan_tpu_torch.io.checkpoint import load_generator
config, _ = load_generator(H5, device="cpu")
assert config["family"] == "fsrgan" and config["source"] == "keras_h5"
from denoise_gan_tpu_torch.tools import export_h5
from denoise_gan_tpu_torch.io import flax_msgpack
from denoise_gan_tpu_torch.io.params import to_jax_trees
assert export_h5.main(["--dgt", "m.dgt", "--out", "m.h5"]) == 0
config, back = load_generator("m.h5", device="cpu")
assert (config["family"], config["scale"]) == ("fsrgan", 4)
assert flax_msgpack.dumps(dict(zip("ps", to_jax_trees(back)))) == \
    flax_msgpack.dumps(dict(zip("ps", to_jax_trees(model))))
assert not any(m.split(".")[0] in ("jax", "flax", "h5py", "tensorflow",
                                   "keras")
               and sys.modules[m] is not None for m in sys.modules)
print("ok")
"""
    code = code.replace("H5", repr(str(REPO / "tests" / "data" /
                                       "fsrgan_ref.h5")))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")

