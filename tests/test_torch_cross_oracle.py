"""The port's cross-oracle eval (denoise_gan_tpu_torch/tools/
cross_oracle_eval.py) and its TensorFlow bicubic (ops/image.py::
resize_bicubic_tf) on the CPU.

- resize_bicubic_tf against ``tf.image.resize(method="bicubic")`` at
  256 -> 64, 256 -> 128, odd sizes and upscales: f32 within 1e-6; after
  round(x * 255), at most 1e-4 of the bytes apart, by at most 1 (ties).
- The tool against the JAX repository's tools/cross_oracle_eval.py, run as
  a subprocess through TOOL_LAUNCHER (which makes it import the JAX
  package and its helper tools from this checkout), on one seeded FSRGAN
  export (the JAX package's exporter, weights drawn as tests/
  serving_files.py draws them) and a 4-image val corpus (the port's synthetic images) at q = 50: the same header, and
  every row's PSNR within 0.05 dB and SSIM within 1e-3 (the CLI bounds of
  PERF.md section 2).  The port's half runs in a child process (tests/
  torch_process.py, tests/torch_side_codec.py), started with the JAX
  tool.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()
tf = pytest.importorskip("tensorflow")

from denoise_gan_tpu.data import native as jnative  # noqa: E402
from denoise_gan_tpu.io import checkpoint as jck  # noqa: E402
from denoise_gan_tpu_torch.tools import quality_table as tq  # noqa: E402

import serving_files as sf  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
RESIZES = ((256, 256, 64, 64), (256, 256, 128, 128), (37, 53, 17, 29),
           (288, 288, 72, 72), (64, 48, 256, 200), (13, 7, 40, 3))
F32_TOL = 1e-6
U8_SHARE = 1e-4
PSNR_TOL, SSIM_TOL = 0.05, 1e-3
Q = 50
N_VAL = 4
JAX_TOOL_S = 600
# The JAX tool and tools/h2h_tf_reference.py put a fixed repository path
# first on sys.path when they run.  The launcher imports the modules they
# use from this checkout first, so that the tool finds them in
# sys.modules and reads no file outside the checkout.
TOOL_LAUNCHER = """
import importlib, os, runpy, sys
repo = os.path.realpath(sys.argv[1])
path = [repo, os.path.join(repo, "tools")] + sys.path
for name in ("denoise_gan_tpu.data.native", "denoise_gan_tpu.infer.image",
             "quality_table", "h2h_tf_reference"):
    sys.path[:] = path     # each tool module prepends a fixed path
    mod = importlib.import_module(name)
    assert os.path.realpath(mod.__file__).startswith(repo + os.sep), (
        mod.__file__)
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_codec") as call:
        yield call


@pytest.mark.parametrize("shape", RESIZES,
                         ids=["x".join(map(str, s)) for s in RESIZES])
def test_resize_bicubic_tf_matches_tensorflow(port, shape):
    hi, wi, ho, wo = shape
    x = np.random.default_rng(hi * wi).random((2, hi, wi, 3),
                                              dtype=np.float32)
    want = tf.image.resize(tf.constant(x), [ho, wo],
                           method="bicubic").numpy()
    got = port("resize_tf", x, ho, wo)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= F32_TOL
    u8 = [np.round(a * 255.0) for a in (got, want)]
    apart = u8[0] != u8[1]
    assert apart.mean() <= U8_SHARE
    assert np.abs(u8[0] - u8[1]).max(initial=0) <= 1


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A seeded FSRGAN export and a corpus root whose val split holds 4
    of the port's synthetic images."""
    root = tmp_path_factory.mktemp("cross_oracle")
    rng = np.random.default_rng(3)
    params, stats = (sf.draw(t, rng) for t in sf.shapes("fsrgan"))
    model = str(root / "fsrgan.dgt")
    jck.export_generator(model, "fsrgan", 4, params, stats)
    val = root / "qdata" / "val" / "imgs"
    val.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for i in range(N_VAL):
        np.save(val / f"im{i:04d}.npy", tq.synth_image(rng))
    return model, str(root / "qdata")


def _rows(lines):
    """{(oracle, q): (model PSNR, model SSIM, input PSNR, input SSIM)} of
    the table's rows."""
    out = {}
    for line in lines:
        m = re.match(r"\| (libjpeg|dct-dev) \| (\d+) \| ([-\d.]+) / "
                     r"([-\d.]+) \| ([-\d.]+) / ([-\d.]+) \|", line)
        if m:
            out[(m.group(1), int(m.group(2)))] = tuple(
                float(v) for v in m.groups()[2:])
    return out


def test_tool_matches_jax_tool(port, files):
    if not jnative.available():
        pytest.skip("the JAX binding's libjpeg codec is unavailable")
    assert Path(jnative.__file__).resolve().is_relative_to(REPO)
    model, data_root = files
    argv = ["--model", model, "--data_root", data_root, "--qs", str(Q)]
    started = port.submit("cross_oracle", argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu", TF_CPP_MIN_LOG_LEVEL="3",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run(
        [sys.executable, "-c", TOOL_LAUNCHER, str(REPO),
         str(REPO / "tools" / "cross_oracle_eval.py"), *argv],
        capture_output=True, text=True, env=env, timeout=JAX_TOOL_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want_lines = [x for x in proc.stdout.splitlines()
                  if x.startswith(("model:", "|"))]
    got_lines = [x for x in started.result(JAX_TOOL_S)
                 if x.startswith(("model:", "|"))]
    assert got_lines[:3] == want_lines[:3]
    got, want = _rows(got_lines), _rows(want_lines)
    assert set(got) == set(want) == {("libjpeg", Q), ("dct-dev", Q)}
    for key, w in want.items():
        g = got[key]
        assert abs(g[0] - w[0]) <= PSNR_TOL and abs(g[2] - w[2]) <= PSNR_TOL
        assert abs(g[1] - w[1]) <= SSIM_TOL and abs(g[3] - w[3]) <= SSIM_TOL


def test_tool_imports_nothing_the_card_lacks():
    """No jax, no JAX package, no root tools/, cv2, PIL or TensorFlow."""
    text = (REPO / "denoise_gan_tpu_torch" / "tools" / "cross_oracle_eval.py"
            ).read_text()
    mods = re.findall(r"^\s*(?:from|import) ([\w.]+)", text, re.M)
    bad = [m for m in mods if m.split(".")[0] in (
        "jax", "flax", "denoise_gan_tpu", "tools", "cv2", "PIL",
        "tensorflow", "keras")]
    assert mods and not bad, bad
