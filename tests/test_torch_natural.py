"""The port's natural-photo tools (denoise_gan_tpu_torch/tools/
train_natural.py, eval_natural.py) against the JAX repository's tools of
the same names on the CPU, and the package's copies of their images
(denoise_gan_tpu_torch/assets/, credited in its CREDITS.md):

- each of the 16 files byte-equal to the installed package's file the JAX
  tools read, its size and sha256 the ones CREDITS.md gives, and decoded
  by the port's codec as PIL's ``.convert("RGB")`` decodes it (as the JAX
  tools do);
- eval_natural's 25 crops (8 + 8 + 9) equal to the JAX tool's;
- train_natural build's tiles, 72 without the textures and 456 with them,
  equal to the JAX tool's by name and sha256 (the JAX build's np.save
  recorded: no tile is written);
- eval_natural against the JAX tool, run as a subprocess through tests/
  test_torch_cross_oracle.py::TOOL_LAUNCHER, on a seeded autoencoder
  export (hopper, q 10 and 50) and a seeded FSRGAN export (TensorFlow's
  bicubic; china, q 30): the same header and rows, every PSNR within
  0.05 dB and SSIM within 1e-3 (the CLI bounds of PERF.md section 2);
- train_natural train on four tiles: the JAX tool's lines and an export;
- neither tool imports what the card's machine lacks (jax, the JAX
  package, the root tools/, PIL, cv2, sklearn, matplotlib, TensorFlow).
The port runs in a child process (tests/torch_process.py, tests/
torch_side_natural.py), started before the JAX tools.
"""

import ast
import hashlib
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()
Image = pytest.importorskip("PIL.Image")
pytest.importorskip("tensorflow")

from denoise_gan_tpu.io import checkpoint as jck  # noqa: E402

import serving_files as sf  # noqa: E402
from test_torch_cross_oracle import TOOL_LAUNCHER  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "denoise_gan_tpu_torch" / "assets"
CREDITS = (ASSETS / "CREDITS.md").read_text()
PSNR_TOL, SSIM_TOL = 0.05, 1e-3
JAX_TOOL_S = 600
# (family, scale, eval_natural's flags)
EVALS = {"autoencoder": (1, ["--qs", "10,50", "--photos", "hopper"]),
         "fsrgan": (4, ["--qs", "30", "--photos", "china"])}


def _jax_tool(name: str):
    """tools/<name>.py of the JAX repository, loaded from this checkout;
    sys.path as it was (the tool prepends a fixed repository path)."""
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


JTRAIN = _jax_tool("train_natural")
JEVAL = _jax_tool("eval_natural")
# each asset and the installed file the JAX tools read
SOURCES = {ASSETS / "photos" / Path(p).name: Path(p)
           for _, p in JEVAL.PHOTO_PATHS}
SOURCES.update({ASSETS / "textures" / Path(p).name: Path(p)
                for p, _ in JTRAIN.TRAIN_TEXTURES.values()})


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_natural") as call:
        yield call


@pytest.fixture(scope="module")
def codec():
    with torch_process("torch_side_codec") as call:
        yield call


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Seeded exports (the JAX package's exporter, weights drawn as tests/
    serving_files.py draws them)."""
    root = tmp_path_factory.mktemp("natural_exports")
    out = {}
    for family, (scale, _) in EVALS.items():
        rng = np.random.default_rng(11)
        params, stats = (sf.draw(t, rng) for t in sf.shapes(family))
        out[family] = str(root / f"{family}.dgt")
        jck.export_generator(out[family], family, scale, params, stats)
    return out


@pytest.fixture(scope="module")
def evals(port, exports):
    """Both tools on each export: the port's started in its child, the JAX
    tool's subprocesses started beside it; their lines."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", TF_CPP_MIN_LOG_LEVEL="3",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    started, procs = {}, {}
    for family, (_, flags) in EVALS.items():
        argv = ["--model", exports[family], *flags]
        started[family] = port.submit("eval_lines", argv)
        procs[family] = subprocess.Popen(
            [sys.executable, "-c", TOOL_LAUNCHER, str(REPO),
             str(REPO / "tools" / "eval_natural.py"), *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    out = {}
    for family, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=JAX_TOOL_S)
        assert proc.returncode == 0, stderr[-2000:]
        want = [x for x in stdout.splitlines()
                if x.startswith(("model:", "|"))]
        got = [x for x in started[family].result(JAX_TOOL_S)
               if x.startswith(("model:", "|"))]
        out[family] = got, want
    return out


@pytest.mark.parametrize("asset", sorted(SOURCES), ids=lambda p: p.name)
def test_asset_is_the_installed_file(asset):
    src = SOURCES[asset]
    if not src.exists():
        pytest.skip(f"{src} is not installed here")
    data = asset.read_bytes()
    assert data == src.read_bytes()
    digest = hashlib.sha256(data).hexdigest()
    row = next(line for line in CREDITS.splitlines()
               if line.startswith(f"| `{asset.name}` |"))
    assert f"`{digest}`" in row and f"| {len(data):,} |" in row


def test_assets_decode_as_pil(codec):
    paths = sorted(SOURCES)
    got = codec("decode_files", [str(p) for p in paths])
    for path, img in zip(paths, got):
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"))
        assert img is not None, path.name
        np.testing.assert_array_equal(img, want, err_msg=path.name)


def test_crops_equal_jax_tool(port):
    started = port.submit("photo_crops")
    want = [(n, hashlib.sha256(np.ascontiguousarray(c).tobytes()).hexdigest())
            for n, c in JEVAL.load_photo_crops()]
    got = started.result()
    assert [n for n, _ in got].count("hopper") == 9 and len(got) == 25
    assert [tuple(x) for x in got] == want


@pytest.mark.parametrize("textures, count", [(0, 72), (1, 456)])
def test_tiles_equal_jax_tool(port, tmp_path, textures, count):
    started = port.submit("tile_digests", bool(textures))
    recorded = {}

    def save(path, arr):
        recorded[os.path.basename(path)] = hashlib.sha256(
            np.ascontiguousarray(arr).tobytes()).hexdigest()

    saved = np.save
    np.save = save
    try:
        class Args:
            data_root = str(tmp_path)
        Args.textures = textures
        JTRAIN.build(Args)
    finally:
        np.save = saved
    assert not list((tmp_path / "train" / "photos").iterdir())
    got = started.result()
    assert len(got) == len(recorded) == count
    assert got == recorded


def _rows(lines):
    """{q: (model PSNR, SSIM, input PSNR, SSIM, dPSNR, dSSIM, per-photo
    dPSNRs)} of an eval_natural table."""
    out = {}
    for line in lines:
        m = re.match(r"\| (\d+) \| (.*) \|$", line)
        if m:
            out[int(m.group(1))] = [float(v) for v in re.findall(
                r"[-+]?\d+\.\d+", m.group(2))]
    return out


@pytest.mark.parametrize("family", sorted(EVALS))
def test_eval_matches_jax_tool(evals, family):
    got, want = evals[family]
    assert got[:3] == want[:3]
    g, w = _rows(got), _rows(want)
    assert set(g) == set(w) and g
    for q, wr in w.items():
        gr = g[q]
        assert len(gr) == len(wr)
        for k, (a, b) in enumerate(zip(gr, wr)):
            tol = SSIM_TOL if k in (1, 3, 5) else PSNR_TOL
            assert abs(a - b) <= tol + 1e-9, (q, k, a, b)


def test_train_tool_runs(port, tmp_path):
    names = ["china_0_0.npy", "china_0_0f.npy", "flower_64_128.npy",
             "sky_0_256f.npy"]
    root = tmp_path / "nat"
    port("write_tiles", str(root / "train" / "photos"), names)
    assert sorted(os.listdir(root / "train" / "photos")) == sorted(names)
    said, steps, exported = port(
        "train_run", str(tmp_path),
        ["--data_root", str(root), "--steps", "2", "--batch", "2",
         "--crop", "32"])
    assert said == ["natural train: autoencoder tiles=4 spe=2 epochs=1 "
                    "(~2 steps) q=10 scale=1",
                    "export: models/nat_autoencoder.dgt"]
    assert steps == 2 and exported


@pytest.mark.parametrize("tool", ["train_natural", "eval_natural"])
def test_tool_imports_nothing_the_card_lacks(tool):
    path = REPO / "denoise_gan_tpu_torch" / "tools" / f"{tool}.py"
    mods = [n.module if isinstance(n, ast.ImportFrom) else a.name
            for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, (ast.Import, ast.ImportFrom))
            for a in (n.names if isinstance(n, ast.Import) else [n])]
    bad = [m for m in mods if m and m.split(".")[0] in (
        "jax", "flax", "denoise_gan_tpu", "tools", "cv2", "PIL", "sklearn",
        "matplotlib", "tensorflow", "keras")]
    assert mods and not bad, bad
