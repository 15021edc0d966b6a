"""The port's quality tools (denoise_gan_tpu_torch/tools/: evaluate,
quality_table, convert_vgg19) against the JAX repository's (tools/
evaluate.py, quality_table.py, convert_vgg19.py, loaded by file path) and
the JAX package, on the CPU.  The port's torch half runs in child
processes (tests/torch_process.py, tests/torch_side_quality.py), all of it
started before the JAX side runs here.

- Corpus: the port draws tools/quality_table.py's synthetic images with
  numpy alone (cv2's INTER_CUBIC resize and its filled rectangles, filled
  circles and lines re-implemented).  Over the smoke corpus's 24 images
  from seed 7: the generator's state equal after every image, the
  background within 1e-5, and at most 2% of an image's values more than
  1/255 apart.  cv2's edge rasterisation (the sub-pixel polygon of a
  thick line, the circle's octant walk) is mirrored step by step, but a
  pixel it puts on the other side of an edge would move a whole pixel,
  hence a share rather than equality (measured: 0, 200 images too).
- evaluate: per image, PSNR within 0.01 dB and SSIM within 1e-4 of the
  composition tools/evaluate.py makes of the JAX package's build_forward,
  degrade_pair, resize_bicubic, psnr and ssim, on the same crops, at f32
  (fast=0); 0.05 dB and 1e-3 with fast=1 (bf16; PERF.md section 2's CLI
  bounds); the four printed lines in the JAX tool's format.
- run_family: the autoencoder trained for one epoch on the CPU writes an
  export that load_generator reads, and a RESULT of finite values; the
  markdown table's text equals the JAX tool's for the same rows.
- convert_vgg19: the .npz of the committed narrow Keras-layout fixture
  (tests/data/vgg19_notop_narrow.h5), of a model_weights/ layout written
  here with h5py and of a torchvision-style state dict equals the JAX
  tool's from_h5 / from_torch, array for array and byte for byte; with no
  source the tool exits non-zero.
"""

import ast
import concurrent.futures
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()
cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from denoise_gan_tpu.data.degrade import degrade_pair  # noqa: E402
from denoise_gan_tpu.data.pipeline import DataPipeline  # noqa: E402
from denoise_gan_tpu.infer import image as jimage  # noqa: E402
from denoise_gan_tpu.io import checkpoint as jck  # noqa: E402
from denoise_gan_tpu.models import build_models  # noqa: E402
from denoise_gan_tpu.ops.image import resize_bicubic  # noqa: E402
from denoise_gan_tpu.ops.metrics import psnr, ssim  # noqa: E402
from denoise_gan_tpu.utils.config import make_config  # noqa: E402
from denoise_gan_tpu_torch.tools import convert_vgg19 as tvgg  # noqa: E402
from denoise_gan_tpu_torch.tools import quality_table as tq  # noqa: E402

import serving_files as sf  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "vgg19_notop_narrow.h5"
CORPUS_SHARE = 0.02            # of an image's values > 1/255 apart
BACKGROUND_ABS = 1e-5
F32, FAST = (0.01, 1e-4), (0.05, 1e-3)     # (PSNR dB, SSIM)
# family: (scale, crop, batch) of the evaluate cases; pix2pix's U-Net
# halves its input 8 times
EVAL = {"autoencoder": (1, 64, 2), "pix2pix": (1, 256, 1),
        "srgan": (4, 64, 2), "fsrgan": (4, 64, 2)}
Q = 30
N_TRAIN, N_VAL = 8, 8          # the smoke family's corpus: one step


def _tool(name):
    """tools/<name>.py of the JAX repository, loaded by file path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shapes(family):
    gen = build_models(family, scale=EVAL[family][0]).generator
    size = {"autoencoder": 32, "pix2pix": 256}.get(family, 16)
    v = jax.eval_shape(lambda: gen.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, size, size, 3)), train=False))
    return v["params"], v.get("batch_stats", {})


def _load_generator(path):
    """The JAX package's load_generator without its eager Flax init."""
    config, _ = jck.read_export(path)
    return jck.load_export_into(path, *_shapes(config["family"]))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The corpus (the port's make_corpus) and one .dgt a family (the JAX
    package's exporter, weights drawn with numpy as tests/serving_files.py
    draws them)."""
    root = tmp_path_factory.mktemp("quality")
    with contextlib.redirect_stdout(io.StringIO()):
        tq.make_corpus(str(root / "qdata"), N_TRAIN, N_VAL)
    models = {}
    for i, family in enumerate(EVAL):
        rng = np.random.default_rng(40 + i)
        params, stats = (sf.draw(t, rng) for t in _shapes(family))
        models[family] = str(root / f"{family}.dgt")
        jck.export_generator(models[family], family, EVAL[family][0],
                             params, stats)
    return root, models


@pytest.fixture(scope="module")
def started(files):
    """The port's side of every case, submitted at once to three children
    (the training first, then pix2pix's evaluations, the longest, then the
    rest in the order the tests read them): {key: future}."""
    root, models = files
    val = str(root / "qdata" / "val")
    work = root / "work"
    work.mkdir()
    with torch_process("torch_side_quality", workers=3) as port:
        futures = {"smoke": port.submit("smoke_family", str(work),
                                        "autoencoder", str(root / "qdata"))}
        for family in ["pix2pix"] + [f for f in EVAL if f != "pix2pix"]:
            _, crop, batch = EVAL[family]
            for fast in (0, 1):
                futures[(family, fast)] = port.submit(
                    "evaluate_arrays", models[family], val, crop, Q, batch,
                    1, fast)
        futures["main"] = port.submit("evaluate_main",
                                      _main_argv(models, val))
        futures["torch_route"] = port.submit("torch_route", str(root),
                                             tq_widths())
        yield futures


def tq_widths():
    """The narrow fixture's widths (tests/make_vgg19_h5_fixture.py)."""
    with h5py.File(FIXTURE, "r") as f:
        return [int(f[layer][layer]["kernel:0"].shape[-1])
                for layer, _ in tvgg.KERAS_NAMES]


def _main_argv(models, val):
    """Both tools' main on the whole val split (a JAX pipeline stopped
    early leaves its producer thread blocked)."""
    return ["--image_dir", val, "--model", models["autoencoder"],
            "--crop_size", "64", "--batch_size", "2", "--jpeg_quality",
            str(Q)]


# ---------------------------------------------------------------------------
# the corpus

@pytest.fixture(scope="module")
def corpora():
    """Both tools' 24 smoke-corpus images from seed 7, each generator's
    state after each image, and the states before each."""
    jtool = _tool("quality_table")
    out = {"before": []}
    for name, draw in (("jax", jtool.synth_image), ("port", tq.synth_image)):
        rng = np.random.default_rng(7)
        imgs, states = [], []
        for _ in range(24):
            if name == "jax":
                out["before"].append(rng.bit_generator.state)
            imgs.append(draw(rng))
            states.append(rng.bit_generator.state)
        out[name] = (imgs, states)
    return out


def test_corpus_generator_stays_in_step(corpora):
    assert corpora["port"][1] == corpora["jax"][1]


def test_corpus_background_matches_cv2(corpora):
    """The 9x9 background resized as cv2.resize(INTER_CUBIC) resizes it,
    from each image's generator state."""
    worst = 0.0
    for state in corpora["before"]:
        ra, rb = np.random.default_rng(), np.random.default_rng()
        ra.bit_generator.state = rb.bit_generator.state = state
        base = ra.uniform(0, 1, (9, 9, 3)).astype(np.float32)
        want = cv2.resize(base, (288, 288), interpolation=cv2.INTER_CUBIC)
        worst = max(worst, float(np.abs(tq.synth_background(rb)
                                        - want).max()))
    print(f"background max |d| {worst:.2e}")
    assert worst <= BACKGROUND_ABS


def test_corpus_images_match_jax_tool(corpora):
    shares = [float((np.abs(g - w) > 1 / 255).mean())
              for g, w in zip(corpora["port"][0], corpora["jax"][0])]
    print(f"worst share of values > 1/255 apart: {max(shares):.2e} "
          f"(bound {CORPUS_SHARE})")
    for g, w in zip(corpora["port"][0], corpora["jax"][0]):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
    assert max(shares) <= CORPUS_SHARE


def test_make_corpus_layout_matches_jax_tool(tmp_path):
    jtool = _tool("quality_table")
    with contextlib.redirect_stdout(io.StringIO()):
        jtool.make_corpus(str(tmp_path / "jax"), 3, 2)
        tq.make_corpus(str(tmp_path / "port"), 3, 2)
    for split in ("train", "val"):
        names = sorted(os.listdir(tmp_path / "jax" / split / "imgs"))
        assert names == sorted(os.listdir(tmp_path / "port" / split /
                                          "imgs"))
        assert names == [f"im{i:04d}.npy" for i in range(len(names))]
        for n in names:
            a = np.load(tmp_path / "jax" / split / "imgs" / n)
            b = np.load(tmp_path / "port" / split / "imgs" / n)
            assert a.dtype == b.dtype == np.float32
            assert a.shape == b.shape == (288, 288, 3)
            assert (np.abs(a - b) > 1 / 255).mean() <= CORPUS_SHARE


# ---------------------------------------------------------------------------
# evaluate

def _jax_scores(model, fast, image_dir, crop, batch):
    """tools/evaluate.py's four per-image arrays of the JAX package for the
    first batch of `image_dir`."""
    config, bundle, forward = jimage.build_forward(model, fast=bool(fast))
    scale = config["scale"] if bundle.upscales else 1
    cfg = make_config("autoencoder", image_dir=image_dir)
    cfg.crop_size, cfg.batch_size = crop, batch
    cfg.scale, cfg.jpeg_quality = scale, Q
    cfg.finalize()

    @jax.jit
    def eval_batch(hr01):
        lo, hi = degrade_pair(hr01, scale, cfg.jpeg_quality)
        out01 = jnp.clip((forward(lo) + 1.0) / 2.0, 0.0, 1.0)
        clean01 = (hi + 1.0) / 2.0
        if scale > 1:
            h, w = hr01.shape[1:3]
            bar01 = jnp.clip(resize_bicubic((lo + 1.0) / 2.0, h, w),
                             0.0, 1.0)
        else:
            bar01 = (lo + 1.0) / 2.0
        return (psnr(out01, clean01), ssim(out01, clean01),
                psnr(bar01, clean01), ssim(bar01, clean01))

    # the whole epoch, so that its producer thread ends (it blocks on a
    # full queue when the consumer stops early); the port scores its first
    # batch (max_batches 1)
    hr = list(DataPipeline(cfg).epoch())[0]
    return [np.asarray(x) for x in eval_batch(jnp.asarray(hr))]


@pytest.fixture(scope="module")
def jax_started(started, files):
    """Every evaluate case's JAX oracle, computed once, in two threads
    started at once beside the port's children (pix2pix's, the longest,
    first): {(family, fast): future}.  The JAX package's load_generator
    is _load_generator here, once an export."""
    root, models = files
    image_dir = str(root / "qdata" / "val")
    lock, loaded = threading.Lock(), {}

    def load(path):
        with lock:
            if path not in loaded:
                loaded[path] = _load_generator(path)
            return loaded[path]

    order = ["pix2pix"] + [f for f in EVAL if f != "pix2pix"]
    with pytest.MonkeyPatch.context() as mp, \
            concurrent.futures.ThreadPoolExecutor(2) as pool:
        mp.setattr(jimage, "load_generator", load)
        yield {(family, fast): pool.submit(
            _jax_scores, models[family], fast, image_dir, *EVAL[family][1:])
            for family in order for fast in (0, 1)}


@pytest.mark.parametrize("fast", [0, 1], ids=["f32", "fast"])
@pytest.mark.parametrize("family", list(EVAL))
def test_evaluate_matches_jax_per_image(started, jax_started, family, fast):
    batch = EVAL[family][2]
    want = jax_started[(family, fast)].result()
    got = started[(family, fast)].result()
    db, ssim_abs = FAST if fast else F32
    for name, g, w, tol in zip(("model psnr", "model ssim", "input psnr",
                                "input ssim"), got, want,
                               (db, ssim_abs, db, ssim_abs)):
        print(f"{family} fast={fast} {name}: port {g} jax {w}")
        assert g.shape == w.shape == (batch,)
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)


def _numbers(line):
    return [float(x) for x in re.findall(r"[-+]?\d+\.\d+", line)]


def test_evaluate_main_prints_jax_lines(started, files, monkeypatch):
    """The port's four lines in the JAX tool's format (its main run here
    on the same export and flags, fast=1): the text apart from the numbers
    equal, the numbers within the fast bounds plus the printed
    rounding."""
    root, models = files
    jtool = _tool("evaluate")
    monkeypatch.setattr(jimage, "load_generator", _load_generator)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtool.main(_main_argv(models, str(root / "qdata" / "val")))
    want = out.getvalue().splitlines()
    got = started["main"].result()
    print("\n".join(got))
    assert len(got) == len(want) == 4
    assert got[0] == want[0]
    strip = re.compile(r"[-+]?\d+\.\d+")
    for g, w in zip(got, want):
        assert strip.sub("#", g) == strip.sub("#", w)
    for g, w, tol in zip(_numbers("".join(got[1:])),
                         _numbers("".join(want[1:])),
                         (0.06, 2e-3, 0.06, 2e-3, 0.11, 3e-3)):
        assert abs(g - w) <= tol


# ---------------------------------------------------------------------------
# run_family and the table

def test_run_family_smoke_writes_a_readable_export(started):
    res, config, finite = started["smoke"].result()
    print("RESULT", res)
    assert config["family"] == "autoencoder" and config["scale"] == 1
    assert finite and res["steps"] == N_TRAIN // 8
    for k in ("psnr_model", "ssim_model", "psnr_input", "ssim_input",
              "train_s"):
        assert np.isfinite(res[k]), k
    assert res["peak_mib"] is None          # not on the card


def test_table_text_equals_jax_tool(started, files, monkeypatch):
    """The JAX tool's main, its run_family replaced by the port's rows,
    prints the port's table."""
    root, _ = files
    res, _, _ = started["smoke"].result()
    rows = {"autoencoder": res,
            "srgan": dict(res, family="srgan", scale=4, q=50,
                          psnr_model=21.5, ssim_model=0.61)}
    jtool = _tool("quality_table")
    monkeypatch.setattr(jtool, "run_family", lambda fam, root: rows[fam])
    monkeypatch.setattr(sys, "argv", ["quality_table.py", "--families",
                                      "autoencoder,srgan", "--data_root",
                                      str(root / "qdata")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtool.main()
    want = out.getvalue().splitlines()
    assert want[-5:] == tq.table(list(rows.values()))


# ---------------------------------------------------------------------------
# convert_vgg19

def _assert_npz_equals(path, want):
    with np.load(path) as data:
        got = {k: data[k] for k in data.files}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        assert got[k].tobytes() == np.ascontiguousarray(want[k]).tobytes(), k


def _model_weights_layout(path):
    """The fixture's weights as a full-model save holds them:
    model_weights/<layer>/{kernel:0, bias:0}."""
    with h5py.File(FIXTURE, "r") as src, h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")
        for layer, _ in tvgg.KERAS_NAMES:
            g = mw.create_group(layer)
            for name in ("kernel:0", "bias:0"):
                g.create_dataset(name, data=src[layer][layer][name][()])


@pytest.mark.parametrize("layout", ["root", "model_weights"])
def test_convert_vgg19_h5_equals_jax_tool(tmp_path, layout):
    h5 = str(FIXTURE)
    if layout == "model_weights":
        h5 = str(tmp_path / "full.h5")
        _model_weights_layout(h5)
    want = _tool("convert_vgg19").from_h5(h5)
    out = tmp_path / "port.npz"
    with contextlib.redirect_stdout(io.StringIO()):
        assert tvgg.main(["--h5", h5, "--out", str(out)]) == 0
    _assert_npz_equals(out, want)
    assert want["conv1_1/kernel"].shape == (3, 3, 3, 2)


def test_convert_vgg19_torch_equals_jax_tool(started, tmp_path):
    port, want = started["torch_route"].result()
    np.savez(tmp_path / "p.npz", **port)
    _assert_npz_equals(tmp_path / "p.npz", want)
    assert len(want) == 32


def test_convert_vgg19_without_source_exits_nonzero(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "denoise_gan_tpu_torch.tools.convert_vgg19",
         "--out", str(tmp_path / "x.npz")], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "--h5" in proc.stderr
    assert not (tmp_path / "x.npz").exists()


# ---------------------------------------------------------------------------
# the tools stand alone

@pytest.mark.parametrize("name", ["evaluate", "quality_table",
                                  "convert_vgg19"])
def test_tool_imports_nothing_the_card_lacks(name):
    """No jax, no JAX package, no root tools/, cv2, PIL, h5py or
    TensorFlow."""
    path = REPO / "denoise_gan_tpu_torch" / "tools" / f"{name}.py"
    mods = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    bad = [m for m in mods if m.split(".")[0] in (
        "jax", "flax", "denoise_gan_tpu", "tools", "cv2", "PIL", "h5py",
        "tensorflow", "keras")]
    assert not bad, bad
