"""The port's still-image CLI (denoise_gan_tpu_torch/infer/image.py) and
comparison run (denoise_gan_tpu_torch/unit_test.py) against the JAX
package's (denoise_gan_tpu/infer/image.py::run, the root unit_test.py) on
the same images and ``.dgt`` exports (tests/serving_files.py; the JAX
side's load_generator is serving_files.load_generator, the same trees
without the eager Flax init).  The port runs in a child process
(tests/torch_process.py) with ``--device cpu``.

Images: a uint8 .npy and a PNG of 64x96 (the autoencoder's whole-image
forward needs multiples of 32), and a 48x40 .npy for FSRGAN 4x through
the overlap tiling.  Outputs are written truncated to uint8, as in both
CLIs.  Bounds: f32 (--fast 0) max 1 level on < 1e-3 of the bytes; bf16
(--fast 1, the default) max 2, > 1 on < 5e-3, > 0 on < 5%, as the bf16
paths of tests/test_torch_cli.py (which says why); the autoencoder in
bf16 drifts in both packages (17 convs, ROADMAP C), so there its share of
bytes > 0 apart goes unbounded (measured up to 7.7%) and it is held to
be no farther from the JAX package's f32 output than JAX's own bf16
output is (tests/test_torch_models_1x.py's rule).  Without cv2 the
port's nlmeans filter says it needs cv2, and images are saved by PIL.
"""

import os
import shutil

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()
cv2 = pytest.importorskip("cv2")

from denoise_gan_tpu.infer import image as jimage  # noqa: E402

import serving_files as sf  # noqa: E402
import unit_test as junit  # noqa: E402

F32, BF16 = (1, 0.0, 1e-3), (2, 5e-3, 5e-2)
# the autoencoder in bf16: no bound on the share > 0 (see the module
# docstring); serving_files.no_farther holds it against JAX's f32 output
BF16_AE = (2, 5e-3, 1.0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("img")
    models = {k: v[0] for k, v in sf.write_files(root).items()}
    rng = np.random.default_rng(7)
    images = {}
    for name, (h, w) in (("ae", (64, 96)), ("up", (48, 40))):
        d = root / name
        d.mkdir()
        frame = sf.video_frames(h, w, seed=20)[0][..., ::-1]     # RGB
        np.save(d / "a.npy", frame)
        if name == "ae":
            noisy = np.clip(frame + rng.normal(0, 12, frame.shape), 0, 255)
            cv2.imwrite(str(d / "b.png"), noisy.astype(np.uint8)[..., ::-1])
        images[name] = d
    return models, images


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_serving") as call:
        yield call


def _read(path):
    if path.endswith(".npy"):
        return np.load(path)
    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


CASES = [  # (id, model, images, flags, bound)
    ("ae-bf16", "autoencoder", "ae", [], BF16_AE),
    ("ae-f32-tanh", "autoencoder", "ae", ["--fast", "0", "--input_range",
                                          "tanh"], F32),
    ("fsrgan-tiled-bf16", "fsrgan", "up", ["--tile", "32", "--tile_overlap",
                                           "8"], BF16),
    ("fsrgan-f32", "fsrgan", "up", ["--fast", "0"], F32),
]


@pytest.mark.parametrize("model,images,flags,bound",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_image_cli_matches_jax(port, files, tmp_path, monkeypatch, model,
                               images, flags, bound):
    monkeypatch.setattr(jimage, "load_generator", sf.load_generator)
    models, dirs = files
    argv = ["--image_dir", str(dirs[images]), "--model", models[model],
            *flags]
    written = jimage.run(jimage.build_parser().parse_args(
        argv + ["--output_dir", str(tmp_path / "jax")]))
    text = port("image_cli", argv + ["--output_dir", str(tmp_path / "port"),
                                     "--device", "cpu"])
    assert len(text.splitlines()) == len(written) == len(os.listdir(
        dirs[images]))
    refs = {}
    if bound is BF16_AE:
        refs = {os.path.basename(p): p for p in jimage.run(
            jimage.build_parser().parse_args(argv + [
                "--fast", "0", "--output_dir", str(tmp_path / "f32")]))}
    for path in written:
        name = os.path.basename(path)
        got = _read(str(tmp_path / "port" / name))
        sf.envelope(name, got, _read(path), bound)
        if refs:
            sf.no_farther(name, got, _read(path), _read(refs[name]))


def test_unit_test_matches_jax(port, files, tmp_path, monkeypatch):
    """*_sr.png (the bf16 forward on the 256-crop) and *_sr_denoise.png
    (the 3x3 median of it) of both runs."""
    monkeypatch.setattr(jimage, "load_generator", sf.load_generator)
    models, dirs = files
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        shutil.copy(dirs["ae"] / "b.png", tmp_path / side / "b.png")
    junit.main(["--image_dir", str(tmp_path / "jax"), "--model",
                models["autoencoder"]])
    # JAX's f32 forward on the same crop, saved as unit_test saves
    _, _, f32 = jimage.build_forward(models["autoencoder"], fast=False)
    img = jimage.decode_image(str(dirs["ae"] / "b.png"))[:256, :256]
    sr = (np.asarray(f32(img[None])[0], np.float32) + 1.0) / 2.0
    saved = lambda x: np.clip(x * 255.0, 0, 255).astype(  # noqa: E731
        np.uint8)[..., ::-1]
    ref = {"b_sr.png": saved(sr),
           "b_sr_denoise.png": saved(junit.denoise_median(sr))}
    text = port("unit_test_cli", ["--image_dir", str(tmp_path / "port"),
                                  "--model", models["autoencoder"],
                                  "--device", "cpu"])
    assert "b_sr.png" in text and "b_sr_denoise.png" in text
    for name in ("b_sr.png", "b_sr_denoise.png"):
        got, want = (_read(str(tmp_path / side / name))
                     for side in ("port", "jax"))
        sf.envelope(name, got, want, BF16_AE)
        sf.no_farther(name, got, want, ref[name])


def test_without_cv2(port, tmp_path):
    assert "needs cv2" in port("without_cv2", "nlmeans", "")
    path = str(tmp_path / "pil.png")
    assert port("without_cv2", "save", path) is None
    assert _read(path).shape == (8, 8, 3)
