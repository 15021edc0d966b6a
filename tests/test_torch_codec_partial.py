"""JPEGs and PNGs that libjpeg and libpng read in part, in the port's codec
(denoise_gan_tpu_torch/data/native.py) against the JAX package's binding
(denoise_gan_tpu/data/native.py), on the CPU:

- the port's copy of sklearn's china.jpg cut at 50, 90 and 99% of its
  bytes (inside its scan: libjpeg warns and fills) decodes as the binding
  decodes it, and as the sidecar's sha256s, which chip_smoke.py's phase
  4l holds the card to;
- the sidecar's cut and corrupt fixtures (tests/make_codec_fixtures.py)
  cover every case the binding reads in part: data that ends or meets a
  marker inside a scan (baseline, extended, progressive, arithmetic),
  block smoothing, bad Huffman codes, restart markers out of sequence,
  progressive scans out of order, arithmetic coding with DAC, and PNGs
  with a late bad Adler-32, an unended stream, extra data, no IEND or bad
  CRCs after the image; the binding returns an image for each of them but
  the ``bad_`` ones (tests/test_torch_codec.py holds each to its pixels);
- a training folder that holds a cut JPEG: the port's DataPipeline gives
  the JAX pipeline's batches byte for byte (so JAX trains on it as the
  port does), and the port's trainer runs an epoch on it.
The port runs in child processes (tests/torch_process.py, tests/
torch_side_codec.py, tests/torch_side_training.py).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.data import native as jnative  # noqa: E402
from denoise_gan_tpu.data import pipeline as jpipeline  # noqa: E402
from denoise_gan_tpu.utils import config as jconfig  # noqa: E402

import make_codec_fixtures as mcf  # noqa: E402

SIDECAR = json.loads(mcf.SIDECAR.read_text())
CASES = {   # a fixture name's start: the case it stands for
    "cut_": "data ending inside a scan",
    "marker_": "a marker inside a scan",
    "prog_dc_only": "block smoothing, DC only",
    "prog_half_scans": "block smoothing, AC 1-9 incomplete",
    "badcode_": "bad Huffman codes",
    "rst_": "restart markers out of sequence",
    "prog_re": "progressive scans out of order",
    "prog_ac_first": "an AC scan before the DC scan",
    "arith_": "arithmetic coding",
    "png_": "PNGs read in part or whole by libpng",
}


@pytest.fixture(scope="module")
def jax_codec():
    if not jnative.available():
        pytest.skip("the JAX binding's libjpeg/libpng codec is unavailable")
    return jnative


@pytest.fixture(scope="module")
def codec():
    with torch_process("torch_side_codec") as call:
        yield call


@pytest.fixture(scope="module")
def training():
    with torch_process("torch_side_training") as call:
        yield call


@pytest.fixture(scope="module")
def cut_folder(tmp_path_factory):
    """china.jpg cut at 90%, flower.jpg and a seeded PNG in one class
    folder."""
    root = tmp_path_factory.mktemp("cut_folder")
    d = root / "cls"
    d.mkdir()
    (d / "a_china_cut.jpg").write_bytes(mcf.photo_cut(
        mcf.PHOTO.read_bytes(), 0.9))
    (d / "b_flower.jpg").write_bytes(
        (mcf.PHOTO.parent / "flower.jpg").read_bytes())
    mcf.write_png(d / "c_seeded.png", mcf.seeded_image(90, 70, 3), 8, 2)
    return str(root)


@pytest.mark.parametrize("frac", mcf.PHOTO_CUTS)
def test_cut_photo_decodes_as_libjpeg(codec, jax_codec, tmp_path, frac):
    path = tmp_path / "cut.jpg"
    path.write_bytes(mcf.photo_cut(mcf.PHOTO.read_bytes(), frac))
    want = jax_codec.decode(str(path))
    assert want is not None and want.shape == (427, 640, 3)
    assert mcf.digest(want) == SIDECAR["photo_cuts"][str(frac)]
    got, = codec("decode_files", [str(path)])
    assert got is not None
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start", sorted(CASES))
def test_partial_fixtures_cover_the_case(start):
    names = [n for n in SIDECAR["partial"] if n.startswith(start)]
    assert names, CASES[start]
    for name in names:
        assert SIDECAR["files"][name]["sha256"] is not None, name
    refused = [n for n in SIDECAR["partial"]
               if SIDECAR["files"][n]["sha256"] is None]
    assert refused == [n for n in SIDECAR["partial"] if n.startswith("bad_")]


def test_folder_with_a_cut_jpeg_trains(training, cut_folder, tmp_path):
    kw = dict(image_dir=cut_folder, batch_size=1, crop_size=64, seed=3,
              cache_images=1, data_workers=2)
    started = training.submit("pipeline_epochs", kw, 1)
    p = jpipeline.DataPipeline(jconfig.TrainConfig(**kw))
    want = [b for b in p.epoch()]
    n, got = started.result()
    assert n == len(want) == 3
    for g, w in zip(got[0], want):
        np.testing.assert_array_equal(g, w)
    run = training("trainer_cli", str(tmp_path), [
        "--image_dir", cut_folder, "--epochs", "1", "--batch_size", "1",
        "--crop_size", "32", "--device", "cpu"], "autoencoder")
    assert "Steps per epoch: 3" in run["stdout"]
    assert "iters: 3," in run["stdout"]
