"""The trainers' data and configuration in the port against the JAX
package, on the CPU: DataPipeline's batches byte for byte for the same
files and seed (two epochs, a shard, the cache off), its resize-up branch
(cv2 where installed, as here; JAX's cubic without it, as on the card's
machine), a decode error raised rather than swallowed; the four trainers'
flags and defaults (the JAX ones plus --device) and their parsing; the
learning-rate schedules.  The port runs in a child process
(tests/torch_process.py).
"""

import dataclasses

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.data import pipeline as jpipeline  # noqa: E402
from denoise_gan_tpu.train.state import ttur_schedules  # noqa: E402
from denoise_gan_tpu.utils import config as jconfig  # noqa: E402

TRAINERS = ("autoencoder", "pix2pix", "srgan", "fsrgan")


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_training") as call:
        yield call


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Seeded images under two class folders: uint8 and float .npy of
    mixed sizes, all at least the crop of 24."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(5)
    for i in range(11):
        d = root / f"class{i % 2}"
        d.mkdir(exist_ok=True)
        h, w = 24 + 3 * i, 30 + 5 * (i % 4)
        if i % 3:
            img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        else:
            img = rng.random((h, w, 4)).astype(np.float32)
        np.save(d / f"im{i:02d}.npy", img)
    return str(root)


def jax_epochs(cfg_kwargs, epochs, seed=None, **shard):
    p = jpipeline.DataPipeline(jconfig.TrainConfig(**cfg_kwargs), seed=seed,
                               **shard)
    return len(p), [[b for b in p.epoch()] for _ in range(epochs)]


@pytest.mark.parametrize("batch_size, cache, workers", [
    (3, 1, 4), (2, 0, 1), (4, 1, 2)])
def test_pipeline_batches_equal_jax(port, image_dir, batch_size, cache,
                                    workers):
    kw = dict(image_dir=image_dir, batch_size=batch_size, crop_size=24,
              seed=7, cache_images=cache, data_workers=workers)
    n, want = jax_epochs(kw, 2)
    got_n, got = port("pipeline_epochs", kw, 2)
    assert got_n == n == 11 // batch_size
    assert len(got) == len(want) == 2
    for ge, we in zip(got, want):
        assert len(ge) == len(we) == n
        for g, w in zip(ge, we):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0][0], got[1][0])    # reshuffled


def test_pipeline_shard_arithmetic(image_dir):
    """The JAX pipeline's per-host shard, which the port's DataPipeline
    keeps (it runs one process: index 0 of 1): every host runs the
    all-host minimum of images // processes."""
    kw = dict(image_dir=image_dir, batch_size=2, crop_size=24, seed=1)
    n0, _ = jax_epochs(kw, 0, process_index=0, process_count=2)
    n1, _ = jax_epochs(kw, 0, process_index=1, process_count=2)
    assert n0 == n1 == (11 // 2) // 2


def test_pipeline_decode_error_raised(port, tmp_path):
    d = tmp_path / "cls"
    d.mkdir()
    for i in range(4):
        np.save(d / f"ok{i}.npy", np.zeros((24, 24, 3), np.uint8))
    (d / "bad.npy").write_bytes(b"garbage")
    kw = dict(image_dir=str(tmp_path), batch_size=5, crop_size=24, seed=0)
    with pytest.raises(Exception) as want:
        jax_epochs(kw, 1)
    msg = port("pipeline_error", kw)
    assert msg is not None
    assert msg.split(":")[0] == type(want.value).__name__


@pytest.mark.parametrize("cv2", [True, False], ids=["cv2", "no_cv2"])
def test_resize_up_matches_jax(port, monkeypatch, cv2):
    """An image smaller than the crop is resized up: by cv2's bicubic
    where cv2 is installed, equal to the JAX package's; without cv2 (the
    card's machine) by JAX's cubic, as the JAX package's fallback."""
    img = np.random.default_rng(3).random((13, 20, 3)).astype(np.float32)
    if not cv2:
        monkeypatch.setattr(jpipeline, "_HAS_CV2", False)
    elif not jpipeline._HAS_CV2:
        pytest.skip("cv2 is not installed")
    want = jpipeline._resize_up_if_needed(img, 24)
    got = port("resize_up", img, 24, cv2)
    assert got.shape == want.shape == (24, 24, 3)
    if cv2:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    big = np.zeros((30, 24, 3), np.float32)
    assert port("resize_up", big, 24, cv2) is not None


@pytest.mark.parametrize("trainer", TRAINERS)
def test_trainer_flags_equal_jax(port, trainer):
    """Every JAX flag with its default and type, plus --device cuda."""
    parser = jconfig.build_parser(trainer)
    want = {a.dest: (a.default, a.type.__name__) for a in parser._actions
            if a.dest != "help"}
    got = port("config_surface", trainer)
    assert got.pop("device") == ("cuda", "str")
    assert got == want


@pytest.mark.parametrize("trainer", TRAINERS)
def test_trainer_parsing_equal_jax(port, trainer):
    argv = ["--batch_size", "4", "--fp16", "1", "--jpeg_quality", "30",
            "--image_dir", "~/x/../data", "--retrain", "0", "--lr", "2e-4"]
    want = dataclasses.asdict(jconfig.parse_args(trainer, argv))
    got = port("config_parsed", trainer, argv + ["--device", "cpu"])
    assert got.pop("device") == "cpu"
    assert got == want
    assert got["model_name"].endswith("_30q_fp16")


@pytest.mark.parametrize("family", ["pix2pix", "fsrgan"])
def test_schedules_equal_optax(port, family):
    """The staircase decay (x0.1 per 100,000 steps, D at 5x) and
    pix2pix's constant 2e-4, read at the optimizer's count."""
    counts = [0, 1, 99_999, 100_000, 250_000]
    cfg = jconfig.make_config(family, lr=3e-4)
    g_sched, d_sched = ttur_schedules(cfg, family)
    got_g, got_d = port("schedules", family, 3e-4, counts)
    np.testing.assert_allclose(got_g, [float(g_sched(c)) for c in counts],
                               rtol=1e-6)
    np.testing.assert_allclose(got_d, [float(d_sched(c)) for c in counts],
                               rtol=1e-6)
