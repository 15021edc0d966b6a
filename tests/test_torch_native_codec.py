"""The port's own image codec (denoise_gan_tpu_torch/data/native.py: its
C++ native/imgcodec.cpp and data/png.py, no libjpeg or libpng) against the
JAX package's libjpeg/libpng binding (denoise_gan_tpu/data/native.py):
JPEG and PNG files written by PIL decode byte-equal, the libjpeg round
trip is byte-equal at two qualities, the port's decode_image equals the
JAX decode_image, and the port's build (into its own _build/) leaves
native/libimgcodec.so (which the JAX binding rebuilds in place) as it
was.  The port runs in a child process (tests/torch_process.py).
tests/test_torch_codec.py holds the codec to libjpeg and libpng on every
committed fixture."""

import os
from pathlib import Path

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.data import native as jnative  # noqa: E402
from denoise_gan_tpu.data.pipeline import decode_image  # noqa: E402

PIL = pytest.importorskip("PIL.Image")
JAX_SO = Path(__file__).resolve().parent.parent / "native" / "libimgcodec.so"
QUALITIES = (30, 85)


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_parallel") as call:
        yield call


@pytest.fixture(scope="module")
def jax_codec():
    # the JAX binding first: it rebuilds its library in place when that is
    # older than the source, which must not fall inside the window below
    if not jnative.available():
        pytest.skip("native codec unavailable (no g++/libjpeg/libpng)")
    return jnative


def _image(h=37, w=53):
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.5 + 0.3 * np.sin(xx / 5 + yy / 9)[..., None] * np.array(
        [1.0, 0.7, -0.5]) + 0.1 * rng.random((h, w, 3))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("codec")
    rgb = _image()
    paths = [str(d / "a.jpg"), str(d / "a.png")]
    PIL.fromarray(rgb).save(paths[0], quality=90)
    PIL.fromarray(rgb).save(paths[1])
    return rgb, paths


def test_port_build_leaves_jax_library(port, jax_codec, tmp_path):
    before = (JAX_SO.read_bytes(), os.stat(JAX_SO).st_mtime_ns)
    lib = Path(port("native_fresh_build", str(tmp_path / "_build")))
    assert lib.parent == tmp_path / "_build" and lib.exists()
    assert (JAX_SO.read_bytes(), os.stat(JAX_SO).st_mtime_ns) == before


def test_decode_and_roundtrip_match_jax(port, jax_codec, files):
    rgb, paths = files
    got = port("native_codec", paths, rgb, QUALITIES)
    assert got["available"] and got["decoder"] == "native"
    assert "denoise_gan_tpu_torch" in got["library"]
    for p, dec in zip(paths, got["decoded"]):
        want = jax_codec.decode(p)
        assert dec.shape == want.shape == rgb.shape
        np.testing.assert_array_equal(dec, want)
    np.testing.assert_array_equal(got["decoded"][1], rgb)   # PNG lossless
    for q, rt in zip(QUALITIES, got["roundtrip"]):
        want = jax_codec.jpeg_roundtrip_u8(rgb, q)
        assert rt.dtype == np.uint8 and not np.array_equal(rt, rgb)
        np.testing.assert_array_equal(rt, want)
    for p, img in zip(paths, got["decode_image"]):
        assert img.dtype == np.float32
        np.testing.assert_array_equal(img, decode_image(p))
