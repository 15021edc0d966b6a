"""The port's image ops and metrics against the JAX package's
(denoise_gan_tpu_torch/ops/image.py, ops/metrics.py, data/pipeline.py,
unit_test.py::denoise_median).  The port runs in a child process
(tests/torch_process.py); inputs are drawn with numpy.

- resize_bicubic vs jax.image.resize(method="cubic", antialias=False)
  through the JAX package's resize_bicubic: 2x and 4x up, down,
  non-square, one axis unchanged, HWC and NHWC; within 1e-5 absolute on
  [0, 1] images (measured <= 5e-7: JAX contracts both axes in one
  einsum, the port in two products).
- resize_with_crop_or_pad: crops, pads and both at once, exact.
- psnr and ssim within 1e-5 relative (measured <= 1e-6).
- decode_image: .npy (uint8 and float, four channels cut to three) and
  PNG, exact against the JAX package's.
- denoise_median: exact against cv2.medianBlur(k=3), which the JAX
  package's unit_test.py calls.
"""

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

import jax.numpy as jnp  # noqa: E402

from denoise_gan_tpu.data.pipeline import decode_image  # noqa: E402
from denoise_gan_tpu.ops.image import (  # noqa: E402
    resize_bicubic, resize_with_crop_or_pad)
from denoise_gan_tpu.ops.metrics import psnr, ssim  # noqa: E402

cv2 = pytest.importorskip("cv2")

RESIZES = [  # (id, input shape, (height, width))
    ("2x-up", (24, 32, 3), (48, 64)),
    ("4x-up", (25, 38, 3), (100, 152)),
    ("down", (40, 30, 3), (13, 7)),
    ("non-square-nhwc", (2, 9, 11, 3), (18, 33)),
    ("one-axis", (17, 20, 3), (68, 20)),
    ("4x-up-nhwc", (1, 13, 17, 3), (52, 68)),
]


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_serving") as call:
        yield call


@pytest.mark.parametrize("shape,size", [r[1:] for r in RESIZES],
                         ids=[r[0] for r in RESIZES])
def test_resize_bicubic_matches_jax(port, shape, size):
    x = np.random.default_rng(len(shape) + size[0]).random(shape).astype(
        np.float32)
    want = np.asarray(resize_bicubic(jnp.asarray(x), *size))
    got = port("resize_bicubic", x, *size)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,size", [
    ((13, 17, 3), (8, 40)), ((13, 17, 3), (20, 9)), ((13, 17, 3), (30, 30)),
    ((2, 48, 64, 3), (256, 256)), ((2, 256, 256, 3), (48, 64))])
def test_resize_with_crop_or_pad_matches_jax(port, shape, size):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    want = np.asarray(resize_with_crop_or_pad(jnp.asarray(x), *size))
    np.testing.assert_array_equal(port("resize_with_crop_or_pad", x, *size),
                                  want)


def test_psnr_ssim_match_jax(port):
    rng = np.random.default_rng(1)
    a = rng.random((2, 40, 52, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    got_p, got_s = port("psnr_ssim", a, b)
    np.testing.assert_allclose(got_p, np.asarray(psnr(a, b)), rtol=1e-5)
    np.testing.assert_allclose(got_s, np.asarray(ssim(a, b)), rtol=1e-5)


def test_decode_image_matches_jax(port, tmp_path):
    rng = np.random.default_rng(2)
    u8 = (rng.random((20, 30, 4)) * 255).astype(np.uint8)
    paths = {"u8.npy": u8, "f32.npy": rng.random((20, 30, 3)).astype(
        np.float32)}
    for name, arr in paths.items():
        np.save(tmp_path / name, arr)
    cv2.imwrite(str(tmp_path / "img.png"), u8[..., :3])
    for name in (*paths, "img.png"):
        path = str(tmp_path / name)
        got, want = port("decode", path), decode_image(path)
        assert got.dtype == np.float32 and got.shape == (20, 30, 3)
        np.testing.assert_array_equal(got, want)


def test_denoise_median_matches_cv2(port):
    img = np.random.default_rng(3).random((19, 26, 3)).astype(np.float32)
    want = cv2.medianBlur((np.clip(img, 0, 1) * 255).astype(np.uint8), 3)
    np.testing.assert_array_equal(port("denoise_median", img),
                                  want.astype(np.float32) / 255.0)
