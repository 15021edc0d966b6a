"""Port ops vs the JAX package: pixel shuffle, grid tiling, grid planning.
All exact: these are pure data movement.  The port runs in a child process
(tests/torch_process.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.infer import engine as jengine  # noqa: E402
from denoise_gan_tpu.infer import kernel_engine as jke  # noqa: E402
from denoise_gan_tpu.ops import image as jimage  # noqa: E402


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


@pytest.mark.parametrize("block,shape", [(2, (2, 3, 5, 16)),
                                         (4, (1, 4, 3, 48))])
def test_depth_to_space_matches_jax(port, rng, block, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jimage.depth_to_space(jnp.asarray(x), block))
    got, via_nchw = port("depth_to_space", x, block)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(via_nchw, want)


@pytest.mark.parametrize("block,shape", [(2, (2, 6, 10, 4)),
                                         (4, (1, 8, 12, 3))])
def test_space_to_depth_matches_jax(port, rng, block, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jimage.space_to_depth(jnp.asarray(x), block))
    np.testing.assert_array_equal(port("space_to_depth", x, block), want)
    back, _ = port("depth_to_space", want, block)
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("frame_hw,ny,nx,tile,stride", [
    ((28, 34), 2, 3, 12, 8),                    # square tiles, exact fit
    ((57, 250), 2, 2, (31, 124), (27, 120)),    # kernel-engine geometry
    ((40, 40), 2, 2, (20, 22), (16, 18)),       # larger frame than needed
])
def test_extract_grid_matches_jax(port, rng, frame_hw, ny, nx, tile, stride):
    x = rng.standard_normal(frame_hw + (3,)).astype(np.float32)
    want = np.asarray(jengine.extract_grid(jnp.asarray(x), ny, nx, tile,
                                           stride))
    got = port("extract_grid", x, ny, nx, tile, stride)
    np.testing.assert_array_equal(got, want)


def test_crop_stitch_matches_jax(port, rng):
    ny, nx, tile, stride = 2, 3, 12, 8
    t = rng.standard_normal((ny * nx, tile, tile, 5)).astype(np.float32)
    want = np.asarray(jengine.crop_stitch(jnp.asarray(t), ny, nx, tile,
                                          stride))
    got = port("crop_stitch", t, ny, nx, tile, stride)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(150, 170), (1080, 1920), (2160, 3840)])
@pytest.mark.parametrize("brc", [24, 27, 45])
def test_plan_grid_matches_jax(port, hw, brc):
    assert port("plan_grid", *hw, brc) == jke.plan_grid(*hw, brc=brc)


def test_plan_grid_1080p_main_path(port):
    assert port("plan_grid", 1080, 1920, 27) == (8, 16, 135)
    assert port("plan_grid", 1080, 1920, 45) == (8, 16, 135)
