"""The port's generic frame engine (infer/engine.py::build_frame_engine,
overlap_add, _phase_feather) and overlap tiling (infer/tile.py) vs the JAX
package's, on the same inputs.  The port runs in a child process
(tests/torch_process.py).

The engines first run one forward, the same in both: x[..., k % 3] * a[k]
+ b[i, j, k], with a in {+-0.5, +-0.25} (an exact product) and b a seeded
pattern over the tile, so every output pixel depends on its place in the
tile and the stitching weights show.  Tolerances:
- f32 output: 2e-6 absolute (XLA may fuse a product into the next add as
  one rounding; measured <= 1.2e-7);
- u8 output, f32 accumulation: max 1 level on < 1e-3 of the bytes (a
  fused rounding can cross a level; measured equal);
- bf16 accumulation: max 1 level on < 2% of the bytes (XLA keeps excess
  precision through fused bf16 ops where PyTorch rounds after each).
Then the real 1x crop engines the video CLI builds (the plain generator
per tile, f32, u8 output): the autoencoder at tile 64/8 (2 x 2 tiles) and
pix2pix at 256/8 (one tile), within max 1 level on < 1e-3 of the bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.infer import engine as jengine  # noqa: E402
from denoise_gan_tpu.infer import tile as jtile  # noqa: E402
from denoise_gan_tpu.models import autoencoder as jae  # noqa: E402
from denoise_gan_tpu.models import pix2pix as jp2p  # noqa: E402

H, W = 40, 56
F32_ATOL = 2e-6
ACC = {"f32": jnp.float32, "bf16": jnp.bfloat16}

# (id, scale, options): every path of build_frame_engine
ENGINES = [
    ("feather-s1-f32", 1, dict(tile=16, overlap=4)),
    ("feather-s1-u8", 1, dict(tile=16, overlap=4, out_uint8=True)),
    ("crop-s1-u8", 1, dict(tile=16, overlap=4, stitch="crop",
                           out_uint8=True)),
    ("whole-s1-f32", 1, dict(tile=0)),
    ("feather-s4-u8", 4, dict(tile=12, overlap=4, out_uint8=True)),
    ("crop-s4-f32", 4, dict(tile=12, overlap=4, stitch="crop")),
    ("whole-s4-u8", 4, dict(tile=0, out_uint8=True)),
    ("bgr-s1-u8", 1, dict(tile=16, overlap=4, out_uint8=True, bgr=True)),
    ("bf16acc-s4-u8", 4, dict(tile=12, overlap=4, out_uint8=True,
                              acc_dtype="bf16")),
    ("bf16acc-s1-f32", 1, dict(tile=16, overlap=6, acc_dtype="bf16")),
    ("fpc2-s1-u8", 1, dict(tile=16, overlap=4, out_uint8=True,
                           frames_per_call=2)),
]


def _affine(scale, rng):
    cc = 3 * scale * scale
    a = rng.choice([0.5, -0.5, 0.25, -0.25], cc).astype(np.float32)
    b = (rng.random((128, 128, cc)) * 0.8 - 0.4).astype(np.float32)
    return a, b


def _jax_forward(a, b):
    idx = np.arange(a.shape[0]) % 3

    def forward(x):
        h, w = x.shape[1:3]
        return x[..., idx] * a + b[:h, :w]
    return forward


def _compare(got, want, acc="f32"):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == np.uint8:
        assert got.dtype == np.uint8
        d = np.abs(got.astype(int) - want.astype(int))
        frac = (d > 0).mean()
        print(f"u8 max {d.max()}, differing {frac:.2e}")
        assert d.max() <= 1 and frac < (2e-2 if acc == "bf16" else 1e-3)
    else:
        want = want.astype(np.float32)
        tol = 2.0 ** -8 if acc == "bf16" else F32_ATOL
        np.testing.assert_allclose(got, want, atol=tol)


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    return [rng.random((H, W, 3)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("name,scale,kw", ENGINES, ids=[e[0] for e in ENGINES])
def test_frame_engine_matches_jax(port, frames, name, scale, kw):
    a, b = _affine(scale, np.random.default_rng(len(name)))
    jkw = dict(kw, acc_dtype=ACC[kw.get("acc_dtype", "f32")])
    run = jengine.build_frame_engine(_jax_forward(a, b), H, W, scale, **jkw)
    got = port("frame_engine_affine", a, b, frames, H, W, scale, **kw)
    if kw.get("frames_per_call", 1) > 1:
        want = np.asarray(run(jnp.asarray(np.stack(frames))))
        assert got.shape == (2, H, W, 3)
        _compare(got, want)
        return
    for g, f in zip(got, frames):
        want = np.asarray(run(jnp.asarray(f)))
        assert want.shape == (H * scale, W * scale, 3)
        _compare(g, want, kw.get("acc_dtype", "f32"))


def test_frame_engine_refusals(port):
    """bgr at scale > 1 raises ValueError, as in JAX; so does a frame of
    another shape, or on another device than the engine's."""
    bgr, shape, device = port("frame_engine_refusals", H, W)
    assert "bgr" in bgr and "expected" in shape and "engine on cpu" in device


@pytest.mark.parametrize("scale", [1, 4])
def test_phase_feather_and_overlap_add_match_jax(port, rng, scale):
    t, ov, ny, nx = 12, 4, 3, 2
    pf = port("phase_feather", t, scale, ov, 3)
    np.testing.assert_array_equal(pf, jengine._phase_feather(t, scale, ov,
                                                             3))
    tiles = rng.standard_normal((ny * nx, t, t, 3 * scale * scale)).astype(
        np.float32)
    want = np.asarray(jax.jit(jengine.overlap_add, static_argnums=(
        1, 2, 3, 4))(tiles, ny, nx, t, t - ov))
    np.testing.assert_array_equal(port("overlap_add", tiles, ny, nx, t,
                                       t - ov), want)


TILE_CASES = [(40, 56, 16, 4, 1), (10, 30, 16, 4, 2), (37, 37, 12, 5, 4)]


def test_tile_plans_match_jax(port):
    for (h, w, t, o, s), (plan, feather) in zip(
            TILE_CASES, port("tile_plans", TILE_CASES)):
        assert [tuple(p) for p in plan] == jtile.plan_tiles(h, w, t, o)
        np.testing.assert_array_equal(feather, jtile._feather(t, s, o))


@pytest.mark.parametrize("size", [(40, 56), (10, 30)])
def test_extract_tiles_matches_jax(port, rng, size):
    img = rng.random(size + (3,)).astype(np.float32)
    np.testing.assert_array_equal(port("extract_tiles", img, 16, 4),
                                  np.asarray(jtile.extract_tiles(img, 16, 4)))


@pytest.mark.parametrize("batch", [0, 5], ids=["whole-batch", "chunked"])
@pytest.mark.parametrize("scale", [1, 2])
def test_tiled_apply_matches_jax(port, rng, scale, batch):
    """tiled_apply with a per-tile function; chunked, the last chunk of the
    12 tiles is filled with leading tiles, so the function sees 5, 5, 5."""
    img = rng.random((40, 50, 3)).astype(np.float32)
    t, o = 20, 6
    pattern = (rng.random((t * scale, t * scale, 3)) - 0.5).astype(
        np.float32)

    def fn(tiles):
        up = jnp.repeat(jnp.repeat(tiles, scale, 1), scale, 2)
        return up * 0.5 + pattern
    want = np.asarray(jtile.tiled_apply(fn, jnp.asarray(img), t, o, scale,
                                        batch))
    got, seen = port("tiled_apply_case", img, t, o, scale, batch, pattern)
    assert got.shape == (40 * scale, 50 * scale, 3)
    assert seen == ([5, 5, 5] if batch else [12])
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


def _jax_init_1x(cls, n, family, rng):
    """The family's Flax trees, kernels drawn with numpy from the JAX
    package's initialiser laws (as tests/test_torch_models_1x.py), biases
    and BN statistics seeded away from 0 and 1."""
    from test_torch_models_1x import _draw
    shapes = jax.eval_shape(lambda: cls().init(
        jax.random.key(0), jnp.zeros((1, n, n, 3)), train=False))
    return {k: _draw(t, rng, family) for k, t in shapes.items()}


# (family, class, tile, overlap, frame size): the crop engines (the video
# CLI's default stitch; feathering is covered above)
REAL = [("autoencoder", jae.AutoencoderGenerator, 64, 8, (64, 100)),
        ("pix2pix", jp2p.Pix2PixGenerator, 256, 8, (200, 240))]


@pytest.mark.parametrize("family,cls,tile,overlap,size", REAL,
                         ids=[r[0] for r in REAL])
def test_real_1x_engines_match_jax(port, family, cls, tile, overlap, size):
    rng = np.random.default_rng(11)
    v = _jax_init_1x(cls, tile, family, rng)
    frame = rng.random(size + (3,)).astype(np.float32)
    gen = cls()

    # the weights enter as arguments of an outer jit: closed over, XLA
    # would fold pix2pix's 54 M constants into the program
    @jax.jit
    def run(v, frame):
        return jengine.build_frame_engine(
            lambda t: gen.apply(v, t, train=False), *size, 1, tile,
            overlap, out_uint8=True, stitch="crop")(frame)
    want = np.asarray(run(v, frame))
    got, = port("frame_engine_generator", family, v["params"],
                v.get("batch_stats"), [frame], tile, overlap, "crop")
    assert want.std() > 5                          # not a flat frame
    _compare(got, want)
