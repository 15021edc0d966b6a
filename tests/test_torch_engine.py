"""The whole slice: the port's FSRGAN kernel engine (pad, tiles, bf16 body,
fused tail twin on the CPU, u8 frame) vs the JAX kernel engine with its
Pallas tail in interpret mode, on the same weights and frames.  The port
runs in a child process (tests/torch_process.py).

Envelopes as tests/test_torch_tail.py: bf16 max |diff| <= 1 on < 1e-3 of
the bytes; w8a8 max <= 2, > 1 on < 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.infer import kernel_engine as jke  # noqa: E402
from denoise_gan_tpu.models.fsrgan import FSRGANGenerator as JGen  # noqa: E402

H, W, BRC = 150, 170, 24


def _reseed(tree, rng):
    """Keep init kernels; redraw biases, BN statistics and PReLU slopes."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _reseed(v, rng)
            continue
        shape = np.shape(v)
        if k == "alpha":
            a = rng.uniform(0.05, 0.3, shape)
        elif k == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        elif k == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif k in ("bias", "mean"):
            a = rng.standard_normal(shape) * 0.05
        else:
            a = np.asarray(v)
        out[k] = np.asarray(a, np.float32)
    return out


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


@pytest.fixture(scope="module")
def weights():
    v = JGen().init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False)
    rng = np.random.default_rng(5)
    return _reseed(v["params"], rng), _reseed(v["batch_stats"], rng)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    return [rng.random((H, W, 3)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
def test_engine_matches_jax_engine(port, weights, frames, mode):
    """Both frames through both engines (w8a8 calibrated on the first).
    The fraction is taken over the two frames: the bf16 body rounds
    differently in XLA and PyTorch in ~0.2% of its outputs, which alone
    flips 0.04-0.12% of a frame's bytes by one level (ROADMAP.md C)."""
    params, stats = weights
    q8 = mode == "w8a8"
    jkw = {"q8_calib_frame": jnp.asarray(frames[0])} if q8 else {}
    jeng = jke.build_fsrgan_kernel_engine(params, stats, H, W, brc=BRC,
                                          interpret=True, **jkw)
    outs, _ = port("engine_frames", params, stats, H, W, BRC, frames,
                   calib=0 if q8 else None)
    diffs = []
    for frame, got in zip(frames, outs):
        want = np.asarray(jke.flat_view(jeng(jnp.asarray(frame)), H, W))
        assert got.shape == (600, 680, 3) and got.dtype == np.uint8
        assert got.std(axis=(0, 1)).min() > 5
        diffs.append(np.abs(got.astype(np.int32)
                            - want.reshape(H * 4, W * 4, 3).astype(np.int32)))
    d = np.stack(diffs)
    if q8:
        assert d.max() <= 2 and (d > 1).mean() < 5e-3, (d.max(),
                                                        (d > 1).mean())
    else:
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(),
                                                        (d > 0).mean())


def test_engine_bgr_and_tail_choice(port, weights, frames):
    """bgr flips the channels; the engine on the CPU reaches the tail twin
    through the wrapper, never the kernel."""
    params, stats = weights
    (rgb,), n_rgb = port("engine_frames", params, stats, H, W, BRC,
                         frames[:1])
    (bgr,), n_bgr = port("engine_frames", params, stats, H, W, BRC,
                         frames[:1], bgr=True)
    np.testing.assert_array_equal(bgr, rgb[..., ::-1])
    for launched in (n_rgb, n_bgr):
        assert launched == {"fused_tail_u8": 0, "fused_tail_u8_reference": 1,
                            "fused_tail64_u8": 0,
                            "fused_tail64_u8_reference": 0}


def _jax_tiles(frame, ny, nx, cr):
    """The JAX engine's input stage (kernel_engine.py:136-153), jitted as
    the engine jits it: a uint8 frame is padded and tiled as bytes, then
    normalised per tile in f32 (which XLA fuses into one multiply-add); a
    float frame is normalised to bf16 first."""
    tr = cr + 4
    pad_h, pad_w = (ny - 1) * cr + tr, (nx - 1) * jke.CORE + jke.T
    u8 = frame.dtype == np.uint8

    @jax.jit
    def stage(x):
        if not u8:
            x = (x * 2.0 - 1.0).astype(jnp.bfloat16)
        x = jnp.pad(x, ((2, pad_h - H - 2), (2, pad_w - W - 2), (0, 0)),
                    mode="edge")
        tiles = jke.extract_grid(x, ny, nx, (tr, jke.T), (cr, jke.CORE))
        if u8:
            tiles = (tiles.astype(jnp.float32) * (2.0 / 255.0)
                     - 1.0).astype(jnp.bfloat16)
        return tiles.astype(jnp.float32)

    return np.asarray(stage(jnp.asarray(frame)))


@pytest.mark.parametrize("kind", ["float", "u8"])
def test_engine_tiles_equal_jax(port, frames, kind):
    """The input stage, shared by both engines, equals the JAX engine's
    bit for bit, for a float frame and (u8_input) for a uint8 frame."""
    frame = frames[1]
    if kind == "u8":
        frame = np.round(frame * 255).astype(np.uint8)
    ny, nx, cr = jke.plan_grid(H, W, BRC)
    got = port("engine_tiles", frame, H, W, BRC)
    np.testing.assert_array_equal(got, _jax_tiles(frame, ny, nx, cr))


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
def test_engine_input_options_match_jax(port, weights, frames, mode):
    """u8_input + bgr_input: the decoder's BGR uint8 frames through both
    engines (w8a8 calibrated on the first RGB float frame, which each
    flips); the fraction is taken over the two frames.  The tiles are equal
    (test_engine_tiles_equal_jax), but uint8 levels reach the body's bf16
    roundings apart more often than float frames do: 1.06e-3 of the bytes
    differ by 1 in bf16 at these seeds (float frames: 6.6e-4).  So bf16 takes
    the JAX package's own bound for this input option, max <= 1 on < 2%
    (tests/test_pallas_tail.py:139-140)."""
    params, stats = weights
    q8 = mode == "w8a8"
    bgr_u8 = [np.ascontiguousarray(
        np.round(f * 255).astype(np.uint8)[..., ::-1]) for f in frames]
    jkw = {"q8_calib_frame": jnp.asarray(frames[0])} if q8 else {}
    jeng = jke.build_fsrgan_kernel_engine(params, stats, H, W, brc=BRC,
                                          interpret=True, u8_input=True,
                                          bgr_input=True, **jkw)
    outs, _ = port("engine_frames", params, stats, H, W, BRC, bgr_u8,
                   calib=0 if q8 else None, u8_input=True, bgr_input=True,
                   calib_frames=frames)
    d = np.stack([np.abs(
        got.astype(np.int32) - np.asarray(jke.flat_view(
            jeng(jnp.asarray(f)), H, W)).reshape(H * 4, W * 4, 3))
        for f, got in zip(bgr_u8, outs)])
    if q8:
        assert d.max() <= 2 and (d > 1).mean() < 5e-3, (d.max(),
                                                        (d > 1).mean())
    else:
        assert d.max() <= 1 and (d > 0).mean() < 2e-2, (d.max(),
                                                        (d > 0).mean())


def test_engine_bgr_input_is_rgb_engine(port, weights, frames):
    """The bgr_input engine on a BGR frame is the RGB engine on the RGB
    frame, within the bf16 envelope (the stem sums its input channels in
    another order)."""
    (rgb,), _ = port("engine_frames", *weights, H, W, BRC, frames[:1])
    (bgr,), _ = port("engine_frames", *weights, H, W, BRC,
                     [np.ascontiguousarray(frames[0][..., ::-1])],
                     bgr_input=True)
    d = np.abs(rgb.astype(np.int32) - bgr.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def test_engine_rejects_wrong_frame_shape(port, weights):
    with pytest.raises(ValueError, match="frame"):
        port("engine_wrong_frame", *weights, H, W, BRC)


def test_body_sample_is_leading_tiles(port, weights, frames):
    """Calibration sample = body output of the first 16 tiles, split across
    frames, as the JAX _body_sample takes it."""
    ny, nx, cr = jke.plan_grid(H, W, BRC)
    assert port("plan_grid", H, W, BRC) == (ny, nx, cr)
    one, two = port("body_samples", *weights, H, W, BRC, frames)
    assert ny * nx == 14
    assert one.shape == (14, cr + 4, 124, 32)           # all 14 tiles
    assert two.shape == (16, cr + 4, 124, 32)           # 8 per frame
    np.testing.assert_array_equal(two[:8], one[:8])
