"""The SRGAN slice: the port's SRGAN kernel engine (pad, tiles, 16-block bf16
body, fused CIN=64 tail twin on the CPU, u8 frame) vs the JAX SRGAN kernel
engine with its Pallas tail in interpret mode, on the same weights and
frames, and the engine's input options.  The port runs in a child process
(tests/torch_process.py).

The 16-block bf16 body drifts further from XLA's than FSRGAN's does.  Each
conv rounds about 3e-5 of its bf16 outputs apart (the two libraries sum in
different orders), and the residual adds carry each one-ulp difference into
the next block's 576-term sums.  With residual kernels at half of LeCun
normal (about the scale of the reference's N(0, 0.02) init) 44% of the
body outputs differ by an ulp or more after 16 blocks (0.07% after one
block, 2.9% after four; measured, ROADMAP.md C), and the engine then
differs on 18% of the bytes (bf16, max 2) and by up to 7 levels (w8a8).  At
a tenth (GAIN) the body differs on 0.5% of its outputs.  w8a8 drifts more
than bf16 because the static activation scales follow the body's maximum:
the port's su1 sits 6e-5 (relative) from JAX's, which moves u1's int8 grid.

Envelopes at GAIN, over two frames: bf16 max |diff| <= 1 on < 5% of the
bytes (measured 1.85%); w8a8 the JAX package's own engine-vs-plain envelope,
max <= 3, > 1 on < 1% (tests/test_pallas_tail_srgan.py:165-166; measured
max 3, > 1 on 0.37%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.infer import kernel_engine as jke  # noqa: E402
from denoise_gan_tpu.models.srgan import SRGANGenerator as JGen  # noqa: E402

H, W, BRC = 100, 150, 25
GAIN = 0.1         # residual-block and post-conv kernels, x LeCun normal


def _reseed(tree, rng, path=()):
    """N(0, 1/fan_in) kernels, GAIN times that in the residual blocks and
    the post-conv; biases, BN statistics and PReLU slopes redrawn."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _reseed(v, rng, path + (k,))
            continue
        shape = np.shape(v)
        if k == "kernel":
            gain = GAIN if "body" in path and path[-1] != "Conv_0" else 1.0
            a = rng.standard_normal(shape) * gain / np.sqrt(
                np.prod(shape[:-1]))
        elif k == "alpha":
            a = rng.uniform(0.05, 0.3, shape)
        elif k == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        elif k == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:                                   # bias, mean
            a = rng.standard_normal(shape) * 0.05
        out[k] = np.asarray(a, np.float32)
    return out


@pytest.fixture(scope="module")
def port():
    with torch_process(workers=2) as call:
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


def _bgr_u8(frames):
    """The decoder's BGR uint8 frames of the RGB float frames."""
    return [np.ascontiguousarray(np.round(f * 255).astype(np.uint8)[..., ::-1])
            for f in frames]


@pytest.fixture(scope="module")
def started(port, weights, frames):
    """The port's engines, started in the children at once: {case:
    future of engine_frames' (frames, launch counts)}.  ``bf16`` is also
    the RGB engine that test_srgan_engine_bgr_input_is_rgb_engine holds
    its BGR-input engine to (its first frame)."""
    params, stats = weights
    run = lambda *a, **kw: port.submit("engine_frames", params, stats, H, W,
                                       BRC, *a, family="srgan", **kw)
    calib = {"bf16": None, "w8a8": 0}
    out = {mode: run(frames, calib=c) for mode, c in calib.items()}
    for mode, c in calib.items():
        out[f"options-{mode}"] = run(_bgr_u8(frames), calib=c, u8_input=True,
                                     bgr_input=True, calib_frames=frames)
    out["bgr_input"] = run([np.ascontiguousarray(frames[0][..., ::-1])],
                           bgr_input=True)
    return out


def _jax_frames(weights, frames, mode, options):
    """The JAX engine's frames: w8a8 calibrated on the RGB float frames[0];
    with `options` (u8_input + bgr_input) on the decoder's BGR uint8
    frames."""
    params, stats = weights
    jkw = {"q8_calib_frame": jnp.asarray(frames[0])} if mode == "w8a8" else {}
    ins = frames
    if options:
        jkw.update(u8_input=True, bgr_input=True)
        ins = _bgr_u8(frames)
    jeng = jke.build_srgan_kernel_engine(params, stats, H, W, brc=BRC,
                                         interpret=True, **jkw)
    return [jeng(jnp.asarray(f)) for f in ins]


def _diff(got, want5):
    want = np.asarray(jke.flat_view(want5, H, W)).reshape(H * 4, W * 4, 3)
    assert got.shape == want.shape and got.dtype == np.uint8
    return np.abs(got.astype(np.int32) - want.astype(np.int32))


def _within(d, q8):
    if q8:
        assert d.max() <= 3 and (d > 1).mean() < 1e-2, (d.max(),
                                                        (d > 1).mean())
    else:
        assert d.max() <= 1 and (d > 0).mean() < 5e-2, (d.max(),
                                                        (d > 0).mean())


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
def test_srgan_engine_matches_jax_engine(started, weights, frames, mode):
    """Both frames through both engines (w8a8 calibrated on the first);
    the fraction is taken over the two frames, as the FSRGAN test does."""
    want = _jax_frames(weights, frames, mode, False)
    outs, launched = started[mode].result()
    assert launched == {f"fused_tail64_u8_reference:{mode}": 2}
    for got in outs:
        assert got.std(axis=(0, 1)).min() > 5
    _within(np.stack([_diff(got, w) for w, got in zip(want, outs)]),
            mode == "w8a8")


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
def test_srgan_engine_input_options_match_jax(started, weights, frames,
                                              mode):
    """u8_input + bgr_input: the decoder's BGR uint8 frames through both
    engines (calibrated on the first RGB float frame, which each flips)."""
    want = _jax_frames(weights, frames, mode, True)
    outs, _ = started[f"options-{mode}"].result()
    _within(np.stack([_diff(got, w) for w, got in zip(want, outs)]),
            mode == "w8a8")


def test_srgan_engine_bgr_input_is_rgb_engine(started):
    """The bgr_input engine on a BGR frame is the RGB engine on the RGB
    frame: the stem sums its input channels in another order, which the
    body carries on as above.  Bound: the JAX package's own for this input
    option, max <= 1 on < 2% (tests/test_pallas_tail.py:139-140; measured
    1.2e-3)."""
    rgb = started["bf16"].result()[0][0]
    (bgr,), _ = started["bgr_input"].result()
    d = np.abs(rgb.astype(np.int32) - bgr.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 2e-2, (d.max(), (d > 0).mean())
