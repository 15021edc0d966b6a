"""The engines' qh8 mode and their canvas outputs (infer/kernel_engine.py)
vs the JAX kernel engines with the same options, their Pallas tails in
interpret mode, on the same weights and frames.  The port runs in a child
process (tests/torch_process.py).  Fractions are taken over two frames, the
first of which calibrates the int8 modes.

qh8 (``qh8=True``, int8 body output and up1): FSRGAN within the JAX
package's qh8 envelope, max <= 2, > 1 on < 5e-3 (test_pallas_tail.py:
185-186); the FSRGAN engine with the K3 body within the envelope its w8a8
engine holds against JAX (max <= 3, > 1 on < 1%).  SRGAN: max <= 4, > 1 on
< 1%.  Its 16-block bf16 body differs from XLA's on about 0.5% of its
outputs by an ulp or more (ROADMAP.md C), and in qh8 those reach the tail
as int8 h: one bf16 ulp near a channel's maximum is ~0.4 of its int8 step
(1.25 max / 127), so many of them move h by a level, where w8a8 sees them
only through up1's 576-term sums.  Measured at these seeds: w8a8 engine vs
JAX max 3, > 1 on 0.37% (test_torch_engine_srgan.py); qh8 max 4, > 1 on
0.76% (this file).

The float-output engines (``out_uint8=False``: the canvas epilogue, f32
[0, 1]) in bf16 and w8a8: as the u8 engines' tests bound each family and
mode (test_torch_engine.py, test_torch_engine_srgan.py), the f32 frames
compared after trunc(x * 255 + 0.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.infer import kernel_engine as jke  # noqa: E402
from denoise_gan_tpu.models.fsrgan import FSRGANGenerator as JGen  # noqa: E402
from denoise_gan_tpu.models.srgan import SRGANGenerator as JGen64  # noqa: E402

# family: (H, W, BRC), as test_torch_engine.py and test_torch_engine_srgan.py
GEOM = {"fsrgan": (150, 170, 24), "srgan": (100, 150, 25)}
SRGAN_GAIN = 0.1   # residual-block and post-conv kernels, x LeCun normal


def _reseed(tree, rng, family, path=()):
    """Biases, BN statistics and PReLU slopes redrawn; SRGAN's kernels
    redrawn at N(0, 1/fan_in), SRGAN_GAIN times that in the body after the
    stem (the two engine tests' seeds)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _reseed(v, rng, family, path + (k,))
            continue
        shape = np.shape(v)
        if k == "kernel":
            if family == "fsrgan":
                a = np.asarray(v)
            else:
                gain = (SRGAN_GAIN if "body" in path and path[-1] != "Conv_0"
                        else 1.0)
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
    with torch_process() as call:
        yield call


@pytest.fixture(scope="module")
def weights():
    out = {}
    for family, cls in (("fsrgan", JGen), ("srgan", JGen64)):
        v = cls().init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                       train=False)
        rng = np.random.default_rng(5)
        out[family] = (_reseed(v["params"], rng, family),
                       _reseed(v["batch_stats"], rng, family))
    return out


@pytest.fixture(scope="module")
def frames():
    out = {}
    for family, (h, w, _) in GEOM.items():
        rng = np.random.default_rng(11)
        out[family] = [rng.random((h, w, 3)).astype(np.float32)
                       for _ in range(2)]
    return out


def _jax_engine(family, params, stats, frames, **kw):
    h, w, brc = GEOM[family]
    build = (jke.build_fsrgan_kernel_engine if family == "fsrgan"
             else jke.build_srgan_kernel_engine)
    if kw.pop("calib", False):
        kw["q8_calib_frame"] = jnp.asarray(frames[0])
    return build(params, stats, h, w, brc=brc, interpret=True, **kw)


def _jax_u8(family, engine, frame):
    """The JAX engine's u8 frame (5D kernel output flattened) as int32."""
    h, w, _ = GEOM[family]
    out = np.asarray(engine(jnp.asarray(frame)))
    if out.ndim == 5:
        out = np.asarray(jke.flat_view(out, h, w))
    return out.reshape(h * 4, w * 4, 3).astype(np.int32)


def _u8(x):
    """A [0, 1] f32 frame as the engines' u8 step: trunc(x * 255 + 0.5)."""
    return (x * np.float32(255) + np.float32(0.5)).astype(np.uint8)


def _assert_within(d, max_d, over, max_frac):
    frac = (d > over).mean()
    assert d.max() <= max_d and frac < max_frac, (d.max(), over, frac)


@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
def test_qh8_engine_matches_jax_engine(port, weights, frames, family):
    params, stats = weights[family]
    h, w, brc = GEOM[family]
    jeng = _jax_engine(family, params, stats, frames[family], calib=True,
                       qh8=True)
    outs, launched = port("engine_frames", params, stats, h, w, brc,
                          frames[family], calib=0, family=family, qh8=True)
    entry = "fused_tail_u8" if family == "fsrgan" else "fused_tail64_u8"
    assert launched == {f"{entry}_reference:qh8": 2}
    for got in outs:
        assert got.shape == (h * 4, w * 4, 3) and got.dtype == np.uint8
        assert got.std(axis=(0, 1)).min() > 5
    d = np.stack([np.abs(got.astype(np.int32) - _jax_u8(family, jeng, f))
                  for f, got in zip(frames[family], outs)])
    print(f"{family} qh8 engine vs JAX: max {d.max()}, > 1 on "
          f"{(d > 1).mean():.2e}")
    if family == "fsrgan":
        _assert_within(d, 2, 1, 5e-3)
    else:
        _assert_within(d, 4, 1, 1e-2)


def test_qh8_mbconv_engine_matches_jax_engine(port, weights, frames):
    """The K3-body FSRGAN engine in qh8 (plain K3 and K1 on the CPU) vs the
    JAX engine (Flax body) in qh8."""
    params, stats = weights["fsrgan"]
    h, w, brc = GEOM["fsrgan"]
    jeng = _jax_engine("fsrgan", params, stats, frames["fsrgan"],
                       calib=True, qh8=True)
    outs, launched = port("mbconv_engine_frames", params, stats, h, w, brc,
                          frames["fsrgan"], calib=0, qh8=True)
    assert launched == {"fused_mbconv_reference": 12,
                        "fused_tail_u8_reference:qh8": 2}
    d = np.stack([np.abs(got.astype(np.int32) - _jax_u8("fsrgan", jeng, f))
                  for f, got in zip(frames["fsrgan"], outs)])
    print(f"K3-body qh8 engine vs JAX: max {d.max()}, > 1 on "
          f"{(d > 1).mean():.2e}")
    _assert_within(d, 3, 1, 1e-2)


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
def test_float_output_engines_match_jax_engine(port, weights, frames, family,
                                               mode):
    params, stats = weights[family]
    h, w, brc = GEOM[family]
    kw = {"out_uint8": False}
    q8 = mode == "w8a8"
    jeng = _jax_engine(family, params, stats, frames[family], calib=q8, **kw)
    outs, launched = port("engine_frames", params, stats, h, w, brc,
                          frames[family], calib=0 if q8 else None,
                          family=family, **kw)
    entry = "fused_tail" if family == "fsrgan" else "fused_tail64"
    assert launched == {f"{entry}_canvas_reference:{mode}": 2}
    diffs = []
    for f, got in zip(frames[family], outs):
        want = np.asarray(jeng(jnp.asarray(f)))
        assert got.shape == want.shape == (h * 4, w * 4, 3)
        assert got.dtype == want.dtype == np.float32
        assert got.min() >= 0 and got.max() <= 1
        got, want = _u8(got), _u8(want)
        assert got.std(axis=(0, 1)).min() > 5
        diffs.append(np.abs(got.astype(np.int32) - want.astype(np.int32)))
    d = np.stack(diffs)
    print(f"{family} f32 {mode} engine vs JAX: max {d.max()}, > 0 on "
          f"{(d > 0).mean():.2e}, > 1 on {(d > 1).mean():.2e}")
    if family == "fsrgan":
        _assert_within(d, 2, 1, 5e-3) if q8 else _assert_within(d, 1, 0,
                                                                1e-3)
    else:
        _assert_within(d, 3, 1, 1e-2) if q8 else _assert_within(d, 1, 0,
                                                                5e-2)


@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
def test_qh8_without_calibration_raises(port, weights, family):
    h, w, brc = GEOM[family]
    with pytest.raises(ValueError, match="q8_calib_frame"):
        port("engine_qh8_without_calibration", *weights[family], h, w, brc,
             family=family)
