"""The 1x denoise families of the port (models/autoencoder.py,
models/pix2pix.py) and their layers (models/layers.py: the stride-2 4x4
SAME conv, ConvTranspose, max_pool_same) vs Flax apply(train=False) and
flax.linen, weights carried across with from_jax_params (ConvTranspose
kernels flipped into conv_transpose2d's layout).  The port runs in a child
process (tests/torch_process.py).

Weights: the JAX package's kernel initialisers drawn with numpy
(autoencoder: he_normal ReLU convs, a lecun_normal tanh conv; pix2pix:
N(0, 0.02)), biases N(0, 0.05), BN running means N(0, 0.1), variances
U(0.5, 1.5), scales U(0.8, 1.2): running statistics away from 0 and 1.
One 128x128 autoencoder tile and one 256x256 pix2pix tile, full width.

Tolerances:
- f32: 1e-5 absolute on the tanh outputs (conftest forces f32 convs on
  the JAX side; the port's CPU tanh is single-threaded, ops/tail.py::
  _tanh, else it moves by up to 1.5e-5 from process to process).
- pix2pix bf16: PERF.md section 2's SRGAN envelope, u8 max 1 on < 5% of
  the bytes (measured max 1 on 1.2%).
- autoencoder bf16: the SRGAN envelope does not hold for JAX's own bf16
  generator either.  17 ReLU convs at He scale with no normalisation
  carry each bf16 rounding that two summation orders put apart into the
  next layers: here JAX's bf16 output is > 1 level from its f32 output on
  0.33% of the bytes, max 3, the port's on 0.37%, max 3 (with another
  draw of the same laws, 21% and max 8 for both).  The test holds the
  port's bf16 to being no farther from the f32 JAX generator than JAX's
  bf16 is: max within JAX's + 1, the share > 1 level within 1.25x JAX's
  + 1e-3 (ROADMAP C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.models import autoencoder as jae  # noqa: E402
from denoise_gan_tpu.models import pix2pix as jp2p  # noqa: E402
from denoise_gan_tpu.models.layers import max_pool_same  # noqa: E402

F32_ATOL = 1e-5
JDTYPES = {"f32": None, "bf16": jnp.bfloat16}
FAMILIES = {"autoencoder": (jae.AutoencoderGenerator, 128),
            "pix2pix": (jp2p.Pix2PixGenerator, 256)}


def _draw(tree, rng, family, path=()):
    """Numpy leaves for a Flax tree of shapes (see the module docstring)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _draw(v, rng, family, path + (k,))
            continue
        shape = v.shape
        if k == "kernel" and family == "pix2pix":
            a = rng.standard_normal(shape, np.float32) * np.float32(0.02)
        elif k == "kernel":
            last = path[-1] == "Conv_16"           # the tanh conv
            a = rng.standard_normal(shape, np.float32) * np.float32(np.sqrt(
                (1.0 if last else 2.0) / np.prod(shape[:-1])))
        elif k == "mean":
            a = rng.standard_normal(shape) * 0.1
        elif k == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif k == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        else:                                        # bias
            a = rng.standard_normal(shape) * 0.05
        out[k] = np.asarray(a, np.float32)
    return out


def _u8(y):
    return np.round((np.asarray(y, np.float32) + 1.0) * 127.5)


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


@pytest.fixture(scope="module")
def cases(port):
    """Per family: (weights, input, JAX outputs by dtype, port outputs by
    dtype), each JAX oracle computed once."""
    rng = np.random.default_rng(3)
    out = {}
    for family, (cls, n) in FAMILIES.items():
        shapes = jax.eval_shape(lambda: cls().init(
            jax.random.key(0), jnp.zeros((1, n, n, 3)), train=False))
        v = {k: _draw(t, rng, family) for k, t in shapes.items()}
        x = (rng.random((1, n, n, 3)) * 2 - 1).astype(np.float32)
        want = {dt: np.asarray(jax.jit(cls(dtype=jdt).apply, static_argnames=(
            "train",))(v, x, train=False), np.float32)
            for dt, jdt in JDTYPES.items()}
        got = port("generator_1x_forward", family, v["params"],
                   v.get("batch_stats"), [x], list(JDTYPES))
        out[family] = (v, x, want, {dt: g[0] for dt, g in got.items()})
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_generator_f32_matches_flax(cases, family):
    _, x, want, got = cases[family]
    assert got["f32"].shape == x.shape and got["f32"].dtype == np.float32
    np.testing.assert_allclose(got["f32"], want["f32"], atol=F32_ATOL)
    assert _u8(want["f32"]).std() > 5          # not a flat output


def test_pix2pix_bf16_within_srgan_envelope(cases):
    _, _, want, got = cases["pix2pix"]
    d = np.abs(_u8(got["bf16"]) - _u8(want["bf16"]))
    print(f"pix2pix bf16 port vs JAX: max {d.max()}, > 0 on "
          f"{(d > 0).mean():.4f}")
    assert d.max() <= 1 and (d > 0).mean() < 5e-2


def test_autoencoder_bf16_no_farther_from_f32_than_jax(cases):
    _, _, want, got = cases["autoencoder"]
    ref = _u8(want["f32"])
    dj = np.abs(_u8(want["bf16"]) - ref)
    dp = np.abs(_u8(got["bf16"]) - ref)
    print(f"autoencoder bf16 vs JAX f32: JAX max {dj.max()}, > 1 on "
          f"{(dj > 1).mean():.4f}; port max {dp.max()}, > 1 on "
          f"{(dp > 1).mean():.4f}")
    assert dp.max() <= dj.max() + 1
    assert (dp > 1).mean() <= 1.25 * (dj > 1).mean() + 1e-3


@pytest.mark.parametrize("size", [8, 9, 16, 17])
@pytest.mark.parametrize("kind", ["conv", "conv_transpose"])
def test_stride2_layers_match_flax(port, rng, kind, size):
    """4x4 stride-2 SAME conv and transpose conv at even and odd sizes
    (lax pads an odd total one more after than before)."""
    x = rng.standard_normal((2, size, size + 3, 5)).astype(np.float32)
    cls = nn.Conv if kind == "conv" else nn.ConvTranspose
    layer = cls(7, (4, 4), strides=(2, 2), padding="SAME")
    v = layer.init(jax.random.key(size), x)
    v = {"params": {"kernel": v["params"]["kernel"],
                    "bias": rng.standard_normal(7).astype(np.float32)}}
    want = np.asarray(layer.apply(v, x))
    got = port("layer_forward", kind, x, np.asarray(v["params"]["kernel"]),
               v["params"]["bias"], stride=2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


@pytest.mark.parametrize("size", [(9, 13), (16, 6)])
def test_max_pool_same_matches_flax(port, rng, size):
    x = rng.standard_normal((2,) + size + (4,)).astype(np.float32)
    got = port("layer_forward", "max_pool", x)
    np.testing.assert_array_equal(got, np.asarray(max_pool_same(x)))


def test_cuda_entry_points_raise_without_gpu(port):
    """build_generator of every family (SRGAN at 2x and 4x) and
    build_frame_engine at its default device raise RuntimeError when no
    GPU is present: nothing falls back to the CPU."""
    messages = port("cuda_requests_1x")
    assert len(messages) == 6
    for m in messages:
        assert m is not None and "CUDA" in m
