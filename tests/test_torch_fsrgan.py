"""Port FSRGAN generator vs Flax apply(train=False), weights carried across
with from_jax_params.  f32: atol 1e-4 (conftest forces f32 matmuls on the
JAX side).  bf16: atol 3e-2, the bf16 resolution of the tanh range, as in
tests/test_pallas_tail.py.  The port runs in a child process
(tests/torch_process.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.models import fsrgan as jfsrgan  # noqa: E402

ATOL = {"f32": 1e-4, "bf16": 3e-2}


def _seeded(tree, rng):
    """Redraw every leaf of a Flax tree from numpy: glorot-scale kernels,
    small biases, BN statistics near identity, PReLU slopes in [0.05, 0.3]
    (init leaves zero biases, unit BN and zero slopes, which would hide a
    mis-mapped leaf)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _seeded(v, rng)
            continue
        shape = v.shape
        if k == "kernel":
            fan = np.prod(shape[:-1]) + np.prod(shape[:-2]) * shape[-1]
            a = rng.standard_normal(shape) * np.sqrt(2.0 / fan)
        elif k == "alpha":
            a = rng.uniform(0.05, 0.3, shape)
        elif k == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        elif k == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:                                   # bias, mean
            a = rng.standard_normal(shape) * 0.05
        out[k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


@pytest.fixture(scope="module")
def variables():
    gen = jfsrgan.FSRGANGenerator()
    v = gen.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False)
    rng = np.random.default_rng(1)
    return {"params": _seeded(v["params"], rng),
            "batch_stats": _seeded(v["batch_stats"], rng)}


JDTYPES = {"f32": None, "bf16": jnp.bfloat16}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_generator_matches_flax(port, variables, rng, dt):
    x = (rng.random((2, 36, 36, 3)) * 2 - 1).astype(np.float32)
    want = np.asarray(jfsrgan.FSRGANGenerator(dtype=JDTYPES[dt]).apply(
        variables, x, train=False), np.float32)
    got = port("generator_forward", variables["params"],
               variables["batch_stats"], x, dt)
    assert got.shape == (2, 144, 144, 3)
    np.testing.assert_allclose(got, want, atol=ATOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_body_matches_flax(port, variables, rng, dt):
    x = (rng.random((2, 36, 36, 3)) * 2 - 1).astype(np.float32)
    p, s = variables["params"]["body"], variables["batch_stats"]["body"]
    want = np.asarray(jfsrgan.FSRGANBody(dtype=JDTYPES[dt]).apply(
        {"params": p, "batch_stats": s}, x, train=False), np.float32)
    got = port("body_forward", p, s, x, dt)
    assert got.shape == (2, 36, 36, 32)
    np.testing.assert_allclose(got, want, atol=ATOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tail_matches_flax(port, variables, rng, dt):
    h = (rng.standard_normal((2, 36, 36, 32)) * 0.5).astype(np.float32)
    p = variables["params"]["tail"]
    want = np.asarray(jfsrgan.FSRGANTail(dtype=JDTYPES[dt]).apply(
        {"params": p}, h))
    got, dtype = port("tail_forward", p, h, dt)
    assert got.shape == (2, 144, 144, 3) and dtype == "torch.float32"
    np.testing.assert_allclose(got, want, atol=ATOL[dt])


def test_make_divisible_matches_jax(port):
    for v in (3, 8, 12, 20, 31, 32, 45, 100, 191):
        for d in (4, 8):
            assert port("make_divisible", v, d) == \
                jfsrgan._make_divisible(v, d)


def test_from_jax_params_rejects_missing_leaf(port, variables):
    p = {k: dict(v) for k, v in variables["params"].items()}
    del p["tail"]["out_conv"]
    with pytest.raises(KeyError, match="out_conv"):
        port("load_generator", p, variables["batch_stats"])


def test_from_jax_params_rejects_unused_leaf(port, variables):
    p = {k: dict(v) for k, v in variables["params"].items()}
    p["tail"]["extra"] = {"kernel": np.zeros((3, 3, 32, 3), np.float32)}
    with pytest.raises(KeyError, match="extra"):
        port("load_generator", p, variables["batch_stats"])


def test_from_jax_params_layouts(port, variables):
    """HWIO -> OIHW, depthwise (3,3,1,C) -> (C,1,3,3), BN/PReLU kept f32."""
    dw, var, var_dtype = port("generator_layouts", variables["params"],
                              variables["batch_stats"])
    ir = variables["params"]["body"]["InvertedResidual_1"]
    assert dw.shape == (192, 1, 3, 3)
    np.testing.assert_array_equal(
        dw, ir["depthwise"]["kernel"].transpose(3, 2, 0, 1))
    assert var_dtype == "torch.float32"
    np.testing.assert_array_equal(
        var, variables["batch_stats"]["body"]["InvertedResidual_1"]
        ["BatchNorm_2"]["var"])


def test_batchnorm_train_mode_not_ported(port):
    """Train-mode BatchNorm, which the generators' eval-only port left
    out, runs as Flax's: batch statistics, the running ones updated by
    Keras momentum (tests/test_torch_train_layers.py holds it in full)."""
    from denoise_gan_tpu.models.layers import BatchNorm as JBN
    x = np.random.default_rng(5).standard_normal((2, 3, 5, 4)).astype(
        np.float32) * 2 + 1
    y, mut = JBN().apply(JBN().init(jax.random.key(0), x, train=False), x,
                         train=True, mutable=["batch_stats"])
    got, mean, var = port("batchnorm_train_forward", x)
    np.testing.assert_allclose(got, np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(mean, mut["batch_stats"]["mean"], rtol=1e-5)
    np.testing.assert_allclose(var, mut["batch_stats"]["var"], rtol=1e-5)


def test_build_generator_seeded(port):
    """FSRGAN and the 1x families build in eval mode, equal twice from one
    seed; an unknown family raises ValueError, as JAX's build_models."""
    for family in ("fsrgan", "autoencoder", "pix2pix"):
        training, a, b = port("seeded_generators", 3, family)
        assert not training
        assert list(a) == list(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])
    with pytest.raises(ValueError, match="unknown model family"):
        port("build_family", "unet")


def test_build_generator_defaults_to_card(port):
    """With no device, build_generator runs on the card; without one it
    raises rather than falling back to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA"):
        port("build_default_device_without_gpu")
