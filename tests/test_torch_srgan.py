"""Port SRGAN generator (models/srgan.py) vs Flax apply(train=False), weights
carried across with from_jax_params.  f32: atol 1e-4 (conftest forces f32
matmuls on the JAX side), at 2 and at 16 residual blocks.  bf16: atol 3e-2,
the bf16 resolution of the tanh range, as tests/test_torch_fsrgan.py.  The
port runs in a child process (tests/torch_process.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.models import srgan as jsrgan  # noqa: E402

ATOL = {"f32": 1e-4, "bf16": 3e-2}
JDTYPES = {"f32": None, "bf16": jnp.bfloat16}


def _seeded(tree, rng, path=()):
    """Redraw every leaf of a Flax tree from numpy: N(0, 1/fan_in) kernels
    (half that in the residual blocks and the post-conv, so that 16 blocks
    neither blow up the body nor saturate tanh), small biases, BN
    statistics near identity, PReLU slopes in [0.05, 0.3]."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _seeded(v, rng, path + (k,))
            continue
        shape = np.shape(v)
        if k == "kernel":
            gain = 0.5 if "body" in path and path[-1] != "Conv_0" else 1.0
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
        out[k] = a.astype(np.float32)
    return out


def _variables(blocks, scale=4):
    v = jsrgan.SRGANGenerator(scale=scale, num_res_blocks=blocks).init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False)
    rng = np.random.default_rng(1)
    return ({"params": _seeded(v["params"], rng, ("gen",)),
             "batch_stats": _seeded(v["batch_stats"], rng, ("gen",))})


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


@pytest.fixture(scope="module")
def variables():
    return {blocks: _variables(blocks) for blocks in (2, 16)}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("blocks", [2, 16])
@pytest.mark.parametrize("part", ["body", "generator"])
def test_srgan_matches_flax(port, variables, rng, part, blocks, dt):
    v = variables[blocks]
    x = (rng.random((2, 36, 36, 3)) * 2 - 1).astype(np.float32)
    if part == "body":
        p, s = v["params"]["body"], v["batch_stats"]["body"]
        want = jsrgan.SRGANBody(blocks, dtype=JDTYPES[dt]).apply(
            {"params": p, "batch_stats": s}, x, train=False)
        shape = (2, 36, 36, 64)
    else:
        p, s = v["params"], v["batch_stats"]
        want = jsrgan.SRGANGenerator(num_res_blocks=blocks,
                                     dtype=JDTYPES[dt]).apply(
            {"params": p, "batch_stats": s}, x, train=False)
        shape = (2, 144, 144, 3)
    got = port("srgan_forward", part, p, s, x, dt, blocks)
    assert got.shape == shape
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=ATOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_srgan_tail_matches_flax(port, variables, rng, dt):
    h = (rng.standard_normal((2, 36, 36, 64)) * 0.5).astype(np.float32)
    p = variables[2]["params"]["tail"]
    want = np.asarray(jsrgan.SRGANTail(dtype=JDTYPES[dt]).apply(
        {"params": p}, h))
    got = port("srgan_forward", "tail", p, None, h, dt)
    assert got.shape == (2, 144, 144, 3)
    np.testing.assert_allclose(got, want, atol=ATOL[dt])


def test_from_jax_params_maps_srgan_tree(port, variables):
    """The body's 69 Flax modules map one to one: 34 bias-free convs, 34
    BatchNorms, one PReLU; the tail's convs keep their biases."""
    p, s = variables[16]["params"], variables[16]["batch_stats"]
    body = p["body"]
    assert len(body) == 69
    assert sum(k.startswith("Conv_") and set(v) == {"kernel"}
               for k, v in body.items()) == 34
    state = port("load_srgan", p, s)
    convs = [k for k in state if k.startswith("body.Conv_")]
    assert len(convs) == 34 and all(k.endswith(".weight") for k in convs)
    np.testing.assert_array_equal(
        state["body.Conv_33.weight"],
        body["Conv_33"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["body.BatchNorm_17.var"],
                                  s["body"]["BatchNorm_17"]["var"])
    assert state["tail.out_conv.weight"].shape == (3, 64, 1, 1)
    assert state["tail.up2.Conv_0.bias"].shape == (256,)


@pytest.mark.parametrize("scale", [1, 2, 8])
def test_srgan_scales_map_flax_trees(port, scale):
    """scale // 2 pixel-shuffle stages, as the Flax generator: its tree
    loads without a missing or unused leaf."""
    v = _variables(1, scale)
    state = port("load_srgan", v["params"], v["batch_stats"], scale, 1)
    assert sum(k.endswith("PReLU_0.alpha") and k.startswith("tail.")
               for k in state) == scale // 2


def test_from_jax_params_rejects_missing_srgan_leaf(port, variables):
    p = {k: dict(v) for k, v in variables[2]["params"].items()}
    del p["body"]["Conv_5"]
    with pytest.raises(KeyError, match="Conv_5"):
        port("load_srgan", p, variables[2]["batch_stats"], 4, 2)


def test_from_jax_params_rejects_stray_body_bias(port, variables):
    p = {k: dict(v) for k, v in variables[2]["params"].items()}
    p["body"]["Conv_3"] = dict(p["body"]["Conv_3"],
                               bias=np.zeros(64, np.float32))
    with pytest.raises(KeyError, match="Conv_3.bias"):
        port("load_srgan", p, variables[2]["batch_stats"], 4, 2)


def test_build_generator_srgan_seeded(port):
    """build_generator("srgan"): eval mode, one seed gives one model,
    kernels N(0, 0.02), BatchNorm scales N(1, 0.02), zero biases and
    slopes."""
    training, a, b = port("seeded_srgan", 5)
    assert not training
    assert list(a) == list(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])
    kernels = np.concatenate([v.ravel() for k, v in a.items()
                              if k.endswith(".weight")])
    gammas = np.concatenate([v for k, v in a.items()
                             if k.endswith(".scale")])
    assert abs(kernels.std() - 0.02) < 1e-3 and abs(kernels.mean()) < 1e-3
    assert abs(gammas.mean() - 1.0) < 3e-3 and abs(gammas.std() - 0.02) < 3e-3
    assert not any(v.any() for k, v in a.items()
                   if k.endswith((".bias", ".alpha", ".mean")))
    assert sum(k.endswith(".weight") for k in a) == 34 + 3
