"""The port's coarse-tail rewrite (infer/fast.py) vs the JAX package's:
scatter_conv_kernel and d2s_perm equal exactly; build_fast_coarse and
build_fast_forward (bf16, the JAX default) for FSRGAN 4x and SRGAN 2x and
4x on two 32x32 tiles, and build_fast_forward's plain-module fallback
for a 1x family, on the same weights.  The port runs in a child process
(tests/torch_process.py).

Weights: kernels drawn with numpy from the JAX package's initialiser laws
(FSRGAN glorot-uniform, SRGAN N(0, 0.02)); biases, BN statistics and PReLU
slopes away from 0 and 1 (as tests/test_torch_engine.py redraws them).
The fallback's autoencoder takes glorot-uniform kernels too: at its own
He scale its bf16 output is as far from JAX's bf16 as JAX's is from f32
(tests/test_torch_models_1x.py holds it to that).  Bound: PERF.md
section 2's port-vs-JAX envelope for SRGAN and the K3 body, bf16 u8 max 1
on < 5% of the bytes (measured on the CPU: FSRGAN 1.9%, SRGAN 2x 0.7%, 4x
0.9%); the coarse output's phase channels, rearranged by one
depth_to_space, are the forward's output.  The bf16 coarse tail rounds
its activations where the fused tails of the kernel engines do not, so
the kernel engines' tighter FSRGAN envelope (< 1e-3) is not its bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.infer import fast as jfast  # noqa: E402
from denoise_gan_tpu.models import autoencoder as jae  # noqa: E402
from denoise_gan_tpu.models import fsrgan as jfsrgan  # noqa: E402
from denoise_gan_tpu.models import srgan as jsrgan  # noqa: E402
from denoise_gan_tpu.ops.image import depth_to_space  # noqa: E402

# (id, family, scale, Flax generator)
CASES = [("fsrgan-4x", "fsrgan", 4, jfsrgan.FSRGANGenerator()),
         ("srgan-2x", "srgan", 2, jsrgan.SRGANGenerator(scale=2)),
         ("srgan-4x", "srgan", 4, jsrgan.SRGANGenerator(scale=4))]
# JAX's build_fast_forward is its coarse tail with the final depth_to_space
# (fast.py:161-167, 207-251): the test runs (compiles) it for FSRGAN and
# takes depth_to_space of JAX's coarse output for SRGAN
JAX_FORWARD = {"fsrgan-4x"}


def _draw(tree, rng, family):
    """Numpy leaves for a Flax tree of shapes (see the module
    docstring)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _draw(v, rng, family)
            continue
        shape = v.shape
        if k == "kernel" and family == "srgan":
            a = rng.standard_normal(shape) * 0.02
        elif k == "kernel":
            fans = np.prod(shape[:-1]) + np.prod(shape[:-2]) * shape[-1]
            limit = np.sqrt(6.0 / fans)
            a = rng.uniform(-limit, limit, shape)
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


def _u8(y):
    return np.round((np.asarray(y, np.float32) + 1.0) * 127.5)


def _within_envelope(got, want, what):
    d = np.abs(_u8(got) - _u8(want))
    print(f"{what}: u8 max {d.max()}, > 0 on {(d > 0).mean():.4f}")
    assert d.max() <= 1 and (d > 0).mean() < 5e-2


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


@pytest.mark.parametrize("m", [1, 2, 4])
def test_scatter_conv_kernel_and_d2s_perm_equal_jax(port, rng, m):
    for shape in ((3, 3, 5, 8), (1, 1, 6, 3), (5, 5, 2, 4)):
        w = rng.standard_normal(shape).astype(np.float32)
        k, p = port("scatter_and_perm", w, m, shape[-1])
        np.testing.assert_array_equal(k, jfast.scatter_conv_kernel(w, m))
        np.testing.assert_array_equal(p, jfast.d2s_perm(m, shape[-1]))


@pytest.mark.parametrize("name,family,scale,gen", CASES,
                         ids=[c[0] for c in CASES])
def test_fast_paths_match_jax(port, name, family, scale, gen):
    rng = np.random.default_rng(scale)
    v = jax.eval_shape(lambda: gen.init(jax.random.key(0), jnp.zeros(
        (1, 16, 16, 3)), train=False))
    params, stats = (_draw(v[k], rng, family)
                     for k in ("params", "batch_stats"))
    x = (rng.random((2, 32, 32, 3)) * 2 - 1).astype(np.float32)
    config = {"family": family, "scale": scale}
    coarse, s = jfast.build_fast_coarse(config, params, stats)
    assert s == scale
    want_coarse = np.asarray(jax.jit(coarse)(x))
    if name in JAX_FORWARD:
        want = np.asarray(jfast.build_fast_forward(config, params, stats)(x))
    else:
        want = np.asarray(depth_to_space(jnp.asarray(want_coarse), scale))
    got_coarse, got_s, got = port("fast_paths", family, scale, params,
                                  stats, x)
    assert got_s == scale
    assert got_coarse.shape == (2, 32, 32, 3 * scale * scale)
    assert got.shape == (2, 32 * scale, 32 * scale, 3)
    _within_envelope(got_coarse, want_coarse, f"{name} coarse")
    _within_envelope(got, want, f"{name} forward")
    np.testing.assert_array_equal(
        np.asarray(depth_to_space(jnp.asarray(got_coarse), scale)), got)


def test_fast_forward_1x_falls_back_to_the_plain_module(port):
    """build_fast_coarse has no path for a 1x family (ValueError; the JAX
    function means to raise one too, but reads the missing tail first);
    build_fast_forward runs its plain module in bf16."""
    rng = np.random.default_rng(1)
    v = jax.eval_shape(lambda: jae.AutoencoderGenerator().init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    v = {"params": _draw(v["params"], rng, "autoencoder")}
    x = (rng.random((2, 32, 32, 3)) * 2 - 1).astype(np.float32)
    config = {"family": "autoencoder", "scale": 1}
    want = np.asarray(jfast.build_fast_forward(config, v["params"], {})(x))
    message, s, got = port("fast_paths", "autoencoder", 1, v["params"], None,
                           x)
    assert "no coarse path" in message and s is None
    _within_envelope(got, want, "autoencoder bf16 forward")
