"""The port's TPU-probe counterparts (denoise_gan_tpu_torch/probes/) vs the
JAX probes' own Pallas kernels, run in interpret mode on the same inputs.
The port runs in a child process (tests/torch_process.py).

K9, tools/exp_vpu_peak.py: ``fma_kernel`` (256 steps of acc * 1.000001 +
1e-7) and ``roll_fma_kernel`` (128 steps of acc + roll(acc, 1, 1) *
0.999999) against ``fma_chain_reference`` and ``roll_fma_chain_reference``
on one numpy-seeded x.  Bound: max |port - JAX| <= iters * 2**-22 *
max |JAX|: per step the two may round up to two f32 ulps of the largest
value apart (the port rounds each multiply-add once, as the CUDA kernels'
fmaf; the JAX kernel in interpret mode as XLA's CPU backend computes it,
where a multiply and an add may each round), and the chain carries that on
(the roll chain's errors grow with its values).  Measured here: 0 for
both (XLA's CPU backend fuses the multiply-add too).  The port's single
rounding, ``fma_f32``, is held to the exactly rounded a * c + b on its own.

K6, tools/exp_int8_mosaic.py: the probe's ``_kernel_bf16`` and
``_kernel_i8`` in a pallas_call that also returns the whole y scratch (the
probe's own output is y[0:8, 0:128]) against ``dot_chain`` after 0 to 3
steps at every K.  int8 must be equal; bf16 within t bf16 ulps of
max |JAX| at step t: each step's sums round to bf16 from f32 in XLA and
from float64 in the port, one rounding apart at most, and later steps carry
those differences (measured: 0.5 ulp at step 3, K = 1152).
"""

import functools
import importlib.util
import os
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from torch_process import skip_without_torch, torch_process

skip_without_torch()


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), "..", "tools",
                           f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jvpu = _load("exp_vpu_peak")
jmos = _load("exp_int8_mosaic")

KS = [128, 384, 1152]
K9_SHAPES = [(16, 256), (8, 512)]


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


def _x(shape):
    return (np.random.default_rng(shape[1]).standard_normal(shape)
            * 1e-3).astype(np.float32)


def _pallas_k9(kernel, x):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(x))


def _check_k9(got, want, iters):
    d = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"max |d| {d:.3e} = {d / scale:.3e} of max |JAX| {scale:.3e}")
    assert np.isfinite(want).all()
    assert d <= iters * 2.0 ** -22 * scale


@pytest.mark.parametrize("shape", K9_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fma_chain_matches_pallas(port, shape):
    x = _x(shape)
    _check_k9(port("probe_fma_reference", x, jvpu.ITERS),
              _pallas_k9(jvpu.fma_kernel, x), jvpu.ITERS)


@pytest.mark.parametrize("shape", K9_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_roll_fma_chain_matches_pallas(port, shape):
    x = _x(shape)
    _check_k9(port("probe_roll_fma_reference", x, jvpu.ITERS // 2),
              _pallas_k9(jvpu.roll_fma_kernel, x), jvpu.ITERS // 2)


def _round_f32(q):
    """The float32 nearest the rational q, ties to an even significand."""
    f = np.float32(float(q))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda c: (abs(Fraction(float(c)) - q),
                                    int(np.float32(c).view(np.uint32)) & 1))


def test_fma_f32_rounds_once(port):
    """fma_f32(a, c, b) against the exactly rounded a * c + b, for the
    probes' two constants on random a and b of magnitudes 1e-8 to 1e8, and
    for a case where rounding to float64 first gives another float32:
    a * c + b = 1 + 2**-24 + 2**-60, which float64 rounds to the float32
    midpoint 1 + 2**-24 and then to 1; rounded once it is 1 + 2**-23."""
    rng = np.random.default_rng(7)

    def draw(n):
        return (rng.standard_normal(n)
                * 10.0 ** rng.integers(-8, 9, n)).astype(np.float32)

    hard_a = np.float32(2.0 ** -24 * (1 + 2.0 ** -12))
    hard_c = np.float32(1 - 2.0 ** -12 + 2.0 ** -24)
    cases = [(draw(1000), np.float32(1.000001), draw(1000)),
             (draw(1000), np.float32(0.999999), draw(1000)),
             (np.array([hard_a, -hard_a], np.float32), hard_c,
              np.array([1, -1], np.float32))]
    for a, c, b in cases:
        got = port("probe_fma_f32", a, c, b)
        want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(c))
                                    + Fraction(float(y)))
                         for x, y in zip(a, b)], np.float32)
        np.testing.assert_array_equal(got, want)
    assert want.tolist() == [1 + 2.0 ** -23, -(1 + 2.0 ** -23)]
    naive = (a.astype(np.float64) * float(c) + b).astype(np.float32)
    assert naive.tolist() == [1.0, -1.0]


@functools.lru_cache(maxsize=None)
def _pallas_k6(dtype, k, iters):
    """The probe's kernel after `iters` steps in interpret mode: (its own
    (8, 128) output, the whole y scratch), f32."""
    kernel, jdt = {"bf16": (jmos._kernel_bf16, jnp.bfloat16),
                   "int8": (jmos._kernel_i8, jnp.int8)}[dtype]

    def wrapped(o_ref, y_out, y):
        kernel(o_ref, y, K=k, iters=iters)
        y_out[:] = y[:].astype(jnp.float32)

    out, y = pl.pallas_call(
        wrapped,
        out_shape=(jax.ShapeDtypeStruct((8, 128), jnp.float32),
                   jax.ShapeDtypeStruct((k, jmos.M), jnp.float32)),
        scratch_shapes=[pltpu.VMEM((k, jmos.M), jdt)], interpret=True)()
    out, y = np.asarray(out), np.asarray(y)
    assert np.array_equal(out, y[:8, :128])
    return y


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_initial_state_matches_pallas(port, dtype, k):
    y, w = port("probe_initial_state", k, dtype)
    assert y.shape == (k, jmos.M) and w.shape == (k, 128)
    np.testing.assert_array_equal(y.astype(np.float32),
                                  _pallas_k6(dtype, k, 0))
    # w never leaves the JAX kernel; one step from the common y pins it
    # (test_dot_chain_matches_pallas), and here its closed form
    r, n = np.arange(k)[:, None], np.arange(128)[None, :]
    if dtype == "int8":
        np.testing.assert_array_equal(w, (r - n) % 125)
    else:
        want = np.asarray(jnp.asarray((r - n).astype(np.float32)
                                      * np.float32(1e-3), jnp.bfloat16))
        np.testing.assert_array_equal(w, want.astype(np.float32))


@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_dot_chain_matches_pallas(port, dtype, k, steps):
    got = port("probe_dot_chain", k, steps, dtype)
    want = _pallas_k6(dtype, k, steps)
    assert got.shape == want.shape == (k, jmos.M)
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
        return
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    d = float(np.abs(got - want).max())
    print(f"max |d| {d} = {d / ulp:.2f} bf16 ulps of max |JAX| {scale}")
    assert np.isfinite(want).all()
    assert d <= steps * ulp


def test_wrappers_run_plain_versions_on_cpu(port):
    equal, launched = port("probe_wrappers_on_cpu")
    assert all(equal.values()), equal
    assert not any(launched.values()), launched


def test_entry_points_raise_without_gpu(port):
    raised = port("probe_entry_points_without_gpu")
    assert set(raised.values()) == {"RuntimeError"}, raised


@pytest.mark.parametrize("bad", ["dtype", "w_shape", "short_k"])
def test_dot_chain_refuses_bad_input(port, bad):
    with pytest.raises(ValueError):
        port("probe_dot_chain_bad_input", bad)
