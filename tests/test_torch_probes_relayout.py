"""The port's K8 and K10 probes (denoise_gan_tpu_torch/probes/relayout.py,
u8_store.py) vs the JAX probes' own Pallas kernels, run in interpret mode
on the same inputs.  The port runs in a child process
(tests/torch_process.py).

K8, tools/exp_relayout.py: ``mm_kernel`` in both operand forms, in a
pallas_call that also returns the dot's whole result (the probe's own
output is the serial sum of y[0, 0] over its 64 reps), against
``matmul_form`` on the same bf16 operands, drawn by the probe's recipe.
Bound per element: |d| <= K * 2**-24 * sum_k |x_k w_k|, XLA's f32
summation order against the port's ideal accumulator (float64, rounded
once); the scalar within 64 times y[0, 0]'s bound plus 64 f32 ulps of
|acc|.  ``tk`` (local to the probe's main(), so copied here line for line
and held to the file's text) against ``transpose_chain_reference``: bit
for bit, one f32 multiply per iteration on both sides.

K10, tools/exp_u8_store.py: ``kernel`` against ``u8_phase_store`` on the
probe's seeded (1024, 48) input, and on a (256, 48) input from another
seed, which the kernel (written for 1024 rows) takes as the first two of
its eight bands.  Bound: max 1 level on <= 1e-3 of the bytes, the
XLA-CPU-vs-PyTorch tanh difference; and the JAX kernel within the same
bound of the probe's own numpy reference (:37-38), which pins the
direction of its lane roll.
"""

import functools
import importlib.util
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from torch_process import skip_without_torch, torch_process

skip_without_torch()


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), "..", "tools",
                           f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jrel = _load("exp_relayout")
ju8 = _load("exp_u8_store")

# (M, K, N): two of the probe's depths at small M, and an M that is not a
# multiple of 16
MM_SHAPES = [(64, 384, 128), (48, 1152, 48), (37, 384, 48)]
FORMS = ["canonical", "sublane"]
TK_SHAPES = [(1536, 128), (96, 64)]


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


@functools.lru_cache(maxsize=None)
def _pallas_k8(form, m, k, n):
    """The probe's mm_kernel in interpret mode on operands drawn by its
    recipe (exp_relayout.py:57-62): (x, w as f32, its (1, 1) output, the
    whole f32 product)."""
    rng = np.random.default_rng(m * k + n)
    xs = (m, k) if form == "canonical" else (k, m)
    x = jnp.asarray(rng.standard_normal(xs) * .01, jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((k, n)) * .01, jnp.bfloat16)
    dims = (((1,), (0,)), ((), ())) if form == "canonical" \
        else (((0,), (0,)), ((), ()))

    def wrapped(x_ref, w_ref, o_ref, y_ref):
        jrel.mm_kernel(x_ref, w_ref, o_ref, form)
        a, b = (x_ref, w_ref) if form == "canonical" else (w_ref, x_ref)
        y_ref[:] = jax.lax.dot_general(a[:], b[:], dims,
                                       preferred_element_type=jnp.float32)

    ys = (m, n) if form == "canonical" else (n, m)
    out, y = pl.pallas_call(
        wrapped, out_shape=(jax.ShapeDtypeStruct((1, 1), jnp.float32),
                            jax.ShapeDtypeStruct(ys, jnp.float32)),
        interpret=True)(x, w)
    return (np.asarray(x.astype(jnp.float32)),
            np.asarray(w.astype(jnp.float32)), float(np.asarray(out)[0, 0]),
            np.asarray(y))


@pytest.mark.parametrize("shape", MM_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("form", FORMS)
def test_matmul_form_matches_pallas(port, form, shape):
    x, w, want_acc, want = _pallas_k8(form, *shape)
    acc, y = port("probe_matmul_form", x, w, form, jrel.REPS)
    assert y.shape == want.shape
    ax, aw = np.abs(x.astype(np.float64)), np.abs(w.astype(np.float64))
    s = ax @ aw if form == "canonical" else aw.T @ ax
    bound = shape[1] * 2.0 ** -24 * s
    d = np.abs(y.astype(np.float64) - want)
    acc_bound = jrel.REPS * (bound[0, 0] + 2.0 ** -23 * abs(want_acc))
    print(f"max |dy| {d.max():.3e}, {(d / bound).max():.3f} of the bound; "
          f"acc {acc!r} vs JAX {want_acc!r}, |d| {abs(acc - want_acc):.3e} "
          f"of bound {acc_bound:.3e}")
    assert np.isfinite(want).all() and (d <= bound).all()
    assert abs(acc - want_acc) <= acc_bound


def _tk(x_ref, o_ref):
    """tools/exp_relayout.py:119-124, ``tk`` (a closure of main())."""
    def body(_, acc):
        t = jnp.swapaxes(acc, 0, 1) * jnp.float32(1.000001)
        return jnp.swapaxes(t, 0, 1)

    o_ref[:] = jax.lax.fori_loop(0, 8, body, x_ref[:])  # 16 transposes


def test_tk_copy_matches_probe_source():
    src = inspect.getsource(jrel.main)
    for line in inspect.getsource(_tk).splitlines()[2:]:
        assert line.strip() in src, line


@pytest.mark.parametrize("shape", TK_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_transpose_chain_matches_pallas(port, shape):
    x = np.random.default_rng(shape[0]).standard_normal(shape).astype(
        np.float32)
    want = np.asarray(pl.pallas_call(
        _tk, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        interpret=True)(x))
    got = port("probe_transpose_chain", x, 8)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(want, x)


@functools.lru_cache(maxsize=None)
def _pallas_k10(seed, rows):
    """The probe's kernel in interpret mode on (1024, 48) standard normal
    f32 from default_rng(seed); the (rows, 48) input that fills its first
    rows / 128 bands, and those bands' output."""
    x = np.random.default_rng(seed).standard_normal((1024, 48)).astype(
        np.float32)
    out = np.asarray(pl.pallas_call(
        ju8.kernel,
        out_shape=jax.ShapeDtypeStruct((8, 4, 128, 12), jnp.uint8),
        interpret=True)(x))
    return x[:rows], out[:rows // 128]


def _u8_diff(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("seed,rows", [(0, 1024), (1, 256)])
def test_u8_store_matches_pallas(port, seed, rows):
    x, want = _pallas_k10(seed, rows)
    got = port("probe_u8_store", x)
    assert got.shape == want.shape == (rows // 128, 4, 128, 12)
    assert got.dtype == np.uint8
    mx, frac = _u8_diff(got, want)
    print(f"port vs JAX: max {mx}, differing {frac:.2e}")
    assert mx <= 1 and frac <= 1e-3


@pytest.mark.parametrize("seed,rows", [(0, 1024), (1, 256)])
def test_pallas_u8_store_matches_probe_reference(seed, rows):
    """The JAX kernel against exp_u8_store.py:37-38, so that the roll's
    direction is held by the probe's own reference."""
    x, got = _pallas_k10(seed, rows)
    ref = np.clip((np.tanh(x) + 1) * 0.5, 0, 1) * 255 + 0.5
    ref = ref.astype(np.uint8).reshape(-1, 128, 4, 12).transpose(0, 2, 1, 3)
    mx, frac = _u8_diff(got, ref)
    print(f"JAX vs the probe's reference: max {mx}, differing {frac:.2e}")
    assert mx <= 1 and frac <= 1e-3
    # a roll the other way would put phase 4 - eo where eo belongs
    swapped = ref[:, [0, 3, 2, 1]]
    assert _u8_diff(got, swapped)[1] > 0.4


def test_wrappers_run_plain_versions_on_cpu(port):
    equal, launched = port("probe_relayout_wrappers_on_cpu")
    assert all(equal.values()), equal
    assert not any(launched.values()), launched


def test_entry_points_raise_without_gpu(port):
    raised = port("probe_relayout_entry_points_without_gpu")
    assert set(raised.values()) == {"RuntimeError"}, raised


@pytest.mark.parametrize("bad", ["dtype", "form", "x_shape", "reps",
                                 "u8_cols", "u8_rows", "u8_dtype"])
def test_wrappers_refuse_bad_input(port, bad):
    with pytest.raises(ValueError):
        port("probe_relayout_bad_input", bad)
