"""The fused tails' qh8 mode and canvas epilogue (ops/tail.py,
ops/tail_srgan.py) vs the JAX package's Pallas tails, run in interpret mode
as tests/test_pallas_tail.py runs them, for both families.  The port runs
in two child processes (tests/torch_process.py), every twin of it started
before the JAX tails run here.

qh8: the body output h reaches the tail as int8, one step size per channel
(calibrate_h_scales), and up1 sums int8 x int8 with the step sizes folded
into W1 (prep_weights_qh8, make_h3_q8).  Every sum after the input is then
an exact integer (the twin's f32 sums of integers are exact), so the twin
matches the JAX kernel byte for byte for FSRGAN.  For SRGAN the target is
the same and the bound max 1 on < 1e-3; measured max 1 on 2.2e-5 of the
bytes, so the target does not hold at this seed.

Canvas: the bf16 tanh before the u8 epilogue (build_fused_tail), compared
after depth_to_space(4).  Not bit-identical in any mode: XLA's f32 tanh on
the CPU is not PyTorch's, and where tanh(y) lies near a bf16 rounding
boundary the two round one ulp apart; bf16 also differs where the f32 sums
round apart, and near 0 one f32 rounding is many bf16 ulps.  Share of
values that differ, and the max difference, measured by
test_canvas_twin_matches_jax_kernel: FSRGAN bf16 5.5e-4 (max 2**-9), w8a8
4.3e-5 (2**-11), qh8 5.1e-5 (2**-10); SRGAN bf16 3.0e-3 (2**-8), w8a8
3.2e-4 (9.8e-3; also up1's f32 summation order, tests/
test_torch_tail_srgan.py), qh8 7.2e-5 (5.9e-3).  In SRGAN's int8 modes an
activation that the two tails put on either side of an int8 rounding
boundary moves the output by a few ulps.  Bounds: < 1e-3 of the values
differ in the int8 modes, < 5e-3 in bf16; the max difference is one bf16
rounding at the top of tanh's range (2**-8), and 2**-6 for SRGAN's int8
modes; and through the engine's u8 steps the canvases agree within max 1
on < 1e-3 of the bytes, the bound of the u8 epilogue.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.models.fsrgan import FSRGANTail as JTail  # noqa: E402
from denoise_gan_tpu.models.srgan import SRGANTail as JTail64  # noqa: E402
from denoise_gan_tpu.ops.pallas import tail as jtail  # noqa: E402
from denoise_gan_tpu.ops.pallas import tail_srgan as jts  # noqa: E402

NY, NX, BRC, CR = 1, 2, 12, 24
FAMILIES = ["fsrgan", "srgan"]
MODES = ["bf16", "w8a8", "qh8"]
CIN = {"fsrgan": 32, "srgan": 64}


def _reseed(tree, rng, kernels):
    """Redraw biases and PReLU slopes (init leaves them zero, which would
    hide a mis-mapped leaf) and, with `kernels`, the kernels at N(0,
    1/fan_in) (SRGAN's N(0, 0.02) init makes a flat image)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _reseed(v, rng, kernels)
        elif k == "kernel":
            out[k] = (rng.standard_normal(v.shape)
                      / np.sqrt(np.prod(v.shape[:-1])) if kernels
                      else np.asarray(v)).astype(np.float32)
        elif k == "bias":
            out[k] = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
        else:
            out[k] = rng.uniform(0.05, 0.3, v.shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def port():
    with torch_process(workers=2) as call:
        yield call


@pytest.fixture(scope="module")
def setups():
    """Per family: the tail params, and the same bf16 tiles for JAX and as
    f32 (exact) for the port."""
    out = {}
    for family, cls in (("fsrgan", JTail), ("srgan", JTail64)):
        cin = CIN[family]
        p = cls().init(jax.random.key(0), jnp.zeros((1, 8, 8, cin)))["params"]
        params = _reseed(p, np.random.default_rng(7), family == "srgan")
        h = np.random.default_rng(3).standard_normal(
            (NY * NX, CR + 4, jtail.T, cin)) * 0.5
        hj = jnp.asarray(h, jnp.bfloat16)
        out[family] = (params, hj, np.asarray(hj.astype(jnp.float32)))
    return out


@pytest.fixture(scope="module")
def started(port, setups):
    """The port's twins, started in the children at once, in the order the
    tests read them: {(test, family, mode): future of twin's (frame,
    q8)}."""
    out = {}
    full = (NY, NX, NY * CR, NX * jtail.CORE)
    ragged = (NY, NX, NY * CR - 5, NX * jtail.CORE - 7)
    for family in FAMILIES:
        params, _, hf = setups[family]
        out[("qh8", family, "qh8")] = port.submit(
            "twin", params, hf, *full, family=family, mode="qh8")
    for family in FAMILIES:
        params, _, hf = setups[family]
        for mode in MODES:
            out[("canvas", family, mode)] = port.submit(
                "twin", params, hf, *full, family=family, mode=mode,
                canvas=True)
    for family in FAMILIES:
        params, _, hf = setups[family]
        for mode in MODES:
            for canvas in (False, True):
                out[("ragged", family, mode, canvas)] = port.submit(
                    "twin", params, hf, *ragged, family=family, mode=mode,
                    canvas=canvas)
    return out


def _jax_weights(family, params, sh):
    """The JAX package's qh8 weights (prep_weights_qh8 and its SRGAN twin)
    for the h step sizes sh."""
    if family == "fsrgan":
        return jtail.prep_weights_qh8(
            jtail.prep_weights_q8(jtail.prep_weights(params)), sh)
    return jts.prep_weights_srgan_qh8(
        jts.prep_weights_srgan_q8(jts.prep_weights_srgan(params)), sh)


def _jax_kw(mode, hj):
    return {} if mode == "bf16" else {
        "q8_calib": hj.astype(jnp.float32), "qh8": mode == "qh8"}


def _jax_u8(family, params, hj, mode):
    build = (jtail.build_fused_tail_u8 if family == "fsrgan"
             else jts.build_fused_tail64_u8)
    out = build(params, NY, NX, brc=BRC, core_rows=CR, interpret=True,
                **_jax_kw(mode, hj))(hj)
    return np.asarray(out).reshape(NY * CR * 4, NX * jtail.CORE * 4, 3)


def _jax_canvas(family, params, hj, mode):
    """build_fused_tail's (ny*cr, nx*120, 48) canvas, depth_to_space(4)."""
    build = (jtail.build_fused_tail if family == "fsrgan"
             else jts.build_fused_tail64)
    c = np.asarray(build(params, NY, NX, brc=BRC, core_rows=CR,
                         interpret=True, **_jax_kw(mode, hj))(hj)
                   .astype(jnp.float32))
    hc, wc = c.shape[:2]
    return c.reshape(hc, wc, 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(
        hc * 4, wc * 4, 3)


def _engine_u8(canvas):
    """The engine's u8 steps on a canvas: trunc(clip((x + 1) / 2, 0, 1) *
    255 + 0.5), in f32."""
    x = np.clip((canvas.astype(np.float32) + np.float32(1)) / np.float32(2),
                0, 1)
    return (x * np.float32(255) + np.float32(0.5)).astype(np.uint8)


@pytest.mark.parametrize("family", FAMILIES)
def test_h_scales_equal_jax(port, setups, family):
    _, hj, hf = setups[family]
    want = jtail.calibrate_h_scales(hj.astype(jnp.float32),
                                    margin=jtail.Q8_MARGIN)
    got = port("h_scales", hf)
    assert got.dtype == np.float32 and got.shape == (CIN[family],)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", FAMILIES)
def test_qh8_weights_equal_jax(port, setups, family):
    """W1 with the h step sizes folded in, int8 per output channel, and its
    scales equal prep_weights_qh8's (W1q, s1n) exactly after unpacking."""
    params, hj, hf = setups[family]
    sh = jtail.calibrate_h_scales(hj.astype(jnp.float32),
                                  margin=jtail.Q8_MARGIN)
    jw = _jax_weights(family, params, sh)
    got = port("qh8_weights", params, hf, family=family)
    assert got["mode"] == "qh8" and got["h_dtype"] == "torch.int8"
    np.testing.assert_array_equal(got["w1"], jw["W1q"])
    np.testing.assert_array_equal(got["s1"], jw["s1n"][:, 0])
    np.testing.assert_array_equal(got["inv_sh"],
                                  np.asarray(1.0 / sh, np.float32))


@pytest.mark.parametrize("family", FAMILIES)
def test_quantize_h_equals_make_h3_q8(port, setups, family):
    """quantize_h is make_h3_q8 without its layout: (N, C, (TR+6)*128)
    channel-major rows padded by 3 rows and cols [-1, 127)."""
    params, hj, hf = setups[family]
    cin, tr = CIN[family], CR + 4
    sh = jtail.calibrate_h_scales(hj.astype(jnp.float32),
                                  margin=jtail.Q8_MARGIN)
    h3 = np.asarray(jtail.make_h3_q8(hj, sh, cin=cin))
    want = h3.reshape(NY * NX, cin, tr + 6, 128)[:, :, 3:3 + tr,
                                                 1:1 + jtail.T]
    got = port("quantized_h", params, hf, family=family)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want.transpose(0, 2, 3, 1))
    assert np.abs(got).max() >= 100         # the grid is used, not flat


@pytest.mark.parametrize("family", FAMILIES)
def test_qh8_twin_matches_jax_kernel(started, setups, family):
    params, hj, _ = setups[family]
    want = _jax_u8(family, params, hj, "qh8")
    got, q8 = started[("qh8", family, "qh8")].result()
    assert q8 and got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"{family} qh8 u8: max {d.max()}, bytes differing "
          f"{(d > 0).mean():.1e}")
    if family == "fsrgan":
        assert d.max() == 0, (d.max(), (d > 0).mean())
    else:
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(),
                                                        (d > 0).mean())
    assert got.std(axis=(0, 1)).min() > 5      # not a constant image


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", FAMILIES)
def test_canvas_twin_matches_jax_kernel(started, setups, family, mode):
    params, hj, _ = setups[family]
    want = _jax_canvas(family, params, hj, mode)
    got, _ = started[("canvas", family, mode)].result()
    assert got.shape == want.shape == (NY * CR * 4, NX * jtail.CORE * 4, 3)
    frac = (got != want).mean()
    dmax = np.abs(got - want).max()
    print(f"{family} {mode} canvas: values differing {frac:.1e}, max "
          f"{dmax:.3e}")
    assert frac < (5e-3 if mode == "bf16" else 1e-3), frac
    assert dmax <= (2.0 ** -6 if family == "srgan" and mode != "bf16"
                    else 2.0 ** -8), dmax
    d = np.abs(_engine_u8(got).astype(np.int32) - _engine_u8(want))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    assert np.abs(got).max() <= 1 and got.std(axis=(0, 1)).min() > 0.02


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", FAMILIES)
def test_u8_epilogue_is_canvas_with_engine_steps(started, family, mode):
    """The port's u8 epilogue vs its canvas followed by the engine's u8
    steps, trunc(clip((x + 1) / 2, 0, 1) * 255 + 0.5): the JAX package's
    bound for the same pair, max 1 on < 1e-3 (test_pallas_tail.py:214-218;
    the kernel rounds (x + 1) * 127.5 + 0.5, the steps twice more)."""
    u8, _ = started[("ragged", family, mode, False)].result()
    canvas, _ = started[("ragged", family, mode, True)].result()
    d = np.abs(u8.astype(np.int32) - _engine_u8(canvas))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("bad", ["canvas_bgr", "qh8_bfloat16_h",
                                 "w8a8_int8_h", "bf16_int8_h"])
@pytest.mark.parametrize("family", FAMILIES)
def test_wrappers_refuse(port, setups, family, bad):
    """The canvas wrapper refuses BGR (the JAX engine's canvas path does,
    kernel_engine.py:112-114); every wrapper refuses an h whose dtype the
    weights' mode does not take (int8 for qh8, else bf16)."""
    params, _, hf = setups[family]
    with pytest.raises(ValueError):
        port("wrapper_bad_input", params, hf, NY, NX, NY * CR,
             NX * jtail.CORE, bad, family=family)
