"""Port SRGAN fused tail (ops/tail_srgan.py: weight prep, calibration, the
CUDA kernel's plain twin and its wrapper) vs the JAX package's Pallas SRGAN
tail, run in interpret mode as tests/test_pallas_tail_srgan.py runs it.  The
port runs in a child process (tests/torch_process.py).

On the u8 output, both modes: max |diff| <= 1 on < 1e-3 of the bytes,
tighter than the JAX package's w8a8 envelope (max <= 2, > 1 on < 5e-3).
bf16 differs by summation order only.  w8a8's sums after up1 are exact
integers, but the twin sums up1's 576 products in f32 in K1's order, and
XLA's dot in another: 76% of the u1 sums differ in their last bits, and one
int8 u1 level in 1.6 million flips, which moves 9.4e-5 of the bytes by 1 at
this seed (measured; ROADMAP.md C).  The last two tests hold the exact-sum
input (ops/tail_srgan.py::dyadic_up1_, dyadic_h) to its name: there every
order gives the same u1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.models.srgan import SRGANTail as JTail  # noqa: E402
from denoise_gan_tpu.ops.pallas import tail as jtail  # noqa: E402
from denoise_gan_tpu.ops.pallas import tail_srgan as jts  # noqa: E402

NY, NX, BRC, CR = 1, 2, 12, 24
CIN = 64


def _reseed(tree, rng):
    """Redraw kernels at N(0, 1/fan_in) (the N(0, 0.02) init makes a flat
    image), biases and PReLU slopes (init leaves them zero, which would hide
    a mis-mapped leaf)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _reseed(v, rng)
        elif k == "kernel":
            out[k] = (rng.standard_normal(v.shape)
                      / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
        elif k == "bias":
            out[k] = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
        else:
            out[k] = rng.uniform(0.05, 0.3, v.shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


@pytest.fixture(scope="module")
def tail_params():
    p = JTail().init(jax.random.key(0), jnp.zeros((1, 8, 8, CIN)))["params"]
    return _reseed(p, np.random.default_rng(7))


@pytest.fixture(scope="module")
def h_tiles():
    """The same bf16 tiles for JAX, and as f32 (exact) for the port."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((NY * NX, CR + 4, jtail.T, CIN)) * 0.5
    hj = jnp.asarray(h, jnp.bfloat16)
    return hj, np.asarray(hj.astype(jnp.float32))


def _u8_diff(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return d.max(), (d > 0).mean()


def test_q8_weights_equal_jax_packed(port, tail_params):
    """The port's per-conv-channel int8 weights and scales equal the JAX
    b-split packed ones (prep_weights_srgan_q8) after unpacking the packing
    loops of prep_weights_srgan (tail_srgan.py:68-90)."""
    jw = jts.prep_weights_srgan_q8(jts.prep_weights_srgan(tail_params))
    tw = port("q8_weights", tail_params, family="srgan")
    W2q, W3q, s2w, s3w = tw["W2q"], tw["W3q"], tw["s2w"], tw["s3w"]
    assert W2q.shape == (3, 3, CIN, 256) and W3q.shape == (1, 1, CIN, 3)
    for b in range(2):
        for a2 in range(2):
            for b2 in range(2):
                q0 = (a2 * 2 + b2) * CIN
                cols = slice(b2 * CIN, (b2 + 1) * CIN)
                np.testing.assert_array_equal(jw["s2n"][b, a2, cols, 0],
                                              s2w[q0:q0 + CIN])
                for du in range(3):
                    for dv in range(3):
                        k0 = (du * 3 + dv) * CIN
                        np.testing.assert_array_equal(
                            jw["W2q"][b, a2, k0:k0 + CIN, cols],
                            W2q[du, dv, :, q0:q0 + CIN])
    for ph in range(16):
        np.testing.assert_array_equal(
            jw["W3q"][ph * CIN:(ph + 1) * CIN, ph * 3:(ph + 1) * 3],
            W3q[0, 0])
        np.testing.assert_array_equal(jw["s3n"][0, ph * 3:(ph + 1) * 3], s3w)


def test_calibrate_tail_scales_matches_jax(port, tail_params, h_tiles):
    hj, hf = h_tiles
    want = jtail.calibrate_tail_scales(tail_params, hj.astype(jnp.float32),
                                       margin=jtail.Q8_MARGIN)
    got, margin = port("calibrate", tail_params, hf, family="srgan")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert margin == jtail.Q8_MARGIN


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
def test_twin_matches_jax_kernel(port, tail_params, h_tiles, mode):
    hj, hf = h_tiles
    q8 = mode == "w8a8"
    kw = {"q8_calib": hj.astype(jnp.float32)} if q8 else {}
    run = jts.build_fused_tail64_u8(tail_params, NY, NX, brc=BRC,
                                    core_rows=CR, interpret=True, **kw)
    want = np.asarray(run(hj)).reshape(NY * CR * 4, NX * jtail.CORE * 4, 3)
    got, got_q8 = port("twin", tail_params, hf, NY, NX, NY * CR,
                       NX * jtail.CORE, q8=q8, family="srgan")
    assert got_q8 == q8
    assert got.shape == want.shape and got.dtype == np.uint8
    dmax, frac0 = _u8_diff(got, want)
    assert dmax <= 1 and frac0 < 1e-3, (dmax, frac0)
    assert got.std(axis=(0, 1)).min() > 5      # not a constant image


def test_twin_bgr_is_channel_flip(port, tail_params, h_tiles):
    _, hf = h_tiles
    args = (tail_params, hf, NY, NX, NY * CR - 5, NX * jtail.CORE - 7)
    rgb, _ = port("twin", *args, family="srgan")
    bgr, _ = port("twin", *args, bgr=True, family="srgan")
    assert rgb.shape == (4 * (NY * CR - 5), 4 * (NX * jtail.CORE - 7), 3)
    np.testing.assert_array_equal(bgr, rgb[..., ::-1])


def test_twin_crops_ragged_frame(port, tail_params, h_tiles):
    """A frame smaller than the grid is the top-left crop of the full one."""
    _, hf = h_tiles
    full, _ = port("twin", tail_params, hf, NY, NX, NY * CR, NX * jtail.CORE,
                   family="srgan")
    part, _ = port("twin", tail_params, hf, NY, NX, 17, 130, family="srgan")
    np.testing.assert_array_equal(part, full[:68, :520])


def test_wrapper_on_cpu_runs_twin(port, tail_params, h_tiles):
    _, hf = h_tiles
    got, want, launched = port("wrapper_on_cpu", tail_params, hf, NY, NX,
                               NY * CR, NX * jtail.CORE, family="srgan")
    np.testing.assert_array_equal(got, want)
    assert launched == {"fused_tail64_u8_reference:bf16": 2}


def test_wrapper_refuses_non_cpu_without_cuda(port, tail_params):
    """A tensor off the CPU goes to the kernel; without CUDA that raises
    rather than falling back to the twin."""
    with pytest.raises(RuntimeError, match="CUDA"):
        port("wrapper_off_cpu_without_cuda", tail_params, NY, NX, CR,
             NY * CR, NX * jtail.CORE, family="srgan")


@pytest.mark.parametrize("bad", ["weights", "dtype", "width", "tiles",
                                 "frame", "layout"])
def test_wrapper_validates_input(port, tail_params, h_tiles, bad):
    _, hf = h_tiles
    with pytest.raises(ValueError):
        port("wrapper_bad_input", tail_params, hf, NY, NX, NY * CR,
             NX * jtail.CORE, bad, family="srgan")


@pytest.mark.parametrize("family,scale", [("srgan", 2), ("fsrgan", 4)])
def test_prepare_tail64_rejects_other_tails(port, family, scale):
    with pytest.raises(ValueError, match="4x tail"):
        port("prepare_tail64_of", family, scale)


def test_exact_sum_inputs_sum_exactly(port):
    """On ops/tail_srgan.py's dyadic grid every f32 partial sum of up1 is
    exact, so the twin's sums equal the float64 sums rounded once (and any
    order, the tensor cores' included, gives them); on N(0, 0.25) h the
    same comparison differs, so the test can tell."""
    got = port("exact_sum_up1", NY, NX, CR)
    n_diff, top = got["dyadic"]
    assert n_diff == 0 and top < 2 ** 9, got
    assert got["gaussian"][0] > 0, got


def test_w8a8_twin_ignores_up1_order_on_exact_sums(port):
    """The w8a8 twin's frame on exact-sum inputs does not change when up1
    sums its taps in reverse: the input on which the kernel's w8a8 is held
    byte for byte to the twin (tests/test_torch_cuda.py) earns its name."""
    frame, reversed_frame, std_min = port("exact_sum_twin_orders", NY, NX,
                                          CR)
    assert frame.shape == (4 * NY * CR, 4 * NX * jtail.CORE, 3)
    np.testing.assert_array_equal(frame, reversed_frame)
    assert std_min > 5                         # not a constant image
