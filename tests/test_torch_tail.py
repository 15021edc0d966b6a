"""Port fused tail (weight prep, calibration, the kernel's plain twin and
its wrapper) vs the JAX package's Pallas tail, run in interpret mode as
tests/test_pallas_tail.py runs it.  The port runs in a child process
(tests/torch_process.py).

On the u8 output: bf16 mode max |diff| <= 1 on < 1e-3 of the bytes
(summation order only); w8a8 mode byte for byte, since its sums after up1
are exact integers and the twin quantises R where the JAX kernel does.

The CUDA kernel (csrc/tail.cu) cannot run here; its index maps can, as
ops/tail.py writes them out: the GEMMs they define must give the twin's
integer sums exactly.  So can up1's sum error bound (csrc/tail_common.cuh,
ops/tail.py::up1_err) against the twin's summation order, and the
one-sign inputs that test it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.models.fsrgan import FSRGANTail as JTail  # noqa: E402
from denoise_gan_tpu.ops.pallas import tail as jtail  # noqa: E402

NY, NX, BRC, CR = 1, 2, 12, 24


def _reseed(tree, rng):
    """Keep the kernels; redraw biases and PReLU slopes from numpy (init
    leaves them zero, which would hide a mis-mapped leaf)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _reseed(v, rng)
        elif k == "bias":
            out[k] = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
        elif k == "alpha":
            out[k] = rng.uniform(0.05, 0.3, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


@pytest.fixture(scope="module")
def tail_params():
    p = JTail().init(jax.random.key(0), jnp.zeros((1, 8, 8, 32)))["params"]
    return _reseed(p, np.random.default_rng(7))


@pytest.fixture(scope="module")
def h_tiles():
    """The same bf16 tiles for JAX, and as f32 (exact) for the port."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((NY * NX, CR + 4, jtail.T, 32)) * 0.5
    hj = jnp.asarray(h, jnp.bfloat16)
    return hj, np.asarray(hj.astype(jnp.float32))


def _u8_diff(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return d.max(), (d > 0).mean(), (d > 1).mean()


def test_q8_weights_equal_jax_packed(port, tail_params):
    """The port's per-conv-channel int8 weights and scales equal the JAX
    packed ones (prep_weights_q8) after unpacking the packing loops of
    prep_weights (tail.py:90-125)."""
    jw = jtail.prep_weights_q8(jtail.prep_weights(tail_params))
    tw = port("q8_weights", tail_params)
    W2q, W3q, s2w = tw["W2q"], tw["W3q"], tw["s2w"]
    n2 = 0
    for a in range(2):
        for a2 in range(2):
            for f in range(4):
                b, b2 = f >> 1, f & 1
                q0 = (a2 * 2 + b2) * 32
                np.testing.assert_array_equal(
                    jw["s2n"][a, a2, f * 32:(f + 1) * 32, 0],
                    s2w[q0:q0 + 32])
                for du in range(3):
                    for ll in range(4):
                        dv = (ll - 1) - b
                        if -1 <= dv <= 1:
                            k0 = (du * 4 + ll) * 32
                            np.testing.assert_array_equal(
                                jw["W2q"][a, a2, k0:k0 + 32,
                                          f * 32:(f + 1) * 32],
                                W2q[du, dv + 1, :, q0:q0 + 32])
                            n2 += 1
    assert n2 == 2 * 2 * 4 * 9
    for rho in range(-1, 5):
        for kap in range(-1, 5):
            k0 = ((rho + 1) * 6 + (kap + 1)) * 32
            for eo in range(4):
                for fo in range(4):
                    du, dv = rho - eo, kap - fo
                    if -1 <= du <= 1 and -1 <= dv <= 1:
                        n0 = (eo * 4 + fo) * 3
                        np.testing.assert_array_equal(
                            jw["W3q"][k0:k0 + 32, n0:n0 + 3],
                            W3q[du + 1, dv + 1])
                        np.testing.assert_array_equal(
                            jw["s3n"][0, n0:n0 + 3], tw["s3w"])


def test_calibrate_tail_scales_matches_jax(port, tail_params, h_tiles):
    hj, hf = h_tiles
    want = jtail.calibrate_tail_scales(tail_params, hj.astype(jnp.float32),
                                       margin=jtail.Q8_MARGIN)
    got, margin = port("calibrate", tail_params, hf)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert margin == jtail.Q8_MARGIN


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
def test_twin_matches_jax_kernel(port, tail_params, h_tiles, mode):
    hj, hf = h_tiles
    q8 = mode == "w8a8"
    kw = {"q8_calib": hj.astype(jnp.float32)} if q8 else {}
    run = jtail.build_fused_tail_u8(tail_params, NY, NX, brc=BRC,
                                    core_rows=CR, interpret=True, **kw)
    want = np.asarray(run(hj)).reshape(NY * CR * 4, NX * jtail.CORE * 4, 3)
    got, got_q8 = port("twin", tail_params, hf, NY, NX, NY * CR,
                       NX * jtail.CORE, q8=q8)
    assert got_q8 == q8
    assert got.shape == want.shape and got.dtype == np.uint8
    dmax, frac0, _ = _u8_diff(got, want)
    if q8:
        assert dmax == 0, (dmax, frac0)
    else:
        assert dmax <= 1 and frac0 < 1e-3, (dmax, frac0)
    assert got.std(axis=(0, 1)).min() > 5      # not a constant image


def test_twin_bgr_is_channel_flip(port, tail_params, h_tiles):
    _, hf = h_tiles
    args = (tail_params, hf, NY, NX, NY * CR - 5, NX * jtail.CORE - 7)
    rgb, _ = port("twin", *args)
    bgr, _ = port("twin", *args, bgr=True)
    assert rgb.shape == (4 * (NY * CR - 5), 4 * (NX * jtail.CORE - 7), 3)
    np.testing.assert_array_equal(bgr, rgb[..., ::-1])


def test_twin_crops_ragged_frame(port, tail_params, h_tiles):
    """A frame smaller than the grid is the top-left crop of the full one."""
    _, hf = h_tiles
    full, _ = port("twin", tail_params, hf, NY, NX, NY * CR, NX * jtail.CORE)
    part, _ = port("twin", tail_params, hf, NY, NX, 17, 130)
    np.testing.assert_array_equal(part, full[:68, :520])


def test_wrapper_on_cpu_runs_twin(port, tail_params, h_tiles):
    _, hf = h_tiles
    got, want, launched = port("wrapper_on_cpu", tail_params, hf, NY, NX,
                               NY * CR, NX * jtail.CORE)
    np.testing.assert_array_equal(got, want)
    assert launched == {"fused_tail_u8_reference:bf16": 2}


def test_wrapper_refuses_non_cpu_without_cuda(port, tail_params):
    """A tensor off the CPU goes to the kernel; without CUDA that raises
    rather than falling back to the twin."""
    with pytest.raises(RuntimeError, match="CUDA"):
        port("wrapper_off_cpu_without_cuda", tail_params, NY, NX, CR,
             NY * CR, NX * jtail.CORE)


def test_cuda_request_without_gpu_raises(port):
    messages, cpu = port("cuda_requests_without_gpu")
    assert all(m is not None and "CUDA" in m for m in messages), messages
    assert cpu == "cpu"


def test_build_without_nvcc_raises(port, tmp_path):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        port("build_without_nvcc", str(tmp_path))
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("bad", ["dtype", "width", "tiles", "frame",
                                 "layout"])
def test_wrapper_validates_input(port, tail_params, h_tiles, bad):
    _, hf = h_tiles
    with pytest.raises(ValueError):
        port("wrapper_bad_input", tail_params, hf, NY, NX, NY * CR,
             NX * jtail.CORE, bad)


# csrc/tail.cu's index maps, ops/tail.py::up1_err and the one-sign inputs

@pytest.mark.parametrize("mode", ["w8a8", "qh8"])
def test_kernel_index_maps_give_twin_sums(port, mode):
    """up2's and the output conv's GEMMs over the rows that up2_rows and
    out_rows gather (R's bf16-derived copy where out_rows says so), with W3
    from out_w3_fragments, equal the twin's integer sums, at the blocks of
    a 24-row tile's first and (ragged) last band and its first and last
    column chunk; the padded B columns are zero."""
    got = port("k1_index_maps", mode)
    for part in ("up2", "out"):
        compared, differ = got[part]
        assert compared > 10000 and differ == 0, (part, got)
    assert got["pad"] == 0


def test_kernel_chunks_feed_the_output_conv_in_order(port):
    """chunk_rows: the chunks write R rows 0.. once each, in order, and the
    output rows 0..4BR-1 once each; every output row's R rows (oy+1..oy+3)
    are written by its chunk or an earlier one and are among the last
    2 CH + 2 written, the kernel's ring."""
    chunks, br, ch = port("k1_chunk_rows")
    ring = 2 * ch + 2
    assert [r for w, _ in chunks for r in w] == list(range(2 * (2 * br + 2)))
    assert [o for _, o in chunks for o in o] == list(range(4 * br))
    for w, outs in chunks:
        for oy in outs:
            assert w[-1] - ring < oy + 1 and oy + 3 <= w[-1], (oy, w)


def test_kernel_w3_fragments_bf16(port):
    """bf16 out_w3_fragments unpacked: each k-step's 16 x 8 B matrix is
    w3's rows with columns 3..7 zero."""
    b, w3 = port("k1_w3_fragments_bf16")
    np.testing.assert_array_equal(b[..., :3], w3.reshape(18, 16, 3))
    assert not b[..., 3:].any()


@pytest.mark.parametrize("one_sign", [False, True], ids=["mixed", "one_sign"])
@pytest.mark.parametrize("k", [288, 576])
def test_up1_err_bounds_the_twin_order(port, k, one_sign):
    """Sequential f32 sums of k bf16 products (the twin's order) stay
    within the twin's part of up1_err, gamma_{k-1}, relative to sum |x w|
    and so to |x| |w|; the tensor core's part is 2**-16."""
    rel_sum, rel_norm, (twin, mma) = port("up1_sum_errors", k, one_sign)
    n = (k - 1) * 2.0 ** -24
    assert twin == pytest.approx(n / (1 - n), rel=1e-5)
    assert mma == 2.0 ** -16
    assert 0 < rel_sum <= twin and rel_norm <= rel_sum, (rel_sum, twin)


def test_up1_certain_needs_the_card(port):
    """ops/tail.py::up1_certain, the kernels' own certainty test, has no
    plain version: on CPU tensors it raises."""
    with pytest.raises((RuntimeError, ValueError)):
        port("up1_certain_on_cpu")


@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
def test_one_sign_inputs_keep_their_promise(port, family):
    """one_sign_up1_ and one_sign_h: every up1 weight and h value >= 0, so
    every up1 product is; the w8a8 twin's frame on them, calibrated on
    them, is not flat."""
    w_min, h_min, std_min = port("one_sign_inputs", family)
    assert w_min >= 0 and h_min >= 0
    assert std_min > 5
