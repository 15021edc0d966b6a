"""The fused tail CUDA kernels (csrc/tail.cu for FSRGAN, csrc/tail_srgan.cu
for SRGAN) against their plain PyTorch twins on the card, at small and ragged
geometries that chip_smoke.py's 1080p shapes do not reach: core_rows not a
multiple of the kernels' bands (15 rows in K1 and K2), and frames that end
inside the last tile row and column.  Likewise the fused inverted residual
(csrc/mbconv.cu, K3) against its plain version, bit for bit, at heights and
widths that its 16 x 16 unit does not divide, with be > 0 so that the zero
ring of the expanded tensor is exercised, on seeded inputs and on one-sign
ones (every product of its two tensor-core sums >= 0, the biases cancelling
the large sums: ops/mbconv.py::one_sign_x, one_sign_block), with more work
units than its persistent grid and with fewer.  K3 sums the expand and the
project on the tensor cores and sums again, in the plain order, every d
and y value whose bf16 rounding its margins leave uncertain; what it
reports of its margins and geometry (dgt_mbconv_params) must equal
ops/mbconv.py's.

These tests need a CUDA GPU and nvcc; without them they skip.  tests/
conftest.py imports jax and hides CUDA devices, so on a machine with a card
run them without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

The port runs in a child process (tests/torch_process.py).  Bound as
chip_smoke.py's: max |du8| <= 1 on < 1e-3 of the bytes (the two sum in
different orders).  In qh8 mode every sum is an exact integer, so kernel and
twin agree byte for byte, in both kernels.  In w8a8 mode every sum after up1
is an exact integer.  Both kernels sum w8a8's up1 on the tensor cores and
sum again, in the twin's order, every value whose int8 step their error
bound leaves uncertain (ops/tail.py::up1_err), so they agree byte for byte,
K1's output-conv taps that read R quantised from bf16 (tile-local output
columns 4j and 4j+3, a quarter of each of their taps) included; on inputs
where every f32 partial sum of up1 is exact (ops/tail_srgan.py::
dyadic_up1_ and dyadic_h) they do so without the repair, and on inputs
where every up1 product has one sign (ops/tail.py::one_sign_up1_ and
one_sign_h: sum errors add up there, and the bias cancels the large sums)
the bound must hold.
The video CLI (infer/video.py) on the card against the CPU on the same
.dgt export and RGBA AVI: the f32 paths (--fast 0, whole frame and
tiled), max 1 level on < 1e-3 of the bytes, PSNR within 0.05 dB; and the
CLI's kernel engine (K1 or K2 launched once a frame) byte for byte
against the same engine called directly on the card.
Training (plain PyTorch, no hand kernel): one f32 step (TF32 off) of
FSRGAN, the autoencoder and SRGAN on the card against the same step in
float64 on the CPU, from the same weights and pair, within the CPU tests'
tolerances, max |d| per gradient tensor within STEP_GRAD_F64 of its
largest value; pix2pix at 256, batch 1, card against the CPU's f32 step
(losses, statistics, gradient directions and norms, the generator's
widened to its BatchNorms' conditioning); the autoencoder's
discriminator half, card against CPU on the same inputs, to the full
rule; train-mode BatchNorm, the JPEG
round trip and the degradation card against CPU; the FSRGAN trainer's
main on the card by default, its exports read back equal.
The canvas epilogue (the bf16 tanh that the u8 epilogue rounds) is held to
the same: equal in the int8 modes, and in bf16 apart by at most
2**-8 (one bf16 ulp at the top of tanh's range: one rounding apart) on
< 2e-3 of the values, about twice the largest reading on the H100 (bf16
values round apart more often than bytes: 1.03e-3 at 1x2x24, where the
bytes differ on < 1e-3; 1.11e-3 for K1 at 1080p in chip_smoke.py).
"""

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

pytestmark = pytest.mark.gpu

# max |d| / max |g| per gradient tensor, the card's f32 training step
# against float64 on these random pairs: the card read up to 1.11e-2 (a
# leaky-ReLU kink flipped: the autoencoder's discriminator; on FSRGAN's
# pair the CPU's f32 step is the one 2.16e-2 off, the card 3.4e-5), so
# 2e-2 (PERF.md section 6)
STEP_GRAD_F64 = 2e-2
# (ny, nx, core_rows, height, width)
GEOMETRIES = [
    (1, 2, 24, 24, 240),      # frame = grid, band does not divide core_rows
    (2, 3, 24, 41, 301),      # ragged bottom and right edges
    (1, 1, 7, 5, 100),        # one tile, fewer core rows than a band
]


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        if not call("cuda_available"):
            pytest.skip("needs a CUDA GPU (and nvcc to build csrc/)")
        yield call


def _check(r, height, width, canvas=False):
    print(f"max {r['max_diff']:.3e}, differing {r['frac_diff']:.3e}")
    assert r["shape"] == r["want_shape"] == (4 * height, 4 * width, 3)
    assert r["dtype"] == ("torch.bfloat16" if canvas else "torch.uint8")
    assert r["device"] == "cuda" and r["launches"] == 1
    assert r["max_diff"] <= (2.0 ** -8 if canvas else 1), r
    assert r["frac_diff"] < (2e-3 if canvas else 1e-3), r
    assert r["std_min"] > 5                    # not a flat frame


@pytest.mark.parametrize("bgr", [False, True], ids=["rgb", "bgr"])
@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_kernel_matches_twin(port, geom, mode, bgr):
    ny, nx, cr, height, width = geom
    _check(port("cuda_kernel_vs_twin", ny, nx, cr, height, width, mode, bgr),
           height, width)


@pytest.mark.parametrize("bgr", [False, True], ids=["rgb", "bgr"])
@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_srgan_kernel_matches_twin(port, geom, mode, bgr):
    ny, nx, cr, height, width = geom
    _check(port("cuda_kernel_vs_twin", ny, nx, cr, height, width, mode, bgr,
                family="srgan"), height, width)


@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_w8a8_kernel_is_bit_identical(port, geom, family):
    ny, nx, cr, height, width = geom
    r = port("cuda_kernel_vs_twin", ny, nx, cr, height, width, "w8a8", False,
             family=family)
    _check(r, height, width)
    assert r["max_diff"] == 0, r


@pytest.mark.parametrize("canvas", [False, True], ids=["u8", "canvas"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_srgan_w8a8_bit_identical_on_exact_sums(port, geom, canvas):
    """K2 in w8a8, both epilogues, equal to its twin where every f32
    partial sum of up1 is exact in any order: there every order gives the
    twin's u1, whatever the error bound leaves to the repair."""
    ny, nx, cr, height, width = geom
    r = port("cuda_exact_sum_w8a8", ny, nx, cr, height, width, canvas)
    _check(r, height, width, canvas=canvas)
    assert r["max_diff"] == 0, r


@pytest.mark.parametrize("canvas", [False, True], ids=["u8", "canvas"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_fsrgan_w8a8_bit_identical_on_exact_sums(port, geom, canvas):
    """K1 in w8a8, both epilogues, equal to its twin where every f32
    partial sum of up1 is exact in any order, as K2 above."""
    ny, nx, cr, height, width = geom
    r = port("cuda_exact_sum_w8a8", ny, nx, cr, height, width, canvas,
             family="fsrgan")
    _check(r, height, width, canvas=canvas)
    assert r["max_diff"] == 0, r


@pytest.mark.parametrize("canvas", [False, True], ids=["u8", "canvas"])
@pytest.mark.parametrize("mode", ["w8a8", "qh8"])
@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_bit_identical_on_one_sign_inputs(port, geom, family, mode, canvas):
    """The int8 modes of both kernels, both epilogues, equal to their twins
    where every up1 product has one sign and the bias cancels the sums: in
    w8a8 by the error bound and the repair, in qh8 by exact sums."""
    ny, nx, cr, height, width = geom
    r = port("cuda_one_sign", ny, nx, cr, height, width, family, mode,
             canvas)
    _check(r, height, width, canvas=canvas)
    assert r["max_diff"] == 0, r


@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
def test_kernel_params_match_python(port, family):
    """What the built kernels report of themselves (dgt_tail_params,
    dgt_tail64_params) equals what the Python side assumes: w8a8's up1
    margin is ops/tail.py::up1_err(9 x channels) (both parts), qh8 has
    none, K1's bf16 none (up1 in the twin's order), K2's bf16 a measured
    one; K1's block and chunk are ops/tail.py's BLOCK and CHUNK, which the
    CPU index-map tests (tests/test_torch_tail.py) walk."""
    got = port("cuda_tail_params")
    modes, (twin, mma) = got[family]["modes"], got[family]["up1_err"]
    assert modes["w8a8"][:2] == (float(np.float32(twin) + np.float32(mma)),
                                 mma)
    assert modes["qh8"][:2] == (0.0, 0.0)
    if family == "fsrgan":
        assert modes["bf16"][:2] == (0.0, 0.0)
        for m in modes.values():
            assert m[2] == (*got["block"], got["chunk"])
    else:
        assert modes["bf16"][0] > 0 and modes["bf16"][1] == 0.0


@pytest.mark.parametrize("q8", [True, False], ids=["int8", "bf16"])
def test_up1_certain_is_sound(port, q8):
    """The kernels' up1 certainty test, as compiled: where it says certain,
    every sum within the margin rounds to the same int8 step (or bf16
    value) as the tensor core's; the seeded values fall on both sides."""
    certain, uncertain, wrong = port("cuda_up1_certain_sound", q8)
    print(f"certain {certain}, uncertain {uncertain}")
    assert wrong == 0
    assert certain > 1000 and uncertain > 1000


@pytest.mark.parametrize("bgr", [False, True], ids=["rgb", "bgr"])
@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_qh8_kernel_is_bit_identical(port, geom, family, bgr):
    """qh8: int8 h from quantize_h, up1 on int8 products (mma.sync)."""
    ny, nx, cr, height, width = geom
    r = port("cuda_kernel_vs_twin", ny, nx, cr, height, width, "qh8", bgr,
             family=family)
    _check(r, height, width)
    assert r["max_diff"] == 0, r


@pytest.mark.parametrize("mode", ["bf16", "w8a8", "qh8"])
@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_canvas_kernel_matches_twin(port, geom, family, mode):
    ny, nx, cr, height, width = geom
    r = port("cuda_kernel_vs_twin", ny, nx, cr, height, width, mode, False,
             family=family, canvas=True)
    _check(r, height, width, canvas=True)
    if mode != "bf16":
        assert r["max_diff"] == 0, r


# (n, h, w): band and chunk dividing nothing; the 1080p tile; one partial
# block; more work units than the persistent grid (216 of 16 x 16 on 132
# SMs); fewer (6), ragged
MBCONV_SHAPES = [(2, 13, 37), (1, 139, 124), (3, 5, 7), (3, 139, 124),
                 (1, 17, 33)]


@pytest.mark.parametrize("one_sign", [False, True], ids=["seeded", "one_sign"])
@pytest.mark.parametrize("expand", [True, False], ids=["expand", "no_expand"])
@pytest.mark.parametrize("shape", MBCONV_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mbconv_kernel_matches_reference(port, shape, expand, one_sign):
    r = port("cuda_mbconv_vs_reference", *shape, expand, one_sign)
    assert r["shape"] == (*shape, 32)
    assert r["dtype"] == "torch.bfloat16" and r["device"] == "cuda"
    assert r["launches"] == 1
    assert r["max_diff"] == 0, r


def test_mbconv_grid_cases(port):
    """MBCONV_SHAPES holds a shape with more work units than K3's
    persistent grid and one with fewer, on this card."""
    more, grid = port("cuda_mbconv_units", 3, 139, 124)
    fewer, _ = port("cuda_mbconv_units", 1, 17, 33)
    assert fewer < grid < more, (fewer, grid, more)


def test_mbconv_params_match_python(port):
    """What the built K3 kernel reports of itself (dgt_mbconv_params)
    equals what ops/mbconv.py holds: the margins' parts (the plain order's
    and the tensor core's at the expand and the project, the roundings
    between a sum and its test) and the unit, chunk and threads."""
    got, want = port("cuda_mbconv_params")
    print(got)
    assert got == want


@pytest.mark.parametrize("bad", ["dtype", "layout"])
def test_mbconv_wrapper_refuses_on_card(port, bad):
    with pytest.raises(ValueError):
        port("cuda_mbconv_bad_input", bad)


def test_build_generator_defaults_to_card(port):
    assert port("default_generator_device") == "cuda"


# The generic frame engine (infer/engine.py) and the 1x families on the
# card against the same engine on the CPU, at chip_smoke.py's cut
# geometries (autoencoder, FSRGAN 4x, SRGAN 2x at 270x480, pix2pix at
# 256x512), on its phase-4e weights.  f32 (TF32 off): max |du8| <= 1 on
# < 1e-3 of the bytes (check (a)).  bf16: the two sum each conv in other
# orders and round every activation to bf16, so they drift apart through
# the layers like the port and the JAX package on the CPU
# (tests/test_torch_models_1x.py); the card's bf16 must be no farther from
# the CPU's f32 engine than the CPU's bf16 is: max within the CPU's + 1,
# the share > 1 level within 1.25x the CPU's + 1e-3.

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("family", ["autoencoder", "pix2pix", "fsrgan",
                                    "srgan"])
def test_generic_engine_card_matches_cpu(port, family, dt):
    r = port("cuda_generic_vs_cpu", family, dt)
    print(r)
    assert r["dtype"] == "torch.uint8" and r["device"] == "cuda"
    assert r["shape"] == r["want_shape"]
    if dt == "f32":
        assert r["card_cpu"]["max"] <= 1 and r["card_cpu"]["gt0"] < 1e-3, r
    else:
        card, cpu = r["card_f32"], r["cpu_f32"]
        assert card["max"] <= cpu["max"] + 1, r
        assert card["gt1"] <= 1.25 * cpu["gt1"] + 1e-3, r


# The probes (denoise_gan_tpu_torch/probes/) at sizes that chip_smoke.py's
# JAX shapes do not reach: a few rows, element and column counts that are
# not a multiple of a block or of K6's 32-column slab, one column, and K6
# in bf16 at K = 1152, where w streams from L2 every step.  K9: bit-identical
# (fmaf and the plain version's fma_f32 each round a multiply-add once).  K6: int8
# bit-identical after `iters` chained steps; bf16 each step, from the
# kernel's previous state, within int8_chain.bf16_step_bound (one bf16
# rounding after f32 sums in another order), and one launch of those steps
# equal to the steps; rows >= 128 unchanged.  From the probe's initial
# state (where int8 saturates at 127 within two steps) and from a random
# one (both signs, rarely saturated).

@pytest.mark.parametrize("iters", [0, 37, 256])
@pytest.mark.parametrize("shape", [(3, 1000), (1, 7), (5, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_probe_fma_kernel_matches_plain(port, shape, iters):
    r = port("cuda_probe_fma", shape, iters)
    print(r)
    assert r["shape"] == shape and r["launches"] == 1
    assert r["equal"], r


@pytest.mark.parametrize("iters", [1, 128])
@pytest.mark.parametrize("rows,width", [(1, 1024), (3, 1024), (5, 1024),
                                        (6, 1024)])
def test_probe_roll_kernel_matches_plain(port, rows, width, iters):
    r = port("cuda_probe_roll", rows, width, iters)
    print(r)
    assert r["shape"] == (rows, width) and r["launches"] == 1
    assert r["equal"], r


@pytest.mark.parametrize("width", [1000, 128, 256, 512, 2048])
def test_probe_roll_kernel_refuses_width(port, width):
    with pytest.raises(ValueError):
        port("cuda_probe_roll_bad_width", width)


@pytest.mark.parametrize("state", ["probe", "random"])
@pytest.mark.parametrize("m", [1, 37, 100])
@pytest.mark.parametrize("k", [128, 384, 1152])
@pytest.mark.parametrize("dtype,iters", [("int8", 50), ("bf16", 4)])
def test_probe_dot_chain_matches_plain(port, dtype, iters, k, m, state):
    r = port("cuda_probe_dot_chain", k, m, iters, dtype, state)
    print(r)
    assert r["shape"] == (k, m) and r["rest_kept"]
    assert r["launches"] == (1 if dtype == "int8" else iters + 1)
    if dtype == "int8":
        assert r["equal"], r
    else:
        assert r["bound_ratio"] <= 1 and r["one_launch"], r


@pytest.mark.parametrize("bad", ["dtype", "w_shape", "short_k", "chunk"])
def test_probe_dot_chain_refuses_on_card(port, bad):
    with pytest.raises(ValueError):
        port("probe_dot_chain_bad_input", bad, device="cuda")


def test_probe_dot_chain_too_deep_fails_at_launch(port):
    # bf16 K = 2560: the slab and the ring of w chunks exceed a block's
    # shared memory, and the C entry point refuses the launch
    with pytest.raises(RuntimeError):
        port("probe_dot_chain_bad_input", "deep", device="cuda")


# K8 and K10 (probes/relayout.py, probes/u8_store.py) at the JAX probes'
# shapes and at sizes they do not reach: an M that is not a multiple of 16
# (ragged rows of A or columns of B, by form), a few reps that do not
# divide among the split CTAs, transposes of ragged tiles, and the u8
# store at one band.  K8's product: every element within
# relayout.product_bound (f32 sums in another order than the ideal
# accumulator), acc within relayout.acc_bound; the transpose chain and the
# u8 store bit-identical (one f32 multiply each step; tanhf and the plain
# version's steps rounded apart).

@pytest.mark.parametrize("reps", [1, 7, 64])
@pytest.mark.parametrize("shape", [(2048, 384, 128), (2048, 1152, 128),
                                   (1024, 1152, 48), (37, 384, 48),
                                   (100, 1152, 72)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("form", ["canonical", "sublane"])
def test_probe_matmul_form_matches_plain(port, form, shape, reps):
    r = port("cuda_probe_matmul_form", *shape, form, reps)
    print(r)
    m, _, n = shape
    assert r["shape"] == ((m, n) if form == "canonical" else (n, m))
    assert r["launches"] == 1
    assert r["y_ratio"] <= 1 and r["acc_ratio"] <= 1, r


@pytest.mark.parametrize("iters", [0, 8, 33])
@pytest.mark.parametrize("rows,cols", [(1536, 128), (45, 70), (1, 33)])
def test_probe_transpose_chain_matches_plain(port, rows, cols, iters):
    r = port("cuda_probe_transpose_chain", rows, cols, iters)
    print(r)
    assert r["shape"] == (rows, cols) and r["launches"] == 1
    assert r["equal"], r


@pytest.mark.parametrize("m", [128, 1024])
def test_probe_u8_store_matches_plain(port, m):
    r = port("cuda_probe_u8_store", m)
    print(r)
    assert r["shape"] == (m // 128, 4, 128, 12) and r["launches"] == 1
    assert r["dtype"] == "torch.uint8" and r["equal"], r


@pytest.mark.parametrize("bad", ["dtype", "form", "x_shape", "reps",
                                 "u8_cols", "u8_rows", "u8_dtype"])
def test_probe_relayout_and_u8_refuse_on_card(port, bad):
    with pytest.raises(ValueError):
        port("probe_relayout_bad_input", bad, device="cuda")


@pytest.mark.parametrize("bad", ["k_step", "k_max"])
def test_probe_matmul_form_launch_refuses_k(port, bad):
    """K not a multiple of 64, or above the 1152 whose operands fit in a
    block's shared memory: the entry point refuses the launch."""
    with pytest.raises(RuntimeError):
        port("probe_relayout_bad_input", bad, device="cuda")


# K7 and K4 (probes/overlap.py, probes/dw_forms.py).  K7: z bit-identical
# to the plain version at the JAX counts in every mode (fmaf(z, c1,
# roll * c2) on both sides), y's columns 128.. kept; y step by step for 8
# steps from the kernel's previous state, each within overlap.step_bound
# (one bf16 rounding after f32 sums in another order), and one launch of
# the 8 steps equal to them.  K4: every form bit-identical to its plain
# version (fmaf in the JAX order on both sides) at 1, 37 and 2000 reps and
# at 1, 7 and 192 channels.

@pytest.mark.parametrize("counts", [(4000, 0), (0, 3000), (4000, 3000),
                                    (1, 2)])
def test_probe_overlap_z_matches_plain(port, counts):
    r = port("cuda_probe_overlap_full", *counts)
    print(r)
    assert r["launches"] == 1 and r["z_equal"] and r["kept"], r


@pytest.mark.parametrize("counts", [(1, 0), (1, 1)])
def test_probe_overlap_y_steps_within_bound(port, counts):
    r = port("cuda_probe_overlap_steps", *counts, 8)
    print(r)
    assert r["finite"] and r["equal"] and r["one_launch"], r
    assert r["ratio"] <= 1, r


@pytest.mark.parametrize("bad", ["dtype", "z_shape", "w_shape", "iters",
                                 "width", "contiguous", "device"])
def test_probe_overlap_refuses_on_card(port, bad):
    with pytest.raises(ValueError):
        port("probe_overlap_bad_input", bad, device="cuda")


@pytest.mark.parametrize("nch", [1, 7, 192])
@pytest.mark.parametrize("reps", [1, 37, 2000])
@pytest.mark.parametrize("form", ["scratch", "value", "chunked", "planes"])
def test_probe_dw_matches_plain(port, form, reps, nch):
    r = port("cuda_probe_dw", nch, reps, form)
    print(r)
    assert r["launches"] == 1 and r["equal"], r
    assert r["shapes"] == ((nch, 2176), (nch, 1920))


@pytest.mark.parametrize("bad", ["dtype", "form", "width", "w_shape",
                                 "reps", "contiguous", "device"])
def test_probe_dw_refuses_on_card(port, bad):
    with pytest.raises(ValueError):
        port("probe_dw_bad_input", bad, device="cuda")


# K5 (probes/mbpipe.py), in every mode (one chain; two chains with their
# own barriers, or one barrier with the phases aligned or offset): the last
# step of a launch against the plain version's pieces from the kernel's own
# bands one step earlier (mbpipe.check): E and p within
# expand_bound and project_bound (tensor-core f32 sums in the hardware's
# order), D bit-identical to the depthwise of the kernel's own E, and the
# new bands bit-identical to the update from the kernel's own p; at 1, 2
# and 37 steps from the probe's state, and from a seeded state of three
# bands (both chains move there), each band equal to that band alone.

MB_MODES = [(1, "own"), (2, "own"), (2, "aligned"), (2, "offset")]


@pytest.mark.parametrize("reps", [1, 2, 37])
@pytest.mark.parametrize("mode", MB_MODES, ids=lambda m: f"{m[0]}-{m[1]}")
def test_probe_mbpipe_matches_plain(port, mode, reps):
    r = port("cuda_probe_mbpipe", reps, *mode)
    print(r)
    assert r["launches"] == 1 and r["d_equal"] and r["r_equal"], r
    assert r["e_ratio"] <= 1 and r["p_ratio"] <= 1, r


@pytest.mark.parametrize("reps", [1, 2, 37])
@pytest.mark.parametrize("mode", MB_MODES, ids=lambda m: f"{m[0]}-{m[1]}")
def test_probe_mbpipe_seeded_bands_match_plain(port, mode, reps):
    r = port("cuda_probe_mbpipe", reps, *mode, seed=reps, bands=3)
    print(r)
    assert r["launches"] == 1 and r["d_equal"] and r["r_equal"], r
    assert r["e_ratio"] <= 1 and r["p_ratio"] <= 1 and r["bands_equal"], r


@pytest.mark.parametrize("bad", ["dtype", "r_shape", "w_shape", "wdw_dtype",
                                 "chains", "reps", "sync", "bands",
                                 "contiguous", "device"])
def test_probe_mbpipe_refuses_on_card(port, bad):
    with pytest.raises(ValueError):
        port("probe_mbpipe_bad_input", bad, device="cuda")


# (id, family, CLI flags)
CLI_F32_PATHS = [
    ("autoencoder-whole", "autoencoder", ["--fast", "0", "--tile", "0"]),
    ("fsrgan-tiled", "fsrgan", ["--fast", "0", "--tile", "48",
                                "--tile_overlap", "8"]),
]


@pytest.fixture(scope="module")
def serving(port):
    """tests/torch_side_serving.py in a child of its own (`port` skips
    first without a card)."""
    with torch_process("torch_side_serving") as call:
        yield call


@pytest.mark.parametrize("family,flags", [c[1:] for c in CLI_F32_PATHS],
                         ids=[c[0] for c in CLI_F32_PATHS])
def test_video_cli_card_matches_cpu(serving, tmp_path, family, flags):
    """The f32 paths (--fast 0), scored: max 1 level on < 1e-3 of the
    bytes, PSNR within 0.05 dB."""
    r = serving("cuda_video_cli_vs_cpu", family, flags, str(tmp_path))
    print(r)
    assert r["shape"][0] == 4 and r["launches"] == {}
    assert r["max_diff"] <= 1 and r["frac_diff"] < 1e-3, r
    p_card, p_cpu = r["psnr"]
    assert abs(p_card - p_cpu) < 0.05


@pytest.mark.parametrize("family,q8,key", [
    ("fsrgan", -1, "fused_tail_u8:w8a8"), ("srgan", 2, "fused_tail64_u8:qh8")])
def test_video_cli_kernel_engine_on_card(serving, tmp_path, family, q8,
                                         key):
    """The kernel engine through the CLI (K1 or K2 once a frame) writes the
    bytes of the same engine called directly on the card.  (Card against
    CPU, the bf16 body on cuDNN and the int8 scales calibrated on it put
    the seeded generators' frames up to 5 levels apart, > 0 on 11%.)"""
    r = serving("cuda_video_cli_vs_engine", family, q8, str(tmp_path))
    print(r)
    assert r["shape"] == (4, 400, 600, 3)
    assert r["launches"] == {key: 4}
    assert r["max_diff"] == 0, r


# ---------------------------------------------------------------------------
# training (train/step.py, train/loop.py): plain PyTorch, no hand kernel

@pytest.fixture(scope="module")
def training(port):
    """tests/torch_side_training.py in a child of its own (`port` skips
    first without a card)."""
    with torch_process("torch_side_training") as call:
        yield call


@pytest.mark.parametrize("family,crop,batch", [
    ("fsrgan", 64, 4), ("autoencoder", 64, 2), ("srgan", 64, 2)])
def test_train_step_card_matches_cpu(training, family, crop, batch):
    """One f32 step (TF32 off) on the card against the same step in
    float64 on the CPU from the same weights and pair: losses within 1e-5
    relative, new BN statistics within 1e-5 of each tensor's largest
    value, the gradients recovered from Adam per tensor cosine >= 0.9999,
    norms within 1e-3 (those at the noise level below it on both sides)
    and max |d| <= STEP_GRAD_F64 max |g_f64|; no hand kernel.  Printed
    beside them: the card against the CPU's f32 step, and the CPU's f32
    step against float64."""
    r = training("cuda_step_vs_cpu", family, crop, batch, f64=True)
    print(r)
    assert r["launches"] == 0
    assert r["loss64"] <= 1e-5 and r["stats64"] <= 1e-5
    for net in ("gen", "disc"):
        cos, norm, rel, noise_ok = r[net + "64"]
        assert cos >= 0.9999 and norm <= 1e-3 and noise_ok, (net, r[net])
        assert rel <= STEP_GRAD_F64, (net, r[net + "64"])


def test_disc_gradient_same_inputs_card_matches_cpu(training):
    """The autoencoder step's discriminator half on the card and on the
    CPU: given the same fake, its gradients meet the CPU tests' full rule
    (max |d| <= 1e-3 max |g|); given each device's own generator output,
    a few e-6 apart, a leaky-ReLU kink flips and moves its first conv's
    gradients by about a percent (printed)."""
    r = training("cuda_disc_same_inputs")
    print(r)
    cos, norm, rel, noise_ok = r["same"]
    assert cos >= 0.9999 and norm <= 1e-3 and rel <= 1e-3 and noise_ok
    assert r["fake_diff"] < 1e-4


def test_pix2pix_step_card_matches_cpu(training):
    """pix2pix at crop 256, batch 1, the same dropout masks on both: the
    losses and statistics as above, the discriminator's gradient
    directions and norms too; the generator's held to cosine >= 0.999
    and norms within 5e-3, the largest max |d| printed.  Its inner
    levels normalise 4, 16 and 64 values a channel (batch 1), where
    BatchNorm's E[x^2] - mean^2 cancels and kinks flip (ROADMAP C, the
    training traps); card against CPU read cosine 0.99960-0.99961, norms
    1.2e-3-1.4e-3, max 0.30 on the H100."""
    r = training("cuda_step_vs_cpu", "pix2pix", 256, 1)
    print(r)
    assert r["launches"] == 0
    assert r["loss"] <= 1e-5 and r["stats"] <= 1e-5
    cos, norm, _, noise_ok = r["disc"]
    assert cos >= 0.9999 and norm <= 1e-3 and noise_ok, r["disc"]
    cos, norm, _, noise_ok = r["gen"]
    assert cos >= 0.999 and norm <= 5e-3 and noise_ok, r["gen"]


def test_train_ops_card_match_cpu(training):
    """Train-mode BatchNorm (f32 output and statistics within 1e-5 of the
    largest value; bf16 output beyond one bf16 ulp on < 1e-3), the JPEG
    round trip and degrade_pair (> 1e-4 apart on < 1e-3 of the values) on
    the card against the CPU."""
    r = training("cuda_ops_vs_cpu")
    print(r)
    f32, bf16 = r["torch.float32"], r["torch.bfloat16"]
    assert max(f32["y_rel"], f32["mean_rel"], f32["var_rel"]) <= 1e-5
    assert bf16["y_ulp_share"] < 1e-3
    assert r["jpeg_share"] < 1e-3 and r["degrade_share"] < 1e-3


def test_trainer_runs_on_card_by_default(training, tmp_path):
    """train_fsrgan_torch's main without --device trains on the card; its
    exports read back equal to the final state; no hand kernel."""
    device, equal, launches, steps = training("cuda_trainer_cli",
                                              str(tmp_path))
    assert device.startswith("cuda") and equal and launches == 0
    assert steps == 2


# ---------------------------------------------------------------------------
# a reference Keras .h5 (io/keras_h5.py) and the space axis
# (parallel/spatial.py) on the card

@pytest.fixture(scope="module")
def keras_h5(port):
    """tests/torch_side_keras_h5.py in a child of its own (`port` skips
    first without a card)."""
    with torch_process("torch_side_keras_h5") as call:
        yield call


def test_h5_kernel_engines_equal_dgt_on_card(keras_h5, tmp_path):
    """The FSRGAN kernel engines (w8a8; the plain body, then the K3 body)
    from tests/data/fsrgan_ref.h5 and from the port converter's .dgt of
    it, on two seeded 48x70 frames: the same bytes; K1 once a frame, K3
    six times a frame with the K3 body."""
    import os
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "fsrgan_ref.h5")
    rng = np.random.default_rng(3)
    frames = [rng.random((48, 70, 3)).astype(np.float32) for _ in range(2)]
    r = keras_h5("cuda_h5_engines_vs_dgt", fixture,
                 str(tmp_path / "ref.dgt"), 48, 70, 8, frames)
    print(r)
    want = {"plain": {"fused_tail_u8:w8a8": 2},
            "k3": {"fused_tail_u8:w8a8": 2, "fused_mbconv": 12}}
    for key, got in r.items():
        assert got["equal"] and got["shape"] == (192, 280, 3), key
        assert got["std"] > 5
        assert got["launches"] == (want[key], want[key])


@pytest.fixture(scope="module")
def parallel(port):
    """tests/torch_side_parallel.py in a child of its own."""
    with torch_process("torch_side_parallel") as call:
        yield call


def test_space_axis_two_ranks_on_card(parallel):
    """parallel/spatial.py::spatial_apply on two gloo ranks sharing cuda:0
    against the plain forward on one process, f32 with TF32 off: within
    1e-5 (byte-equality printed), one halo exchange a conv wider than 1x1;
    SRGAN also on an uneven split (45 rows: 22 / 23)."""
    cases = {"fsrgan": ("fsrgan", 64, 72), "srgan": ("srgan", 45, 40),
             "autoencoder": ("autoencoder", 64, 96)}
    exchanges = {"fsrgan": 11, "srgan": 36, "autoencoder": 17}
    r = parallel("cuda_spatial_two_ranks", cases)
    for name, ranks in r.items():
        rows = cases[name][1]
        for rank, (span, max_d, equal, n, std) in enumerate(ranks):
            print(f"{name} rank {rank}: rows {span}, max |d| {max_d:.2e}, "
                  f"byte-equal {equal}")
            assert span == (rank * rows // 2, (rank + 1) * rows // 2)
            assert max_d <= 1e-5 and n == exchanges[cases[name][0]]
            assert std > 0.01
